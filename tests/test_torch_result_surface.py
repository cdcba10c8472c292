"""The per-path result surface of the port: the lazy replays of
``PathfinderResult``, ``path_result``, the two ``__repr__``, the progress
output, and the ``ops`` pieces they stand on.

* ``lbfgs_inverse_hessians``, ``history_windows`` and ``fit_distributions``
  against the JAX package's on a JAX trace carried in with
  ``interop.trace_from_numpy`` (f64, rtol 1e-10).
* ``maximize_elbo`` and ``elbo_stats`` against JAX's with JAX's noise
  injected (f64, rtol 1e-8: same arithmetic, another summation order).
* ``elbo_estimates`` replays the stored ``elbo_values`` bitwise on the CPU,
  NaN exactly where they are NaN (the counterpart of
  ``tests/test_singlepath.py:283-300``).
* ``ThrottledProgress`` keeps the contract of ``tests/test_diagnostics.py``.
"""

import dataclasses
import io

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu import pathfinder as jpathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops import elbo as jelbo
from pathfinder_tpu.ops import lbfgs as jlbfgs
from pathfinder_tpu_torch import multipathfinder, pathfinder
from pathfinder_tpu_torch.interop import trace_from_numpy
from pathfinder_tpu_torch.models import zoo
from pathfinder_tpu_torch.ops import elbo as telbo
from pathfinder_tpu_torch.ops import lbfgs as tlbfgs
from pathfinder_tpu_torch.utils.misc import tree_map
from pathfinder_tpu_torch.utils.progress import ThrottledProgress

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


D, L = 5, 20
CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX single-path run at d=5 in f64, and the port's run beside it
    with the JAX trace injected in place of its own."""
    jt = jzoo.HierarchicalGaussian(D, seed=1)
    init = np.random.default_rng(0).uniform(-2.0, 2.0, D)
    jres = jpathfinder(jt, key=jax.random.key(4), init=jnp.asarray(init), maxiters=L)
    tres = pathfinder(zoo.HierarchicalGaussian(D, seed=1), init=init, maxiters=L, **CPU)
    tr = jres.optim_trace
    trace = trace_from_numpy(tr.xs, tr.log_densities, tr.gradients, tr.num_valid)
    injected = dataclasses.replace(tres, optim_trace=tree_map(lambda t: t[0], trace))
    return jres, injected, trace


def test_inverse_hessians_and_windows_match_jax(jax_run):
    jres, _, trace = jax_run
    jfits, jmask, jrej = jlbfgs.lbfgs_inverse_hessians(jres.optim_trace, history_length=6)
    fits, mask, rej = tlbfgs.lbfgs_inverse_hessians(trace, history_length=6)
    valid = np.asarray(jmask)
    assert valid.sum() > 3 and np.array_equal(mask[0].numpy(), valid) and int(rej[0]) == int(jrej)
    jdense = np.asarray(jax.vmap(lambda c: c.to_dense())(jfits))
    np.testing.assert_allclose(fits.to_dense()[0].numpy()[valid], jdense[valid], rtol=1e-10, atol=1e-12)
    aux = tlbfgs.lbfgs_history_aux(trace)
    jaux = jlbfgs.lbfgs_history_aux(jres.optim_trace)
    for J in (2, 6):
        idx, m = tlbfgs.history_windows(aux.accept, J)
        jidx, jm = jlbfgs.history_windows(jaux.accept, J)
        assert np.array_equal(m[0].numpy(), np.asarray(jm))
        assert np.array_equal(idx[0].numpy(), np.asarray(jidx))


def test_fit_distributions_match_jax(jax_run):
    jres, injected, _ = jax_run
    got, want = injected.fit_distributions, jres.fit_distributions
    valid = np.asarray(jres.optim_trace.point_mask)
    assert got.mean.shape == (L + 1, D)
    np.testing.assert_allclose(got.mean.numpy()[valid], np.asarray(want.mean)[valid], rtol=1e-10, atol=1e-12)
    jdense = np.asarray(jax.vmap(lambda c: c.to_dense())(want.cov))
    np.testing.assert_allclose(got.cov.to_dense().numpy()[valid], jdense[valid], rtol=1e-10, atol=1e-12)


def test_maximize_elbo_and_elbo_stats_match_jax_with_injected_noise(jax_run):
    jres, injected, _ = jax_run
    N = 5
    key = jax.random.key(11)
    jdists = jax.tree_util.tree_map(lambda leaf: leaf[1:], jres.fit_distributions)
    valid = jres.optim_trace.point_mask[1:]
    jbest, jest, jval = jelbo.maximize_elbo(key, jres.logp, jdists, N, valid)
    noise = np.stack([
        np.asarray(jax.random.normal(jax.random.fold_in(key, i), (D, N), dtype=jnp.float64))
        for i in range(L)
    ])
    dists = tree_map(lambda t: t[1:], injected.fit_distributions)
    logp = zoo.HierarchicalGaussian(D, seed=1).logp
    best, est, val = telbo.maximize_elbo(logp, dists, torch.tensor(noise), torch.tensor(np.asarray(valid)))
    jv = np.asarray(jest.value)
    assert np.array_equal(np.isnan(est.value.numpy()), np.isnan(jv)) and np.isfinite(jv).sum() > 3
    np.testing.assert_allclose(est.value.numpy(), jv, rtol=1e-8)
    np.testing.assert_allclose(est.std_err.numpy(), np.asarray(jest.std_err), rtol=1e-7)
    np.testing.assert_allclose(est.draws.numpy()[np.asarray(valid)],
                               np.asarray(jest.draws)[np.asarray(valid)], rtol=1e-10, atol=1e-12)
    assert int(best) == int(jbest) and float(val) == pytest.approx(float(jval), rel=1e-8)
    i = int(best)
    one = tree_map(lambda t: t[i], dists)
    jone = jax.tree_util.tree_map(lambda leaf: leaf[i], jdists)
    v, se = telbo.elbo_stats(logp, one, torch.tensor(noise[i]))
    jvv, jse = jelbo.elbo_stats(jax.random.fold_in(key, i), jres.logp, jone, N)
    np.testing.assert_allclose([float(v), float(se)], [float(jvv), float(jse)], rtol=1e-8)


def test_elbo_estimates_replay_the_stored_values():
    res = pathfinder(zoo.StandardNormal(4), seed=3, maxiters=50, ndraws_elbo=5, **CPU)
    assert res.success
    stored = res.elbo_values
    assert bool(torch.isnan(stored).any())  # converged well before maxiters
    est = res.elbo_estimates
    nan = torch.isnan(stored)
    assert torch.equal(torch.isnan(est.value), nan) and torch.equal(torch.isnan(est.std_err), nan)
    assert torch.equal(est.value[~nan], stored[~nan]) and torch.equal(est.std_err[~nan], res.elbo_se[~nan])
    assert est.draws.shape == (50, 4, 5)
    # the winner's replayed draws are its stored draws
    assert torch.equal(est.draws[res.fit_iteration - 1], res.draws)


def test_path_result_views_the_batched_states():
    res = multipathfinder(zoo.HierarchicalGaussian(D, seed=0), 40, seed=2, nruns=4, maxiters=L, **CPU)
    views = res.pathfinder_results
    assert len(views) == 4
    st = res.states
    for k, p in enumerate(views):
        assert torch.equal(p.draws, st.draws[k]) and p.fit_iteration == int(st.fit_iteration[k])
        assert torch.equal(p.fit_distribution.mean, st.fit_distribution.mean[k])
        assert torch.equal(p.optim_trace.xs, st.trace.xs[k]) and p.num_tries == int(res.num_tries[k])
        assert p.success == bool(st.success[k]) and p.num_fn_evals == int(st.num_fn_evals[k])
        assert p.draws_transformed is p.draws and p.transform is None
        est = p.elbo_estimates  # a path of a batch replays its own streams
        nan = torch.isnan(p.elbo_values)
        assert torch.equal(torch.isnan(est.value), nan) and torch.equal(est.value[~nan], p.elbo_values[~nan])
        fits = p.fit_distributions
        assert torch.equal(fits.mean[p.fit_iteration], p.fit_distribution.mean)


def test_reprs():
    mres = multipathfinder(zoo.StandardNormal(3), 30, seed=0, nruns=4, maxiters=L, **CPU)
    text = repr(mres)
    assert text.startswith("Multi-path Pathfinder result") and "runs: 4" in text and "draws: 30" in text
    assert "Pareto shape diagnostic" in text and "hint" not in text
    bad = dataclasses.replace(mres, psis_result=dataclasses.replace(
        mres.psis_result, pareto_shape=torch.tensor(1.5)))
    assert "very bad" in repr(bad) and "hint: k-hat > 0.7" in repr(bad)
    assert "Pareto" not in repr(dataclasses.replace(mres, psis_result=None))
    p = mres.path_result(1)
    text = repr(p)
    assert text.startswith("Single-path Pathfinder result") and f"fit iteration: {p.fit_iteration}" in text
    assert "fit ELBO: " in text and "tries: 1" in text


def test_progress_lines(capsys):
    def flaky(x):
        clean = -0.5 * (x * x).sum(-1)
        return torch.where(x.abs().amax(-1) > 3.0, torch.full_like(clean, torch.nan), clean)

    res = pathfinder(flaky, dim=2, seed=3, init_scale=6.0, ntries=50, maxiters=20,
                     progress=True, **CPU)
    err = capsys.readouterr().err
    assert res.success and res.num_tries > 1
    assert "Optimizing (try 1)" in err and f"Optimizing (try {res.num_tries})" in err
    assert f"Optimizing (try {res.num_tries + 1})" not in err
    r = pathfinder(lambda x: -0.5 * ((x - 2.0) ** 2).sum(-1), dim=4, maxiters=20, progress_every=1, **CPU)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "L-BFGS iter" in ln]
    assert len(lines) >= int(r.optim_trace.num_valid) - 1 and "/20" in lines[0]
    pathfinder(zoo.StandardNormal(3), maxiters=20, optimizer="cg", progress_every=2, **CPU)
    assert "CG iter 2/20" in capsys.readouterr().out
    multipathfinder(zoo.StandardNormal(3), 20, nruns=8, maxiters=10, progress=True, **CPU)
    assert "Multi-path Pathfinder: 8/8 (100.0%)" in capsys.readouterr().err


def test_throttled_progress_contract():
    buf = io.StringIO()
    p = ThrottledProgress(1000, min_seconds=0.0, min_fraction=0.1, stream=buf)
    for i in range(0, 1001, 10):
        p.update(i)
    p.close()
    out = buf.getvalue()
    assert out.count("/1000") <= 15  # about one line per 10%, not 100
    assert "1000/1000 (100.0%)" in out


def test_throttled_progress_final_state_visible_when_incomplete():
    buf = io.StringIO()
    p = ThrottledProgress(100, min_seconds=1e9, min_fraction=0.5, stream=buf)
    p.update(10, extra="(round 1, long tail here)")
    p.update(97, extra="done")  # throttled: below the step and inside the window
    p.close()
    lines = buf.getvalue().split("\r")
    assert any("97/100" in ln for ln in lines)
    assert "long tail" not in lines[-1].rstrip("\n")  # the shorter line overwrites the longer

"""The port's multipathfinder as a whole, held against the JAX package.

* Statistical parity at d=16, K=8, maxiters=64 over 5 seeds: both packages
  start from the same initial points (seeded numpy) in f64, so their L-BFGS
  trajectories and evaluation counts agree up to stopping-rule ties at the
  f64 noise floor; their
  noise differs (threefry vs the port's Philox streams), so k̂ and the moment
  error are compared as medians against a band around the JAX values:
  ``[min − r/2, max + r/2]`` of the JAX per-seed values, r their range.
* Determinism: a path's draws are bitwise identical alone, in a batch of 8,
  and in a retry batch.
* The numpy copy of ``hierarchical_gaussian_truth`` equals the original.
* ``import pathfinder_tpu_torch`` loads no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu import multipathfinder as jmultipathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu_torch import multipathfinder, resample
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.singlepath import PathfinderConfig, pathfinder_core, pathfinder
from pathfinder_tpu_torch.utils import rng


def _moment_err(draws, mean_t, sd_t):
    """Max standardized error of the draw means (draws ``(d, N)``)."""
    x = np.asarray(draws, dtype=np.float64)
    return float(np.max(np.abs(x.mean(axis=1) - mean_t) / sd_t))


def _band(values):
    lo, hi = min(values), max(values)
    r = hi - lo
    return lo - r / 2, hi + r / 2


def _statistical_parity(d, K, seeds, maxiters=64):
    jt, tt = jzoo.HierarchicalGaussian(d, seed=0), tzoo.HierarchicalGaussian(d, seed=0)
    mean_t, sd_t = tzoo.hierarchical_gaussian_truth(d, seed=0)
    jk, jm, tk, tm = [], [], [], []
    n_equal = 0
    for s in seeds:
        init = np.random.default_rng(100 + s).uniform(-2.0, 2.0, (K, d))
        jr = jmultipathfinder(
            jt, 1000, key=jax.random.key(s), init=jnp.asarray(init),
            maxiters=maxiters, elbo_chunk=8,
        )
        tr = multipathfinder(tt, 1000, seed=s, init=init, maxiters=maxiters, elbo_chunk=8)
        assert bool(np.all(np.asarray(jr.states.success)))
        assert bool(tr.states.success.all())
        assert int(tr.num_tries.max()) == 1
        # same initial points, same deterministic optimizer: the evaluation
        # counts agree, except where a late step's ftol stall test (10 ulps
        # of f) is decided by summation-order rounding of logp
        t_ev = tr.states.num_fn_evals.numpy()
        j_ev = np.asarray(jr.states.num_fn_evals)
        n_equal += int(np.sum(t_ev == j_ev))
        assert abs(int(t_ev.sum()) - int(j_ev.sum())) <= 0.01 * j_ev.sum()
        assert torch.isfinite(tr.draws).all()
        jk.append(float(jr.psis_result.pareto_shape))
        tk.append(float(tr.psis_result.pareto_shape))
        jm.append(_moment_err(jr.draws, mean_t, sd_t))
        tm.append(_moment_err(tr.draws.numpy(), mean_t, sd_t))
    assert n_equal >= 0.8 * K * len(seeds)
    for name, jv, tv in (("khat", jk, tk), ("moment error", jm, tm)):
        lo, hi = _band(jv)
        med = float(np.median(tv))
        assert lo <= med <= hi, f"{name}: port median {med} outside JAX band [{lo}, {hi}] (JAX {jv})"


def test_multipathfinder_statistical_parity_small():
    _statistical_parity(16, 8, seeds=range(5))


@pytest.mark.slow
def test_multipathfinder_statistical_parity_headline():
    _statistical_parity(1000, 100, seeds=range(5))


def test_a_paths_draws_do_not_depend_on_its_batch():
    d, K, seed = 16, 8, 3
    target = tzoo.HierarchicalGaussian(d, seed=0)
    res = multipathfinder(target, 100, seed=seed, nruns=K, maxiters=64, elbo_chunk=8)
    cfg = res.config

    def run(path_ids, round_idx):
        ids = torch.tensor(path_ids)
        stream = rng.Stream(seed, ids, round_idx, rng.INIT)
        x0 = stream.uniform(d, torch.float32, "cpu") * 4.0 - 2.0
        return pathfinder_core(target, x0, cfg, seed, ids, round_idx)

    for k in (0, 5):
        alone = run([k], 0)
        assert torch.equal(alone.draws[0], res.states.draws[k])
        assert torch.equal(alone.trace.xs[0], res.states.trace.xs[k])
    # a retry batch: failed lanes compacted and padded by repeating the first
    retry = run([5, 2, 5, 5], 1)
    alone = run([5], 1)
    assert torch.equal(retry.draws[0], alone.draws[0])
    assert torch.equal(retry.draws[2], alone.draws[0])
    assert not torch.equal(alone.draws[0], res.states.draws[5])  # a new round
    again = multipathfinder(target, 100, seed=seed, nruns=K, maxiters=64, elbo_chunk=8)
    assert torch.equal(again.draws, res.draws)


def test_resample_reuses_psis_and_chained_calls_differ():
    target = tzoo.HierarchicalGaussian(16, seed=0)
    res = multipathfinder(target, 50, seed=2, nruns=4, maxiters=32, elbo_chunk=8)
    r1 = resample(res, 30)
    r2 = resample(r1, 30)
    assert r1.psis_result is res.psis_result and r1.draws.shape == (16, 30)
    assert not torch.equal(r1.draws, r2.draws)
    fresh = resample(res, 30, ndraws_per_run=7)
    assert fresh.draws_per_component.shape == (4, 7, 16)
    assert fresh.psis_result.weights.shape == (28,)
    assert torch.isfinite(fresh.draws).all()
    uniform = resample(res, 30, importance=False)
    assert uniform.psis_result is None


def test_single_path_pathfinder_runs_and_succeeds():
    r = pathfinder(tzoo.HierarchicalGaussian(16, seed=0), seed=1, maxiters=64, ndraws=12)
    assert r.success and r.draws.shape == (16, 12) and torch.isfinite(r.draws).all()
    assert r.num_fn_evals > r.optim_trace.num_valid.item() > 2


def test_truth_copy_equals_the_original():
    for d, seed in ((16, 0), (1000, 0), (50, 3)):
        jm, js = jzoo.hierarchical_gaussian_truth(d, seed)
        tm, ts = tzoo.hierarchical_gaussian_truth(d, seed)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ts, js)


def test_targets_equal_jax_targets():
    x = np.random.default_rng(0).standard_normal((5, 16))
    for jt, tt in (
        (jzoo.HierarchicalGaussian(16, seed=2), tzoo.HierarchicalGaussian(16, seed=2)),
        (jzoo.StandardNormal(16), tzoo.StandardNormal(16)),
    ):
        want = np.asarray(jax.vmap(jt.logp)(jnp.asarray(x)))
        np.testing.assert_allclose(tt.logp(torch.tensor(x)).numpy(), want, rtol=1e-12)
        _, g = tt.value_and_grad(torch.tensor(x))
        jg = np.asarray(jax.vmap(jax.grad(jt.logp))(jnp.asarray(x)))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-12)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pathfinder_tpu_torch, pathfinder_tpu_torch.interop, "
        "pathfinder_tpu_torch.ops.kernels.woodbury_kernels; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathfinder_tpu')]; "
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_unported_options_raise():
    t = tzoo.StandardNormal(4)
    for kw in ({"mesh": None}, {"optimizer": "cg"}, {"importance_denominator": "mixture"}):
        with pytest.raises(NotImplementedError):
            multipathfinder(t, 10, nruns=2, maxiters=3, **kw)
    with pytest.raises(NotImplementedError):
        PathfinderConfig(line_search="wolfe")


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        multipathfinder(tzoo.StandardNormal(4), 10, nruns=2, maxiters=3, device="cuda")

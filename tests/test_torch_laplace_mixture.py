"""The port's k̂ remedies, held against the JAX package: the mixture
denominator, the Laplace covariance correction and ``optimizer="auto"``.

Deterministic pieces (mixture log ratios, corrected covariances) go through
both packages on the same numpy inputs in f64 and agree to ``rtol=1e-10``
(``1e-8`` after an eigendecomposition). The auto mode's rules (selection,
early exit, NaN ranking, keep-only-if-better, validation and its messages)
are checked on the port and, where JAX can say the same without a full run,
against JAX's own messages. The end-to-end run draws other random numbers
than JAX (Philox streams, not threefry), so it is compared as a median over
seeds against the band ``[min − r/2, max + r/2]`` of JAX's per-seed values.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pathfinder_tpu.multipath as jmp
from pathfinder_tpu import multipathfinder as jmultipathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodbury
import pathfinder_tpu_torch.multipath as tmp
from pathfinder_tpu_torch import laplace_resample, multipathfinder, resample
from pathfinder_tpu_torch.interop import mvnormal_from_numpy
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.models.protocol import batched_hessian
from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace
from pathfinder_tpu_torch.ops.psis import PSISResult

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

CPU = dict(device="cpu")


def _components(K, d, m, seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal((K, d))
    A = rng.uniform(0.5, 2.0, (K, d))
    B = rng.standard_normal((K, d, m)) / np.sqrt(d)
    Q = rng.standard_normal((K, m, m))
    D = Q @ np.swapaxes(Q, 1, 2) / max(m, 1) + 0.1 * np.eye(m)
    jcomp = JMvNormal(
        jnp.asarray(mean),
        jax.vmap(JWoodbury.from_parts)(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D)),
    )
    return jcomp, mvnormal_from_numpy(mean, A, B, D)


@pytest.mark.parametrize("K,N,d,m", [(4, 5, 8, 4), (6, 3, 16, 12), (3, 4, 8, 0)])
def test_mixture_log_ratios_match_jax(K, N, d, m):
    jcomp, tcomp = _components(K, d, m, seed=K + d)
    draws = np.random.default_rng(1).standard_normal((K, N, d))
    want = np.asarray(jmp._log_importance_ratios_mixture(jcomp, jnp.asarray(draws)))
    got = tmp._log_importance_ratios_mixture(tcomp, torch.tensor(draws))
    assert got.shape == (K, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    own = np.asarray(jmp._log_importance_ratios_fit(jcomp, jnp.asarray(draws)))
    np.testing.assert_allclose(
        tmp._log_importance_ratios_fit(tcomp, torch.tensor(draws)).numpy(), own, rtol=1e-10)
    # the mixture density is at least each draw's own share of it
    assert (got.numpy() >= own - np.log(K) - 1e-9).all()


def test_psis_result_by_denominator_matches_jax():
    jt, tt = jzoo.StandardNormal(8), tzoo.StandardNormal(8)
    jcomp, tcomp = _components(5, 8, 4, seed=3)
    draws = np.random.default_rng(2).standard_normal((5, 20, 8))
    for denom in ("component", "mixture"):
        jp = jmp._compute_psis_result(jt.logp, jcomp, jnp.asarray(draws), denominator=denom)
        tp = tmp._compute_psis_result(tt.logp, tcomp, torch.tensor(draws), denominator=denom)
        np.testing.assert_allclose(tp.log_weights.numpy(), np.asarray(jp.log_weights), rtol=1e-7, atol=1e-8)
        np.testing.assert_allclose(float(tp.pareto_shape), float(jp.pareto_shape), rtol=1e-6)
    with pytest.raises(ValueError) as jerr:
        jmp._compute_psis_result(jt.logp, jcomp, jnp.asarray(draws), denominator="banana")
    with pytest.raises(ValueError) as terr:
        tmp._compute_psis_result(tt.logp, tcomp, torch.tensor(draws), denominator="banana")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown importance_denominator"):
        multipathfinder(tt, 10, nruns=2, maxiters=3, importance_denominator="banana", **CPU)


def _dense(cov):
    return cov.to_dense().numpy()


def test_laplace_covariances_diag_fallback_and_saddle_free():
    """Non-positive diag(−H) coordinates fall back to the fitted diagonal;
    negative eigenvalues keep their scale (variance 1/|λ|) under 'full'; a
    zero or non-finite Hessian falls back whole. Each case equals JAX's."""
    negH = np.stack([np.diag([4.0, -1.0, 2.0]), np.eye(3)])
    # a third component with correlations and one negative direction
    Q = np.linalg.qr(np.random.default_rng(0).standard_normal((3, 3)))[0]
    negH = np.concatenate([negH, (Q @ np.diag([3.0, -0.5, 0.2]) @ Q.T)[None]])
    fit_diag = np.full((3, 3), 7.0)
    for method in ("diag", "full"):
        jc = jmp._laplace_covariances(jnp.asarray(negH), jnp.asarray(fit_diag), method)
        tc = tmp._laplace_covariances(torch.tensor(negH), torch.tensor(fit_diag), method)
        assert tc.B.shape == (3, 3, 0) and tc.D.shape == (3, 0, 0)
        assert tc.diag_A == (method == "diag")
        want = np.asarray(jax.vmap(lambda c: c.to_dense())(jc))
        np.testing.assert_allclose(_dense(tc), want, rtol=1e-8, atol=1e-10)
        assert tc.is_finite_pd().all()
    diag = tmp._laplace_covariances(torch.tensor(negH), torch.tensor(fit_diag), "diag")
    np.testing.assert_allclose(diag.diag()[:2].numpy(), [[0.25, 7.0, 0.5], [1.0, 1.0, 1.0]])
    full = tmp._laplace_covariances(torch.tensor(negH), torch.tensor(fit_diag), "full")
    np.testing.assert_allclose(np.diag(_dense(full)[0]), [0.25, 1.0, 0.5], rtol=1e-10)
    np.testing.assert_allclose(
        np.sort(np.linalg.eigvalsh(_dense(full)[2])), np.sort([1 / 3.0, 1 / 0.5, 1 / 0.2]), rtol=1e-9)
    negH_bad = np.stack([np.zeros((3, 3)), np.full((3, 3), np.nan), np.eye(3)])
    negH_bad[2, 0, 1] = np.inf
    for method in ("diag", "full"):
        tc = tmp._laplace_covariances(torch.tensor(negH_bad), torch.tensor(fit_diag), method)
        np.testing.assert_allclose(_dense(tc)[:2], np.stack([np.diag([7.0] * 3)] * 2), rtol=1e-12)
        assert np.isfinite(_dense(tc)).all() and tc.is_finite_pd().all()
        jc = jmp._laplace_covariances(jnp.asarray(negH_bad[:2]), jnp.asarray(fit_diag[:2]), method)
        np.testing.assert_allclose(
            _dense(tc)[:2], np.asarray(jax.vmap(lambda c: c.to_dense())(jc)), rtol=1e-12)
    for mod, arg in ((jmp, jnp.asarray(negH)), (tmp, torch.tensor(negH))):
        with pytest.raises(ValueError, match="unknown laplace_resample method 'banana'"):
            mod._laplace_covariances(arg, arg[:, 0], "banana")


@pytest.fixture(scope="module")
def fitted():
    tt = tzoo.HierarchicalGaussian(6, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = multipathfinder(tt, 60, nruns=4, maxiters=40, seed=3, dtype=torch.float64, **CPU)
    return tt, res


@pytest.mark.parametrize("method", ["diag", "full"])
def test_laplace_resample_keeps_means_and_swaps_covariances(fitted, method):
    tt, res = fitted
    r2 = laplace_resample(res, 50, method=method)
    old, new = res.fit_distribution.components, r2.fit_distribution.components
    assert torch.equal(new.mean, old.mean)
    assert new.cov.B.shape == (4, 6, 0) and old.cov.B.shape == (4, 6, 12)
    # the covariance JAX builds from the same Hessians at the same means
    jt = jzoo.HierarchicalGaussian(6, seed=1)
    negH = -jax.vmap(jax.hessian(jt.logp))(jnp.asarray(old.mean.numpy()))
    np.testing.assert_allclose(
        -batched_hessian(tt.logp)(old.mean).numpy(), np.asarray(negH), rtol=1e-9, atol=1e-10)
    jc = jmp._laplace_covariances(negH, jnp.asarray(old.cov.diag().numpy()), method)
    np.testing.assert_allclose(
        _dense(new.cov), np.asarray(jax.vmap(lambda c: c.to_dense())(jc)), rtol=1e-8, atol=1e-10)
    # the per-path views hold the corrected components and their draws
    assert r2.states.fit_distribution is new
    assert r2.states.draws.shape == (4, 6, 15)
    assert torch.equal(r2.states.draws.mT, r2.draws_per_component)
    assert r2.states.elbo_values is res.states.elbo_values  # still the uncorrected fits'
    assert r2.draws.shape == (6, 50) and torch.isfinite(r2.draws).all()
    assert r2.psis_result.weights.shape == (60,)
    assert r2.psis_result is not res.psis_result
    # every draw is one of its component's pooled draws
    k0 = int(r2.draw_component_ids[0])
    assert (r2.draws_per_component[k0] == r2.draws[:, 0]).all(dim=1).any()
    # the draws follow the corrected covariance, not the fitted one
    many = laplace_resample(res, 50, method=method, ndraws_per_run=4000, importance=False)
    assert many.psis_result is None and many.draws_per_component.shape == (4, 4000, 6)
    sd = many.draws_per_component.std(dim=1)
    np.testing.assert_allclose(sd.numpy(), np.sqrt(new.cov.diag().numpy()), rtol=0.1)


def test_laplace_resample_streams_options_and_chaining(fitted):
    tt, res = fitted
    a, b = laplace_resample(res, 50), laplace_resample(res, 50)
    assert torch.equal(a.draws, b.draws) and a.resample_count == 1  # same (seed, count)
    chained = laplace_resample(a, 50)
    assert chained.resample_count == 2 and not torch.equal(chained.draws, a.draws)
    again = resample(a, 30)  # re-resampling without correcting again
    assert again.psis_result is a.psis_result and again.resample_count == 2
    assert again.fit_distribution is a.fit_distribution
    # a component's draws do not depend on the other components
    sub = dataclasses.replace(
        res,
        fit_distribution=type(res.fit_distribution)(
            tmp.tree_map(lambda t: t[:2], res.fit_distribution.components)),
        draws_per_component=res.draws_per_component[:2],
        states=tmp.tree_map(lambda t: t[:2], res.states),
    )
    assert torch.equal(laplace_resample(sub, 10).draws_per_component, a.draws_per_component[:2])
    # an explicit Hessian is the one that is used
    calls = []

    def hess(x):
        calls.append(x.shape)
        return batched_hessian(tt.logp)(x)

    c = laplace_resample(res, 50, hess=hess)
    assert calls == [(4, 6)] and torch.equal(c.draws, a.draws)
    mix = laplace_resample(res, 50, importance_denominator="mixture")
    assert mix.importance_denominator == "mixture" and a.importance_denominator == "component"
    assert not torch.equal(mix.psis_result.log_weights, a.psis_result.log_weights)
    with pytest.raises(ValueError, match="unknown laplace_resample method"):
        laplace_resample(res, 10, method="banana")


def test_resample_reuses_or_recomputes_by_denominator(fitted):
    _, res = fitted
    same = resample(res, 20, importance_denominator="component")
    assert same.psis_result is res.psis_result  # the tag matches: reused
    mix = resample(res, 20, importance_denominator="mixture")
    assert mix.psis_result is not res.psis_result and mix.importance_denominator == "mixture"
    assert resample(mix, 20).psis_result is mix.psis_result  # None reuses the tag
    back = resample(mix, 20, importance_denominator="component")
    np.testing.assert_allclose(
        back.psis_result.log_weights.numpy(), res.psis_result.log_weights.numpy(), rtol=1e-12)


def test_mixture_denominator_end_to_end(fitted):
    tt, res = fitted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mix = multipathfinder(tt, 60, nruns=4, maxiters=40, seed=3, dtype=torch.float64,
                              importance_denominator="mixture", **CPU)
    assert mix.importance_denominator == "mixture"
    assert torch.equal(mix.draws_per_component, res.draws_per_component)  # the same fits
    want = tmp._compute_psis_result(tt.logp, res.fit_distribution.components,
                                    res.draws_per_component, "mixture")
    assert torch.equal(mix.psis_result.log_weights, want.log_weights)


def _quiet(*args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return multipathfinder(*args, **kw, **CPU)


def test_auto_selects_the_lower_khat():
    tt = tzoo.HierarchicalGaussian(8, seed=0)
    kw = dict(nruns=6, maxiters=40, seed=11, dtype=torch.float64)
    r_auto = _quiet(tt, 60, optimizer="auto", auto_khat_early_exit=None, **kw)
    r_l, r_c = _quiet(tt, 60, optimizer="lbfgs", **kw), _quiet(tt, 60, optimizer="cg", **kw)
    k_l, k_c = float(r_l.psis_result.pareto_shape), float(r_c.psis_result.pareto_shape)
    assert float(r_auto.psis_result.pareto_shape) == min(k_l, k_c)
    winner = r_l if k_l <= k_c else r_c
    assert r_auto.config.optimizer == winner.config.optimizer
    assert torch.equal(r_auto.draws, winner.draws)  # it IS the winner's result
    assert resample(r_auto, 20).draws.shape == (8, 20)


def test_auto_custom_set_perfect_fit_rank_and_early_exit(monkeypatch):
    """A NaN-k̂ perfect fit (uniform weights: a zero-variance tail) ranks
    best; a first candidate under the threshold ends the competition."""
    target = tzoo.StandardNormal(4)
    kw = dict(seed=15, nruns=4, maxiters=40, dtype=torch.float64)
    res = _quiet(target, 60, optimizer="auto", auto_optimizers=("lbfgs", "newton"),
                 auto_khat_early_exit=None, **kw)
    alone = {o: tmp._khat(_quiet(target, 60, optimizer=o, **kw)) for o in ("lbfgs", "newton")}
    assert res.config.optimizer == min(alone, key=alone.get)
    # the second candidate's weights come out exactly uniform, k̂ not computed
    real, calls = tmp._compute_psis_result, []

    def second_is_perfect(logp, components, draws_knd, denominator="component", **options):
        calls.append(1)
        out = real(logp, components, draws_knd, denominator, **options)
        if len(calls) < 2:
            return out
        w = torch.full_like(out.weights, 1.0 / out.weights.shape[0])
        return PSISResult(torch.log(w), w, torch.tensor(float("nan")), out.tail_length, 1.0)

    with monkeypatch.context() as mp:
        mp.setattr(tmp, "_compute_psis_result", second_is_perfect)
        res = _quiet(target, 60, optimizer="auto", auto_optimizers=("lbfgs", "newton"),
                     auto_khat_early_exit=None, **kw)
    assert res.config.optimizer == "newton" and torch.isnan(res.psis_result.pareto_shape)
    assert float(res.psis_result.ess) / res.psis_result.weights.shape[0] >= 0.99
    assert _quiet(target, 20, seed=1, nruns=2, maxiters=20, optimizer="auto",
                  auto_optimizers="lbfgs").config.optimizer == "lbfgs"
    calls = []

    def spy(value_and_grad, x0, **kw):
        calls.append(1)
        return minimize_lbfgs_trace(value_and_grad, x0, **kw)

    kw = dict(seed=21, nruns=4, maxiters=40, optimizer="auto", auto_optimizers=("lbfgs", spy))
    res = _quiet(target, 60, **kw)
    assert res.config.optimizer == "lbfgs" and not calls
    assert tmp._khat(res) < 0.7
    _quiet(target, 60, auto_khat_early_exit=None, **kw)
    assert len(calls) == 1
    alone = _quiet(target, 60, auto_optimizers=spy, **{k: v for k, v in kw.items() if k != "auto_optimizers"})
    assert alone.config.optimizer is spy
    with pytest.raises((TypeError, ValueError)):
        multipathfinder(target, 10, auto_khat_early_exit="bogus", **kw, **CPU)
    assert len(calls) == 2  # the bad threshold failed before any run


def _fake_result(khat, ess_frac=0.5, success=True, finite=True, n=40):
    w = torch.full((n,), 1.0 / n, dtype=torch.float64)
    if ess_frac < 0.99:  # unequal weights: ESS = 1/Σw²
        w = torch.zeros(n, dtype=torch.float64)
        w[: max(1, int(n * ess_frac))] = 1.0 / max(1, int(n * ess_frac))
    psis_result = PSISResult(
        torch.log(w), w, torch.tensor(float(khat), dtype=torch.float64), n // 5, 1.0)
    draws = torch.zeros(3, 5) if finite else torch.full((3, 5), torch.nan)
    states = type("S", (), {"success": torch.tensor([True, success])})()
    return type("R", (), {"psis_result": psis_result, "states": states, "draws": draws})()


def test_khat_ranking_of_nan():
    """A NaN k̂ ranks first only with near-uniform weights, every path
    succeeded and finite draws; any other NaN ranks last."""
    nan = float("nan")
    assert tmp._khat(_fake_result(0.4)) == 0.4
    assert tmp._khat(_fake_result(nan, ess_frac=1.0)) == float("-inf")
    assert tmp._khat(_fake_result(nan, ess_frac=0.5)) == float("inf")
    assert tmp._khat(_fake_result(nan, ess_frac=1.0, success=False)) == float("inf")
    assert tmp._khat(_fake_result(nan, ess_frac=1.0, finite=False)) == float("inf")
    ranked = sorted([_fake_result(nan, 0.5), _fake_result(0.9), _fake_result(nan, 1.0)], key=tmp._khat)
    assert [tmp._khat(r) for r in ranked] == [float("-inf"), 0.9, float("inf")]


def test_auto_laplace_escalation_keeps_only_an_improvement(monkeypatch):
    target = tzoo.CorrelatedGaussian(5, seed=2)
    kw = dict(seed=31, nruns=4, maxiters=60, history_length=5, optimizer="auto",
              auto_optimizers=("lbfgs",), dtype=torch.float64)
    r_base = _quiet(target, 100, auto_khat_early_exit=None, **kw)
    # an impossible threshold forces the escalation
    r_esc = _quiet(target, 100, auto_khat_early_exit=-1.0, auto_laplace=True, **kw)
    k_base, k_esc = tmp._khat(r_base), tmp._khat(r_esc)
    assert k_esc <= k_base
    expect = laplace_resample(r_base, 100, method="diag")
    if tmp._khat(expect) < k_base:
        assert torch.equal(r_esc.draws, expect.draws)
        assert r_esc.fit_distribution.components.cov.B.shape[-1] == 0
    else:
        assert torch.equal(r_esc.draws, r_base.draws)
    # the rule itself, with corrections of a known k̂
    real = tmp.laplace_resample
    seen = []

    def fake(result, ndraws, method):
        seen.append(method)
        out = real(result, ndraws, method=method)
        return dataclasses.replace(
            out, psis_result=dataclasses.replace(out.psis_result, pareto_shape=torch.tensor(fake.khat)))

    monkeypatch.setattr(tmp, "laplace_resample", fake)
    fake.khat = k_base - 0.1
    better = _quiet(target, 100, auto_khat_early_exit=-1.0, auto_laplace="full", **kw)
    assert seen == ["full"] and better.fit_distribution.components.cov.B.shape[-1] == 0
    assert not better.fit_distribution.components.cov.diag_A
    fake.khat = k_base + 0.1
    worse = _quiet(target, 100, auto_khat_early_exit=-1.0, auto_laplace=True, **kw)
    assert seen == ["full", "diag"] and torch.equal(worse.draws, r_base.draws)
    # a winner already under the threshold is not corrected at all
    _quiet(target, 100, auto_khat_early_exit=1e9, auto_laplace=True, **kw)
    assert len(seen) == 2


def test_auto_validation_messages_equal_jax():
    jt, tt = jzoo.StandardNormal(4), tzoo.StandardNormal(4)
    cases = [
        dict(optimizer="auto", auto_optimizers=("lbfgs", "newtn")),
        dict(optimizer="auto", auto_optimizers=()),
        dict(auto_optimizers=("lbfgs",)),
        dict(auto_khat_early_exit=0.5),
        dict(auto_laplace=True),
        dict(optimizer="auto", auto_laplace="banana"),
        dict(optimizer="auto", importance=False),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as jerr:
            jmultipathfinder(jt, 10, key=jax.random.key(0), nruns=2, maxiters=10, **kw)
        with pytest.raises(ValueError) as terr:
            multipathfinder(tt, 10, seed=0, nruns=2, maxiters=10, **kw, **CPU)
        assert str(terr.value) == str(jerr.value), kw


def test_only_the_winner_warns_with_an_adapted_hint(monkeypatch):
    def bad_psis(khat):
        def fake(logp, components, draws_knd, denominator="component", **options):
            n = draws_knd.shape[0] * draws_knd.shape[1]
            w = torch.full((n,), 1.0 / n, dtype=draws_knd.dtype)
            return PSISResult(torch.log(w), w, torch.tensor(khat), n // 5, 1.0)
        return fake

    tt = tzoo.StandardNormal(4)
    monkeypatch.setattr(tmp, "_compute_psis_result", bad_psis(1.5))
    with pytest.warns(UserWarning) as rec:
        multipathfinder(tt, 40, nruns=2, maxiters=10, **CPU)
    msgs = [str(w.message) for w in rec if "unreliable" in str(w.message)]
    assert len(msgs) == 1 and "Pareto k-hat = 1.50 (very bad)" in msgs[0]
    assert msgs[0].endswith(jmp._khat_remedy_hint())
    for name in ("optimizer='auto'", "laplace_resample", "auto_laplace=True", "warm_start_chains"):
        assert name in msgs[0]
    monkeypatch.setattr(tmp, "_compute_psis_result", bad_psis(0.9))
    with pytest.warns(UserWarning) as rec:
        multipathfinder(tt, 40, nruns=2, maxiters=10, optimizer="auto", auto_laplace=True, **CPU)
    msgs = [str(w.message) for w in rec if "unreliable" in str(w.message)]
    assert len(msgs) == 1 and "(bad)" in msgs[0]  # two candidates ran, one warning
    assert msgs[0].endswith(jmp._khat_remedy_hint(tried_auto=True, tried_laplace=True))
    assert "optimizer='auto'" not in msgs[0] and "laplace_resample" not in msgs[0]
    monkeypatch.setattr(tmp, "_compute_psis_result", bad_psis(0.3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        multipathfinder(tt, 40, nruns=2, maxiters=10, **CPU)  # a good verdict is silent
    for a, b in ((False, True), (True, False)):
        assert tmp._khat_remedy_hint(a, b) == jmp._khat_remedy_hint(a, b)


def _band(values):
    lo, hi = min(values), max(values)
    return lo - (hi - lo) / 2, hi + (hi - lo) / 2


def test_auto_with_laplace_statistical_parity_small():
    """``optimizer="auto", auto_laplace=True`` at d=16, K=8 over 6 seeds,
    both packages from the same initial points in f64: the port's median k̂
    and moment error lie in the band of JAX's per-seed values."""
    d, K = 16, 8
    jt, tt = jzoo.HierarchicalGaussian(d, seed=0), tzoo.HierarchicalGaussian(d, seed=0)
    mean_t, sd_t = tzoo.hierarchical_gaussian_truth(d, seed=0)

    def merr(draws):
        x = np.asarray(draws, dtype=np.float64)
        return float(np.max(np.abs(x.mean(axis=1) - mean_t) / sd_t))

    jk, jm, tk, tm = [], [], [], []
    for s in range(6):
        init = np.random.default_rng(200 + s).uniform(-2.0, 2.0, (K, d))
        kw = dict(init=init, maxiters=64, elbo_chunk=8, optimizer="auto", auto_laplace=True,
                  auto_khat_early_exit=None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jr = jmultipathfinder(jt, 1000, key=jax.random.key(s), **{**kw, "init": jnp.asarray(init)})
            tr = multipathfinder(tt, 1000, seed=s, **kw, **CPU)
        assert bool(tr.states.success.all()) and torch.isfinite(tr.draws).all()
        jk.append(float(jr.psis_result.pareto_shape))
        tk.append(float(tr.psis_result.pareto_shape))
        jm.append(merr(jr.draws))
        tm.append(merr(tr.draws.numpy()))
    for name, jv, tv in (("khat", jk, tk), ("moment error", jm, tm)):
        lo, hi = _band(jv)
        med = float(np.median(tv))
        assert lo <= med <= hi, f"{name}: port median {med} outside JAX band [{lo}, {hi}] (JAX {jv}, port {tv})"

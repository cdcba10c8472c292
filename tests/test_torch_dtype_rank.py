"""The port at every float dtype and any rank, held against the JAX package
on the CPU, and what goes with it: the route of kernels B1/B2 on the card,
the general kernel's launch plan, the memory rule's estimates, ``pathfinder
(core=)`` and the package's exports.

* The plain versions of B1 (sample+logq) and B2 (whiten+sumsq, per factor
  and over a shared x) read their inputs in the storage dtype and compute in
  ``promote_types(dtype, float32)``, rounding each output once, as the TPU
  kernels did. They are held against the JAX package's Woodbury math
  (``unwhiten``, ``logdet``, ``invquad``, ``MvNormal.logpdf``) computed at
  that precision on the same rounded inputs and rounded once. Tolerances,
  relative to the output's magnitude ``max(|want|, mean |want|)``: float64
  1e-10 (the same arithmetic summed in another order); float32 1e-5; float16
  and bfloat16 2 ulps of the storage dtype (the float32 results differ in
  their last bits, and rounding once can then land one ulp apart). At
  m > d the Gram matrix is singular but for its ridge, and ``C`` and ``Ci``
  have large entries whose products cancel, so each side's accumulation
  error scales with the magnitude of the terms, not of the result: on top,
  64 ulps of the accumulation type (float64, or float32) times that
  magnitude (``|a½|(|u| + |X||C||X|ᵀ|u|) + |μ|`` for x, ``Σ (|w| + W)·W``
  with ``W = |v| + |X||Ci||X|ᵀ|v|`` for the Mahalanobis term).
* The route on the card is decided from dtype and rank before the launch:
  the fast kernel for float32 at rank ≤ ``MAX_RANK``, the general kernel
  for everything else; checked with the loaders and launchers replaced, no
  card needed.
* ``pathfinder(history_length=20)`` (rank 40) follows the JAX package's
  trajectory and fits; ``multipathfinder(dtype=torch.float64)`` agrees with
  it in evaluations, k̂ and moment error; at bfloat16 and float16 both give
  the same warning and the same outcome (no path succeeds in bfloat16, and
  float16 raises ``NotImplementedError``: neither package has a float16
  Cholesky or triangular solve on the CPU).
"""

import dataclasses
import math
import re
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu import multipathfinder as jmultipathfinder, pathfinder as jpathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodbury
from pathfinder_tpu_torch import multipathfinder, pathfinder
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.multipath import _compute_psis_result, _log_importance_ratios_mixture
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.parallel import sharding
from pathfinder_tpu_torch.singlepath import pathfinder_core, uniform_init_sampler
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

DTYPES = ("float64", "float32", "bfloat16", "float16")
# the tolerance of the plain versions against JAX, relative to the output's
# magnitude: float64 and float32 absolute values, 16-bit ones in ulps
PLAIN_TOL = {"float64": 1e-10, "float32": 1e-5, "bfloat16": 2, "float16": 2}


def _rounded(a, dtype):
    """``a`` rounded to the torch ``dtype`` and back to float64 numpy."""
    return torch.tensor(np.asarray(a, dtype=np.float64)).to(dtype).double().numpy()


def _assert_at_magnitude(got, want, dt_name, what, terms=0.0):
    """``|got − want| <= tol·max(|want|, mean |want|) + 64·eps_acc·terms``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.abs(want[np.isfinite(want)]).mean())
    tol = PLAIN_TOL[dt_name]
    if dt_name in ("bfloat16", "float16"):
        tol = tol * float(torch.finfo(getattr(torch, dt_name)).eps)
    eps_acc = float(torch.finfo(torch.float64 if dt_name == "float64" else torch.float32).eps)
    bound = tol * scale + 64 * eps_acc * np.asarray(terms, np.float64)
    # a value past the dtype's range rounds to the same infinity on both sides
    finite = np.isfinite(want)
    assert np.array_equal(got[~finite], want[~finite]), f"{what}: overflows differ"
    excess = (np.abs(got - want) - bound)[finite].max(initial=0.0)
    assert np.all(np.isfinite(got[finite])) and excess <= 0, f"{what}: exceeds its bound by {excess}"


def _terms(lv, v, core):
    """The magnitude of the terms of ``v + X (core (Xᵀ v))`` per element."""
    X, K = np.abs(lv["X"]), np.abs(lv[core])
    return np.abs(v) + X @ (K @ (X.T @ np.abs(v)))


@pytest.mark.parametrize("d", [7, 33])
@pytest.mark.parametrize("m", [0, 40, 100])
@pytest.mark.parametrize("dt_name", DTYPES)
def test_plain_versions_match_jax_at_every_dtype_and_rank(dt_name, m, d):
    tdt = getattr(torch, dt_name)
    jacc = jnp.float64 if dt_name == "float64" else jnp.float32
    rng = np.random.default_rng(10 * d + m)
    Bn, N, P = 2, 5, 9
    comps, leaves = [], []
    for _ in range(Bn):
        mean = rng.standard_normal(d)
        A = rng.uniform(0.5, 2.0, d)
        B = rng.standard_normal((d, m)) / np.sqrt(d)
        Q = rng.standard_normal((m, m))
        D = Q @ Q.T / max(m, 1) + 0.1 * np.eye(m)
        cov = JWoodbury.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D))
        # what both sides read: the factor and the mean rounded to the dtype
        r = lambda a: _rounded(a, tdt)  # noqa: E731
        F = cov.factor
        parts = dict(a_half=r(F.a_half), X=r(F.X), C=r(F.C), Ci=r(F.Ci), log_det=r(F.log_det),
                     mean=r(mean))
        jcov = dataclasses.replace(cov, factor=dataclasses.replace(
            F, **{k: jnp.asarray(parts[k], jacc) for k in ("a_half", "X", "C", "Ci", "log_det")}))
        jcov = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jacc), jcov)
        comps.append(JMvNormal(jnp.asarray(parts["mean"], jacc), jcov))
        leaves.append(parts)
    u = _rounded(rng.standard_normal((Bn, d, N)), tdt)
    xs = _rounded(rng.standard_normal((d, P)), tdt)
    t = lambda key: torch.tensor(np.stack([p[key] for p in leaves])).to(tdt)  # noqa: E731
    a_half, X, C, Ci, mu, logdet = (t(k) for k in ("a_half", "X", "C", "Ci", "mean", "log_det"))

    x, logq = wk.sample_and_logq_torch(torch.tensor(u).to(tdt), a_half, X, C, mu, logdet)
    maha = wk.whiten_sumsq_torch(x, a_half, X, Ci, mu)
    shared = wk.whiten_sumsq_torch(torch.tensor(xs).to(tdt), a_half, X, Ci, mu)
    assert x.dtype == logq.dtype == maha.dtype == shared.dtype == tdt
    for b, (jd, lv) in enumerate(zip(comps, leaves)):
        ub = jnp.asarray(u[b], jacc)
        xj = jd.cov.unwhiten(ub) + jd.mean[:, None]
        logqj = -0.5 * (d * math.log(2 * math.pi) + jd.cov.logdet() + jnp.sum(ub * ub, axis=0))
        terms = np.abs(lv["a_half"])[:, None] * _terms(lv, u[b], "C") + np.abs(lv["mean"])[:, None]
        _assert_at_magnitude(x[b].double(), _rounded(xj, tdt), dt_name, "B1 x", terms)
        _assert_at_magnitude(logq[b].double(), _rounded(logqj, tdt), dt_name, "B1 logq")
        # B2 at the port's own draws, as read back in the dtype, and at a shared x
        for got, xv, what in ((maha[b], x[b].double().numpy(), "B2"),
                              (shared[b], xs, "B2 shared x")):
            logpdf = jd.logpdf(jnp.asarray(xv, jacc))
            mahaj = -2.0 * logpdf - d * math.log(2 * math.pi) - jd.cov.logdet()
            v = (xv - lv["mean"][:, None]) / lv["a_half"][:, None]
            W = _terms(lv, v, "Ci") + (np.abs(xv) + np.abs(lv["mean"])[:, None]) / lv["a_half"][:, None]
            w = np.abs(_rounded(jd.cov.whiten(jnp.asarray(xv, jacc) - jd.mean[:, None]), torch.float64))
            _assert_at_magnitude(got.double(), _rounded(mahaj, tdt), dt_name, what,
                                 np.sum((w + W) * W, axis=0))


class _Recorder:
    """Stands in for the libraries, the launchers and the card."""

    def __init__(self, monkeypatch):
        self.routes = []
        lib = type("Lib", (), {n: n for n in (
            "pf_sample_logq", "pf_whiten_sumsq", "pf_whiten_sumsq_shared", "pfg_sample_logq",
            "pfg_whiten_sumsq", "pfg_whiten_sumsq_shared")})()
        monkeypatch.setattr(wk, "load_library", lambda: lib)
        monkeypatch.setattr(wk, "load_general_library", lambda: lib)
        monkeypatch.setattr(wk, "_num_sms", lambda index: wk.NUM_SMS)
        monkeypatch.setattr(wk, "_launch", lambda name, entry, *a, **k: self.routes.append(entry))
        monkeypatch.setattr(wk, "_launch_general",
                            lambda name, entry, *a, **k: self.routes.append(entry))


@pytest.mark.parametrize("dt_name", DTYPES)
def test_the_route_is_the_fast_kernel_exactly_for_float32_up_to_max_rank(monkeypatch, dt_name):
    rec = _Recorder(monkeypatch)
    dtype = getattr(torch, dt_name)
    for m in (0, 12, wk.MAX_RANK, wk.MAX_RANK + 1, 40, 100):
        B, d, N = 2, 8, 3
        z = lambda *s: torch.zeros(s, dtype=dtype)  # noqa: E731
        args = (z(B, d, N), z(B, d) + 1, z(B, d, m), z(B, m, m), z(B, d))
        rec.routes.clear()
        wk._sample_and_logq_cuda(*args, z(B))
        wk._whiten_sumsq_cuda(*args)
        wk._whiten_sumsq_cuda(z(d, 7), *args[1:])
        fast = dtype == torch.float32 and m <= wk.MAX_RANK
        assert wk.uses_fast_kernel(dtype, m) == fast
        want = (["pf_sample_logq", "pf_whiten_sumsq", "pf_whiten_sumsq_shared"] if fast else
                ["pfg_sample_logq", "pfg_whiten_sumsq", "pfg_whiten_sumsq_shared"])
        assert rec.routes == want, (dt_name, m)


def test_the_kernels_refuse_mixed_and_unknown_dtypes(monkeypatch):
    _Recorder(monkeypatch)
    B, d, N, m = 2, 8, 3, 4
    f32, f64 = torch.float32, torch.float64
    args = [torch.zeros(B, d, N, dtype=f32), torch.ones(B, d, dtype=f32),
            torch.zeros(B, d, m, dtype=f64), torch.zeros(B, m, m, dtype=f32),
            torch.zeros(B, d, dtype=f32)]
    with pytest.raises(TypeError, match="expected torch.float32"):
        wk._whiten_sumsq_cuda(*args)
    args = [a.to(torch.int32) for a in args]
    with pytest.raises(TypeError, match="the kernels take"):
        wk._whiten_sumsq_cuda(*args)


def _source_general_layout(m, nt, rows, pk, threads, ws):
    """Evaluate ``GLayout`` of the general kernel's CUDA source."""
    src = wk._GENERAL_SOURCE.read_text()
    body = re.search(r"struct GLayout \{(.*?)\n\};", src, re.S).group(1)
    terms = re.findall(r"o \+= (.*?);", body)
    assert len(terms) == 9
    p = m * nt
    env = dict(m=m, nt=nt, rows=rows, pk=pk, threads=threads, ws=int(ws), p=p,
               g=threads // p if 0 < p < threads else 1)
    return sum(eval(t, {}, env) for t in terms)


@pytest.mark.parametrize("m", [0, 1, 12, 40, 258])
def test_general_layout_and_constants_mirror_the_cuda_source(m):
    for nt in (1, 4, 16):
        for rows, pk, ws in ((1, 1, False), (37, 5, False), (256, 12, True)):
            assert wk._general_layout(m, nt, rows, pk, 256, ws) == _source_general_layout(
                m, nt, rows, pk, 256, ws)
    src = wk._GENERAL_SOURCE.read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == wk._G_THREADS
    assert int(re.search(r"kMaxColTile = (\d+);", src).group(1)) == wk._G_MAX_COLS
    assert int(re.search(r"kMaxSmem = (\d+);", src).group(1)) == wk.SMEM_LIMIT
    codes = dict(re.findall(r"k(F32|F64|F16|BF16) = (\d)", src))
    names = {"F32": torch.float32, "F64": torch.float64, "F16": torch.float16,
             "BF16": torch.bfloat16}
    assert {names[k]: int(v) for k, v in codes.items()} == wk._DTYPE_CODES


@pytest.mark.parametrize("dt_name", DTYPES)
@pytest.mark.parametrize("m", [0, 12, 40, 100, 258, 2000, 12000])
def test_general_plan_keeps_to_the_card_at_any_rank(dt_name, m):
    dtype = getattr(torch, dt_name)
    acc = 8 if dtype == torch.float64 else 4
    for d in (1, 25, 999, 1000):
        for N in (1, 5, 10, 1000):
            threads, nt, rows, pk, smem, ws = wk._general_plan(d, m, N, dtype)
            assert threads == wk._G_THREADS and 1 <= nt <= wk._G_MAX_COLS and nt & (nt - 1) == 0
            assert nt <= max(1, 1 << (N - 1).bit_length())
            assert 1 <= rows <= min(d, wk._G_MAX_ROWS) and 1 <= pk <= max(m, 1)
            assert smem == acc * wk._general_layout(m, nt, rows, pk, threads, ws) <= wk.SMEM_LIMIT
            # the sums leave shared memory only where they could not fit at nt = 1
            assert ws == (acc * (3 * m + threads + pk * m + m + 4) > wk.SMEM_LIMIT and nt == 1)
    with pytest.raises(ValueError, match="does not fit"):
        wk._general_plan(10, 60000, 5, dtype)


def test_a_small_limit_moves_the_sums_to_the_workspace():
    plan = wk._general_plan(999, 1000, 5, torch.float32, smem_limit=16384)
    threads, nt, rows, pk, smem, ws = plan
    assert ws and nt == 1 and smem <= 16384 and rows >= 1
    assert wk._general_workspace(1000, 1) == 3 * 1000


def _jax_correlated(d):
    return jzoo.CorrelatedGaussian(d, seed=0), tzoo.CorrelatedGaussian(d, seed=0)


def test_pathfinder_at_rank_40_follows_jax():
    """history_length=20 (m = 40 > 32, the general kernel's case on the
    card) on CorrelatedGaussian(20) from the same start in float64: the same
    trajectory (1e-8) and, at every point, the same fitted normal (means
    1e-6, covariance diagonals 1e-6 relative)."""
    jt, tt = _jax_correlated(20)
    x0 = np.random.default_rng(3).uniform(-2.0, 2.0, 20)
    kw = dict(maxiters=40, history_length=20, ndraws=50, ndraws_elbo=20)
    jr = jpathfinder(jt, key=jax.random.key(0), init=jnp.asarray(x0), **kw)
    tr = pathfinder(tt, seed=0, init=x0, device="cpu", **kw)
    assert tr.success and bool(jr.success) and tr.draws.dtype == torch.float64
    n = int(tr.optim_trace.num_valid)
    assert n == int(jr.optim_trace.num_valid) > 20  # more points than the history holds
    np.testing.assert_allclose(tr.optim_trace.xs[:n].numpy(), np.asarray(jr.optim_trace.xs)[:n],
                               rtol=1e-8, atol=1e-8)
    tf, jf = tr.fit_distributions, jr.fit_distributions
    np.testing.assert_allclose(tf.mean[:n].numpy(), np.asarray(jf.mean)[:n], rtol=1e-6, atol=1e-6)
    jdiag = np.asarray(jax.vmap(lambda c: c.diag())(jf.cov))[:n]
    np.testing.assert_allclose(tf.cov.diag()[:n].numpy(), jdiag, rtol=1e-6)
    assert tuple(tr.draws.shape) == (20, 50) and torch.isfinite(tr.draws).all()


def test_multipathfinder_float64_agrees_with_jax():
    """dtype=float64 asked for explicitly with float32 starts (d=16, K=8,
    3 seeds): both packages cast the starts, walk the same trajectories
    (evaluation counts equal up to an ftol tie at the noise floor) and give
    k̂ and moment errors whose medians lie in the band of the JAX values."""
    jt, tt = jzoo.HierarchicalGaussian(16, seed=0), tzoo.HierarchicalGaussian(16, seed=0)
    mean_t, sd_t = tzoo.hierarchical_gaussian_truth(16, seed=0)
    jk, tk, jm, tm, equal = [], [], [], [], 0
    for s in range(3):
        init = np.random.default_rng(200 + s).uniform(-2.0, 2.0, (8, 16)).astype(np.float32)
        jr = jmultipathfinder(jt, 400, key=jax.random.key(s), init=jnp.asarray(init),
                              maxiters=64, elbo_chunk=8, dtype=jnp.float64)
        tr = multipathfinder(tt, 400, seed=s, init=init, maxiters=64, elbo_chunk=8,
                             dtype=torch.float64, device="cpu")
        assert tr.draws.dtype == torch.float64 and np.asarray(jr.draws).dtype == np.float64
        assert bool(tr.states.success.all()) and bool(np.all(np.asarray(jr.states.success)))
        equal += int((tr.states.num_fn_evals.numpy() == np.asarray(jr.states.num_fn_evals)).sum())
        jk.append(float(jr.psis_result.pareto_shape))
        tk.append(float(tr.psis_result.pareto_shape))
        jm.append(float(np.max(np.abs(np.asarray(jr.draws).mean(1) - mean_t) / sd_t)))
        tm.append(float(np.max(np.abs(tr.draws.numpy().mean(1) - mean_t) / sd_t)))
    assert equal >= 0.8 * 24
    for name, jv, tv in (("khat", jk, tk), ("moment error", jm, tm)):
        lo, hi = min(jv), max(jv)
        lo, hi = lo - (hi - lo) / 2, hi + (hi - lo) / 2
        assert lo <= float(np.median(tv)) <= hi, (name, jv, tv)


@pytest.mark.parametrize("dt_name", ["bfloat16", "float16"])
def test_low_precision_outcome_matches_jax(dt_name):
    """The same warning, and the same outcome: at bfloat16 the run ends with
    no path succeeding; float16 raises NotImplementedError in both."""
    target_j, target_t = jzoo.HierarchicalGaussian(16, seed=0), tzoo.HierarchicalGaussian(16, seed=0)
    kw = dict(nruns=8, maxiters=32, ntries=2)

    def outcome(run):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                res = run()
                out = int(np.asarray(res.states.success).sum())
            except Exception as e:  # the outcome is the exception's type
                out = type(e)
        return out, any("optimization state is almost always" in str(w.message) for w in caught)

    j = outcome(lambda: jmultipathfinder(target_j, 100, key=jax.random.key(0),
                                         dtype=getattr(jnp, dt_name), **kw))
    t = outcome(lambda: multipathfinder(target_t, 100, seed=0, dtype=getattr(torch, dt_name),
                                        device="cpu", **kw))
    assert t == j
    assert j[1] and (j[0] == 0 if dt_name == "bfloat16" else j[0] is NotImplementedError)


def test_lane_bytes_know_the_optimizer_and_the_denominator():
    base = dict(maxiters=64, history_length=6, ndraws_elbo=5, elbo_chunk=8, ndraws=5)
    for opt, copies in sharding.DENSE_COPIES.items():
        small = sharding.lane_bytes(1000, **base, optimizer=opt)
        large = sharding.lane_bytes(2000, **base, optimizer=opt)
        # the dense matrices set the peak, and grow with d²
        assert small >= copies * 4 * 1000**2 and large >= 4 * copies * 4 * 1000**2
        assert large - 4 * copies * 4 * 2000**2 < small  # the rest grows with d
        assert sharding.lane_bytes(1000, **base, dtype=torch.float64, optimizer=opt) > small
    lbfgs = sharding.lane_bytes(1000, **base)
    assert sharding.lane_bytes(1000, **base, optimizer="cg") == lbfgs
    assert sharding.lane_bytes(1000, **base, optimizer=lambda *a: None) == lbfgs
    assert sharding.lane_bytes(1000, **base, optimizer="bfgs") > 5 * lbfgs
    mix = sharding.lane_bytes(1000, **base, importance_denominator="mixture", nruns=32768)
    assert mix - lbfgs == sharding.MIXTURE_COPIES * 4 * 5 * 32768
    card = 80 * 10**9
    cap_l = sharding.plan_launches(32768, lbfgs, 0, card)[0]
    cap_b = sharding.plan_launches(32768, sharding.lane_bytes(1000, **base, optimizer="bfgs"),
                                   0, card)[0]
    assert cap_b < cap_l / 5


def test_laplace_blocks_come_from_their_own_estimate(monkeypatch):
    per = sharding.laplace_lane_bytes(1000, 10)
    assert per >= (sharding.HESSIAN_COPIES + 1) * 4 * 1000**2
    assert sharding.laplace_lane_bytes(1000, 10, method="full") > per
    assert sharding.laplace_lane_bytes(2000, 10) > 3.9 * per
    assert sharding.laplace_block(100, 1000, 10, torch.float32, "diag", "cpu") is None
    card = 80 * 10**9
    monkeypatch.setattr(sharding, "device_memory_bytes", lambda device: card)
    block = sharding.laplace_block(32768, 1000, 10, torch.float32, "diag", torch.device("cuda"))
    fit = int(sharding.LAUNCH_SHARE * card) // per
    assert block <= fit and -(-32768 // block) == -(-32768 // fit)
    # the run's cap for L-BFGS lanes would put far more Hessians on the card
    assert block < sharding.plan_launches(32768, sharding.lane_bytes(1000, 64, 6, 5, 8, 5), 0,
                                          card)[0] / 5
    assert sharding.laplace_block(100, 1000, 10, torch.float32, "diag", torch.device("cuda")) is None


@pytest.fixture(scope="module")
def small_run():
    return multipathfinder(tzoo.HierarchicalGaussian(16, seed=0), 200, seed=2, nruns=20,
                           maxiters=20, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("chunk", [1, 3, 7, 20])
def test_blocked_mixture_denominator_is_bitwise_the_unblocked_one(small_run, chunk):
    """Blocks of ``chunk`` paths' draws (the last one shorter where chunk
    does not divide K = 20), every component at each: each draw's logsumexp
    over the K components is unchanged by the blocking, bit for bit. Through
    PSIS the target's own log density is evaluated block by block too, and
    a batched matmul there may round the last bit otherwise at another
    batch size: the weights agree to 1e-12."""
    comps = small_run.fit_distribution.components
    dk = small_run.draws_per_component
    whole = _log_importance_ratios_mixture(comps, dk)
    blocks = torch.cat([_log_importance_ratios_mixture(comps, dk[lo:lo + chunk])
                        for lo in range(0, dk.shape[0], chunk)])
    assert torch.equal(blocks, whole)
    psis_whole = _compute_psis_result(small_run.logp, comps, dk, "mixture")
    psis_blocks = _compute_psis_result(small_run.logp, comps, dk, "mixture", chunk=chunk)
    torch.testing.assert_close(psis_blocks.log_weights, psis_whole.log_weights, rtol=1e-12, atol=1e-12)


def test_pathfinder_core_option_wraps_the_default_bitwise():
    target = tzoo.HierarchicalGaussian(8, seed=0)
    calls = []

    def core(*args):
        calls.append(args[5])
        return pathfinder_core(*args)

    kw = dict(seed=4, maxiters=30, ndraws=20, device="cpu", dtype=torch.float64)
    a, b = pathfinder(target, **kw), pathfinder(target, core=core, **kw)
    assert calls == [0] and a.num_tries == b.num_tries == 1
    for x, y in ((a.draws, b.draws), (a.fit_distribution.mean, b.fit_distribution.mean),
                 (a.elbo_values, b.elbo_values), (a.optim_trace.xs, b.optim_trace.xs)):
        assert torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))


def test_a_failing_core_drives_the_retry_loop_as_in_jax():
    """A core whose first try fails: both packages try again from a fresh
    start (round 1 of the streams; ``fold_in(key, 1)`` in JAX) and succeed
    on the second try."""
    from pathfinder_tpu.singlepath import pathfinder_core as jcore

    jcalls, tcalls = [], []

    def jflaky(key, x0, target, config):
        state = jcore(key, x0, target, config)
        jcalls.append(state)
        return state._replace(success=jnp.asarray(False)) if len(jcalls) == 1 else state

    def tflaky(target, x0s, config, seed, path_ids, round_idx):
        state = pathfinder_core(target, x0s, config, seed, path_ids, round_idx)
        tcalls.append(round_idx)
        if round_idx == 0:
            state = dataclasses.replace(state, success=torch.zeros_like(state.success))
        return state

    jt, tt = jzoo.HierarchicalGaussian(8, seed=0), tzoo.HierarchicalGaussian(8, seed=0)
    jr = jpathfinder(jt, key=jax.random.key(1), maxiters=30, core=jflaky)
    tr = pathfinder(tt, seed=1, maxiters=30, core=tflaky, device="cpu")
    assert (jr.num_tries, len(jcalls), bool(jr.success)) == (2, 2, True)
    assert (tr.num_tries, tcalls, tr.success) == (2, [0, 1], True)
    # the second try is round 1's: its start from round 1 of the init stream,
    # its noise from round 1 of the others
    x0 = uniform_init_sampler(2.0)(
        rng.Stream(1, torch.zeros(1, dtype=torch.int64), 1, rng.INIT), 8, torch.float32, "cpu")
    alone = pathfinder(tt, seed=1, maxiters=30, device="cpu", init=x0[0],
                       core=lambda t, x, c, s, p, r: pathfinder_core(t, x, c, s, p, 1))
    assert alone.num_tries == 1 and torch.equal(alone.draws, tr.draws)
    with pytest.warns(UserWarning, match="failed after 2 tries"):
        never = pathfinder(tt, seed=1, maxiters=30, ntries=2, device="cpu",
                           core=lambda *a: dataclasses.replace(
                               pathfinder_core(*a), success=torch.zeros(1, dtype=torch.bool)))
    assert never.num_tries == 2 and not never.success


def test_the_exports_of_ops_and_utils():
    import pathfinder_tpu.ops as jops
    import pathfinder_tpu.utils as jutils
    import pathfinder_tpu_torch.ops as tops
    import pathfinder_tpu_torch.utils as tutils
    from pathfinder_tpu_torch.ops.woodbury import WoodburyFactor, WoodburyPDMat, pdfactorize
    from pathfinder_tpu_torch.utils.misc import findmax_skipnan

    assert tops.__all__ == jops.__all__ and tutils.__all__ == jutils.__all__
    assert (tops.WoodburyFactor, tops.WoodburyPDMat, tops.pdfactorize) == (
        WoodburyFactor, WoodburyPDMat, pdfactorize)
    assert tutils.findmax_skipnan is findmax_skipnan
    doc = sharding.__doc__
    assert "no decision" not in doc and "ftol" in doc and "last bits" in doc

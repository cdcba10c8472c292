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
  per factor the fast kernel for float32 at rank ≤ ``MAX_RANK``, the
  general kernel for everything else, and B2 over a shared x the shared-x
  kernel at every dtype and rank; checked with the loaders and launchers
  replaced, no card needed. The shared-x kernel's layout mirror and plan are
  held against its source and the card's limits at any rank.
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
            "pf_sample_logq", "pf_whiten_sumsq", "pfg_sample_logq", "pfg_whiten_sumsq",
            "pfs_whiten_sumsq")})()
        monkeypatch.setattr(wk, "load_library", lambda: lib)
        monkeypatch.setattr(wk, "load_general_library", lambda: lib)
        monkeypatch.setattr(wk, "load_shared_library", lambda: lib)
        monkeypatch.setattr(wk, "_num_sms", lambda index: wk.NUM_SMS)
        monkeypatch.setattr(wk, "_launch", lambda name, entry, *a, **k: self.routes.append(entry))
        monkeypatch.setattr(wk, "_launch_general",
                            lambda name, entry, *a, **k: self.routes.append(entry))
        monkeypatch.setattr(wk, "_launch_shared", lambda entry, *a, **k: self.routes.append(entry))


@pytest.mark.parametrize("dt_name", DTYPES)
def test_the_route_is_the_fast_kernel_exactly_for_float32_up_to_max_rank(monkeypatch, dt_name):
    """Per factor the fast kernel takes float32 up to ``MAX_RANK`` and the
    general one the rest; over a shared x the shared-x kernel takes every
    dtype and rank."""
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
        want = (["pf_sample_logq", "pf_whiten_sumsq"] if fast else
                ["pfg_sample_logq", "pfg_whiten_sumsq"]) + ["pfs_whiten_sumsq"]
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


def _source_shared_layout(esz, asz, lo, W, F, R, m, kw, ws):
    """Evaluate ``SLayout`` of the shared-x kernel's CUDA source."""
    src = wk._SHARED_SOURCE.read_text()
    body = re.search(r"struct SLayout \{(.*?)\n\};", src, re.S).group(1)
    start = re.search(r"int o = 0;\n(.*)total = o;", body, re.S).group(1)
    terms = re.findall(r"o \+= (.*?);", start)
    assert len(terms) == 12

    def r16(n):
        return (n + 15) & ~15

    def run_bytes(n):
        return r16(n) + 16

    def x_stride(a, k):
        return k + 4 if a == 8 else (k + 8 if k % 16 == 0 else k)

    def x_col_bytes(e, rows):
        return run_bytes(rows * e) + (16 if e == 8 else 0)

    def kstep_split(w, rank):
        return 8 // w if rank > 0 and -(-rank // 8) <= wk._S_RANK_TILES else 1

    def ci_staged(e, f, rank):
        return int(rank > 0 and f * run_bytes(rank * rank * e) <= 32768)

    nc, mp, keep = 16 * W // F, 8 * -(-m // 8), int(m > 0)
    inner, one = keep * (1 - int(ws)), int(kw >= mp)
    env = dict(esz=esz, asz=asz, lo=lo, W=W, F=F, R=R, m=m, kw=kw, nc=nc, mp=mp, keep=keep,
               inner=inner, one=one, conv=keep * (1 - one), kColTile=16, kWarps=8,
               xrun=one * run_bytes(R * m * esz) + (1 - one) * R * run_bytes(kw * esz),
               r16=r16, run_bytes=run_bytes, x_stride=x_stride, x_col_bytes=x_col_bytes,
               kstep_split=kstep_split, ci_staged=ci_staged)
    return sum(eval(t, {}, env) for t in terms)


@pytest.mark.parametrize("dt_name", DTYPES)
@pytest.mark.parametrize("m", [0, 1, 7, 12, 32, 40, 100, 258])
def test_shared_layout_and_constants_mirror_the_cuda_source(dt_name, m):
    """``_shared_layout`` against ``SLayout`` of ``csrc/woodbury_shared.cu``
    for every shape, factor group, chunk and window the plans use, with and
    without the workspace; the constants and dtype codes against the
    source's."""
    dtype = getattr(torch, dt_name)
    esz, asz = torch.finfo(dtype).bits // 8, 8 if dtype == torch.float64 else 4
    lo = int(dtype != torch.float64)
    mp = 8 * -(-m // 8)
    for W in (1, 2, 4, 8):
        for F in (f for f in (1, 2, 4, 8) if f <= W):
            for R in ((128,) if m == 0 else (32, 64)):
                for kw in ((0,) if m == 0 else sorted({mp, max(8, mp - 8), 8})):
                    for ws in ((False,) if m == 0 else (False, True)):
                        assert wk._shared_layout(esz, asz, lo, W, F, R, m, kw, ws) == \
                            _source_shared_layout(esz, asz, lo, W, F, R, m, kw, ws)
    src = wk._SHARED_SOURCE.read_text()
    assert int(re.search(r"kThreads = (\d+);", src).group(1)) == wk._G_THREADS
    assert int(re.search(r"kColTile = (\d+);", src).group(1)) == wk._S_COL_TILE
    assert int(re.search(r"kRankTiles = (\d+);", src).group(1)) == wk._S_RANK_TILES
    assert int(re.search(r"kMaxSmem = (\d+);", src).group(1)) == wk.SMEM_LIMIT
    codes = dict(re.findall(r"k(F32|F64|F16|BF16) = (\d)", src))
    names = {"F32": torch.float32, "F64": torch.float64, "F16": torch.float16,
             "BF16": torch.bfloat16}
    assert {names[k]: int(v) for k, v in codes.items()} == wk._DTYPE_CODES


@pytest.mark.parametrize("dt_name", DTYPES)
@pytest.mark.parametrize("m", [0, 1, 7, 12, 32, 40, 100, 258, 2000, 12000])
def test_shared_shape_keeps_to_the_card_at_any_rank(dt_name, m):
    """At any rank the shared-x kernel has a shape: every rank staged at
    once where it fits, else X's ranks in windows (with t and s in the
    workspace where they do not fit either); its layout keeps to the card
    for the factor groups the plan may take, and the workspace slice holds
    t and s."""
    dtype = getattr(torch, dt_name)
    W, R, kw, ws, limit = wk._shared_shape(m, dtype)
    mp = 8 * -(-m // 8)
    assert W in (1, 2, 4, 8) and limit <= wk.SMEM_LIMIT
    assert R == 128 if m == 0 else R in (32, 64)
    if m == 0:
        assert kw == 0 and not ws
    else:
        assert 8 <= kw <= mp and (kw == mp or W == 1) and (not ws or kw < mp)
    plan = wk._shared_plan(7, 25, m, 77, dtype)
    assert plan.smem <= limit and (plan.W, plan.R, plan.kw, plan.ws) == (W, R, kw if m else 0, ws)
    assert wk._shared_workspace(W, m) == 16 * W * (2 * mp + 5)


def test_a_small_limit_moves_t_and_s_to_the_workspace():
    """Under a 64 KB limit rank 258 takes X's ranks in windows with t and s
    in shared memory, and rank 1000 puts t and s in the workspace too; the
    grid of a workspace plan is two CTAs an SM, a slice each."""
    win = wk._shared_plan(4, 999, 258, 77, torch.float32, smem_limit=65536)
    assert win.kw < 264 and not win.ws and win.smem <= 65536
    ws = wk._shared_plan(4, 999, 1000, 77, torch.float32, smem_limit=65536)
    assert ws.ws and ws.kw < 1000 and ws.smem <= 65536
    assert wk._shared_ctas(ws, 4, 77, wk.NUM_SMS) == min(4 * 5, 2 * wk.NUM_SMS)
    with pytest.raises(ValueError, match="does not fit"):
        wk._shared_shape(12, torch.float32, smem_limit=4096)


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

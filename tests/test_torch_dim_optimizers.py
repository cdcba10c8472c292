"""Every optimizer on the mesh's ``dim`` axis, and B2's row split, in the
port, held against the JAX package's ``dim`` mesh on its 8 virtual CPU
devices and against the port unsharded (float64):

* ``multipathfinder`` with ``optimizer`` ``"cg"``, ``"bfgs"``, ``"newton"``
  and a user callable (each package's own ``minimize_cg_trace``) on
  ``paths_dim_mesh(4, ·)`` at d=64, both packages from the same initial
  points: the success and fit iterations of JAX's mesh run and the port's
  are equal, and the port's draws lie within ``atol=1e-8`` of its unsharded
  run's;
* ``optimizer="auto"`` with and without ``auto_laplace`` (the escalation
  forced) on ``paths_dim_mesh(1, ·)`` of two entries, three seeds: the
  port's winner and k̂ are its unsharded run's (k̂ within 1e-8); against
  JAX's auto on its ``(1, 2)`` mesh the port's median k̂ lies in the band
  ``[min − r/2, max + r/2]`` of JAX's per-seed values, the tolerance
  ``test_torch_multipath.py`` holds the port to. The winner is not compared
  with JAX's: the two packages draw other random numbers, and at these sizes
  the candidates' k̂ differ by less than their Monte Carlo spread, so even
  the unsharded runs of the two packages pick different winners on some
  seeds;
* ``minimize_bfgs_trace`` under ``dim_map`` over 2, 4 and 8 members, H split
  by rows, against the unsharded trace: ``xs`` within 1e-10, counts equal;
* the plain B2 split (``whiten_sumsq_partial_torch`` / ``_resume_torch``)
  over 2, 4 and 8 row blocks against the unsplit ``whiten_sumsq_torch``, to
  1e-12;
* ``MvNormal.logpdf`` under ``dim_map`` (d=256, m=4) against JAX's on
  ``shard_dim``-placed inputs and against the port unsharded, to
  ``rtol=1e-12``, and ``WoodburyPDMat.invquad`` in the group agreeing with
  it.

A target whose BFGS trajectory is ill-conditioned (``HierarchicalGaussian``)
amplifies the rank-order rounding of the split sums as it amplifies any
rounding: there a perturbation of ``x0`` by one part in 10¹⁵ moves the
unsharded trace by up to 2e-5, and so does the split. The BFGS case uses a
correlated Gaussian, where the trace is well-conditioned.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.multipath import multipathfinder as jmultipathfinder
from pathfinder_tpu.models import StandardNormal as JStandardNormal
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops.cg import minimize_cg_trace as jminimize_cg_trace
from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodburyPDMat
from pathfinder_tpu.parallel.dim_sharding import dim_mesh as jdim_mesh, shard_dim as jshard_dim
from pathfinder_tpu.parallel.sharding import paths_dim_mesh as jpaths_dim_mesh
from pathfinder_tpu_torch import laplace_resample, multipathfinder, paths_dim_mesh
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.ops.bfgs import minimize_bfgs_trace
from pathfinder_tpu_torch.ops.cg import minimize_cg_trace
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.parallel.dim_sharding import dim_map, dim_mesh, shard_dim

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bad-k̂ hint, not under test here
        return fn(*args, **kwargs)


OPTIMIZERS = {"cg": ("cg", "cg"), "bfgs": ("bfgs", "bfgs"), "newton": ("newton", "newton"),
              "callable": (jminimize_cg_trace, minimize_cg_trace)}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_each_optimizer_on_the_paths_dim_mesh(name):
    jopt, topt = OPTIMIZERS[name]
    d, K = 64, 4
    init = np.random.default_rng(7).uniform(-2.0, 2.0, (K, d))
    jres = jmultipathfinder(JStandardNormal(d), key=jax.random.key(3), ndraws=64, nruns=K,
                            maxiters=10, ndraws_elbo=8, init=jnp.asarray(init), optimizer=jopt,
                            mesh=jpaths_dim_mesh(4, jax.devices()[:8]))
    kw = dict(seed=3, maxiters=10, ndraws_elbo=8, init=init, optimizer=topt, device="cpu",
              dtype=torch.float64)
    target = tzoo.StandardNormal(d)
    ref = multipathfinder(target, 64, **kw)
    got = multipathfinder(target, 64, mesh=paths_dim_mesh(4, ["cpu"] * 8), **kw)
    for res in (got, ref):
        np.testing.assert_array_equal(res.states.success.numpy(), np.asarray(jres.states.success))
        np.testing.assert_array_equal(res.states.fit_iteration.numpy(),
                                      np.asarray(jres.states.fit_iteration))
    np.testing.assert_array_equal(got.states.num_fn_evals.numpy(), ref.states.num_fn_evals.numpy())
    np.testing.assert_allclose(got.draws.numpy(), ref.draws.numpy(), atol=1e-8)


AUTO_SEEDS = (0, 1, 2)


@pytest.mark.parametrize("laplace", [False, True])
def test_auto_on_the_paths_dim_mesh(laplace):
    target = tzoo.HierarchicalGaussian(16, seed=0)
    opts = dict(auto_laplace=True, auto_khat_early_exit=-1.0) if laplace else {}
    kw = dict(nruns=8, maxiters=40, optimizer="auto", **opts)
    khats = []
    for seed in AUTO_SEEDS:
        ref = _quiet(multipathfinder, target, 100, seed=seed, device="cpu", dtype=torch.float64,
                     **kw)
        got = _quiet(multipathfinder, target, 100, seed=seed, device="cpu", dtype=torch.float64,
                     mesh=paths_dim_mesh(1, ["cpu"] * 2), **kw)
        assert got.config.optimizer == ref.config.optimizer
        k_got, k_ref = float(got.psis_result.pareto_shape), float(ref.psis_result.pareto_shape)
        assert abs(k_got - k_ref) <= 1e-8
        khats.append(k_got)
        if laplace:  # the correction itself, on the mesh result's gathered states
            lap_got, lap_ref = laplace_resample(got, 100), laplace_resample(ref, 100)
            assert abs(float(lap_got.psis_result.pareto_shape)
                       - float(lap_ref.psis_result.pareto_shape)) <= 1e-8
            np.testing.assert_allclose(lap_got.draws.numpy(), lap_ref.draws.numpy(), atol=1e-8)
    if laplace:
        return
    jt = jzoo.HierarchicalGaussian(16, seed=0)
    jk = [float(_quiet(jmultipathfinder, jt, key=jax.random.key(seed), ndraws=100,
                       mesh=jpaths_dim_mesh(1, jax.devices()[:2]), **kw).psis_result.pareto_shape)
          for seed in AUTO_SEEDS]
    lo, hi = min(jk) - (max(jk) - min(jk)) / 2, max(jk) + (max(jk) - min(jk)) / 2
    assert lo <= float(np.median(khats)) <= hi, (khats, jk)


@pytest.mark.parametrize("members", [2, 4, 8])
def test_bfgs_row_by_row(members):
    """BFGS with H split by rows (``(K, d/w, d)`` a member) against the
    unsharded trace; each member holds only its rows of H."""
    d = 64
    target = tzoo.CorrelatedGaussian(d)
    x0 = torch.tensor(np.random.default_rng(0).uniform(-2, 2, (4, d)))
    ref = minimize_bfgs_trace(target.value_and_grad, x0, maxiters=30)
    mesh = dim_mesh(["cpu"] * members)

    def run(tg, x):
        tr = minimize_bfgs_trace(tg.value_and_grad, x.T.contiguous(), maxiters=30)
        return (tr.xs.permute(2, 0, 1).contiguous(), tr.num_valid, tr.num_fn_evals,
                tr.num_bfgs_updates_rejected)

    xs, *counts = dim_map(run, mesh, out_split=(True, False, False, False))(
        target, shard_dim((x0.T.contiguous(),), mesh, dim=d)[0])
    np.testing.assert_allclose(xs.gather().permute(1, 2, 0).numpy(), ref.xs.numpy(), atol=1e-10)
    for got, want in zip(counts, (ref.num_valid, ref.num_fn_evals,
                                  ref.num_bfgs_updates_rejected)):
        assert torch.equal(got.gather(), want)
    assert int(ref.num_valid.min()) > 10  # a trajectory of many BFGS updates


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_plain_b2_split_matches_unsplit(blocks):
    rng_ = np.random.default_rng(blocks)
    Bn, d, m, N = 3, 96, 12, 10
    x = _t(rng_.standard_normal((Bn, d, N)))
    a_half = _t(rng_.uniform(0.5, 1.5, (Bn, d)))
    X = _t(rng_.standard_normal((Bn, d, m)) / np.sqrt(d))
    Ci = _t(0.1 * rng_.standard_normal((Bn, m, m)))
    mu = _t(rng_.standard_normal((Bn, d)))
    ref = wk.whiten_sumsq_torch(x, a_half, X, Ci, mu)
    r = d // blocks
    cut = [slice(j * r, (j + 1) * r) for j in range(blocks)]
    ts = [wk.whiten_sumsq_partial(x[:, c], a_half[:, c], X[:, c], mu[:, c], d) for c in cut]
    t = ts[0]
    for p in ts[1:]:  # in rank order, as the row group sums them
        t = t + p
    assert t.shape == (Bn, m, N)
    qs = [wk.whiten_sumsq_resume(x[:, c], a_half[:, c], X[:, c], Ci, mu[:, c], t, d) for c in cut]
    q = qs[0]
    for p in qs[1:]:
        q = q + p
    np.testing.assert_allclose(q.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    # 16-bit inputs: the partial sums in float32
    h = [a.to(torch.bfloat16) for a in (x, a_half, X, Ci, mu)]
    t16 = wk.whiten_sumsq_partial(h[0], h[1], h[2], h[4], d)
    assert t16.dtype == torch.float32
    assert wk.whiten_sumsq_resume(*h, t16, d).dtype == torch.float32


def test_logpdf_in_a_row_group():
    rng_ = np.random.default_rng(3)
    d, m, N = 256, 4, 32
    A = rng_.uniform(0.5, 2.0, d)
    B = rng_.standard_normal((d, m)) / np.sqrt(d)
    D = np.eye(m)
    mu = rng_.standard_normal(d)
    x = rng_.standard_normal((d, N))

    @jax.jit
    def jlogpdf(A, B, D, mu, x):
        return JMvNormal(mu, JWoodburyPDMat.from_parts(A, B, D)).logpdf(x)

    with jdim_mesh(jax.devices()[:8]) as jmesh:
        A_j, B_j, mu_j, x_j = jshard_dim(tuple(jnp.asarray(a) for a in (A, B, mu, x)), jmesh,
                                         dim=d)
        jout = np.asarray(jlogpdf(A_j, B_j, jnp.asarray(D), mu_j, x_j))

    def logpdf(A, B, D, mu, x):
        W = WoodburyPDMat.from_parts(A, B, D)
        return MvNormal(mu, W).logpdf(x), W.invquad(x - mu[:, None]), W.logdet()

    mesh = dim_mesh(["cpu"] * 8)
    placed = shard_dim((_t(A), _t(B), _t(mu), _t(x)), mesh, dim=d)
    lp, maha, logdet = (o.gather() for o in dim_map(logpdf, mesh, out_split=(False,) * 3)(
        *placed[:2], _t(D), *placed[2:]))
    ref = logpdf(_t(A), _t(B), _t(D), _t(mu), _t(x))[0]
    np.testing.assert_allclose(lp.numpy(), jout, rtol=1e-12)
    np.testing.assert_allclose(lp.numpy(), ref.numpy(), rtol=1e-12)
    # invquad in the group: the same Mahalanobis terms
    np.testing.assert_allclose((-0.5 * (d * np.log(2 * np.pi) + logdet + maha)).numpy(),
                               lp.numpy(), rtol=1e-12)


def test_hessians_from_many_threads():
    """``batched_hessian`` from more threads than cores at once, as a mesh's
    Newton members and blocks call it: torch's forward-mode levels are global
    to the process, and two forward passes at once invalidated each other's
    ("Trying to access a forward AD level ..."). Every thread gets the
    Hessian of one thread alone."""
    import sys
    import threading

    from pathfinder_tpu_torch.models.protocol import batched_hessian

    target = tzoo.CorrelatedGaussian(6)
    hess = batched_hessian(target.logp)
    x = torch.tensor(np.random.default_rng(1).standard_normal((3, 6)))
    want = hess(x)
    results, errors = [], []

    def work():
        try:
            for _ in range(5):
                results.append(torch.equal(hess(x), want))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors and len(results) == 80 and all(results)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m", [(torch.float32, 12), (torch.float64, 12),
                                     (torch.float32, 40), (torch.float32, 0)])
def test_b2_split_kernels_on_the_card(dtype, m):
    """B2's partial and resume on the card (fast kernel at float32 m <= 32,
    the general one otherwise) against their plain versions, in 2 row blocks
    at the PSIS shape, and a repeat bitwise equal. ``chip_smoke.py`` makes
    the same check on a machine with the card alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng_ = np.random.default_rng(m)
    Bn, d, N = 100, 1000, 10
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    x, a_half = t(rng_.standard_normal((Bn, d, N))), t(rng_.uniform(0.5, 1.5, (Bn, d)))
    X, Ci = t(rng_.standard_normal((Bn, d, m)) / np.sqrt(d)), t(0.1 * rng_.standard_normal((Bn, m, m)))
    mu = t(rng_.standard_normal((Bn, d)))
    blocks = [slice(0, d // 2), slice(d // 2, d)]

    def split(kernel):
        part = wk.whiten_sumsq_partial if kernel else (
            lambda x_, a_, X_, mu_, _: wk.whiten_sumsq_partial_torch(x_, a_, X_, mu_))
        res = wk.whiten_sumsq_resume if kernel else (
            lambda x_, a_, X_, C_, mu_, t_, _: wk.whiten_sumsq_resume_torch(x_, a_, X_, C_, mu_,
                                                                             t_))
        args = [(x[:, c].contiguous(), a_half[:, c].contiguous(), X[:, c].contiguous(),
                 mu[:, c].contiguous()) for c in blocks]
        tt = part(*args[0], d) + part(*args[1], d)
        return res(*args[0][:3], Ci, args[0][3], tt, d) + res(*args[1][:3], Ci, args[1][3], tt, d)

    got, want = split(True), split(False)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(split(True), got)


@pytest.mark.slow
def test_auto_laplace_at_the_headline_width_on_the_dim_mesh():
    """``optimizer="auto", auto_laplace=True`` at d=1000 on a ``(1, 2)``
    mesh: the unsharded run's winner and k̂ (within 1e-8)."""
    target = tzoo.HierarchicalGaussian(1000, seed=0)
    kw = dict(nruns=8, maxiters=64, elbo_chunk=8, seed=0, device="cpu", dtype=torch.float64,
              optimizer="auto", auto_laplace=True)
    ref = _quiet(multipathfinder, target, 200, **kw)
    got = _quiet(multipathfinder, target, 200, mesh=paths_dim_mesh(1, ["cpu"] * 2), **kw)
    assert got.config.optimizer == ref.config.optimizer
    assert abs(float(got.psis_result.pareto_shape) - float(ref.psis_result.pareto_shape)) <= 1e-8

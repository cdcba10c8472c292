"""The mixture and dense covariances on the mesh's ``dim`` axis, in the port,
held against the JAX package's ``dim`` mesh on its 8 virtual CPU devices and
against the port unsharded (float64):

* the plain B2 split over an ``x`` shared by every factor
  (``whiten_sumsq_partial_torch`` / ``_resume_torch`` with a 2-D ``x``) over
  2, 4 and 8 row blocks, at ranks 0 and 4, against the unsplit
  ``whiten_sumsq_torch``, to 1e-12;
* ``UniformMixture.logpdf`` and the shared-x ``MvNormal.logpdf`` of batched
  normals under ``dim_map`` on 8 members (d=256, K=6, m=4, P=32), against
  JAX's on ``shard_dim``-placed inputs and the port unsharded, to
  ``rtol=1e-12``;
* a dense ``A`` split by rows (d=512, m=8): ``logdet``, ``solve``,
  ``unwhiten``, ``invquad``, and ``MvNormal.logpdf`` and ``rand_and_logpdf``
  with JAX's noise injected, against JAX's ``shard_dim`` run and the port
  unsharded, to ``rtol=1e-10``; the other ``WoodburyPDMat`` operations of a
  dense ``A`` in a group against the port unsharded;
* the row group's view of a Woodbury matrix and of a mixture, against the
  port unsharded: ``WoodburyPDMat.dim`` and ``UniformMixture.dim`` are the
  full d, ``to_dense`` gives the member's rows of every column, ``entry``
  takes indices of the full matrix from two members' blocks, and
  ``UniformMixture.sample`` gives the unsharded draws (1e-12) and ids.

On the card (``cuda``, skipped without one): the shared-x kernel's split
parts against their plain versions at the mixture shape.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
from pathfinder_tpu.ops.mvnormal import UniformMixture as JUniformMixture
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodburyPDMat
from pathfinder_tpu.parallel.dim_sharding import dim_mesh as jdim_mesh, shard_dim as jshard_dim
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.parallel.dim_sharding import dim_map, dim_mesh, shard_dim
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8
    return jdim_mesh(jax.devices()[:8])


@pytest.mark.parametrize("m", [0, 4])
@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_plain_shared_x_split_matches_unsplit(blocks, m):
    rng_ = np.random.default_rng(10 * blocks + m)
    Bn, d, P = 5, 96, 11
    x = _t(rng_.standard_normal((d, P)))
    a_half = _t(rng_.uniform(0.5, 1.5, (Bn, d)))
    X = _t(rng_.standard_normal((Bn, d, m)) / np.sqrt(d))
    Ci = _t(0.1 * rng_.standard_normal((Bn, m, m)))
    mu = _t(rng_.standard_normal((Bn, d)))
    ref = wk.whiten_sumsq_torch(x, a_half, X, Ci, mu)
    r = d // blocks
    cut = [slice(j * r, (j + 1) * r) for j in range(blocks)]
    ts = [wk.whiten_sumsq_partial(x[c], a_half[:, c], X[:, c], mu[:, c], d) for c in cut]
    t = ts[0]
    for p in ts[1:]:  # in rank order, as the row group sums them
        t = t + p
    assert t.shape == (Bn, m, P)
    qs = [wk.whiten_sumsq_resume(x[c], a_half[:, c], X[:, c], Ci, mu[:, c], t, d) for c in cut]
    q = qs[0]
    for p in qs[1:]:
        q = q + p
    assert q.shape == (Bn, P)
    np.testing.assert_allclose(q.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def _mixture_leaves(rng_, d, K, m, P):
    """A mixture's leaves with d leading, as ``shard_dim`` splits them: A (d,
    K), B (d, K, m), D (K, m, m), mean (d, K), and the pooled draws x (d, P)."""
    A = rng_.uniform(0.5, 2.0, (d, K))
    B = rng_.standard_normal((d, K, m)) / np.sqrt(d)
    D = np.broadcast_to(np.eye(m), (K, m, m)) * rng_.uniform(0.5, 1.5, (K, 1, 1))
    mean = rng_.standard_normal((d, K))
    x = 1.5 * rng_.standard_normal((d, P))
    return A, B, D, mean, x


def test_mixture_logpdf_in_a_row_group(jmesh):
    d, K, m, P = 256, 6, 4, 32
    leaves = _mixture_leaves(np.random.default_rng(7), d, K, m, P)

    @jax.jit
    def jlogpdf(A, B, D, mean, x):
        cov = jax.vmap(JWoodburyPDMat.from_parts)(A.T, jnp.swapaxes(B, 0, 1), D)
        comps = JMvNormal(mean.T, cov)
        return (JUniformMixture(comps).logpdf(x),
                jax.vmap(lambda c: c.logpdf(x))(comps))

    with jmesh:
        placed_j = jshard_dim(tuple(jnp.asarray(a) for a in leaves[:3]), jmesh, dim=d)
        mean_j, x_j = jshard_dim((jnp.asarray(leaves[3]), jnp.asarray(leaves[4])), jmesh, dim=d)
        jmix, jcomp = (np.asarray(a) for a in jlogpdf(*placed_j, mean_j, x_j))

    def logpdf(A, B, D, mean, x):
        comps = MvNormal(mean.mT.contiguous(), WoodburyPDMat.from_parts(A.mT, B.transpose(0, 1), D))
        return UniformMixture(comps).logpdf(x), comps.logpdf(x)

    mesh = dim_mesh(["cpu"] * 8)
    args = tuple(_t(a) for a in leaves)
    placed = shard_dim(args, mesh, dim=d)
    mix, comp = (o.gather() for o in dim_map(logpdf, mesh, out_split=(False, False))(*placed))
    ref_mix, ref_comp = logpdf(*args)
    assert mix.shape == (P,) and comp.shape == (K, P)
    for got, want, jwant in ((mix, ref_mix, jmix), (comp, ref_comp, jcomp)):
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-12)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def _dense_case(rng_, d, m, N):
    """A dense SPD A (d, d), exactly symmetric, B (d, m), D, mean, x and the
    noise u (d, N)."""
    G = rng_.standard_normal((d, d)) / np.sqrt(d)
    A = 0.5 * np.eye(d) + G @ G.T
    A = (A + A.T) / 2
    B = rng_.standard_normal((d, m)) / np.sqrt(d)
    D = np.eye(m) * 0.5
    mean = rng_.standard_normal(d)
    x = rng_.standard_normal((d, N))
    return A, B, D, mean, x


def test_dense_covariance_in_a_row_group(jmesh):
    d, m, N = 512, 8, 16
    A, B, D, mean, x = _dense_case(np.random.default_rng(11), d, m, N)
    key = jax.random.key(3)

    @jax.jit
    def jcompute(A, B, D, mean, x, key):
        W = JWoodburyPDMat.from_parts(A, B, D)
        normal = JMvNormal(mean, W)
        draws, logq = normal.rand_and_logpdf(key, N)
        return W.logdet(), W.solve(x), W.unwhiten(x), W.invquad(x), normal.logpdf(x), draws, logq

    with jmesh:
        A_j, B_j, mean_j, x_j = jshard_dim(tuple(jnp.asarray(a) for a in (A, B, mean, x)), jmesh,
                                           dim=d)
        jout = jcompute(A_j, B_j, jnp.asarray(D), mean_j, x_j, key)
    u = np.asarray(jax.random.normal(key, (d, N), dtype=jnp.float64))  # JAX's noise for the key

    def compute(A, B, D, mean, x, u):
        W = WoodburyPDMat.from_parts(A, B, D)
        normal = MvNormal(mean, W)
        draws, logq = normal.rand_and_logpdf(u=u)
        return W.logdet(), W.solve(x), W.unwhiten(x), W.invquad(x), normal.logpdf(x), draws, logq

    mesh = dim_mesh(["cpu"] * 8)
    args = tuple(_t(a) for a in (A, B, D, mean, x, u))
    placed = shard_dim(args, mesh, dim=d)
    split = (False, True, True, False, False, True, False)
    out = dim_map(compute, mesh, out_split=split)(*placed[:2], args[2], *placed[3:])
    ref = compute(*args)
    for o, r, j in zip(out, ref, jout):
        np.testing.assert_allclose(o.gather().numpy(), np.asarray(j), rtol=1e-10)
        np.testing.assert_allclose(o.gather().numpy(), r.numpy(), rtol=1e-10)
    # the solve comes back in row blocks, one a member
    assert out[1].split and all(b.shape == (d // 8, N) for b in out[1].blocks)


def test_dense_covariance_operations_in_a_row_group():
    """The rest of a dense ``A``'s ``WoodburyPDMat`` in a group (d=64 on 4
    members), against the port unsharded, to ``rtol=1e-10``: its rows of
    ``W x``, ``inv``, ``add_scaled_identity``, ``add``, ``to_dense``,
    ``diag``, ``whiten`` and ``inv_unwhiten``, and ``quad``, ``entry`` and
    the log determinants of the derived matrices."""
    d, m, N = 64, 4, 5
    A, B, D, mean, x = _dense_case(np.random.default_rng(12), d, m, N)

    def compute(A, B, D, x):
        W = WoodburyPDMat.from_parts(A, B, D)
        Wi, W2 = W.inv(), W.add_scaled_identity(0.25)
        return (W.mul(x), Wi.solve(x), W2.solve(x), (W + W).mul(x), W.to_dense(), W.diag(),
                W.whiten(x), W.inv_unwhiten(x), W.quad(x), W.entry(3, 40),
                torch.stack([Wi.logdet(), W2.logdet(), W.scale(2.0).logdet()]))

    mesh = dim_mesh(["cpu"] * 4)
    args = tuple(_t(a) for a in (A, B, D, x))
    placed = shard_dim(args, mesh, dim=d)
    split = (True,) * 8 + (False,) * 3
    out = dim_map(compute, mesh, out_split=split)(*placed[:2], args[2], placed[3])
    ref = compute(*args)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.gather().numpy(), r.numpy(), rtol=1e-10, atol=1e-13)


REPAIRS = ("woodbury dim", "to_dense rows", "entry across members", "mixture dim",
           "mixture sample")


@pytest.mark.parametrize("case", REPAIRS)
def test_a_row_group_sees_the_whole_matrix(case):
    """What a member sees of a Woodbury matrix and of a mixture (d=16, m=2, K=3
    normals on 2 members) is what the unsharded port gives: the full d, its
    rows of every column of the dense matrix, an entry whose row and column
    lie in different members' blocks, and the mixture's draws and ids."""
    d, K, m, ndraws = 16, 3, 2, 5
    A, B, D, mean, _ = _mixture_leaves(np.random.default_rng(13), d, K, m, 1)
    stream = rng.Stream(2, 4, 0, rng.RESAMPLE_FRESH)

    def mixture(A, B, D, mean):
        return UniformMixture(MvNormal(mean.mT.contiguous(),
                                       WoodburyPDMat.from_parts(A.mT, B.transpose(0, 1), D)))

    def observe(A, B, D, mean):
        mix = mixture(A, B, D, mean)
        W = mix.components.cov
        if case == "woodbury dim":
            return torch.tensor(W.dim)
        if case == "to_dense rows":
            return W.to_dense().transpose(0, 1)  # (d rows, K, d)
        if case == "entry across members":
            return W.entry(3, 12)
        if case == "mixture dim":
            return torch.tensor(mix.dim)
        return mix.sample(stream, ndraws)

    mesh = dim_mesh(["cpu"] * 2)
    args = tuple(_t(a) for a in (A, B, D, mean))
    split = {"to_dense rows": True, "mixture sample": (True, False)}.get(case, False)
    got = dim_map(observe, mesh, out_split=split)(*shard_dim(args, mesh, dim=d))
    want = observe(*args)
    if case == "mixture sample":
        np.testing.assert_allclose(got[0].gather().numpy(), want[0].numpy(), rtol=1e-12,
                                   atol=1e-12)
        assert torch.equal(got[1].gather(), want[1])
        return
    if case in ("woodbury dim", "mixture dim"):
        assert int(want) == d
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m", [(torch.float32, 12), (torch.float64, 12),
                                     (torch.float32, 40), (torch.float32, 0)])
def test_shared_x_split_kernels_on_the_card(dtype, m):
    """The shared-x kernel's partial and resume on the card against their
    plain versions, in 2 row blocks at the mixture shape, and a repeat
    bitwise equal. ``chip_smoke.py`` makes the same check on a machine with
    the card alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng_ = np.random.default_rng(m)
    Bn, d, P = 100, 1000, 1000
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    x, a_half = t(rng_.standard_normal((P, d))).mT, t(rng_.uniform(0.5, 1.5, (Bn, d)))
    X, Ci = t(rng_.standard_normal((Bn, d, m)) / np.sqrt(d)), t(0.1 * rng_.standard_normal((Bn, m, m)))
    mu = t(rng_.standard_normal((Bn, d)))
    blocks = [slice(0, d // 2), slice(d // 2, d)]

    def split(kernel):
        part = wk.whiten_sumsq_partial if kernel else (
            lambda x_, a_, X_, mu_, _: wk.whiten_sumsq_partial_torch(x_, a_, X_, mu_))
        res = wk.whiten_sumsq_resume if kernel else (
            lambda x_, a_, X_, C_, mu_, t_, _: wk.whiten_sumsq_resume_torch(x_, a_, X_, C_, mu_,
                                                                             t_))
        args = [(x[c], a_half[:, c].contiguous(), X[:, c].contiguous(), mu[:, c].contiguous())
                for c in blocks]
        tt = part(*args[0], d) + part(*args[1], d)
        return res(*args[0][:3], Ci, args[0][3], tt, d) + res(*args[1][:3], Ci, args[1][3], tt, d)

    got, want = split(True), split(False)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(split(True), got)


@pytest.mark.parametrize("m", [0, 4])
def test_the_shared_x_split_wrappers_hand_their_entries_the_plan(monkeypatch, m):
    """``whiten_sumsq_partial``/``_resume`` on the card with a 2-D ``x`` route
    to the shared-x kernel's split entries, each with ``x`` in the ``(P, d_r)``
    layout, the plan of ``d_r`` rows and its grid, ``t`` written and read in
    the ``(B, P, m)`` layout, and count their launches under their own names;
    the partial at rank 0 launches nothing. (The entries are stand-ins: the
    wrapper's side, on the CPU.)"""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(wk, "_num_sms", lambda index: wk.NUM_SMS)
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = types.SimpleNamespace(pfs_whiten_sumsq_partial=entry("partial"),
                                pfs_whiten_sumsq_resume=entry("resume"))
    monkeypatch.setattr(wk, "load_shared_library", lambda: lib)
    Bn, d_r, P, dtype = 3, 40, 5, torch.float64
    x = torch.zeros(d_r, P, dtype=dtype)  # a member's contiguous rows: transposed once
    a_half, mu = torch.ones(Bn, d_r, dtype=dtype), torch.zeros(Bn, d_r, dtype=dtype)
    X, Ci = torch.zeros(Bn, d_r, m, dtype=dtype), torch.zeros(Bn, m, m, dtype=dtype)
    wk.reset_launch_counts()
    t = wk._whiten_sumsq_partial_cuda(x, a_half, X, mu, 2 * d_r)
    assert t.shape == (Bn, m, P) and t.mT.is_contiguous()
    sums = wk._whiten_sumsq_resume_cuda(x, a_half, X, Ci, mu, t, 2 * d_r)
    assert sums.shape == (Bn, P) and sums.dtype == torch.float64
    plan = wk._shared_plan(Bn, d_r, m, P, dtype)
    grid = (Bn, d_r, m, P, plan.W, plan.F, plan.R, plan.kw, int(plan.ws), plan.smem,
            wk._shared_ctas(plan, Bn, P, wk.NUM_SMS), None, 0)
    assert [name for name, _ in calls] == (["resume"] if m == 0 else ["partial", "resume"])
    for name, args in calls:
        pointers = args[1:-len(grid)]
        assert args[0] == wk._DTYPE_CODES[dtype] and args[-len(grid):] == grid
        assert len(pointers) == (5 if name == "partial" else 7)
    counts = wk.launch_counts()
    assert counts["whiten_sumsq_shared_partial"] == (0 if m == 0 else 1)
    assert counts["whiten_sumsq_shared_resume"] == 1 and counts["whiten_sumsq_shared"] == 0
    wk.reset_launch_counts()

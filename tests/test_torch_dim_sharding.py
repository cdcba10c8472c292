"""The mesh's ``dim`` axis in the port (``parallel/dim_sharding.py``,
``paths_dim_mesh``, ``utils/rows.py``), held against the JAX package's
``dim_mesh`` on its 8 virtual CPU devices and against the port unsharded.

One case per test of ``tests/test_dim_sharding.py``:

* Woodbury operations (d=512, m=8) on ``shard_dim``-placed inputs agree with
  JAX's sharded results and the port's unsharded ones to ``rtol=1e-10``,
  and the solve comes back in row blocks;
* ``MvNormal.rand_and_logpdf`` (d=256, m=4) with JAX's noise injected
  agrees with JAX's sharded draws to ``1e-12``; drawn from a stream, each
  member takes its rows of the unsplit noise (against the unsharded run,
  ``1e-12``);
* ``pathfinder_core`` on ``StandardNormal(256)`` with its rows over 8
  members has the unsharded run's success and fit iteration, mean and draws
  within ``atol=1e-10``;
* ``shard_dim``'s rules;
* ``multipathfinder`` on ``paths_dim_mesh(4, ["cpu"] * 8)`` at d=64, with
  both denominators, has the unsharded run's success and fit iterations,
  draws within ``atol=1e-8``; d=63 raises naming the ``'dim' mesh axis``.

And the contract of the port's own design: a ``dim`` width of 1 is bitwise
the ``paths`` mesh run; a repeat is bitwise equal; the plain B1 partial and
resume over 2, 4 and 8 row blocks agree with the unsplit plain B1 to
``1e-12``; what is not ported on the axis (an ``x`` shared by batched
normals, a dense covariance) raises ``NotImplementedError``;
an exception in one member's thread reaches the caller, and a member that
does not come breaks its peers' barrier at the timeout instead of hanging
them.
"""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import StandardNormal as JStandardNormal
from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodburyPDMat
from pathfinder_tpu.parallel.dim_sharding import dim_mesh as jdim_mesh, shard_dim as jshard_dim
from pathfinder_tpu_torch import multipathfinder, paths_dim_mesh, paths_mesh
from pathfinder_tpu_torch import singlepath as tsinglepath
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.parallel import dim_sharding
from pathfinder_tpu_torch.parallel.dim_sharding import dim_map, dim_mesh, shard_dim
from pathfinder_tpu_torch.parallel.sharding import make_path_executor
from pathfinder_tpu_torch.utils import rng, rows

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8
    return jdim_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def mesh():
    return dim_mesh(CPU8)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_woodbury_ops_dim_sharded(jmesh, mesh):
    rng_ = np.random.default_rng(0)
    d, m = 512, 8
    A = rng_.uniform(0.5, 2.0, d)
    B = rng_.standard_normal((d, m)) / np.sqrt(d)
    D = np.eye(m) * 0.5
    x = rng_.standard_normal((d, 16))

    @jax.jit
    def jcompute(A, B, D, x):
        W = JWoodburyPDMat.from_parts(A, B, D)
        return W.logdet(), W.solve(x), W.unwhiten(x), W.invquad(x)

    with jmesh:
        A_j, B_j, x_j = jshard_dim((jnp.asarray(A), jnp.asarray(B), jnp.asarray(x)), jmesh, dim=d)
        jout = jcompute(A_j, B_j, jnp.asarray(D), x_j)

    def compute(A, B, D, x):
        W = WoodburyPDMat.from_parts(A, B, D)
        return W.logdet(), W.solve(x), W.unwhiten(x), W.invquad(x)

    A_s, B_s, x_s = shard_dim((_t(A), _t(B), _t(x)), mesh, dim=d)
    out = dim_map(compute, mesh, out_split=(False, True, True, False))(A_s, B_s, _t(D), x_s)
    ref = compute(_t(A), _t(B), _t(D), _t(x))
    for o, r, j in zip(out, ref, jout):
        np.testing.assert_allclose(o.gather().numpy(), np.asarray(j), rtol=1e-10)
        np.testing.assert_allclose(o.gather().numpy(), r.numpy(), rtol=1e-10)
    # the solve comes back in row blocks, one a mesh entry
    assert out[1].split and all(b.shape == (d // 8, 16) for b in out[1].blocks)
    assert not out[0].split and len(out[0].blocks) == 8


def test_mvnormal_sampling_dim_sharded(jmesh, mesh):
    rng_ = np.random.default_rng(1)
    d, m, N = 256, 4, 32
    A = rng_.uniform(0.5, 2.0, d)
    B = rng_.standard_normal((d, m)) / np.sqrt(d)
    D = np.eye(m)
    mu = rng_.standard_normal(d)
    key = jax.random.key(0)

    @jax.jit
    def jdraw(A, B, D, mu, key):
        return JMvNormal(mu, JWoodburyPDMat.from_parts(A, B, D)).rand_and_logpdf(key, N)

    with jmesh:
        A_j, B_j, mu_j = jshard_dim((jnp.asarray(A), jnp.asarray(B), jnp.asarray(mu)), jmesh, dim=d)
        jx, jlq = jdraw(A_j, B_j, jnp.asarray(D), mu_j, key)
    u = np.asarray(jax.random.normal(key, (d, N), dtype=jnp.float64))  # JAX's noise for the key

    def draw(A, B, D, mu, u):
        return MvNormal(mu, WoodburyPDMat.from_parts(A, B, D)).rand_and_logpdf(u=u)

    A_s, B_s, mu_s, u_s = shard_dim((_t(A), _t(B), _t(mu), _t(u)), mesh, dim=d)
    x_s, lq_s = dim_map(draw, mesh, out_split=(True, False))(A_s, B_s, _t(D), mu_s, u_s)
    np.testing.assert_allclose(x_s.gather().numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_allclose(lq_s.gather().numpy(), np.asarray(jlq), rtol=1e-12)

    # from a stream: each member draws its rows of the unsplit (d, N) block
    stream = rng.Stream(5, 3, 1, rng.EXTRA)

    def from_stream(A, B, D, mu):
        return MvNormal(mu, WoodburyPDMat.from_parts(A, B, D)).rand_and_logpdf(stream, N)

    xs, lqs = dim_map(from_stream, mesh, out_split=(True, False))(A_s, B_s, _t(D), mu_s)
    xr, lqr = from_stream(_t(A), _t(B), _t(D), _t(mu))
    np.testing.assert_allclose(xs.gather().numpy(), xr.numpy(), rtol=1e-12)
    np.testing.assert_allclose(lqs.gather().numpy(), lqr.numpy(), rtol=1e-12)


def test_pathfinder_core_dim_sharded():
    """The core with its rows over 8 members matches the unsharded core."""
    d = 256
    target = tzoo.StandardNormal(d)
    config = tsinglepath.PathfinderConfig(maxiters=16, history_length=4, ndraws_elbo=4, ndraws=8)
    x0 = torch.tensor(np.random.default_rng(2).uniform(-2, 2, (1, d)))
    ids = torch.zeros(1, dtype=torch.int64)
    ref = make_path_executor()(ids, x0, target, config, 3, 0)
    out = make_path_executor(paths_dim_mesh(1, CPU8))(ids, x0, target, config, 3, 0)
    assert bool(out.success[0]) and bool(ref.success[0])
    assert int(out.fit_iteration[0]) == int(ref.fit_iteration[0])
    assert out.draws.shape == ref.draws.shape == (1, d, 8)
    np.testing.assert_allclose(out.fit_distribution.mean.numpy(),
                               ref.fit_distribution.mean.numpy(), atol=1e-10)
    np.testing.assert_allclose(out.draws.numpy(), ref.draws.numpy(), atol=1e-10)
    np.testing.assert_allclose(out.trace.xs.numpy(), ref.trace.xs.numpy(), atol=1e-10)


def test_shard_dim_replicates_small_cores(mesh):
    B_s, D_s = shard_dim((torch.ones(512, 8), torch.ones(8, 8)), mesh)
    assert B_s.split and [b.shape for b in B_s.blocks] == [(64, 8)] * 8
    assert not D_s.split and D_s.shape == (8, 8)
    assert dim_sharding.dim_sharding_for(mesh, torch.ones(512)).split
    assert not dim_sharding.dim_sharding_for(mesh, torch.tensor(1.0)).split


def test_shard_dim_rejects_indivisible_explicit_dim(mesh):
    with pytest.raises(ValueError, match="not divisible"):
        shard_dim((torch.zeros(1001),), mesh, dim=1001)


def test_shard_dim_warns_when_nothing_shardable(mesh):
    with pytest.warns(UserWarning, match="REPLICATED"):
        shard_dim((torch.zeros(7), torch.zeros(3)), mesh)


def test_shard_dim_rejects_explicit_dim_matching_no_leaf(mesh):
    x = torch.arange(1024.0)  # padded
    with pytest.raises(ValueError, match="matches no leaf"):
        shard_dim((x,), mesh, dim=1000 - 1000 % 8)  # stale divisible d
    out = shard_dim((x,), mesh, dim=1024)
    assert out[0].shape == (1024,) and torch.equal(out[0].gather(), x)


@pytest.mark.parametrize("denominator", ["component", "mixture"])
def test_multipath_on_combined_paths_dim_mesh(denominator):
    d = 64
    target = tzoo.StandardNormal(d)
    kw = dict(nruns=4, maxiters=30, ndraws_elbo=8, seed=3, device="cpu", dtype=torch.float64,
              importance_denominator=denominator)
    res_u = multipathfinder(target, 64, **kw)
    mesh2 = paths_dim_mesh(4, CPU8)
    assert mesh2.shape == {"paths": 4, "dim": 2}
    res_s = multipathfinder(target, 64, mesh=mesh2, **kw)
    np.testing.assert_array_equal(res_s.states.success.numpy(), res_u.states.success.numpy())
    np.testing.assert_array_equal(res_s.states.fit_iteration.numpy(),
                                  res_u.states.fit_iteration.numpy())
    np.testing.assert_allclose(res_s.draws.numpy(), res_u.draws.numpy(), atol=1e-8)
    with pytest.raises(ValueError, match="'dim' mesh axis"):
        multipathfinder(tzoo.StandardNormal(63), 16, nruns=4, maxiters=10, seed=3,
                        device="cpu", mesh=mesh2)


def test_hierarchical_target_matches_the_unsharded_run():
    """A target that takes iterations: the trajectories, evaluation counts,
    fits and draws of the dim mesh against the unsharded run."""
    target = tzoo.HierarchicalGaussian(64, seed=0)
    kw = dict(nruns=4, maxiters=50, ndraws_elbo=8, seed=3, device="cpu", dtype=torch.float64)
    ref = multipathfinder(target, 64, **kw)
    got = multipathfinder(target, 64, mesh=paths_dim_mesh(2, ["cpu"] * 4), **kw)
    np.testing.assert_array_equal(got.states.num_fn_evals.numpy(), ref.states.num_fn_evals.numpy())
    np.testing.assert_array_equal(got.states.fit_iteration.numpy(),
                                  ref.states.fit_iteration.numpy())
    np.testing.assert_allclose(got.states.trace.xs.numpy(), ref.states.trace.xs.numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(got.states.draws.numpy(), ref.states.draws.numpy(), atol=1e-8)
    np.testing.assert_allclose(got.draws.numpy(), ref.draws.numpy(), atol=1e-8)


def _same_bits(a, b):
    for name in ("draws", "draw_component_ids"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in ((a.states.trace.xs, b.states.trace.xs), (a.states.draws, b.states.draws),
                 (a.states.fit_distribution.cov.factor.C, b.states.fit_distribution.cov.factor.C),
                 (a.psis_result.log_weights, b.psis_result.log_weights)):
        assert torch.equal(x, y)


def test_dim_width_one_is_bitwise_the_paths_mesh_run():
    target = tzoo.HierarchicalGaussian(16, seed=0)
    kw = dict(nruns=4, maxiters=40, seed=1, device="cpu")
    a = multipathfinder(target, 100, mesh=paths_dim_mesh(2, ["cpu"] * 2), **kw)
    b = multipathfinder(target, 100, mesh=paths_mesh(["cpu"] * 2), **kw)
    _same_bits(a, b)


def test_a_repeat_is_bitwise_equal():
    target = tzoo.HierarchicalGaussian(16, seed=0)
    kw = dict(nruns=4, maxiters=40, seed=1, device="cpu", mesh=paths_dim_mesh(2, ["cpu"] * 8),
              keep_traces=False)
    _same_bits(multipathfinder(target, 100, **kw), multipathfinder(target, 100, **kw))


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_plain_b1_split_matches_unsplit(blocks):
    rng_ = np.random.default_rng(blocks)
    Bn, d, m, N = 3, 96, 12, 5
    u = _t(rng_.standard_normal((Bn, d, N)))
    a_half = _t(rng_.uniform(0.5, 1.5, (Bn, d)))
    X = _t(rng_.standard_normal((Bn, d, m)) / np.sqrt(d))
    C = _t(0.1 * rng_.standard_normal((Bn, m, m)))
    mu, logdet = _t(rng_.standard_normal((Bn, d))), _t(rng_.standard_normal(Bn))
    x_ref, lq_ref = wk.sample_and_logq_torch(u, a_half, X, C, mu, logdet)
    r = d // blocks
    parts = [wk.sample_and_logq_partial(u[:, j * r:(j + 1) * r], X[:, j * r:(j + 1) * r], d)
             for j in range(blocks)]
    t, usq = parts[0]
    for p in parts[1:]:  # in rank order, as the row group sums them
        t, usq = t + p[0], usq + p[1]
    assert t.shape == (Bn, m, N) and usq.shape == (Bn, N)
    out = [wk.sample_and_logq_resume(u[:, j * r:(j + 1) * r], a_half[:, j * r:(j + 1) * r],
                                     X[:, j * r:(j + 1) * r], C, mu[:, j * r:(j + 1) * r],
                                     logdet, t, usq, d) for j in range(blocks)]
    np.testing.assert_allclose(torch.cat([o[0] for o in out], dim=1).numpy(), x_ref.numpy(),
                               rtol=1e-12, atol=1e-12)
    for o in out:
        np.testing.assert_allclose(o[1].numpy(), lq_ref.numpy(), rtol=1e-12, atol=1e-12)
    # 16-bit inputs: the partials in float32, the outputs rounded once
    p16 = wk.sample_and_logq_partial(u.to(torch.bfloat16), X.to(torch.bfloat16), d)
    assert p16[0].dtype == p16[1].dtype == torch.float32


def test_unported_on_the_dim_axis_raises():
    """What the axis does not run yet: ``logpdf`` of one ``x`` shared by
    batched normals (the mixture denominator's kernel has no split), and a
    dense covariance (no row split of a dense A)."""
    d, m, two = 8, 2, dim_mesh(["cpu"] * 2)
    f64 = dict(dtype=torch.float64)
    A_s, B_s, x_s = shard_dim((torch.ones(d, 3, **f64), torch.ones(d, 3, m, **f64) / d,
                               torch.ones(d, 5, **f64)), two, dim=d)

    def shared_logpdf(A, B, x):  # three normals, one x (d_r, 5) shared by them
        W = WoodburyPDMat.from_parts(A.mT, B.transpose(0, 1), torch.eye(m, **f64).expand(3, m, m))
        return MvNormal(torch.zeros(3, A.shape[0], **f64), W).logpdf(x)

    with pytest.raises(NotImplementedError, match="shared by batched normals on the 'dim' mesh"):
        dim_map(shared_logpdf, two, out_split=False)(A_s, B_s, x_s)

    def dense(A, B, x):
        W = WoodburyPDMat.from_parts(torch.eye(A.shape[0], **f64), B[:, 0], torch.eye(m, **f64))
        return MvNormal(torch.zeros(A.shape[0], **f64), W).logpdf(x)

    with pytest.raises(NotImplementedError, match="dense A on the 'dim' mesh axis"):
        dim_map(dense, two, out_split=False)(A_s, B_s, x_s)


def test_an_exception_in_one_member_reaches_the_caller(monkeypatch):
    """A member that raises breaks its peers' barrier: they raise at once,
    the caller sees the member's own exception, and nothing is left
    waiting."""
    real = tsinglepath.elbo_noise

    def noise(*args):
        if rows.row_offset() > 0:
            raise FloatingPointError("member 1 failed")
        return real(*args)

    monkeypatch.setattr(tsinglepath, "elbo_noise", noise)
    t0 = time.perf_counter()
    with pytest.raises(FloatingPointError, match="member 1 failed"):
        multipathfinder(tzoo.StandardNormal(8), 10, nruns=2, maxiters=5, device="cpu",
                        mesh=paths_dim_mesh(1, ["cpu"] * 2))
    assert time.perf_counter() - t0 < rows.BARRIER_TIMEOUT / 10
    assert not [th for th in threading.enumerate() if th.name.startswith("pathfinder-mesh")]


def test_a_member_that_does_not_come_times_out(monkeypatch):
    monkeypatch.setattr(rows, "BARRIER_TIMEOUT", 0.5)
    group = rows.RowGroup([torch.device("cpu")] * 2, 4)
    errors = []

    def member(rank):
        try:
            with group.member(rank):
                if rank == 1:
                    time.sleep(1.5)  # past the timeout: never at the first barrier in time
                rows.sum_rows(torch.ones(1))
        except threading.BrokenBarrierError as e:
            errors.append((rank, e))

    threads = [threading.Thread(target=member, args=(r,)) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert sorted(r for r, _ in errors) == [0, 1]

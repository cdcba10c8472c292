"""The port's NUTS, held against the JAX package in f64 on the CPU.

* with the JAX package's own random numbers injected (momenta, directions,
  leaf and merge uniforms under the same ``fold_in`` keys) the positions agree
  transition by transition, for chains in lockstep, with a fixed low-rank
  metric and with windowed mass-matrix adaptation. The test compares 50 to 60
  transitions and allows 1e-6: the decisions are the same, the arithmetic is
  the same up to summation order, and the step-size feedback grows that; it
  stops comparing a chain where a branch (a ``take``, a U-turn test at ``≤ 0``)
  was decided in the last ulps, which these seeds do not reach;
* ``_warmup_schedule`` equal; the leapfrog ledger; frozen lanes;
* a chain's samples do not depend on the chains beside it;
* non-finite starts are made visible.

The statistical tests are in ``tests/test_torch_nuts_stats.py``.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JW
from pathfinder_tpu_torch import interop
from pathfinder_tpu_torch.models import zoo as tzoo

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

jnuts = importlib.import_module("pathfinder_tpu.integrations.nuts")
jhmc = importlib.import_module("pathfinder_tpu.integrations.hmc")
tnuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")


def _jax_nuts_noise(key, W, N, d, max_depth):
    """The numbers ``nuts`` of the JAX package draws under ``key``, per
    transition: the momentum ``fold_in(k, 0)``, and per doubling ``depth`` the
    direction ``fold_in(fold_in(k, 1), depth)``, the merge uniform
    ``fold_in(fold_in(k, 3), depth)`` and one uniform per leaf ``n``,
    ``fold_in(fold_in(fold_in(k, 2), depth), n)``."""
    L = 1 << (max_depth - 1)
    keys = jnp.concatenate([jax.random.split(jax.random.fold_in(key, 0), W),
                            jax.random.split(jax.random.fold_in(key, 1), N)])

    def one(k):
        mom = jax.random.normal(jax.random.fold_in(k, 0), (d,), dtype=jnp.float64)

        def per_depth(dep):
            k_dir = jax.random.fold_in(jax.random.fold_in(k, 1), dep)
            k_sub = jax.random.fold_in(jax.random.fold_in(k, 2), dep)
            k_merge = jax.random.fold_in(jax.random.fold_in(k, 3), dep)
            leaf = jax.vmap(
                lambda n: jax.random.uniform(jax.random.fold_in(k_sub, n), dtype=jnp.float64)
            )(jnp.arange(L))
            return jax.random.bernoulli(k_dir), jax.random.uniform(k_merge, dtype=jnp.float64), leaf

        return (mom,) + jax.vmap(per_depth)(jnp.arange(max_depth))

    return jax.vmap(one)(keys)


def _array_noise(keys, W, N, d, max_depth):
    per_chain = [_jax_nuts_noise(k, W, N, d, max_depth) for k in keys]
    stack = lambda i: np.stack([np.asarray(n[i]) for n in per_chain], axis=1)
    return interop.ArrayNoise(momentum=stack(0), direction=stack(1), merge=stack(2), leaf=stack(3))


def _compare(outs, got, tol=1e-6):
    for c, want in enumerate(outs):
        assert np.array_equal(got.n_leapfrogs[c].numpy(), np.asarray(want.n_leapfrogs))
        assert np.array_equal(got.warmup_n_leapfrogs[c].numpy(), np.asarray(want.warmup_n_leapfrogs))
        assert np.array_equal(got.tree_depths[c].numpy(), np.asarray(want.tree_depths))
        assert np.array_equal(got.diverging[c].numpy(), np.asarray(want.diverging))
        np.testing.assert_allclose(got.samples[c].numpy(), np.asarray(want.samples), rtol=tol, atol=tol)
        np.testing.assert_allclose(got.log_densities[c].numpy(), np.asarray(want.log_densities), rtol=tol, atol=tol)
        np.testing.assert_allclose(got.accept_stat[c].numpy(), np.asarray(want.accept_stat), rtol=tol, atol=tol)
        np.testing.assert_allclose(float(got.step_size[c]), float(want.step_size), rtol=tol)


def test_nuts_matches_jax_under_injected_noise_fixed_lowrank_metric():
    """Three lockstep chains on a correlated Gaussian with a shared low-rank
    metric, 30 warm-up + 30 sampling transitions each."""
    d, C, W, N, md = 5, 3, 30, 30, 6
    r = np.random.default_rng(0)
    A = r.uniform(0.5, 2.0, d)
    B = r.standard_normal((d, 2)) / np.sqrt(d)
    D = np.diag(r.uniform(0.5, 2.0, 2))
    jm = jhmc.WoodburyMetric(JW.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D)))
    tm = interop.metric_from_numpy(A, B, D)
    jt, tt = jzoo.CorrelatedGaussian(d, seed=11), tzoo.CorrelatedGaussian(d, seed=11)
    x0 = r.standard_normal((C, d))
    keys = jax.random.split(jax.random.key(3), C)
    outs = [jnuts.nuts(keys[c], jt.value_and_grad, jm, jnp.asarray(x0[c]), num_samples=N,
                       num_warmup=W, max_depth=md) for c in range(C)]
    got = tnuts.nuts(0, tt.value_and_grad, tm, torch.tensor(x0), num_samples=N, num_warmup=W,
                     max_depth=md, noise=_array_noise(keys, W, N, d, md))
    assert got.samples.shape == (C, N, d) and got.inv_mass_diag is None
    _compare(outs, got)
    # the chains stopped their trees at different depths: lanes were frozen
    assert len({tuple(got.n_leapfrogs[c].tolist()) for c in range(C)}) == C


def test_nuts_matches_jax_under_injected_noise_with_adaptation():
    """Windowed mass-matrix adaptation from the identity on a badly scaled
    Gaussian: the per-chain metric changes inside the warm-up."""
    C, W, N, md = 2, 40, 10, 7
    scales = np.asarray([0.2, 1.0, 5.0])
    d = 3
    jvg = jax.value_and_grad(lambda x: -0.5 * jnp.sum((x / scales) ** 2))
    st = torch.tensor(scales)
    tvg = tzoo.LogDensity(lambda x: -0.5 * torch.sum((x / st) ** 2, dim=-1), d).value_and_grad
    x0 = np.random.default_rng(1).standard_normal((C, d)) * 0.1
    keys = jax.random.split(jax.random.key(5), C)
    kw = dict(num_samples=N, num_warmup=W, max_depth=md, adapt_mass_matrix=True,
              init_buffer=5, term_buffer=5, base_window=8)
    outs = [jnuts.nuts(keys[c], jvg, None, jnp.asarray(x0[c]), **kw) for c in range(C)]
    got = tnuts.nuts(0, tvg, None, torch.tensor(x0), noise=_array_noise(keys, W, N, d, md), **kw)
    _compare(outs, got)
    for c in range(C):
        np.testing.assert_allclose(got.inv_mass_diag[c].numpy(), np.asarray(outs[c].inv_mass_diag), rtol=1e-6)


@pytest.mark.parametrize("args", [(500, 75, 50, 25), (100, 75, 50, 25), (30, 75, 50, 25),
                                  (200, 10, 20, 7), (1000, 75, 50, 25), (1, 0, 0, 1)])
def test_warmup_schedule_equal(args):
    js, jw = jnuts._warmup_schedule(*args)
    ts, tw = tnuts._warmup_schedule(*args)
    assert np.array_equal(js, ts) and np.array_equal(jw, tw)


def test_warmup_schedule_validation():
    vg = tzoo.StandardNormal(2).value_and_grad
    x0 = torch.zeros(1, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="base_window"):
        tnuts.nuts(0, vg, None, x0, num_samples=10, num_warmup=500, adapt_mass_matrix=True, base_window=0)
    with pytest.raises(ValueError, match="base_window"):
        tnuts.nuts(0, vg, None, x0, num_samples=10, num_warmup=500, adapt_mass_matrix=True, init_buffer=-1)


def test_popcount():
    for n in (0, 1, 2, 3, 255, 256, 1023, 0b1011011, (1 << 20) - 1):
        assert tnuts._popcount(n) == bin(n).count("1")


def test_chain_does_not_depend_on_its_neighbours():
    """Chain 2 of 4 equals the same chain run alone, bit for bit: frozen
    lanes move nothing, and every random number is a function of the chain's
    own id."""
    d = 3
    scales = torch.tensor([0.5, 1.0, 3.0], dtype=torch.float64)
    vg = tzoo.LogDensity(lambda x: -0.5 * torch.sum((x / scales) ** 2, dim=-1), d).value_and_grad
    x0 = torch.tensor(np.random.default_rng(2).standard_normal((4, d)))
    kw = dict(num_samples=25, num_warmup=25, max_depth=6)
    for adapt in (False, True):
        all4 = tnuts.nuts(9, vg, None, x0, adapt_mass_matrix=adapt, **kw)
        alone = tnuts.nuts(9, vg, None, x0[2:3], chain_ids=[2], adapt_mass_matrix=adapt, **kw)
        assert torch.equal(all4.samples[2], alone.samples[0])
        assert torch.equal(all4.n_leapfrogs[2], alone.n_leapfrogs[0])
        assert torch.equal(all4.warmup_n_leapfrogs[2], alone.warmup_n_leapfrogs[0])
        assert torch.equal(all4.step_size[2], alone.step_size[0])
        assert not torch.equal(all4.samples[1], all4.samples[2])
    vec = tnuts.nuts(9, vg, None, x0[0], **kw)  # one chain as a vector
    assert vec.samples.shape == (25, d) and vec.step_size.ndim == 0
    assert torch.equal(vec.samples, all4.samples[0]) is False  # all4 is the adaptive run
    assert torch.equal(vec.samples, tnuts.nuts(9, vg, None, x0, **kw).samples[0])


def test_nuts_leapfrog_ledger():
    """``n_leapfrogs`` and ``warmup_n_leapfrogs`` count each chain's own
    logp+grad evaluations: positive, within the doubling budget
    ``2^depth − 1``, and equal to the calls the target saw when one chain
    runs alone (a frozen lane counts nothing)."""
    d = 3
    calls = []
    base = tzoo.StandardNormal(d).value_and_grad

    def vg(x):
        calls.append(x.shape[0])
        return base(x)

    for adapt in (False, True):
        out = tnuts.nuts(7, vg, None, torch.ones(3, d, dtype=torch.float64), num_samples=40,
                         num_warmup=30, max_depth=6, adapt_mass_matrix=adapt)
        n_lf, w_lf, depths = out.n_leapfrogs, out.warmup_n_leapfrogs, out.tree_depths
        assert n_lf.shape == (3, 40) and w_lf.shape == (3, 30)
        assert bool((n_lf >= 1).all()) and bool((w_lf >= 1).all())
        assert bool((n_lf <= 2**depths - 1 + (depths == 0)).all())
        assert bool((n_lf >= depths).all())
    calls.clear()
    one = tnuts.nuts(7, vg, None, torch.ones(1, d, dtype=torch.float64), num_samples=40,
                     num_warmup=30, max_depth=6)
    assert len(calls) == 1 + int(one.n_leapfrogs.sum()) + int(one.warmup_n_leapfrogs.sum())


def test_nuts_nonfinite_start_is_visible_not_stuck():
    """A chain started outside the support (logp = −inf) does not return
    copies of x0 with a healthy-looking accept_stat = 1: its outputs are
    NaN-poisoned, its neighbours' are not, and ``nuts_chains`` raises."""

    def logp(x):
        inside = (x > 0).all(dim=-1)
        return torch.where(inside, -0.5 * torch.sum(x * x, dim=-1), -torch.inf)

    vg = tzoo.LogDensity(logp, 3).value_and_grad
    x0 = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]], dtype=torch.float64)
    out = tnuts.nuts(0, vg, None, x0, num_samples=20, num_warmup=10, max_depth=5)
    assert bool(torch.isnan(out.samples[1]).all()) and bool(torch.isnan(out.log_densities[1]).all())
    assert bool((out.accept_stat[1] == 0.0).all()) and bool(out.diverging[1].all())
    assert bool(torch.isfinite(out.samples[0]).all()) and bool((out.samples[0] > 0).all())
    with pytest.raises(ValueError, match="chains \\[1\\] start at"):
        tnuts.nuts_chains(1, vg, None, x0, num_samples=10, num_warmup=5)
    from pathfinder_tpu_torch.parallel.sharding import Mesh, paths_mesh

    # a ("paths", "dim") mesh splits the chains over its first axis and
    # replicates over the second: the chain start is still checked
    dim_mesh = Mesh(np.array([["cpu", "cpu"]], dtype=object), ("paths", "dim"))
    with pytest.raises(ValueError, match="chains \\[1\\] start at"):
        tnuts.nuts_chains(1, vg, None, x0, mesh=dim_mesh)
    with pytest.raises(ValueError, match="not divisible over the 2-wide 'paths' mesh axis"):
        tnuts.nuts_chains(1, vg, None, x0[:1], mesh=paths_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="one row per chain"):
        tnuts.nuts_chains(1, vg, None, x0[0])

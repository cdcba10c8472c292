"""The port's Woodbury metric and HMC, held against the JAX package in f64
on the CPU.

* the metric's three operations against JAX (1e-12) and against the dense
  matrix, for a metric shared by the chains and for one with a chain axis;
* ``da_update`` and one leapfrog step against JAX (1e-12);
* ``hmc`` with the JAX package's own random numbers injected: the positions
  agree transition by transition (1e-6 over 40 transitions of 6 steps: the
  same decisions and the same arithmetic up to summation order, whose
  1e-13 a step grows through the step-size adaptation's feedback);
* a chain's samples do not depend on the chains beside it;
* warm starts from plain and transform-aware Pathfinder results, with the
  thresholds of ``tests/test_integrations.py``.
"""

import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JW
from pathfinder_tpu_torch import interop, multipathfinder, pathfinder
from pathfinder_tpu_torch.models import bayes as tb
from pathfinder_tpu_torch.models import zoo as tzoo

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

# the JAX package's ``integrations`` exports functions named like its modules
jhmc = importlib.import_module("pathfinder_tpu.integrations.hmc")
thmc = importlib.import_module("pathfinder_tpu_torch.integrations.hmc")


def _parts(rng, n=6, m=4):
    A = rng.uniform(0.5, 2.0, n)
    B = rng.standard_normal((n, m)) / np.sqrt(n)
    U = np.linalg.qr(rng.standard_normal((m, m)))[0]
    D = U @ np.diag(rng.uniform(0.5, 2.0, m)) @ U.T
    return A, B, D


def make_metrics(rng, n=6, m=4):
    A, B, D = _parts(rng, n, m)
    jm = jhmc.WoodburyMetric(JW.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D)))
    tm = interop.metric_from_numpy(A, B, D)
    return jm, tm, np.diag(A) + B @ D @ B.T


def test_metric_matches_jax_and_dense():
    rng = np.random.default_rng(0)
    jm, tm, W = make_metrics(rng)
    P = rng.standard_normal((5, 6))
    pt = torch.tensor(P)
    ke = tm.kinetic_energy(pt).numpy()
    gk = tm.grad_kinetic(pt).numpy()
    mom = tm.sample_momentum(pt).numpy()
    for c in range(5):
        p = jnp.asarray(P[c])
        np.testing.assert_allclose(ke[c], float(jm.kinetic_energy(p)), rtol=1e-12)
        np.testing.assert_allclose(gk[c], np.asarray(jm.grad_kinetic(p)), rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(mom[c], np.asarray(jm.minv.inv_unwhiten(p)), rtol=1e-11, atol=1e-12)
    np.testing.assert_allclose(ke, 0.5 * np.einsum("ci,ij,cj->c", P, W, P), rtol=1e-9)
    np.testing.assert_allclose(gk, P @ W, rtol=1e-9)
    np.testing.assert_allclose(tm.to_inverse_mass_matrix().numpy(), W, rtol=1e-9, atol=1e-12)
    # one vector, as the JAX metric takes it
    np.testing.assert_allclose(float(tm.kinetic_energy(pt[2])), ke[2], rtol=1e-12)
    np.testing.assert_allclose(tm.grad_kinetic(pt[2]).numpy(), gk[2], rtol=1e-12)
    # momentum draws have covariance M = W⁻¹
    z = torch.tensor(np.random.default_rng(1).standard_normal((200_000, 6)))
    emp = np.cov(tm.sample_momentum(z).numpy().T)
    np.testing.assert_allclose(emp, np.linalg.inv(W), atol=0.05, rtol=0.1)


def test_metric_with_a_chain_axis_matches_shared():
    """A shared factor against a batched ``p``, and one factor per chain."""
    rng = np.random.default_rng(2)
    C, n, m = 3, 5, 2
    parts = [_parts(rng, n, m) for _ in range(C)]
    batched = interop.metric_from_numpy(*(np.stack([p[i] for p in parts]) for i in range(3)))
    assert batched.batched and batched.dim == n
    P = torch.tensor(rng.standard_normal((C, n)))
    for c in range(C):
        one = interop.metric_from_numpy(*parts[c])
        assert not one.batched
        np.testing.assert_allclose(batched.kinetic_energy(P)[c].numpy(), one.kinetic_energy(P)[c].numpy(), rtol=1e-12)
        np.testing.assert_allclose(batched.grad_kinetic(P)[c].numpy(), one.grad_kinetic(P)[c].numpy(), rtol=1e-12)
        np.testing.assert_allclose(batched.sample_momentum(P)[c].numpy(), one.sample_momentum(P)[c].numpy(), rtol=1e-11)


def test_diag_metric_closed_form_matches_factorized():
    v = np.random.default_rng(3).uniform(0.2, 3.0, (4, 7))
    for rank in (0, 3):
        for diag in (v[0], v):  # shared, and one diagonal per chain
            m = thmc.WoodburyMetric.diag(torch.tensor(diag), rank=rank)
            ref = interop.metric_from_numpy(
                diag, np.zeros(diag.shape + (rank,)), np.zeros(diag.shape[:-1] + (rank, rank))
            )
            P = torch.tensor(np.random.default_rng(4).standard_normal((4, 7)))
            for op in ("kinetic_energy", "grad_kinetic", "sample_momentum"):
                np.testing.assert_allclose(
                    getattr(m, op)(P).numpy(), getattr(ref, op)(P).numpy(), rtol=1e-12
                )
            np.testing.assert_allclose(m.minv.logdet().numpy(), ref.minv.logdet().numpy(), rtol=1e-12)
            assert m.minv.B.shape[-1] == rank
    jd = jhmc.WoodburyMetric.diag(jnp.asarray(v[0]), rank=2)
    td = thmc.WoodburyMetric.diag(torch.tensor(v[0]), rank=2)
    p = np.random.default_rng(5).standard_normal(7)
    np.testing.assert_allclose(
        td.sample_momentum(torch.tensor(p)).numpy(), np.asarray(jd.minv.inv_unwhiten(jnp.asarray(p))),
        rtol=1e-12,
    )


def test_da_update_matches_jax():
    jda = jhmc.da_init(0.1, jnp.float64)
    tda = thmc.da_init(0.1, torch.float64, (3,))
    stats = np.random.default_rng(6).uniform(0.0, 1.0, (12, 3))
    for row in stats:
        tda = thmc.da_update(tda, torch.tensor(row), 0.8)
    for c in range(3):
        j = jda
        for row in stats:
            j = jhmc.da_update(j, jnp.asarray(row[c]), 0.8)
        for a, b in zip(tda, j):
            np.testing.assert_allclose(a[c].numpy(), float(b), rtol=1e-12, atol=1e-14)
    # a warm-up of length zero keeps the requested step size
    np.testing.assert_allclose(torch.exp(thmc.da_init(0.37, torch.float64)[2]).item(), 0.37, rtol=1e-12)


def test_leapfrog_matches_jax_and_conserves_energy():
    d = 4
    rng = np.random.default_rng(2)
    jm, tm, _ = make_metrics(rng, n=d, m=2)
    jt, tt = jzoo.CorrelatedGaussian(d, seed=1), tzoo.CorrelatedGaussian(d, seed=1)
    X, P = rng.standard_normal((3, d)), rng.standard_normal((3, d))
    xt, pt = torch.tensor(X), torch.tensor(P)
    lp0, g0 = tt.value_and_grad(xt)
    eps = torch.tensor([0.05, 0.1, 0.2], dtype=torch.float64)  # one step size per chain
    x1, p1, g1, lp1 = thmc.leapfrog_step(tt.value_and_grad, tm, xt, pt, g0, eps)
    for c in range(3):
        jg0 = jt.value_and_grad(jnp.asarray(X[c]))[1]
        want = jhmc.leapfrog_step(jt.value_and_grad, jm, jnp.asarray(X[c]), jnp.asarray(P[c]), jg0, float(eps[c]))
        for got, w in zip((x1, p1, g1, lp1), want):
            np.testing.assert_allclose(got[c].numpy(), np.asarray(w), rtol=1e-12, atol=1e-13)
    x5, p5, lp5, g5 = thmc.leapfrog(tt.value_and_grad, tm, xt, pt, g0, 0.05, 5)
    jx5 = jhmc.leapfrog(jt.value_and_grad, jm, jnp.asarray(X[0]), jnp.asarray(P[0]),
                        jt.value_and_grad(jnp.asarray(X[0]))[1], 0.05, 5)
    np.testing.assert_allclose(x5[0].numpy(), np.asarray(jx5[0]), rtol=1e-11)
    np.testing.assert_allclose(float(lp5[0]), float(jx5[2]), rtol=1e-11)
    # near-exact energy conservation at a small step
    h0 = tm.kinetic_energy(pt) - lp0
    _, p100, lp100, _ = thmc.leapfrog(tt.value_and_grad, tm, xt, pt, g0, 0.01, 100)
    assert float((tm.kinetic_energy(p100) - lp100 - h0).abs().max()) < 1e-3
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        thmc.leapfrog(tt.value_and_grad, tm, xt, pt, g0, 0.1, 0)


def _jax_hmc_noise(key, W, N, d):
    """The numbers ``hmc`` of the JAX package draws under ``key``: per
    transition a momentum, a step-size jitter and a Metropolis uniform."""
    keys = jnp.concatenate([jax.random.split(jax.random.fold_in(key, 0), W),
                            jax.random.split(jax.random.fold_in(key, 1), N)])

    def one(k):
        k_mom, k_acc, k_jit = jax.random.split(k, 3)
        return (jax.random.normal(k_mom, (d,), dtype=jnp.float64),
                jax.random.uniform(k_jit, dtype=jnp.float64, minval=0.8, maxval=1.2),
                jax.random.uniform(k_acc, dtype=jnp.float64))

    return jax.vmap(one)(keys)


def test_hmc_matches_jax_under_injected_noise():
    """Three chains in lockstep against three JAX chains, each under its own
    key: positions, acceptance probabilities and the adapted step size."""
    d, C, W, N = 5, 3, 25, 15
    rng = np.random.default_rng(7)
    jm, tm, _ = make_metrics(rng, n=d, m=2)
    jt, tt = jzoo.CorrelatedGaussian(d, seed=3), tzoo.CorrelatedGaussian(d, seed=3)
    x0 = rng.standard_normal((C, d))
    keys = jax.random.split(jax.random.key(11), C)
    outs = [jhmc.hmc(keys[c], jt.value_and_grad, jm, jnp.asarray(x0[c]), num_samples=N,
                     num_warmup=W, num_leapfrog=6) for c in range(C)]
    noises = [_jax_hmc_noise(keys[c], W, N, d) for c in range(C)]
    stack = lambda i: np.stack([np.asarray(n[i]) for n in noises], axis=1)
    noise = interop.ArrayNoise(momentum=stack(0), jitter=stack(1), accept=stack(2))
    got = thmc.hmc(0, tt.value_and_grad, tm, torch.tensor(x0), num_samples=N, num_warmup=W,
                   num_leapfrog=6, noise=noise)
    assert got.samples.shape == (C, N, d)
    for c in range(C):
        np.testing.assert_allclose(got.samples[c].numpy(), np.asarray(outs[c].samples), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.accept_prob[c].numpy(), np.asarray(outs[c].accept_prob), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got.log_densities[c].numpy(), np.asarray(outs[c].log_densities), rtol=1e-6)
        np.testing.assert_allclose(float(got.step_size[c]), float(outs[c].step_size), rtol=1e-7)
        # the first transitions, before the feedback has grown anything
        np.testing.assert_allclose(got.samples[c, :1].numpy(), np.asarray(outs[c].samples[:1]), rtol=1e-7, atol=1e-7)


def test_hmc_chain_does_not_depend_on_its_neighbours():
    d = 4
    tt = tzoo.StandardNormal(d)
    metric = thmc.WoodburyMetric.diag(torch.tensor([0.5, 1.0, 2.0, 1.5], dtype=torch.float64))
    x0 = torch.tensor(np.random.default_rng(8).standard_normal((4, d)))
    kw = dict(num_samples=20, num_warmup=20, num_leapfrog=4)
    all4 = thmc.hmc(5, tt.value_and_grad, metric, x0, **kw)
    alone = thmc.hmc(5, tt.value_and_grad, metric, x0[2:3], chain_ids=[2], **kw)
    assert torch.equal(all4.samples[2], alone.samples[0])
    assert not torch.equal(all4.samples[1], all4.samples[2])
    other_seed = thmc.hmc(6, tt.value_and_grad, metric, x0, **kw)
    assert not torch.equal(other_seed.samples, all4.samples)
    # one chain as a vector: results without the chain axis
    single = thmc.hmc(5, tt.value_and_grad, metric, x0[0], **kw)
    assert single.samples.shape == (20, d) and single.step_size.ndim == 0
    assert torch.equal(single.samples, all4.samples[0])


def test_zero_warmup_respects_init_step_size():
    tt = tzoo.StandardNormal(3)
    out = thmc.hmc(0, tt.value_and_grad, thmc.WoodburyMetric.diag(torch.ones(3, dtype=torch.float64)),
                   torch.zeros(2, 3, dtype=torch.float64), num_samples=5, num_warmup=0,
                   init_step_size=0.37)
    np.testing.assert_allclose(out.step_size.numpy(), 0.37, rtol=1e-12)


def test_devices_and_inputs():
    tt = tzoo.StandardNormal(3)
    metric = thmc.WoodburyMetric.diag(torch.ones(3, dtype=torch.float64))
    # a numpy x0 goes to the card by default, and without one that raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            thmc.hmc(0, tt.value_and_grad, metric, np.zeros((2, 3)), num_samples=2, num_warmup=2)
    out = thmc.hmc(0, tt.value_and_grad, metric, np.zeros((2, 3)), num_samples=2, num_warmup=2,
                   device="cpu")
    assert out.samples.dtype == torch.float64 and out.samples.device.type == "cpu"
    with pytest.raises(ValueError, match="x0 must be"):
        thmc.hmc(0, tt.value_and_grad, metric, torch.zeros(2, 3, 1), num_samples=2, num_warmup=2)
    with pytest.raises(ValueError, match="chain_ids must have shape"):
        thmc.hmc(0, tt.value_and_grad, metric, torch.zeros(2, 3), chain_ids=[1], num_samples=2, num_warmup=2)
    meta = thmc.WoodburyMetric.diag(torch.ones(3, device="meta"))
    with pytest.raises(ValueError, match="the metric is on meta but x0 is on cpu"):
        thmc.hmc(0, tt.value_and_grad, meta, torch.zeros(2, 3), num_samples=2, num_warmup=2)
    with pytest.raises(ValueError, match="transitions exceed"):
        thmc.hmc(0, tt.value_and_grad, metric, torch.zeros(2, 3), num_samples=1 << 24, num_warmup=1)


def test_warm_started_hmc_posterior_agreement():
    """Pathfinder → HMC recovers the mean and covariance of a correlated
    Gaussian within Monte-Carlo error; four chains of 600 draws in place of
    the JAX test's one chain of 4000."""
    d = 5
    target = tzoo.CorrelatedGaussian(d, seed=3)
    res = pathfinder(target, seed=0, ndraws=10, maxiters=80, history_length=d, device="cpu",
                     dtype=torch.float64)
    assert res.success
    metric = thmc.WoodburyMetric.from_result(res)
    assert metric.minv is res.fit_distribution.cov
    vg = thmc.resolve_result_value_and_grad(res)
    out = thmc.hmc(1, vg, metric, res.draws[:, :4].mT, num_samples=600, num_warmup=200, num_leapfrog=8)
    xs = out.samples.reshape(-1, d).numpy()
    assert float(out.accept_prob.mean()) > 0.6
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), target.cov, atol=0.3, rtol=0.3)
    one = thmc.hmc_warm_start(1, res, num_samples=30, num_warmup=30, num_leapfrog=8, draw_index=3)
    assert one.samples.shape == (30, d)
    with pytest.raises(IndexError, match="draw_index 10 out of range"):
        thmc.hmc_warm_start(1, res, draw_index=10)
    with pytest.raises(IndexError, match="draw_index -11 out of range"):
        thmc.WoodburyMetric.from_result(res, -11)


def _gauss_model():
    obs = np.asarray([1.0, 2.0, 0.5, 1.5])

    def loglik(p):
        o = torch.as_tensor(obs, dtype=p["mu"].dtype, device=p["mu"].device)
        mu, sigma = p["mu"][..., None], p["sigma"][..., None]
        return torch.sum(-0.5 * ((o - mu) / sigma) ** 2 - torch.log(sigma), dim=-1)

    return tb.BayesModel({"mu": tb.Normal(0.0, 5.0), "sigma": tb.HalfNormal(2.0)}, loglik)


def test_hmc_warm_start_on_transform_aware_result():
    """On a ``BayesModel`` result the sampler targets the linked
    (unconstrained) density, never the model itself."""
    model = _gauss_model()
    res = pathfinder(model, seed=0, maxiters=50, device="cpu", dtype=torch.float64)
    assert res.success
    vg = thmc.resolve_result_value_and_grad(res)
    lp, g = vg(torch.tensor([[0.0, -3.0]], dtype=torch.float64))  # finite at any real vector
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    out = thmc.hmc_warm_start(1, res, num_samples=200, num_warmup=100, num_leapfrog=8)
    assert out.samples.shape == (200, 2)
    assert float(out.accept_prob.mean()) > 0.5
    chain = model.draws_to_chain(out.samples.mT)
    assert bool((chain["sigma"] > 0).all())
    assert abs(float(chain["mu"].mean()) - 1.25) < 0.6


def test_warm_start_from_multipath_result_uses_the_draws_component():
    d = 4
    target = tzoo.CorrelatedGaussian(d, seed=2)
    res = multipathfinder(target, 40, nruns=4, seed=0, maxiters=60, device="cpu", dtype=torch.float64)
    for i in (0, 7, -1):
        k = int(res.draw_component_ids[i])
        metric = thmc.WoodburyMetric.from_result(res, i)
        np.testing.assert_allclose(
            metric.to_inverse_mass_matrix().numpy(),
            res.fit_distribution.components.cov.to_dense()[k].numpy(), rtol=1e-12,
        )
    with pytest.raises(IndexError, match="out of range"):
        thmc.WoodburyMetric.from_result(res, 40)
    # a user's own gradient given to multipathfinder is the one the sampler gets
    calls = []

    def grad(x):
        calls.append(x.shape)
        return target.value_and_grad(x)[1]

    res_g = multipathfinder(target.logp, 40, nruns=4, dim=d, grad=grad, seed=0, maxiters=60,
                            device="cpu", dtype=torch.float64)
    n = len(calls)
    assert n > 0
    thmc.resolve_result_value_and_grad(res_g)(torch.zeros(2, d, dtype=torch.float64))
    assert len(calls) == n + 1

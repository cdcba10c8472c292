"""The port's NUTS and warm starts, statistically: the tests of
``tests/test_nuts.py`` with several lockstep chains in place of one long
chain (on the CPU a leaf iteration costs about a millisecond whatever the
number of chains) and the same thresholds. The slice as a whole,
``multipathfinder(transform=...)`` then ``nuts_chains``, is held against the
JAX package in ``tests/test_torch_multipath.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from pathfinder_tpu_torch import interop, multipathfinder, pathfinder
from pathfinder_tpu_torch.integrations.hmc import WoodburyMetric
from pathfinder_tpu_torch.models import bayes as tb
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.utils.diagnostics import ess_bulk, split_rhat

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

# the submodule: the package exports the function ``nuts`` under its name
tnuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")


def test_nuts_standard_normal():
    d = 4
    out = tnuts.nuts(0, tzoo.StandardNormal(d).value_and_grad, None,
                     torch.ones(6, d, dtype=torch.float64), num_samples=200, num_warmup=100,
                     max_depth=6)
    xs = out.samples.reshape(-1, d).numpy()
    assert not bool(out.diverging.any())
    assert np.abs(xs.mean(axis=0)).max() < 0.12
    np.testing.assert_allclose(xs.var(axis=0), np.ones(d), rtol=0.15)
    assert bool(((out.step_size > 0.3) & (out.step_size < 2.5)).all())


def test_nuts_preconditioned_depth_small():
    """With the metric equal to the target's covariance the trajectory turns
    fast: shallow trees and nearly independent draws."""
    d = 6
    target = tzoo.CorrelatedGaussian(d, seed=3)
    A = np.full(d, 1e-3)
    metric = interop.metric_from_numpy(A, np.eye(d), target.cov - np.diag(A))
    x0 = torch.tensor(np.tile(target.mean, (8, 1)))
    out = tnuts.nuts(2, target.value_and_grad, metric, x0, num_samples=200, num_warmup=150, max_depth=6)
    assert float(out.tree_depths.double().mean()) <= 3.0
    np.testing.assert_allclose(out.samples.reshape(-1, d).mean(0).numpy(), target.mean, atol=0.1)
    assert float(ess_bulk(out.samples).min()) > 800  # of 1600 draws


def test_nuts_windowed_mass_matrix_adaptation():
    """Windowed adaptation learns a badly scaled target's variances from the
    identity: per chain, the adapted diagonal M⁻¹ matches the marginal
    variances, and the trees get shallower than with the identity."""
    scales = np.asarray([0.05, 1.0, 20.0, 5.0])  # sd spread 400:1
    d = 4
    st = torch.tensor(scales)
    vg = tzoo.LogDensity(lambda x: -0.5 * torch.sum((x / st) ** 2, dim=-1), d).value_and_grad
    x0 = torch.zeros(6, d, dtype=torch.float64)
    out = tnuts.nuts(5, vg, None, x0, num_samples=150, num_warmup=300, max_depth=8,
                     adapt_mass_matrix=True)
    assert out.inv_mass_diag.shape == (6, d)
    # each chain's estimate comes from its last window's correlated draws:
    # the mean over the 6 chains is held to the JAX test's 0.5, every single
    # chain to a factor of 3 (the spread to learn is 160,000:1)
    np.testing.assert_allclose(out.inv_mass_diag.mean(0).numpy(), scales**2, rtol=0.5)
    ratio = out.inv_mass_diag.numpy() / scales**2
    assert ratio.min() > 1 / 3 and ratio.max() < 3
    xs = out.samples.reshape(-1, d).numpy()
    np.testing.assert_allclose(xs.std(axis=0), scales, rtol=0.15)
    assert np.abs(xs.mean(axis=0) / scales).max() < 0.15
    fixed = tnuts.nuts(5, vg, None, x0[:2], num_samples=40, num_warmup=60, max_depth=8)
    assert float(out.tree_depths.double().mean()) < float(fixed.tree_depths.double().mean())
    dense = WoodburyMetric(interop.woodbury_from_numpy(np.eye(d), np.zeros((d, 0)), np.zeros((0, 0))))
    with pytest.raises(ValueError, match="requires a diagonal-A metric"):
        tnuts.nuts(5, vg, dense, x0, num_samples=5, num_warmup=5, adapt_mass_matrix=True)


def test_nuts_adaptation_from_a_lowrank_pathfinder_metric():
    """Adaptation also runs when the first metric is a low-rank Pathfinder
    fit shared by the chains: it seeds the first window, then each chain has
    its own diagonal."""
    d = 5
    target = tzoo.CorrelatedGaussian(d, seed=4)
    res = pathfinder(target, seed=0, ndraws=10, maxiters=80, history_length=d, device="cpu",
                     dtype=torch.float64)
    metric = WoodburyMetric.from_result(res)
    assert metric.minv.B.shape[-1] == 2 * d
    out = tnuts.nuts(6, target.value_and_grad, metric, res.draws[:, :6].mT, num_samples=150,
                     num_warmup=300, max_depth=7, adapt_mass_matrix=True)
    np.testing.assert_allclose(out.samples.reshape(-1, d).mean(0).numpy(), target.mean, atol=0.2)
    # each chain's estimate comes from the last window's ~150 correlated
    # draws: their mean over the 6 chains is held to the JAX test's 0.6,
    # every single chain to a factor of 3
    np.testing.assert_allclose(out.inv_mass_diag.mean(0).numpy(), np.diag(target.cov), rtol=0.6)
    ratio = out.inv_mass_diag.numpy() / np.diag(target.cov)
    assert ratio.min() > 1 / 3 and ratio.max() < 3


def test_nuts_funnel_mixes_into_neck():
    target = tzoo.NealsFunnel(11)
    out = tnuts.nuts(3, target.value_and_grad, None, torch.zeros(6, 11, dtype=torch.float64),
                     num_samples=150, num_warmup=100, max_depth=6)
    v = out.samples[..., 0]
    assert float(v.min()) < -2.0 and float(v.max()) > 2.0
    assert float(out.diverging.double().mean()) < 0.2


def test_nuts_chains_with_summary_and_warm_start_chains():
    """``warm_start_chains`` packages (value_and_grad, metric, x0s) from a
    multipath result: the inits are its draws, the metric the first selected
    draw's component; the chains recover the target and mix."""
    d = 5
    target = tzoo.CorrelatedGaussian(d, seed=4)
    res = multipathfinder(target, 64, seed=3, nruns=4, maxiters=60, history_length=d,
                          device="cpu", dtype=torch.float64)
    vg, metric, x0s = tnuts.warm_start_chains(res, 4)
    assert x0s.shape == (4, d) and torch.equal(x0s, res.draws[:, :4].mT)
    k0 = int(res.draw_component_ids[0])
    assert torch.equal(metric.minv.to_dense(), res.fit_distribution.component(k0).cov.to_dense())
    out, summary = tnuts.nuts_chains(4, vg, metric, x0s, num_samples=300, num_warmup=100, max_depth=6)
    assert out.samples.shape == (4, 300, d) and summary["rhat"].shape == (d,)
    np.testing.assert_allclose(summary["mean"].numpy(), target.mean, atol=0.2)
    assert float(summary["rhat"].max()) < 1.05
    assert float(summary["ess_bulk"].min()) > 300 and float(summary["ess_tail"].min()) > 200
    again = tnuts.nuts(4, vg, metric, x0s, num_samples=20, num_warmup=100, max_depth=6)
    assert torch.equal(again.samples, out.samples[:, :20])  # the same seed, the same chains
    with pytest.raises(ValueError, match="chain inits"):
        tnuts.warm_start_chains(res, 65)
    with pytest.raises(IndexError, match="out of range"):
        tnuts.warm_start_chains(res, 2, draw_indices=[0, 999])
    with pytest.raises(IndexError, match="\\[-65\\] out of range"):
        tnuts.warm_start_chains(res, 2, draw_indices=[0, -65])
    with pytest.raises(ValueError, match="draw_indices has 3 entries"):
        tnuts.warm_start_chains(res, 4, draw_indices=[0, 1, 2])
    _, _, x0s_neg = tnuts.warm_start_chains(res, 2, draw_indices=[0, -1])
    assert torch.equal(x0s_neg[1], res.draws[:, -1])


def test_nuts_warm_start_from_pathfinder():
    d = 5
    target = tzoo.CorrelatedGaussian(d, seed=4)
    res = pathfinder(target, seed=0, ndraws=10, maxiters=80, history_length=d, device="cpu",
                     dtype=torch.float64)
    assert res.success
    one = tnuts.nuts_warm_start(1, res, num_samples=50, num_warmup=50, max_depth=6)
    assert one.samples.shape == (50, d) and not bool(one.diverging.any())
    vg, metric, x0s = tnuts.warm_start_chains(res, 6)
    out = tnuts.nuts(2, vg, metric, x0s, num_samples=200, num_warmup=100, max_depth=6)
    xs = out.samples.reshape(-1, d).numpy()
    assert not bool(out.diverging.any())
    np.testing.assert_allclose(xs.mean(axis=0), target.mean, atol=0.15)
    np.testing.assert_allclose(np.cov(xs.T), target.cov, atol=0.3, rtol=0.35)
    assert bool((split_rhat(out.samples) < 1.05).all())


def test_warm_start_chains_on_transform_aware_result():
    obs = np.asarray([1.0, 2.0, 0.5, 1.5])

    def loglik(p):
        o = torch.as_tensor(obs, dtype=p["mu"].dtype, device=p["mu"].device)
        mu, sigma = p["mu"][..., None], p["sigma"][..., None]
        return torch.sum(-0.5 * ((o - mu) / sigma) ** 2 - torch.log(sigma), dim=-1)

    model = tb.BayesModel({"mu": tb.Normal(0.0, 5.0), "sigma": tb.HalfNormal(2.0)}, loglik)
    res = multipathfinder(model, 32, seed=5, nruns=4, maxiters=50, device="cpu", dtype=torch.float64)
    vg, metric, x0s = tnuts.warm_start_chains(res, 2)
    lp, g = vg(torch.tensor([[0.0, -3.0]], dtype=torch.float64))
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    out, summary = tnuts.nuts_chains(6, vg, metric, x0s, num_samples=120, num_warmup=100, max_depth=6)
    chain = model.draws_to_chain(out.samples.reshape(-1, 2).mT)
    assert bool((chain["sigma"] > 0).all())
    assert abs(float(chain["mu"].mean()) - 1.25) < 0.6
    one = tnuts.nuts_warm_start(2, res, num_samples=60, num_warmup=60, max_depth=6)
    assert bool((model.draws_to_chain(one.samples.mT)["sigma"] > 0).all())


def test_nuts_truth_anchored_hierarchical():
    """NUTS from the identity with adaptation against the exact moments of
    the hierarchical target (quadrature) at d = 10."""
    d = 10
    target = tzoo.HierarchicalGaussian(d, seed=0)
    mean_t, sd_t = tzoo.hierarchical_gaussian_truth(d, seed=0)
    out = tnuts.nuts(1, target.value_and_grad, None, torch.zeros(8, d, dtype=torch.float64),
                     num_samples=200, num_warmup=200, max_depth=7, adapt_mass_matrix=True)
    xs = out.samples.reshape(-1, d).numpy()
    ess = ess_bulk(out.samples).numpy()
    z = np.abs(xs.mean(axis=0) - mean_t) / (sd_t / np.sqrt(ess))
    assert z.max() < 5.0, z
    np.testing.assert_allclose(xs.std(axis=0), sd_t, rtol=0.2)
    assert float(out.diverging.double().mean()) < 0.02

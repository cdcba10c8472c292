"""The port's serving-scale options held against the port itself, on the CPU
(the counterpart of ``TestChunkedLaunches``, ``TestOffloadLaunches``,
``TestKeepTraces`` and ``test_chunked_psis_matches_unchunked`` of
``tests/test_multipath.py``, where JAX is held against itself).

K=9 paths at d=5, maxiters=20, f64. A chunked run equals the one-launch run
to 1e-10 on every lane, except that one lane may take one more or one fewer
step where the ``ftol`` stall test at the f64 noise floor is decided by
summation order. Offload, a slim trace and the block-wise PSIS tail move
bits only, so they are compared bitwise. The memory rule is a pure function
of the configuration and the card's memory, checked without a card.
"""

import warnings

import numpy as np
import pytest
import torch

from pathfinder_tpu_torch import laplace_resample, multipathfinder, resample
from pathfinder_tpu_torch.models import zoo
from pathfinder_tpu_torch.multipath import _compute_psis_result
from pathfinder_tpu_torch.parallel import sharding
from pathfinder_tpu_torch.singlepath import PathfinderConfig, pathfinder_core
from pathfinder_tpu_torch.utils import rng
from pathfinder_tpu_torch.utils.misc import tree_map

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


D, K, MAXITERS = 5, 9, 20
KW = dict(seed=1, nruns=K, maxiters=MAXITERS, device="cpu", dtype=torch.float64)


def _leaves(state):
    out = []
    tree_map(lambda t: out.append(t), state)
    return out


def _assert_states_equal(a, b):
    """Every leaf bitwise equal (NaN where the other is NaN)."""
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)



def _flaky(x):
    """A standard normal whose density is NaN outside a cube of half-width
    1.5: starts from U[−2, 2] fail often, so retries run."""
    clean = -0.5 * (x * x).sum(-1)
    return torch.where(x.abs().amax(-1) > 1.5, torch.full_like(clean, torch.nan), clean)


@pytest.fixture(scope="module")
def target():
    return zoo.HierarchicalGaussian(D, seed=0)


@pytest.fixture(scope="module")
def one_launch(target):
    return multipathfinder(target, 60, **KW)


@pytest.fixture(scope="module")
def offloaded(target):
    return multipathfinder(target, 60, max_paths_per_launch=4, offload_launches=True, **KW)


@pytest.mark.parametrize("cap", [3, 4])
def test_chunked_launches_match_one_launch(target, one_launch, cap):
    res = multipathfinder(target, 60, max_paths_per_launch=cap, **KW)
    assert res.max_paths_per_launch == cap and one_launch.max_paths_per_launch is None
    a, b = one_launch.states, res.states
    same = a.trace.num_valid == b.trace.num_valid
    # at most one lane may move by one step (the ftol tie, see the docstring)
    assert int((~same).sum()) <= 1
    assert bool(((a.trace.num_valid - b.trace.num_valid).abs() <= 1).all())
    np.testing.assert_allclose(b.draws[same].numpy(), a.draws[same].numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(b.fit_distribution.mean[same].numpy(),
                               a.fit_distribution.mean[same].numpy(), rtol=1e-10, atol=1e-10)
    assert torch.equal(b.path_id, torch.arange(K)) and torch.equal(b.success, a.success)
    if bool(same.all()):
        np.testing.assert_allclose(res.draws.numpy(), one_launch.draws.numpy(), rtol=1e-10, atol=1e-10)


def test_offload_is_bitwise_the_on_device_run(target, offloaded):
    on = multipathfinder(target, 60, max_paths_per_launch=4, offload_launches=False, **KW)
    _assert_states_equal(on.states, offloaded.states)
    assert torch.equal(on.draws, offloaded.draws)
    assert torch.equal(on.draw_component_ids, offloaded.draw_component_ids)
    assert torch.equal(on.psis_result.log_weights, offloaded.psis_result.log_weights)

def test_offload_of_one_launch_is_bitwise_the_launch(target, one_launch):
    single = multipathfinder(target, 60, offload_launches=True, **KW)
    assert single.max_paths_per_launch is None
    _assert_states_equal(single.states, one_launch.states)
    assert torch.equal(single.draws, one_launch.draws)


def test_retries_merge_into_offloaded_states():
    kw = dict(seed=2, nruns=K, dim=3, maxiters=15, init_scale=2.0, device="cpu", dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the retry and bad-k̂ warnings
        plain = multipathfinder(_flaky, 40, **kw)
        chunked = multipathfinder(_flaky, 40, max_paths_per_launch=4, offload_launches=True,
                                  keep_traces=False, **kw)
        single = multipathfinder(_flaky, 40, offload_launches=True, **kw)
    assert int(plain.num_tries.max()) > 2  # retry rounds ran
    assert bool(plain.states.success.all())
    for res, cap in ((chunked, 4), (single, None)):
        assert torch.equal(res.num_tries, plain.num_tries)
        assert torch.equal(res.states.round, plain.states.round)
        assert torch.equal(res.states.fit_distribution.mean, plain.states.fit_distribution.mean)
        assert torch.equal(res.draws, plain.draws)
        # each path keeps the width of the launch that ran its last attempt:
        # round 0 ran all K paths, a retry round its failed paths padded to a
        # power of two, in launches of at most the cap
        for k in range(K):
            r = int(res.states.round[k])
            n = int((res.num_tries > r).sum())
            n = n if r == 0 else 1 << (n - 1).bit_length()
            assert int(res.states.launch_lanes[k]) == (n if cap is None else min(cap, n))


def test_keep_traces_false(target, one_launch):
    slim = multipathfinder(target, 60, max_paths_per_launch=4, keep_traces=False, **KW)
    tr = slim.states.trace
    assert tr.xs.shape == (K, 0, D) and tr.gradients.shape == (K, 0, D)
    assert tr.log_densities.shape == (K, 0)
    # the trace's counts are kept, and everything pooled is unchanged
    assert torch.equal(tr.num_valid, one_launch.states.trace.num_valid)
    assert torch.equal(tr.num_fn_evals, one_launch.states.trace.num_fn_evals)
    np.testing.assert_allclose(slim.draws.numpy(), one_launch.draws.numpy(), rtol=1e-10, atol=1e-10)
    p = slim.path_result(0)
    for name in ("fit_distributions", "elbo_estimates"):
        with pytest.raises(ValueError, match="keep_traces=False"):
            getattr(p, name)
    assert one_launch.path_result(0).fit_distributions.mean.shape == (MAXITERS + 1, D)


@pytest.mark.parametrize("denominator", ["component", "mixture"])
def test_chunked_psis_matches_unchunked(one_launch, denominator):
    comps = one_launch.fit_distribution.components
    dk = one_launch.draws_per_component
    whole = _compute_psis_result(one_launch.logp, comps, dk, denominator)
    for chunk in (2, 4, K):
        blocks = _compute_psis_result(one_launch.logp, comps, dk, denominator, chunk=chunk)
        assert torch.equal(blocks.log_weights, whole.log_weights)
        assert float(blocks.pareto_shape) == float(whole.pareto_shape)


def test_resample_and_laplace_resample_on_an_offloaded_chunked_result(target, one_launch, offloaded):
    assert offloaded.states.draws.device.type == "cpu" and offloaded.max_paths_per_launch == 4
    for kw in (dict(), dict(ndraws_per_run=7), dict(importance_denominator="mixture")):
        a, b = resample(one_launch, 30, **kw), resample(offloaded, 30, **kw)
        np.testing.assert_allclose(b.draws.numpy(), a.draws.numpy(), rtol=1e-10, atol=1e-10)
        assert torch.equal(a.draw_component_ids, b.draw_component_ids)
    for method in ("diag", "full"):
        a = laplace_resample(one_launch, 30, method=method)
        b = laplace_resample(offloaded, 30, method=method)
        np.testing.assert_allclose(b.draws.numpy(), a.draws.numpy(), rtol=1e-10, atol=1e-10)
        assert b.max_paths_per_launch == 4
        assert b.fit_distribution.components.cov.B.shape == (K, D, 0)
        np.testing.assert_allclose(float(b.psis_result.pareto_shape), float(a.psis_result.pareto_shape),
                                   rtol=1e-10)


def test_memory_rule_is_a_pure_function_of_device_memory():
    peak = sharding.lane_bytes(1000, 64, 6, 5, 8, 5)
    slim = sharding.state_bytes(1000, 64, 6, 5, keep_traces=False)
    full = sharding.state_bytes(1000, 64, 6, 5)
    assert peak == sharding.lane_bytes(1000, 64, 6, 5, 8, 5) and peak > full > slim
    card = 80 * 10**9
    fit = int(sharding.LAUNCH_SHARE * card) // peak
    # one launch where it fits; else the fewest even launches that fit
    assert sharding.plan_launches(fit, peak, slim, card) == (None, False)
    cap, off = sharding.plan_launches(32768, peak, slim, card)
    n = -(-32768 // cap)
    assert cap <= fit and n == -(-32768 // fit) and n * cap - 32768 < n and not off
    # traces kept: 32768 states pass a quarter of the card, so they go to the host
    assert sharding.plan_launches(32768, peak, full, card)[1]
    # what the caller gives is kept
    assert sharding.plan_launches(32768, peak, full, card, cap=8192, offload=False) == (8192, False)
    assert sharding.plan_launches(100, peak, full, card, offload=True) == (None, True)
    # a smaller card, a smaller cap; f64 doubles the floats
    assert sharding.plan_launches(32768, peak, slim, card // 4)[0] < cap
    assert sharding.lane_bytes(1000, 64, 6, 5, 8, 5, torch.float64) > peak
    assert sharding.pad_paths(9) == 9 and sharding.pad_paths(9, cap=4) == 12 and sharding.pad_paths(9, cap=9) == 9


@pytest.mark.parametrize("keep_traces", [True, False])
def test_state_bytes_count_a_real_state(target, keep_traces):
    from pathfinder_tpu_torch.multipath import _slim_traces

    cfg = PathfinderConfig(maxiters=MAXITERS, history_length=4, ndraws=7)
    ids = torch.arange(3)
    x0 = rng.Stream(0, ids, 0, rng.INIT).uniform(D, torch.float32, "cpu") * 4.0 - 2.0
    st = pathfinder_core(target, x0, cfg, 0, ids, 0)
    st = st if keep_traces else _slim_traces(st)
    got = sum(t.numel() * t.element_size() for t in _leaves(st))
    assert got == 3 * sharding.state_bytes(D, MAXITERS, 4, 7, torch.float32, keep_traces)


def test_cpu_defaults_are_one_launch_on_the_device(one_launch):
    assert one_launch.max_paths_per_launch is None
    assert one_launch.states.draws.device.type == "cpu" and not one_launch.states.draws.is_pinned()
    with pytest.raises(ValueError, match="positive"):
        multipathfinder(zoo.StandardNormal(3), 10, nruns=2, maxiters=3, device="cpu",
                        max_paths_per_launch=0)

"""The bound on the target's batched evaluations (``models/protocol.bounded_target``)
held against the unbounded target, on the CPU.

With ``target_points`` forced small, every call site that hands the target a
batch (the trajectory's value and gradient, an ELBO chunk, the PSIS blocks,
a whole ``multipathfinder`` call with its retries) gives the unbounded
result bit for bit, on two targets whose rows do not depend on the rows
beside them on the CPU: a logistic regression with its own gradient, whose
sums all run along the last axis, and the hierarchical Gaussian by
autograd. (A matrix product's rows can: the CPU's GEMM kernels, like
cuBLAS's, follow the batch's size.) With ``target_points=None`` the CPU
splits nothing.
The memory rule with a learned bytes-per-point figure is a pure function,
checked without a card.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pathfinder_tpu_torch import multipathfinder, pathfinder
from pathfinder_tpu_torch.models import zoo
from pathfinder_tpu_torch.models.protocol import (
    TARGET_SHARE,
    LogDensity,
    batched_hessian,
    bounded_target,
    target_bound,
)
from pathfinder_tpu_torch.multipath import _compute_psis_result, laplace_resample
from pathfinder_tpu_torch.ops.elbo import maximize_elbo_chunked
from pathfinder_tpu_torch.ops.lbfgs import lbfgs_history_aux, minimize_lbfgs_trace
from pathfinder_tpu_torch.parallel import sharding
from pathfinder_tpu_torch.singlepath import (
    PathfinderConfig,
    candidate_dists,
    elbo_noise,
)
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.misc import tree_map

torch.set_num_threads(1)

K, MAXITERS = 12, 25
F64 = torch.float64


def _logistic() -> LogDensity:
    """Bayesian logistic regression on 320 rows at d = 6: its logits summed
    column by column, its sums over the rows along the last axis (a short
    reduction's vector lanes can run across the batch's rows instead), and
    320 a whole number of vectors, so that a row's elementwise pass runs the
    same vector code at any batch size."""
    X, y, _ = zoo.german_credit_synthetic(n=320, d=6, seed=3)
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    XT = X.T.contiguous()

    def logits(b):
        z = b[:, :1] * XT[0]
        for j in range(1, 6):
            z = z + b[:, j:j + 1] * XT[j]
        return z

    def logp(b):
        z = logits(b)
        prior = b[:, 0] ** 2
        for j in range(1, 6):
            prior = prior + b[:, j] ** 2
        return torch.sum(y * z - F.softplus(z), -1) - 0.005 * prior

    def value_and_grad(b):
        r = y - torch.sigmoid(logits(b))
        return logp(b), (r[:, None, :] * XT).sum(-1) - b / 100

    return LogDensity(logp=logp, dim=6, value_and_grad=value_and_grad)


@pytest.fixture(scope="module", params=["logistic", "hierarchical"])
def target(request):
    return _logistic() if request.param == "logistic" else zoo.HierarchicalGaussian(6, seed=1)


def _x0(d, k=K, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(k, d, generator=g, dtype=F64) * 2 - 1) * 2


def _leaves(tree):
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _points_and_splits(fn):
    """``(points, splits)`` the always-on counters gained while ``fn`` ran."""
    before = tracing.counts(tracing.TARGET)
    fn()
    after = tracing.counts(tracing.TARGET)
    return tuple(after.get(n, 0) - before.get(n, 0)
                 for n in (tracing.TARGET_POINTS, tracing.TARGET_SPLITS))


@pytest.mark.parametrize("points", [1, 5, K - 1])
def test_trajectory_value_and_grad_bitwise(target, points):
    x = _x0(target.dim)
    bounded = bounded_target(target, points)
    lp, g = target.value_and_grad(x)
    got = {}
    n = _points_and_splits(lambda: got.update(vg=bounded.value_and_grad(x)))
    _assert_bitwise(got["vg"], (lp, g))
    assert n == (K, 1)
    # the whole L-BFGS trajectory, every evaluation through the bound
    _assert_bitwise(minimize_lbfgs_trace(bounded.value_and_grad, x, maxiters=MAXITERS),
                    minimize_lbfgs_trace(target.value_and_grad, x, maxiters=MAXITERS))


@pytest.mark.parametrize("points", [3, 17])
def test_elbo_chunk_values_and_errors_bitwise(target, points):
    x = _x0(target.dim)
    cfg = PathfinderConfig(maxiters=MAXITERS)
    trace = minimize_lbfgs_trace(target.value_and_grad, x, maxiters=MAXITERS)
    aux = lbfgs_history_aux(trace, cfg.epsilon_curvature)
    make = candidate_dists(trace, aux, cfg.history_length)
    ids = torch.arange(K)

    def run(logp):
        return maximize_elbo_chunked(
            logp, make, lambda idx: elbo_noise(7, ids, 0, idx, target.dim, 5, F64, "cpu"),
            num_candidates=MAXITERS, chunk_size=8, valid_mask=aux.point_mask[:, 1:], dtype=F64)

    want = run(target.logp)
    got = {}
    points_n, splits = _points_and_splits(
        lambda: got.update(r=run(bounded_target(target, points).logp)))
    _assert_bitwise(got["r"], want)
    assert splits >= 1 and points_n % (K * 8 * 5) == 0  # whole chunks of K·C·N points


def test_psis_ratios_bitwise(target):
    res = multipathfinder(target, 200, nruns=K, maxiters=MAXITERS, seed=2, device="cpu",
                          dtype=F64)
    comps, draws = res.states.fit_distribution, res.states.draws.mT
    want = _compute_psis_result(target.logp, comps, draws)
    for points, chunk in ((7, None), (4, 5)):
        got = _compute_psis_result(bounded_target(target, points).logp, comps, draws,
                                   chunk=chunk)
        _assert_bitwise((got.log_weights, got.pareto_shape), (want.log_weights, want.pareto_shape))


def _flaky_logistic(target):
    """``target`` NaN outside a cube of half-width 1.5, so that starts from
    U[−2, 2] fail and retries run."""

    def logp(x):
        lp = target.logp(x)
        return torch.where(x.abs().amax(-1) > 1.5, torch.full_like(lp, torch.nan), lp)

    return LogDensity(logp=logp, dim=target.dim)


@pytest.mark.parametrize("flaky", [False, True])
def test_multipathfinder_bitwise_under_a_small_bound(target, flaky):
    fn = _flaky_logistic(target) if flaky else target
    kw = dict(nruns=K, maxiters=MAXITERS, seed=5, device="cpu", dtype=F64)
    want = multipathfinder(fn, 300, **kw)
    got = {}
    points_n, splits = _points_and_splits(
        lambda: got.update(r=multipathfinder(fn, 300, target_points=6, **kw)))
    got = got["r"]
    if flaky:
        assert int(want.num_tries.max()) > 1  # the retries ran, through the bound too
    assert torch.equal(got.num_tries, want.num_tries)
    _assert_bitwise(got.states, want.states)
    _assert_bitwise((got.draws, got.draw_component_ids, got.psis_result.log_weights),
                    (want.draws, want.draw_component_ids, want.psis_result.log_weights))
    assert splits > 0 and points_n > 0
    # the result's target keeps the bound, and its Hessian is the target's own
    lap = laplace_resample(got, 100)
    assert torch.equal(lap.draws, laplace_resample(want, 100).draws)


def test_single_path_bitwise_under_a_small_bound(target):
    kw = dict(dim=target.dim, maxiters=MAXITERS, seed=4, device="cpu", dtype=F64, ndraws=20)
    want, got = pathfinder(target, **kw), pathfinder(target, target_points=1, **kw)
    _assert_bitwise((got.state, got.draws), (want.state, want.draws))


def test_unset_bound_splits_nothing_on_the_cpu(target):
    kw = dict(nruns=K, maxiters=MAXITERS, seed=5, device="cpu", dtype=F64)
    points_n, splits = _points_and_splits(lambda: multipathfinder(target, 300, **kw))
    assert splits == 0
    # the trajectory's evaluations (K points each) and more: every point is counted
    assert points_n > K * MAXITERS
    x = _x0(target.dim, 64)
    assert bounded_target(target).logp(x).shape == (64,)
    assert bounded_target(target).value_and_grad(x)[1].shape == (64, target.dim)


def test_counters_are_always_on_and_keyed_by_call(target):
    bounded = bounded_target(target, 4)
    x = _x0(target.dim, 10)
    tracing.reset(tracing.TARGET)
    bounded.logp(x)
    assert tracing.counts_by_key(tracing.TARGET) == {
        tracing.TARGET_POINTS: {None: 10}, tracing.TARGET_SPLITS: {None: 1}}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        multipathfinder(target, 100, nruns=4, maxiters=10, seed=1, device="cpu", dtype=F64,
                        target_points=3)
    calls = [s.id for s in tracing.spans() if s.name == "call"]
    by_key = tracing.counts_by_key(tracing.TARGET)
    assert len(calls) == 1
    assert set(by_key[tracing.TARGET_POINTS]) == {None, calls[0]}
    assert by_key[tracing.TARGET_SPLITS][calls[0]] > 0
    tracing.reset(tracing.TARGET)


def test_bound_is_checked(target):
    with pytest.raises(ValueError, match="target_points"):
        PathfinderConfig(target_points=0)
    with pytest.raises(ValueError, match="target_points"):
        bounded_target(target, 0)


def test_hessian_of_a_bounded_target_is_the_targets(target):
    x = _x0(target.dim, 3)
    h = batched_hessian(bounded_target(target, 1).logp)(x)
    torch.testing.assert_close(h, batched_hessian(target.logp)(x), rtol=0, atol=0)


def test_memory_rule_plans_one_launch_where_the_split_evaluation_fits():
    """Covertype's shape (d = 56, float64, K = 100, ELBO chunks of 16
    candidates × 5 draws): a point costs the target about 15 MB, so a
    lane's chunk of 80 points would take 1.2 GB and 100 lanes 120 GB,
    more than the card. Bounded, the evaluation takes at most
    ``TARGET_SHARE`` of the card beside the lanes, and one launch of 100
    lanes is planned."""
    card = 80 * 2**30
    d, point = 56, 15 * 2**20
    base = dict(maxiters=64, history_length=6, ndraws_elbo=5, elbo_chunk=16, ndraws=10,
                dtype=F64)
    lane = sharding.lane_bytes(d, **base)
    per_lane = point * 16 * 5
    held = int(TARGET_SHARE * card) // point * point  # the learned bound's blocks
    state = sharding.state_bytes(d, 64, 6, 10, F64)
    assert sharding.plan_launches(100, lane, state, card, target_per_lane=per_lane,
                                  target_held=held) == (None, False)
    # unbounded, the evaluation holds every lane's points: several launches
    assert sharding.plan_launches(100, lane, state, card, target_per_lane=per_lane,
                                  target_held=100 * per_lane)[0] < 100
    assert np.isclose(TARGET_SHARE, 0.25)


def test_memory_rule_counts_the_target_for_a_launchs_lanes():
    """A light target (the 1000-D hierarchical Gaussian at float32, about
    10 kB a point, 40 points a lane in chunks of 8 candidates × 5 draws) at
    K = 32,768: the plan counts the target for the lanes of one launch, so
    it keeps the four launches of 8,192 that the rule planned when it
    counted the target's temporaries as ``2·d·N`` floats more a draw, and
    the bound's share of the card, set aside whole, would not."""
    card = 80 * 2**30
    f, d, C, N = 4, 1000, 8, 5
    lane = sharding.lane_bytes(d, 64, 6, N, C, 5)
    state = sharding.state_bytes(d, 64, 6, 5, keep_traces=False)
    point = 10_000
    held = int(TARGET_SHARE * card) // point * point
    planned = sharding.plan_launches(32768, lane, state, card, target_per_lane=C * N * point,
                                     target_held=held)
    assert planned == sharding.plan_launches(32768, lane + C * f * 2 * d * N, state, card)
    assert planned[0] == 8192
    assert sharding.plan_launches(32768, lane, state, card - held)[0] < 8192
    # no target term: the lanes alone
    assert (sharding.plan_launches(32768, lane, state, card)
            == sharding.plan_launches(32768, lane, state, card, target_per_lane=0, target_held=0))


def test_target_terms_of_a_forced_bound(target):
    """``sharding.target_bytes`` from the learned bytes a point (seeded here,
    where no card measures them) and a forced ``target_points``; on the CPU
    the unforced bound is none."""
    x = _x0(target.dim, 4)
    owner = getattr(target.logp, "__self__", target.logp)
    seeded = {("logp", F64, x.device): 300, ("value_and_grad", F64, x.device): 1000}
    owner.__dict__.setdefault("_pf_point_bytes", {}).update(seeded)
    try:
        assert sharding.target_bytes(target, x, 2, points=7) == (1000, 7000)
        assert sharding.target_bytes(target, x, 5, points=7) == (1500, 7000)
    finally:
        for key in seeded:
            owner._pf_point_bytes.pop(key)
    assert target_bound(target, "logp", x) is None
    assert target_bound(target, "value_and_grad", x, 9) == 9

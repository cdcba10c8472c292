"""Dynamic NUTS with the low-rank Woodbury metric, chains in lockstep
(counterpart of ``pathfinder_tpu/integrations/nuts.py``).

Multinomial No-U-Turn sampler (Hoffman & Gelman 2014 termination; Betancourt
2017 multinomial state sampling), iterative, with a fixed ``max_depth``:

* subtrees are built leaf by leaf with a checkpoint stack of size
  ``max_depth + 1``: an aligned block of size 2^k that ends at leaf ``n``
  (binary: k trailing ones) is U-turn-checked against the checkpoint stored
  when its first leaf ``a = n − 2^k + 1`` was visited; block starts live at
  stack index ``popcount(a)``. This makes the recursive algorithm's complete
  set of sub-tree checks with O(max_depth) memory.
* tree doubling is the outer loop; a subtree that turns or diverges is
  discarded whole (the edges do not advance), as in the recursion.
* the U-turn criterion is the generalized one, ``ρ·M⁻¹p_start ≤ 0`` or
  ``ρ·M⁻¹p_end ≤ 0`` with ρ the block's momentum sum; every metric product
  in O(d·m) low-rank form through :class:`WoodburyMetric`.

Chains are the batch axis, ``(C, d)``. Both loops run until *every* chain is
done, one device→host read per iteration for the loop condition. The chains
that still run are all at the same doubling and the same leaf (each starts at
0 and stops for good), so depth, leaf index and checkpoint slots are plain
integers; what differs by chain is a mask. A chain that has turned, diverged
or finished its subtree is frozen: none of its state moves and it counts no
leapfrog, though the batch's integrator evaluates its lane.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pathfinder_tpu_torch.integrations.hmc import (
    WoodburyMetric,
    check_transitions,
    da_init,
    da_update,
    leapfrog_step,
    resolve_result_value_and_grad,
    sampler_inputs,
    sampler_noise,
)
from pathfinder_tpu_torch.parallel.sharding import check_mesh, run_on_devices
from pathfinder_tpu_torch.utils.diagnostics import summarize
from pathfinder_tpu_torch.utils.misc import tree_map

__all__ = [
    "nuts",
    "nuts_chains",
    "nuts_warm_start",
    "warm_start_chains",
    "NUTSResult",
]

_MAX_DELTA_H = 1000.0  # divergence threshold (Stan's default)


class _Point(NamedTuple):
    x: torch.Tensor  # (C, d)
    p: torch.Tensor  # (C, d)
    g: torch.Tensor  # (C, d) ∇logp(x)
    logp: torch.Tensor  # (C,)


def _where(mask, new, old):
    """``new`` in the lanes of ``mask (C,)``, else ``old``; tensors or
    tuples of tensors with the chain axis first."""
    if isinstance(new, tuple):
        items = [_where(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*items) if hasattr(new, "_fields") else tuple(items)
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _popcount(n: int) -> int:
    """Set bits of a non-negative integer."""
    count = 0
    while n:
        n &= n - 1
        count += 1
    return count


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _uturn(metric, rho, p_start, p_end):
    return (_dot(rho, metric.grad_kinetic(p_start)) <= 0) | (
        _dot(rho, metric.grad_kinetic(p_end)) <= 0
    )


class _Subtree(NamedTuple):
    edge: _Point  # the integration edge, momentum in the true frame
    rho: torch.Tensor  # (C, d) the subtree's momentum sum (true frame)
    prop: tuple  # (x, g, logp) of the subtree's proposal
    log_sum_w: torch.Tensor  # (C,)
    accept_sum: torch.Tensor  # (C,)
    n_leaves: torch.Tensor  # (C,) int64: leapfrogs this subtree cost the chain
    turning: torch.Tensor  # (C,) bool
    diverging: torch.Tensor  # (C,) bool


def _build_subtree(log_u, depth, vg, metric, edge, sign, eps, h0, max_depth, active):
    """Integrate ``2^depth`` leaves from ``edge`` in direction ``sign (C,)``
    in the lanes of ``active``, with the complete aligned-block U-turn
    checks; ``log_u (C, 2^depth)`` are the logs of the leaves' uniforms.
    Momenta are reported in the true (trajectory-time) frame."""
    C, d = edge.x.shape
    sgn = sign[:, None]
    # integrate in a flipped frame, so that the integrator always steps +eps
    cur = edge._replace(p=sgn * edge.p)
    rho = torch.zeros_like(edge.x)
    prop = (edge.x, edge.g, edge.logp)
    log_sum_w = torch.full_like(edge.logp, -torch.inf)
    accept_sum = torch.zeros_like(edge.logp)
    n_leaves = torch.zeros(C, dtype=torch.int64, device=edge.x.device)
    turning = torch.zeros(C, dtype=torch.bool, device=edge.x.device)
    diverging = torch.zeros_like(turning)
    p_ckpt = edge.x.new_zeros((max_depth + 1, C, d))  # momentum checkpoints (true frame)
    rho_ckpt = edge.x.new_zeros((max_depth + 1, C, d))  # rho-prefix checkpoints

    for n in range(1 << depth):
        run = active & ~turning & ~diverging
        if not bool(run.any()):  # the loop condition: one device→host read a leaf
            break
        new = _Point(*leapfrog_step(vg, metric, cur.x, cur.p, cur.g, eps))
        p_true = sgn * new.p
        delta = (new.logp - metric.kinetic_energy(p_true)) - h0
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        div_new = delta < -_MAX_DELTA_H

        # multinomial proposal update within the subtree
        log_sum_new = torch.logaddexp(log_sum_w, delta)
        take = log_u[:, n] < (delta - log_sum_new)
        prop = _where(run & take, (new.x, new.g, new.logp), prop)
        accept_sum = accept_sum + torch.where(
            run, torch.clamp(torch.exp(delta), max=1.0), torch.zeros_like(delta)
        )
        rho_new = rho + p_true

        if n % 2 == 0:  # checkpoint store at even leaves: stack index popcount(n)
            ck = _popcount(n)
            p_ckpt[ck] = _where(run, p_true, p_ckpt[ck])
            rho_ckpt[ck] = _where(run, rho, rho_ckpt[ck])
            turn_new = torch.zeros_like(turning)
        else:
            # U-turn checks at odd leaves over the aligned blocks that end
            # here: block k starts at a = n + 1 − 2^k, its checkpoint at
            # index popcount(a), from idx_max = popcount(n >> 1) down to
            # idx_min (one block per trailing one of n)
            idx_max = _popcount(n >> 1)
            idx_min = idx_max - _popcount(n & ~(n + 1)) + 1
            v_end = metric.grad_kinetic(p_true)
            turn_new = torch.zeros_like(turning)
            for i in range(idx_min, idx_max + 1):
                rho_block = rho_new - rho_ckpt[i]
                turn_new = turn_new | (
                    (_dot(rho_block, metric.grad_kinetic(p_ckpt[i])) <= 0)
                    | (_dot(rho_block, v_end) <= 0)
                )

        cur = _where(run, new, cur)
        rho = _where(run, rho_new, rho)
        log_sum_w = torch.where(run, log_sum_new, log_sum_w)
        n_leaves = n_leaves + run
        turning = torch.where(run, turn_new, turning)
        diverging = torch.where(run, div_new, diverging)

    return _Subtree(
        edge=cur._replace(p=sgn * cur.p), rho=rho, prop=prop, log_sum_w=log_sum_w,
        accept_sum=accept_sum, n_leaves=n_leaves, turning=turning, diverging=diverging,
    )


class _Tree(NamedTuple):
    prop: tuple  # (x, g, logp) the transition's proposal
    depth: torch.Tensor  # (C,) int64
    turning: torch.Tensor
    diverging: torch.Tensor
    accept_sum: torch.Tensor
    n_leaves: torch.Tensor  # (C,) int64


def _nuts_transition(noise, t, vg, metric, pt0: _Point, eps, max_depth):
    """One transition of every chain from ``pt0``: ``(x, logp, g,
    accept_stat, tree)``."""
    C = pt0.x.shape[0]
    dev = pt0.x.device
    h0 = pt0.logp - metric.kinetic_energy(pt0.p)
    left = right = pt0
    rho = pt0.p
    prop = (pt0.x, pt0.g, pt0.logp)
    log_sum_w = torch.zeros_like(pt0.logp)  # the initial point has weight exp(0)
    depth = torch.zeros(C, dtype=torch.int64, device=dev)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    accept_sum = torch.zeros_like(pt0.logp)
    n_leaves = torch.zeros(C, dtype=torch.int64, device=dev)

    go_rights, u_merge, u_leaf = noise.tree(t, max_depth)  # drawn once a transition
    log_u_merge, log_u_leaf = torch.log(u_merge), torch.log(u_leaf)
    for it in range(max_depth):
        active = ~turning & ~diverging  # chains still doubling: all at depth ``it``
        if not bool(active.any()):
            break
        go_right = go_rights[:, it]
        sign = torch.where(go_right, 1.0, -1.0).to(pt0.x.dtype)
        edge = _where(go_right, right, left)
        first = (1 << it) - 1  # the leaves of doubling ``it``
        sub = _build_subtree(log_u_leaf[:, first : 2 * first + 1], it, vg, metric, edge, sign,
                             eps, h0, max_depth, active)

        ok = active & ~sub.turning & ~sub.diverging
        # biased progressive merge (Betancourt 2017)
        take = ok & (log_u_merge[:, it] < (sub.log_sum_w - log_sum_w))
        prop = _where(take, sub.prop, prop)
        log_sum_w = torch.where(ok, torch.logaddexp(log_sum_w, sub.log_sum_w), log_sum_w)
        left = _where(ok & ~go_right, sub.edge, left)
        right = _where(ok & go_right, sub.edge, right)
        rho = _where(ok, rho + sub.rho, rho)
        full_turn = ok & _uturn(metric, rho, left.p, right.p)

        depth = depth + active
        turning = torch.where(active, sub.turning | full_turn, turning)
        diverging = torch.where(active, sub.diverging, diverging)
        accept_sum = accept_sum + sub.accept_sum  # zero in the lanes that did not run
        n_leaves = n_leaves + sub.n_leaves

    accept_stat = accept_sum / torch.clamp(n_leaves, min=1)
    tree = _Tree(prop, depth, turning, diverging, accept_sum, n_leaves)
    return prop[0], prop[2], prop[1], accept_stat, tree


class NUTSResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, d)
    log_densities: torch.Tensor  # (C, num_samples)
    accept_stat: torch.Tensor  # (C, num_samples)
    tree_depths: torch.Tensor  # (C, num_samples)
    diverging: torch.Tensor  # (C, num_samples) bool
    step_size: torch.Tensor  # (C,)
    # (C, d) adapted diagonal M⁻¹ when adapt_mass_matrix=True, else None
    inv_mass_diag: Optional[torch.Tensor] = None
    # exact leapfrog counts per transition. Each leapfrog is one logp+grad
    # evaluation, so these are the sampler's cost ledger (Stan's n_leapfrog__):
    # total evaluations = 1 (the initial point) + sum(warmup_n_leapfrogs)
    # + sum(n_leapfrogs)
    n_leapfrogs: Optional[torch.Tensor] = None  # (C, num_samples) int64
    warmup_n_leapfrogs: Optional[torch.Tensor] = None  # (C, num_warmup) int64


def _warmup_schedule(num_warmup, init_buffer, term_buffer, base_window):
    """Stan's three-phase warm-up schedule as host-side boolean masks:
    ``slow[t]`` marks the steps whose draw feeds the variance estimator,
    ``win_end[t]`` the last step of each expanding adaptation window (window
    sizes double; the last window takes the remainder)."""
    if init_buffer < 0 or term_buffer < 0 or base_window < 1:
        raise ValueError(
            "warmup schedule requires init_buffer >= 0, term_buffer >= 0, "
            f"base_window >= 1; got ({init_buffer}, {term_buffer}, "
            f"{base_window})"
        )
    if num_warmup < init_buffer + term_buffer + base_window:
        # Stan's rescaling for short warm-ups (windowed_adaptation.hpp)
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = max(num_warmup - init_buffer - term_buffer, 1)
    slow = np.zeros(num_warmup, bool)
    win_end = np.zeros(num_warmup, bool)
    lo, hi = init_buffer, num_warmup - term_buffer
    slow[lo:hi] = True
    t, size = lo, base_window
    while t < hi:
        end = t + size
        if end + 2 * size > hi:
            end = hi
        win_end[min(end, hi) - 1] = True
        t, size = end, size * 2
    return slow, win_end


@torch.no_grad()
def nuts(
    seed: int,
    value_and_grad: Callable,
    metric: Optional[WoodburyMetric],
    x0,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 10,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass_matrix: bool = False,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
    *,
    chain_ids=None,
    noise=None,
    device="cuda",
) -> NUTSResult:
    """Run one NUTS chain per row of ``x0 (C, d)`` (a vector ``(d,)`` is one
    chain and gives results without the chain axis), where ``x0`` lives; a
    numpy ``x0`` goes to ``device``. ``chain_ids`` (default ``0..C−1``) name
    the chains' random streams.

    ``metric=None`` starts from the identity metric. With the default
    ``adapt_mass_matrix=False`` the metric stays fixed: the Pathfinder
    warm-start workflow, where the fit covariance *is* the metric. With
    ``adapt_mass_matrix=True`` the warm-up runs Stan's windowed adaptation:
    expanding slow windows accumulate a Welford estimate of each chain's
    posterior variance, each window end replaces the chain's metric by the
    regularized diagonal estimate ``(n/(n+5))·var + 1e-3·(5/(n+5))`` and
    restarts the dual averaging of the step size; the initial metric (e.g.
    the Pathfinder fit) then only seeds the first window."""
    x0, single = sampler_inputs(x0, metric, device)
    check_transitions(num_warmup + num_samples)
    noise = sampler_noise(noise, seed, chain_ids, x0)
    C, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    if metric is None:
        metric = WoodburyMetric.diag(torch.ones(d, dtype=dtype, device=dev))
    logp0, g0 = value_and_grad(x0)
    x, logp, g = x0, logp0, g0
    # dual-averaging state (mu, log_eps, log_eps_bar, h_acc, t), shared with
    # hmc.py; mu is carried so that windowed adaptation can restart the
    # averaging inside the warm-up
    da = da_init(init_step_size, dtype, (C,), dev)

    def transition(t, x, logp, g, metric, eps):
        p = metric.sample_momentum(noise.momentum(t))
        return _nuts_transition(noise, t, value_and_grad, metric, _Point(x, p, g, logp), eps, max_depth)

    if adapt_mass_matrix:
        if not metric.minv.diag_A:
            raise ValueError(
                "adapt_mass_matrix=True requires a diagonal-A metric "
                "(every Pathfinder fit metric is); got a dense A"
            )
        slow, win_end = _warmup_schedule(num_warmup, init_buffer, term_buffer, base_window)
        cnt = 0  # the Welford count is the same for every chain
        mean = torch.zeros_like(x0)
        m2 = torch.zeros_like(x0)
    warmup_n_leapfrogs = torch.zeros((C, num_warmup), dtype=torch.int64, device=dev)
    for t in range(num_warmup):
        x, logp, g, astat, tree = transition(t, x, logp, g, metric, torch.exp(da[1]))
        da = da_update(da, astat, target_accept)
        warmup_n_leapfrogs[:, t] = tree.n_leaves
        if not adapt_mass_matrix:
            continue
        if slow[t]:  # Welford accumulation over the slow window's draws
            cnt += 1
            delta = x - mean
            mean = mean + delta / cnt
            m2 = m2 + delta * (x - mean)
        if win_end[t]:
            # window end: swap in the regularized diagonal estimate, reset
            # the estimator, restart dual averaging at the current step size
            var = m2 / max(cnt - 1.0, 1.0)
            var_reg = (cnt / (cnt + 5.0)) * var + 1e-3 * (5.0 / (cnt + 5.0))
            # no low-rank columns are kept: a zero column adds nothing
            metric = WoodburyMetric.diag(torch.clamp(var_reg, min=1e-10))
            cnt, mean, m2 = 0, torch.zeros_like(x0), torch.zeros_like(x0)
            # restart seeded from the *averaged* log step size, which is
            # stable against the last iteration's noise. Stan re-runs its
            # step-size heuristic against the new metric instead; the
            # averaged value re-adapts within a few iterations.
            zero = torch.zeros_like(da[2])
            da = (np.log(10.0) + da[2], da[2], da[2], zero, zero.clone())
    eps_final = torch.exp(da[2])
    inv_mass_diag = None
    if adapt_mass_matrix:
        inv_mass_diag = metric.minv.diag().expand(C, d)

    xs = x0.new_empty((C, num_samples, d))
    lps = x0.new_empty((C, num_samples))
    astats = x0.new_empty((C, num_samples))
    depths = torch.zeros((C, num_samples), dtype=torch.int64, device=dev)
    divs = torch.zeros((C, num_samples), dtype=torch.bool, device=dev)
    n_lf = torch.zeros((C, num_samples), dtype=torch.int64, device=dev)
    for i in range(num_samples):
        x, logp, g, astat, tree = transition(num_warmup + i, x, logp, g, metric, eps_final)
        xs[:, i], lps[:, i], astats[:, i] = x, logp, astat
        depths[:, i], divs[:, i], n_lf[:, i] = tree.depth, tree.diverging, tree.n_leaves
    # A non-finite starting logp (x0 outside the support, or a NaN gradient)
    # makes every multinomial weight infinite, and the chain would return
    # num_samples copies of x0 with healthy-looking accept_stat = 1. Such a
    # chain's outputs are NaN-poisoned to make the failure visible (the
    # entry points that take several chains validate and raise before this).
    ok0 = torch.isfinite(logp0) & torch.isfinite(g0).all(dim=-1)
    nan = torch.full((), torch.nan, dtype=dtype, device=dev)
    out = NUTSResult(
        samples=torch.where(ok0[:, None, None], xs, nan),
        log_densities=torch.where(ok0[:, None], lps, nan),
        accept_stat=torch.where(ok0[:, None], astats, torch.zeros_like(astats)),
        tree_depths=depths,
        diverging=divs | ~ok0[:, None],
        step_size=eps_final,
        inv_mass_diag=inv_mass_diag,
        n_leapfrogs=n_lf,
        warmup_n_leapfrogs=warmup_n_leapfrogs,
    )
    if single:
        return NUTSResult(*(None if f is None else f[0] for f in out))
    return out


def nuts_chains(
    seed: int,
    value_and_grad: Callable,
    metric: Optional[WoodburyMetric],
    x0s,
    mesh=None,
    **kwargs,
):
    """Run one NUTS chain per row of ``x0s (C, d)``, all in lockstep on one
    device, and return ``(result, summary)``: the chain-stacked
    :class:`NUTSResult` and the :func:`~pathfinder_tpu_torch.utils.
    diagnostics.summarize` dict (mean, sd, ess_bulk, ess_tail, rhat over the
    ``(C, N, d)`` sample stack). Chains that start at a non-finite log
    density or gradient raise here.

    ``mesh`` (``parallel.sharding.paths_mesh``) splits the chains over the
    mesh's first axis, whose width must divide ``C``: each block of chains
    runs on its device from a host thread of its own, with ``chain_ids``
    its own slice of ``0..C−1``, so that no random number moves, and the
    metric copied there (a metric with a chain axis is split with the
    chains). The blocks are gathered, in order, where ``x0s`` lies, and
    summarized there. A block is the unsharded run of its chains, so a
    block of ``c`` chains gives the bits of ``nuts`` on those chains alone
    with the same ``chain_ids``. ``value_and_grad`` must compute where its
    inputs lie, as the zoo's targets do. A mesh with a ``dim`` axis as its
    second (``paths_dim_mesh``) replicates over it, as the JAX package does:
    the chains split over the first axis, each block on that row's first
    device."""
    x0s, single = sampler_inputs(x0s, metric, kwargs.get("device", "cuda"))
    if single:
        raise ValueError("x0s must have shape (C, d): one row per chain")
    C = x0s.shape[0]
    if mesh is not None:
        check_mesh(mesh)
        axis = mesh.axis_names[0]
        n_dev = mesh.shape[axis]
        if C % n_dev != 0:
            raise ValueError(
                f"{C} chains are not divisible over the {n_dev}-wide "
                f"'{axis}' mesh axis; pad x0s or change the chain count."
            )
    # initial-energy validation at the boundary, as Stan does: a chain
    # started at a non-finite logp or gradient would only NaN-poison its
    # outputs (see nuts())
    lp0, g0 = value_and_grad(x0s)
    bad = ~(torch.isfinite(lp0) & torch.isfinite(g0).all(dim=1))
    if bool(bad.any()):
        raise ValueError(
            f"chains {torch.nonzero(bad)[:, 0].tolist()} start at "
            "non-finite log density or gradient; choose in-support x0s"
        )
    if mesh is None:
        out = nuts(seed, value_and_grad, metric, x0s, **kwargs)
    else:
        out = _nuts_blocks(seed, value_and_grad, metric, x0s, mesh, **kwargs)
    return out, summarize(out.samples)


def _nuts_blocks(seed, value_and_grad, metric, x0s, mesh, **kwargs) -> NUTSResult:
    """``nuts`` over the chains of ``x0s``, one block of chains for each
    entry along ``mesh``'s first axis, gathered where ``x0s`` lies."""
    C = x0s.shape[0]
    devices = list(mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0])
    per = C // len(devices)
    ids = kwargs.pop("chain_ids", None)
    ids = torch.arange(C) if ids is None else torch.as_tensor(ids, dtype=torch.int64)

    def block(i, dev):
        lo = i * per
        if metric is None:
            m = None
        elif metric.batched:
            m = tree_map(lambda t: t[lo:lo + per].to(dev), metric)
        else:
            m = tree_map(lambda t: t.to(dev), metric)
        return nuts(seed, value_and_grad, m, x0s[lo:lo + per].to(dev),
                    chain_ids=ids[lo:lo + per].to(dev), **kwargs)

    blocks = run_on_devices(devices, block)
    return NUTSResult(*(
        None if parts[0] is None else torch.cat([t.to(x0s.device) for t in parts])
        for parts in zip(*blocks)
    ))


def warm_start_chains(result, n_chains: int, *, draw_indices=None):
    """``(value_and_grad, metric, x0s)`` for a multi-chain NUTS/HMC warm
    start from a Pathfinder result (initial points + metric), on the device
    the result's tensors live on::

        vg, metric, x0s = warm_start_chains(result, 4)
        out, summary = nuts_chains(seed, vg, metric, x0s, num_warmup=100)

    ``draw_indices`` selects which of the result's draws (PSIS-resampled for
    multipath) start the chains; by default the first ``n_chains``. The
    metric is shared by the chains: the fit covariance (single path) or the
    component of the first selected draw (multipath: no single Woodbury
    matrix represents a mixture; see :meth:`WoodburyMetric.from_result`)."""
    ndraws = result.draws.shape[1]
    if draw_indices is None:
        if n_chains > ndraws:
            raise ValueError(
                f"need {n_chains} chain inits but the result has only "
                f"{ndraws} draws; rerun with more ndraws or pass "
                "draw_indices"
            )
        draw_indices = range(n_chains)
    draw_indices = [int(i) for i in draw_indices]
    if len(draw_indices) != n_chains:
        raise ValueError(
            f"draw_indices has {len(draw_indices)} entries but "
            f"n_chains={n_chains}"
        )
    # every index is checked: a negative one beyond the range would wrap
    # around, and from_result only sees draw_indices[0]
    bad = [i for i in draw_indices if not -ndraws <= i < ndraws]
    if bad:
        raise IndexError(
            f"draw_indices {bad} out of range for a result with "
            f"{ndraws} draws"
        )
    vg = resolve_result_value_and_grad(result)
    metric = WoodburyMetric.from_result(result, draw_indices[0])
    idx = torch.as_tensor(draw_indices, device=result.draws.device)
    x0s = result.draws[:, idx].mT.contiguous()
    return vg, metric, x0s


def nuts_warm_start(
    seed: int,
    result,
    *,
    num_samples: int = 1000,
    num_warmup: int = 500,
    max_depth: int = 10,
    draw_index: int = 0,
    **kwargs,
) -> NUTSResult:
    """NUTS initialized from a Pathfinder result, on the device its tensors
    live on: position = a Pathfinder draw, metric = the fit covariance."""
    vg = resolve_result_value_and_grad(result)
    metric = WoodburyMetric.from_result(result, draw_index)
    x0 = result.draws[:, draw_index]
    return nuts(
        seed, vg, metric, x0,
        num_samples=num_samples, num_warmup=num_warmup, max_depth=max_depth,
        **kwargs,
    )

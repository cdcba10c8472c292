"""The trace and the loop shared by the trajectory optimizers (L-BFGS, CG,
BFGS, Newton), batched over lanes.

The JAX package writes each optimizer as its own ``lax.while_loop`` under
``vmap``; what differs between them is only how a search direction is
formed and what is carried from one iteration to the next. Here the K
paths are a leading axis and the loop is masked: a lane whose own condition
is false keeps its whole state, as a finished lane of JAX's batched
``while_loop`` does, so every lane, its evaluation count included, follows
the path it would follow alone. The stopping and abort rules are the JAX
package's ``minimize_lbfgs_trace``'s. The trace stores the log-density view
(``logp`` and ``∇logp``); the optimizers minimize ``f = −logp``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops.linesearch import resolve_c1, resolve_line_search
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.rows import is_lead, max_rows

__all__ = [
    "OptimizationTrace",
    "advance",
    "minimize_trace",
    "report",
    "running",
    "scale_aware_gtol",
    "should_abort_nonfinite",
    "start_trace",
]


def should_abort_nonfinite(logp_value, grad_logp, fail_on_nonfinite=True):
    """Abort iff ``fail_on_nonfinite`` and (``isnan(logp)`` or
    ``logp == +Inf`` or any gradient entry non-finite); ``logp == −Inf`` does
    not abort."""
    bad = (
        torch.isnan(logp_value)
        | (logp_value == torch.inf)
        | max_rows((~torch.isfinite(grad_logp)).any(dim=-1))
    )
    return bad & fail_on_nonfinite


def scale_aware_gtol(gtol_user, g0, dtype):
    """The user's ``gtol`` floored at 25 eps times ``min(1, |g0|∞)``."""
    floor = 25 * torch.finfo(dtype).eps
    g0_scale = max_rows(g0.abs().amax(dim=-1))
    g0_scale = torch.where(
        torch.isfinite(g0_scale) & (g0_scale > 0), g0_scale,
        torch.ones_like(g0_scale),
    )
    return torch.clamp(floor * torch.clamp(g0_scale, max=1.0), min=gtol_user)


@dataclasses.dataclass(frozen=True)
class OptimizationTrace:
    """Fixed-shape trace, batched over lanes. Index 0 is the initial point;
    entries at index ≥ ``num_valid`` are padding."""

    xs: torch.Tensor  # (K, maxiters+1, d) iterates
    log_densities: torch.Tensor  # (K, maxiters+1) logp values
    gradients: torch.Tensor  # (K, maxiters+1, d) ∇logp
    num_valid: torch.Tensor  # (K,) number of valid points (≥ 1)
    num_bfgs_updates_rejected: torch.Tensor  # (K,)
    num_fn_evals: torch.Tensor  # (K,) value_and_grad evaluations
    num_ls_exhausted: torch.Tensor  # (K,) steps kept by the fallback

    @property
    def point_mask(self) -> torch.Tensor:
        n = self.xs.shape[-2]
        pos = torch.arange(n, device=self.xs.device)
        return pos < self.num_valid[..., None]


def start_trace(value_and_grad: Callable, x0: torch.Tensor, *, maxiters: int, gtol: float,
                ftol: float, fail_on_nonfinite: bool) -> tuple:
    """What every trajectory starts from: ``(neg_vg, f0, g0, gtol_eff,
    init_abort, ftol_rel, (xs, fs, gs))``. ``neg_vg`` is the minimizer's
    view of ``value_and_grad`` in ``x0``'s dtype, ``f0`` and ``g0`` its value
    and gradient at ``x0``, and the trace buffers hold ``x0`` in row 0."""
    K, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    ftol_rel = float(ftol) * float(torch.finfo(dtype).eps) if ftol > 0 else 0.0

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        return (-lp).to(dtype), (-glp).to(dtype)

    f0, g0 = neg_vg(x0)
    gtol_eff = scale_aware_gtol(float(gtol), g0, dtype)
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)

    xs = torch.zeros((K, maxiters + 1, d), dtype=dtype, device=dev)
    fs = torch.zeros((K, maxiters + 1), dtype=dtype, device=dev)
    gs = torch.zeros((K, maxiters + 1, d), dtype=dtype, device=dev)
    xs[:, 0], fs[:, 0], gs[:, 0] = x0, -f0, -g0
    return neg_vg, f0, g0, gtol_eff, init_abort, ftol_rel, (xs, fs, gs)


def running(st: dict, maxiters: int) -> torch.Tensor:
    """The lanes that run the next iteration."""
    return (~st["done"]) & (st["it"] < maxiters)


def report(it_new, logp, wrote, *, every: int, maxiters: int, name: str) -> None:
    """Print the progress line of each lane that ``wrote`` its trace row
    ``it_new`` (a multiple of ``every``), with its ``logp``."""
    shown = wrote & (it_new % every == 0)
    for it_k, lp in zip(it_new[shown].tolist(), logp[shown].tolist()):
        print(f"  {name} iter {it_k}/{maxiters} logp={lp:.4g}")


def advance(st: dict, run, ls, direction, mid, update_fn: Callable, trace: tuple, gtol_eff,
            *, ftol_rel: float, fail_on_nonfinite: bool, progress_every: int, maxiters: int,
            name: str) -> None:
    """One iteration's work after its search ``ls`` along ``direction``, on
    the lanes that ``run``: the trace rows, the stopping and abort rules, and
    the optimizer's ``update_fn``; updates ``st`` and the trace in place."""
    xs, fs, gs = trace
    K = run.shape[0]
    lanes = torch.arange(K, device=run.device)
    it, x, f = st["it"], st["x"], st["f"]
    x_new = x + ls.step_size[:, None] * direction
    f_new, g_new = ls.f, ls.g
    progress = ls.ok
    abort = should_abort_nonfinite(-f_new, -g_new, fail_on_nonfinite)

    it_new = torch.where(progress, it + 1, it)
    # only running lanes that made progress write, each its own next row
    wr = run & progress
    xs[lanes, it_new] = torch.where(wr[:, None], x_new, xs[lanes, it_new])
    fs[lanes, it_new] = torch.where(wr, -f_new, fs[lanes, it_new])
    gs[lanes, it_new] = torch.where(wr[:, None], -g_new, gs[lanes, it_new])
    if progress_every > 0 and is_lead():
        report(it_new, -f_new, wr, every=progress_every, maxiters=maxiters, name=name)

    converged = max_rows(g_new.abs().amax(dim=-1)) <= gtol_eff
    if ftol_rel > 0:
        stalled = progress & ((f - f_new) <= ftol_rel * (f_new.abs() + ftol_rel))
    else:
        stalled = torch.zeros_like(progress)

    new = dict(
        update_fn(st, mid, direction, ls, x_new),
        it=it_new,
        x=torch.where(progress[:, None], x_new, x),
        f=torch.where(progress, f_new, f),
        g=torch.where(progress[:, None], g_new, st["g"]),
        nev=st["nev"] + ls.num_evals,
        nexh=st["nexh"] + (progress & ls.exhausted).long(),
        done=(~progress) | converged | stalled | (progress & abort),
    )
    for k, v in new.items():
        m = run.reshape((K,) + (1,) * (v.ndim - 1))
        st[k] = torch.where(m, v, st[k])


def minimize_trace(
    value_and_grad: Callable,
    x0: torch.Tensor,
    carry: dict,
    direction_fn: Callable,
    update_fn: Callable,
    *,
    maxiters: int,
    gtol: float,
    ftol: float,
    max_ls_evals: int,
    c1: Optional[float],
    c2: float,
    fail_on_nonfinite: bool,
    line_search: str,
    progress_every: int = 0,
    name: str = "L-BFGS",
) -> OptimizationTrace:
    """Maximize ``logp`` from each row of ``x0 (K, d)``, recording every
    trajectory.

    ``carry`` holds the optimizer's own per-lane tensors (leading axis K).
    Each iteration calls ``direction_fn(st, gs) -> (direction, alpha0,
    carry)`` with the state ``st`` (``it``, ``x``, ``f``, ``g`` in the
    minimizer's view, and the carry's entries) and the trace's gradient rows
    ``gs``; it may change the carry before the search. After the line
    search, ``update_fn(st, carry, direction, ls, x_new) -> carry`` gives
    the carry of lanes that ran. A ``nrej`` entry of the carry is reported
    as the trace's ``num_bfgs_updates_rejected``. With ``progress_every > 0``
    each lane that reaches an iteration divisible by it prints
    ``  {name} iter {it}/{maxiters} logp={logp}`` to standard output.
    """
    K = x0.shape[0]
    ls_fn = resolve_line_search(line_search)
    c1 = resolve_c1(c1, line_search)
    neg_vg, f0, g0, gtol_eff, init_abort, ftol_rel, trace = start_trace(
        value_and_grad, x0, maxiters=maxiters, gtol=gtol, ftol=ftol,
        fail_on_nonfinite=fail_on_nonfinite)

    izero = torch.zeros(K, dtype=torch.int64, device=x0.device)
    st = dict(carry, it=izero, x=x0, f=f0, g=g0, nev=izero + 1, nexh=izero, done=init_abort)

    while True:
        run = running(st, maxiters)
        running_any = run.any()
        with tracing.sync("ops/trajectory.py"):
            running_any = bool(running_any)
        if not running_any:
            break
        direction, alpha0, mid = direction_fn(st, trace[2])
        ls = ls_fn(
            neg_vg, st["x"], st["f"], st["g"], direction, alpha0,
            c1=c1, c2=c2, max_evals=max_ls_evals, active=run,
        )
        advance(st, run, ls, direction, mid, update_fn, trace, gtol_eff, ftol_rel=ftol_rel,
                fail_on_nonfinite=fail_on_nonfinite, progress_every=progress_every,
                maxiters=maxiters, name=name)

    xs, fs, gs = trace
    return OptimizationTrace(
        xs=xs,
        log_densities=fs,
        gradients=gs,
        num_valid=st["it"] + 1,
        num_bfgs_updates_rejected=st.get("nrej", izero),
        num_fn_evals=st["nev"],
        num_ls_exhausted=st["nexh"],
    )

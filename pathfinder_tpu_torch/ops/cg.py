"""Nonlinear conjugate gradient with a trajectory trace, batched over lanes
(counterpart of ``pathfinder_tpu/ops/cg.py``).

:func:`minimize_cg_trace` returns the same
:class:`~pathfinder_tpu_torch.ops.lbfgs.OptimizationTrace` as
``minimize_lbfgs_trace``, so the Woodbury fits, the ELBO and the draws run
unchanged on a different optimization algorithm: they depend on the trace
only.

Algorithm: Polak-Ribière+ (β = max(0, gₖ₊₁·(gₖ₊₁−gₖ)/gₖ·gₖ)) with a
steepest-descent restart on non-descent directions (Nocedal & Wright 2006,
Alg. 5.4 and eq. 5.45), sharing the line searches and every stopping and
abort rule with L-BFGS; the masked loop over the K lanes is
``ops/trajectory.py``'s. In a row group (the mesh's ``dim`` axis) each
member holds its rows of every vector, and each inner product over ``d`` is
summed over the members (``utils/rows.sum_rows``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops.linesearch import initial_step_size
from pathfinder_tpu_torch.ops.trajectory import OptimizationTrace, minimize_trace
from pathfinder_tpu_torch.utils.rows import sum_rows

__all__ = ["minimize_cg_trace"]


def minimize_cg_trace(
    value_and_grad: Callable,
    x0: torch.Tensor,
    maxiters: int = 1000,
    history_length: int = 6,  # unused; the optimizers share one signature
    gtol: float = 1e-8,
    ftol: float = 10.0,
    epsilon_curvature: float = 1e-12,  # unused; the optimizers share one signature
    max_ls_evals: int = 12,
    c1: Optional[float] = None,
    c2: float = 0.9,
    fail_on_nonfinite: bool = True,
    line_search: str = "hager_zhang",
    progress_every: int = 0,
) -> OptimizationTrace:
    """Maximize ``logp`` from each row of ``x0 (K, d)`` with PR+ nonlinear
    CG, recording every trajectory.

    Contract, conventions and stopping rules are those of
    :func:`~pathfinder_tpu_torch.ops.lbfgs.minimize_lbfgs_trace`.
    ``num_bfgs_updates_rejected`` of the trace is 0: CG keeps no curvature
    pairs, and the fit stage derives its own guarded history from the trace.
    """
    K, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    lanes = torch.arange(K, device=dev)
    carry = dict(
        p=torch.zeros((K, d), dtype=dtype, device=dev),  # previous direction
        dphi0_prev=torch.zeros(K, dtype=dtype, device=dev),  # gᵀp at the previous step
        step_prev=torch.ones(K, dtype=dtype, device=dev),  # previous accepted step
    )

    def direction_fn(st, gs):
        it, g = st["it"], st["g"]
        # PR+ β against the gradient at the previous iterate (trace row
        # it−1, minimizer view); at it == 0 the β term is unused
        g_prev = -gs[lanes, torch.clamp(it - 1, min=0)]
        gg_prev, g_dg, gg = sum_rows(torch.sum(g_prev * g_prev, dim=-1),
                                     torch.sum(g * (g - g_prev), dim=-1),
                                     torch.sum(g * g, dim=-1))
        beta = g_dg / torch.where(gg_prev > 0, gg_prev, torch.ones_like(gg_prev))
        beta = torch.clamp(beta, min=0.0)
        first = it == 0
        direction = torch.where(first[:, None], -g, -g + beta[:, None] * st["p"])
        dphi0 = sum_rows(torch.sum(g * direction, dim=-1))
        # restart with steepest descent when not a descent direction
        bad_dir = ~(dphi0 < 0)
        direction = torch.where(bad_dir[:, None], -g, direction)
        dphi0 = torch.where(bad_dir, -gg, dphi0)

        # initial trial step: the shared heuristic at first, then the slope
        # carried across iterations (α₀ = α_{k−1}·dφ₀_{k−1}/dφ₀, N&W eq. 3.60),
        # clipped for safety
        a0_carry = st["step_prev"] * st["dphi0_prev"] / torch.where(
            dphi0 < 0, dphi0, -torch.ones_like(dphi0)
        )
        a0_carry = torch.clamp(a0_carry, 1e-8, 1e4)
        a0_carry = torch.where(torch.isfinite(a0_carry), a0_carry, torch.ones_like(a0_carry))
        alpha0 = torch.where(first, initial_step_size(st["x"], st["f"], g), a0_carry)
        return direction, alpha0, dphi0

    def update_fn(st, dphi0, direction, ls, x_new):
        progress = ls.ok
        return dict(
            p=torch.where(progress[:, None], direction, st["p"]),
            dphi0_prev=torch.where(progress, dphi0, st["dphi0_prev"]),
            step_prev=torch.where(progress, ls.step_size, st["step_prev"]),
        )

    return minimize_trace(
        value_and_grad, x0, carry, direction_fn, update_fn,
        maxiters=maxiters, gtol=gtol, ftol=ftol, max_ls_evals=max_ls_evals,
        c1=c1, c2=c2, fail_on_nonfinite=fail_on_nonfinite, line_search=line_search,
        progress_every=progress_every, name="CG",
    )

"""Dense BFGS with a trajectory trace, batched over lanes (counterpart of
``pathfinder_tpu/ops/bfgs.py``).

Classical BFGS (Nocedal & Wright 2006, Alg. 6.1 with the eq. 6.17
inverse-Hessian update): the optimizer carries a dense ``(d, d)`` estimate
per lane and discards it at the end. Only the trajectory is returned; the
fit stage rebuilds limited-memory inverse Hessians from it, whatever
optimizer produced it. O(d²) memory and operations per lane and iteration,
so it is for moderate d; L-BFGS stays the default. The masked loop over the
K lanes is ``ops/trajectory.py``'s.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops.linesearch import initial_step_size
from pathfinder_tpu_torch.ops.trajectory import OptimizationTrace, minimize_trace

__all__ = ["minimize_bfgs_trace"]


def minimize_bfgs_trace(
    value_and_grad: Callable,
    x0: torch.Tensor,
    maxiters: int = 1000,
    history_length: int = 6,  # unused; the optimizers share one signature
    gtol: float = 1e-8,
    ftol: float = 10.0,
    epsilon_curvature: float = 1e-12,
    max_ls_evals: int = 12,
    c1: Optional[float] = None,
    c2: float = 0.9,
    fail_on_nonfinite: bool = True,
    line_search: str = "hager_zhang",
    progress_every: int = 0,
) -> OptimizationTrace:
    """Maximize ``logp`` from each row of ``x0 (K, d)`` with dense
    inverse-Hessian BFGS, recording every trajectory.

    Contract, conventions and stopping rules are those of
    :func:`~pathfinder_tpu_torch.ops.lbfgs.minimize_lbfgs_trace`.
    ``num_bfgs_updates_rejected`` counts the curvature-rejected updates of
    H, the event the L-BFGS optimizer counts.
    """
    K, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    eps_curv = float(epsilon_curvature)
    eye = torch.eye(d, dtype=dtype, device=dev)
    izero = torch.zeros(K, dtype=torch.int64, device=dev)
    carry = dict(
        H=eye.expand(K, d, d).clone(),  # inverse-Hessian estimate
        n_updates=izero,  # accepted updates since H was last the identity
        nrej=izero,
    )

    def direction_fn(st, gs):
        g = st["g"]
        direction = -(st["H"] @ g[..., None])[..., 0]
        dphi0 = torch.sum(g * direction, dim=-1)
        # rounding can cost H its positive definiteness: restart with
        # steepest descent from a fresh identity, and reset the update
        # count so that the next accepted pair applies the eq. 6.20 scale
        # again (an unscaled identity after a restart would put the unit
        # step orders of magnitude off on badly scaled targets)
        bad_dir = ~(dphi0 < 0)
        direction = torch.where(bad_dir[:, None], -g, direction)
        H = torch.where(bad_dir[:, None, None], eye, st["H"])
        n_upd = torch.where(bad_dir, 0, st["n_updates"])
        # first iteration: the shared step heuristic; afterwards the natural
        # step 1, whose scale H carries
        alpha0 = torch.where(
            st["it"] == 0, initial_step_size(st["x"], st["f"], g), torch.ones_like(st["f"])
        )
        return direction, alpha0, (H, n_upd)

    def update_fn(st, mid, direction, ls, x_new):
        H, n_upd = mid
        progress = ls.ok
        # curvature-guarded update (N&W eq. 6.17) under the literal
        # `s·y > eps·|y|²` rule of the L-BFGS history, so the rejection
        # count agrees with the fit stage's on the same trajectory. The rule
        # is NaN/inf-safe as it is: sy = NaN compares False, and sy = +inf
        # forces yy = +inf (inf > inf is False).
        sv = x_new - st["x"]
        yv = ls.g - st["g"]
        sy = torch.sum(sv * yv, dim=-1)
        yy = torch.sum(yv * yv, dim=-1)
        accept = progress & (sy > eps_curv * yy)
        # N&W eq. 6.20: the first H (after the start or a restart) is scaled
        # to (s·y / y·y) I before the update
        gamma = torch.where(yy > 0, sy / yy, torch.ones_like(sy))
        H_base = torch.where(
            (accept & (n_upd == 0))[:, None, None], gamma[:, None, None] * eye, H
        )
        rho = torch.where(sy > 0, 1.0 / sy, torch.zeros_like(sy))[:, None, None]
        Hy = (H_base @ yv[..., None])[..., 0]
        yHy = torch.sum(yv * Hy, dim=-1)[:, None, None]
        s_Hy = sv[:, :, None] * Hy[:, None, :]
        H_upd = (
            H_base
            - rho * (s_Hy + s_Hy.mT)
            + (rho * rho * yHy + rho) * (sv[:, :, None] * sv[:, None, :])
        )
        H_new = torch.where(accept[:, None, None], H_upd, H)
        return dict(
            H=torch.where(progress[:, None, None], H_new, st["H"]),
            n_updates=n_upd + accept.long(),
            nrej=st["nrej"] + (progress & ~accept).long(),
        )

    return minimize_trace(
        value_and_grad, x0, carry, direction_fn, update_fn,
        maxiters=maxiters, gtol=gtol, ftol=ftol, max_ls_evals=max_ls_evals,
        c1=c1, c2=c2, fail_on_nonfinite=fail_on_nonfinite, line_search=line_search,
        progress_every=progress_every, name="BFGS",
    )

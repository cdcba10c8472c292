"""Modified Newton with a trajectory trace, batched over lanes (counterpart
of ``pathfinder_tpu/ops/newton.py``).

The one optimizer that consumes the order-2 capability of the target
protocol (``LogDensity.hess``, else ``torch.func``'s Hessian). Each
iteration eigendecomposes the minimizer-view Hessian and takes the
saddle-free step (N&W §3.4, Dauphin et al. 2014)

    p = −V diag(1/max(|λ|, δ)) Vᵀ g,   δ = √eps · max(1, max|λ|)

which is a descent direction whatever the Hessian's signature; a line
search then guarantees progress. O(d³) per lane and iteration: for the
moderate-d regime where curvature is affordable. The masked loop over the K
lanes is ``ops/trajectory.py``'s.

In a row group (the mesh's ``dim`` axis) the loop runs on each member's
rows, but the Hessian, its ``eigh`` and the direction run whole on the
lead (``utils/rows.run_on_lead``), with the whole target's ``hess``, and
each member takes its rows of the direction: a dense ``eigh`` has no row
split in the port, as the target has none.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops.trajectory import OptimizationTrace, minimize_trace
from pathfinder_tpu_torch.utils.rows import run_on_lead

__all__ = ["minimize_newton_trace"]


def minimize_newton_trace(
    value_and_grad: Callable,
    x0: torch.Tensor,
    hess: Optional[Callable] = None,
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
    """Maximize ``logp`` from each row of ``x0 (K, d)`` with modified
    Newton, recording every trajectory.

    ``hess(x (K, d)) -> (K, d, d)`` is the Hessian of **logp**, of the full
    rows also in a row group; required (the registry passes
    ``LogDensity.hess`` or a ``torch.func`` Hessian).
    Contract, conventions and stopping rules are those of the other
    trajectory optimizers; ``num_bfgs_updates_rejected`` is 0.
    """
    if hess is None:
        raise ValueError(
            "minimize_newton_trace requires hess (the optimizer registry passes "
            "LogDensity.hess or a torch.func Hessian)"
        )
    dtype = x0.dtype
    sqrt_eps = math.sqrt(float(torch.finfo(dtype).eps))

    def whole_direction(x, g):
        H_min = (-hess(x)).to(dtype)
        H_min = 0.5 * (H_min + H_min.mT)  # eigh wants exact symmetry
        # a non-finite Hessian has no spectrum (and makes eigh raise): that
        # lane takes steepest descent for this step
        finite = torch.isfinite(H_min).all(dim=(-2, -1))
        w, V = torch.linalg.eigh(torch.where(finite[:, None, None], H_min, 0.0))
        # saddle-free spectrum: |λ| floored at δ. Clamping λ → max(λ, δ)
        # would amplify negative-curvature components by 1/δ, a step the
        # bounded line search cannot recover from; |λ| keeps every step
        # O(1/|λ|) and still turns negative curvature into descent.
        wmax = w.abs().amax(dim=-1, keepdim=True)
        delta = sqrt_eps * torch.clamp(wmax, min=1.0)
        w_mod = torch.maximum(w.abs(), delta)
        direction = -(V @ ((V.mT @ g[..., None])[..., 0] / w_mod)[..., None])[..., 0]
        dir_ok = finite & torch.isfinite(direction).all(dim=-1)
        direction = torch.where(dir_ok[:, None], direction, -g)
        bad_dir = ~(torch.sum(g * direction, dim=-1) < 0)
        return torch.where(bad_dir[:, None], -g, direction)

    def direction_fn(st, gs):
        # Newton's natural step: alpha0 = 1 from the first iteration
        return run_on_lead(whole_direction, st["x"], st["g"]), torch.ones_like(st["f"]), None

    return minimize_trace(
        value_and_grad, x0, {}, direction_fn, lambda st, mid, direction, ls, x_new: {},
        maxiters=maxiters, gtol=gtol, ftol=ftol, max_ls_evals=max_ls_evals,
        c1=c1, c2=c2, fail_on_nonfinite=fail_on_nonfinite, line_search=line_search,
        progress_every=progress_every, name="Newton",
    )

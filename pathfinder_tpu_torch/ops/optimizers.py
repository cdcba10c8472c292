"""Trajectory-optimizer registry: named built-ins and user callables
(counterpart of ``pathfinder_tpu/ops/optimizers.py``).

A trajectory optimizer is any callable with the **trace contract**

    minimize(value_and_grad, x0, *, maxiters, history_length, gtol, ftol,
             epsilon_curvature, max_ls_evals, c1, c2, fail_on_nonfinite,
             line_search[, progress_every]) -> OptimizationTrace

(see :func:`pathfinder_tpu_torch.ops.lbfgs.minimize_lbfgs_trace` for every
argument and for the fixed-shape trace; ``value_and_grad`` takes a batch
``x (K, d)`` and returns ``(logp, ∇logp)`` in the maximization view, and the
trace records logp-view values). The fit, ELBO and draw stages read only the
trace, so anything that keeps the contract plugs into ``optimizer=`` of both
entry points. A custom optimizer may accept and ignore arguments it has no use
for, as CG does with ``history_length``. ``progress_every`` is passed only
when ``PathfinderConfig.progress_every`` is above 0.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Union

from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace

__all__ = ["OPTIMIZERS", "resolve_optimizer", "NEWTON_DENSE_DIM_WARN"]

# Above this dimension whatever materializes dense (d, d) Hessians (the
# Newton optimizer, the Laplace correction) warns: O(d²) memory per lane and,
# with an eigendecomposition, O(d³) operations.
NEWTON_DENSE_DIM_WARN = 2000


def _lbfgs(target, dim):
    return minimize_lbfgs_trace


def _cg(target, dim):
    from pathfinder_tpu_torch.ops.cg import minimize_cg_trace

    return minimize_cg_trace


def _bfgs(target, dim):
    from pathfinder_tpu_torch.ops.bfgs import minimize_bfgs_trace

    return minimize_bfgs_trace


def _newton(target, dim):
    from pathfinder_tpu_torch.models.protocol import batched_hessian
    from pathfinder_tpu_torch.ops.newton import minimize_newton_trace

    user_hess = getattr(target, "hess", None)
    hess_fn = user_hess if user_hess is not None else batched_hessian(target.logp)
    if dim is not None and dim > NEWTON_DENSE_DIM_WARN:
        how = (
            "derives the Hessian with torch.func.hessian (d forward-over-reverse "
            "passes per iteration)"
            if user_hess is None
            else "calls your hess="
        )
        warnings.warn(
            f"optimizer='newton' at d={dim} {how} and materializes a "
            f"(d, d)={dim}x{dim} matrix plus one dense eigh (O(d^3)) per "
            "iteration — expect high memory and long iterations above "
            f"d~{NEWTON_DENSE_DIM_WARN}. Consider optimizer='lbfgs' or "
            "'cg' (O(d) per iteration) at this scale."
        )
    return functools.partial(minimize_newton_trace, hess=hess_fn)


# name -> factory(target, dim) -> minimize callable. A factory may inspect
# the target (newton wires the order-2 capability) and warn about scale.
OPTIMIZERS = {
    "lbfgs": _lbfgs,
    "cg": _cg,
    "bfgs": _bfgs,
    "newton": _newton,
}


def resolve_optimizer(optimizer: Union[str, Callable], target, dim=None) -> Callable:
    """Resolve ``PathfinderConfig.optimizer`` to a minimize callable.

    Strings look up the registry (``'auto'`` is handled a level up, in
    ``multipathfinder``: a single path has no k̂ to select by); callables
    pass through untouched.
    """
    if isinstance(optimizer, str):
        if optimizer == "auto":
            raise ValueError(
                "optimizer='auto' is a multipathfinder feature (it selects "
                "by the multipath Pareto-k̂ diagnostic); a single path has "
                "no selection signal — pick one of "
                f"{tuple(OPTIMIZERS)} or pass a callable"
            )
        factory = OPTIMIZERS.get(optimizer)
        if factory is None:
            raise ValueError(
                f"unknown optimizer {optimizer!r}; choose from "
                f"{tuple(OPTIMIZERS)} or pass a callable with the "
                "minimize_*_trace contract (see "
                "pathfinder_tpu_torch.ops.optimizers)"
            )
        return factory(target, dim)
    if callable(optimizer):
        return optimizer
    raise TypeError(
        f"optimizer must be a registered name {tuple(OPTIMIZERS)} or a "
        f"callable with the minimize_*_trace contract; got "
        f"{type(optimizer).__name__}"
    )

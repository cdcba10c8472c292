"""Target log-density protocol (counterpart of ``pathfinder_tpu/models/protocol.py``).

A target's ``logp`` takes a batch ``x`` of shape ``(K, d)`` and returns
``(K,)``. Gradients come from ``torch.autograd.grad(logp(x).sum(), x)``:
lanes are independent, so the gradient of the sum is each lane's own.
Hessians, ``hess(x (K, d)) -> (K, d, d)``, are the order-2 capability: a
target may bring its own, else :func:`batched_hessian` derives one with
``torch.func``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = [
    "LogDensity",
    "as_log_density",
    "autograd_value_and_grad",
    "batched_hessian",
]


def autograd_value_and_grad(logp: Callable) -> Callable:
    """``x (K, d) -> (logp (K,), ∇logp (K, d))`` by reverse-mode autograd."""

    def value_and_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            lp = logp(xr)
            (g,) = torch.autograd.grad(lp.sum(), xr)
        return lp.detach(), g

    return value_and_grad


def batched_hessian(logp: Callable) -> Callable:
    """``x (K, d) -> (K, d, d)``: the Hessian of ``logp`` at every row, by
    ``torch.func.hessian`` (forward over reverse) under ``torch.func.vmap``.
    ``logp`` is called on one row as a batch of one, so it must be free of
    in-place updates and of ``.item()``. The derived function is kept on
    ``logp`` itself, as the JAX package's ``cached_hessian`` is."""
    h = getattr(logp, "_pf_cached_hess", None)
    if h is None:
        one = torch.func.hessian(lambda x: logp(x[None])[0])
        h = torch.func.vmap(one)
        try:
            logp._pf_cached_hess = h
        except (AttributeError, TypeError):
            pass  # no __dict__ (a functools.partial): not kept
    return h


@dataclasses.dataclass(frozen=True)
class LogDensity:
    """A target distribution over ``(dim,)`` vectors, evaluated in batches.

    ``value_and_grad(x)`` returns ``(logp(x), ∇logp(x))`` for ``x (K, d)``;
    when absent it is derived with autograd. ``hess`` (optional,
    ``x (K, d) -> (K, d, d)``, the Hessian of logp) is used by
    ``optimizer="newton"`` and by the Laplace correction; absent, they
    derive it with :func:`batched_hessian`.
    """

    logp: Callable
    dim: Optional[int] = None
    value_and_grad: Optional[Callable] = None
    hess: Optional[Callable] = None

    def __post_init__(self):
        if self.value_and_grad is None:
            object.__setattr__(
                self, "value_and_grad", autograd_value_and_grad(self.logp)
            )

    def with_dim(self, dim) -> "LogDensity":
        return dataclasses.replace(self, dim=dim)


def as_log_density(fn, dim=None, grad=None, hess=None) -> LogDensity:
    """Coerce user input into a :class:`LogDensity`: a ``LogDensity``, any
    object with ``logp`` and ``dim`` attributes (and optionally
    ``value_and_grad`` or ``logp_and_grad``, and ``hess``), or a plain
    batched callable ``logp(x (K, d))``. ``grad``, ``x (K, d) -> (K, d)``,
    is the user's own gradient and replaces autograd where the input brings
    no ``value_and_grad``. An explicit ``hess`` wins over the object's own."""
    if isinstance(fn, LogDensity):
        if hess is not None and fn.hess is not hess:
            fn = dataclasses.replace(fn, hess=hess)
        if dim is not None and fn.dim is None:
            return fn.with_dim(dim)
        return fn
    if hasattr(fn, "logp"):
        d = fn.dim if getattr(fn, "dim", None) is not None else dim
        vg = getattr(fn, "value_and_grad", None) or getattr(fn, "logp_and_grad", None)
        if vg is None and grad is not None:
            vg = _vg_from_parts(fn.logp, grad)
        h = hess if hess is not None else getattr(fn, "hess", None)
        return LogDensity(logp=fn.logp, dim=d, value_and_grad=vg, hess=h)
    if callable(fn):
        vg = _vg_from_parts(fn, grad) if grad is not None else None
        return LogDensity(logp=fn, dim=dim, value_and_grad=vg, hess=hess)
    raise TypeError(f"cannot interpret {type(fn)!r} as a log density")


def _vg_from_parts(logp: Callable, grad: Callable) -> Callable:
    """``value_and_grad`` from a log density and the user's gradient of it,
    both batched."""

    def value_and_grad(x):
        return logp(x), grad(x)

    return value_and_grad

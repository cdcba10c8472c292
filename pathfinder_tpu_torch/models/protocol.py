"""Target log-density protocol (counterpart of ``pathfinder_tpu/models/protocol.py``).

A target's ``logp`` takes a batch ``x`` of shape ``(K, d)`` and returns
``(K,)``. Gradients come from ``torch.autograd.grad(logp(x).sum(), x)``:
lanes are independent, so the gradient of the sum is each lane's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["LogDensity", "as_log_density", "autograd_value_and_grad"]


def autograd_value_and_grad(logp: Callable) -> Callable:
    """``x (K, d) -> (logp (K,), ∇logp (K, d))`` by reverse-mode autograd."""

    def value_and_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            lp = logp(xr)
            (g,) = torch.autograd.grad(lp.sum(), xr)
        return lp.detach(), g

    return value_and_grad


@dataclasses.dataclass(frozen=True)
class LogDensity:
    """A target distribution over ``(dim,)`` vectors, evaluated in batches.

    ``value_and_grad(x)`` returns ``(logp(x), ∇logp(x))`` for ``x (K, d)``;
    when absent it is derived with autograd.
    """

    logp: Callable
    dim: Optional[int] = None
    value_and_grad: Optional[Callable] = None

    def __post_init__(self):
        if self.value_and_grad is None:
            object.__setattr__(
                self, "value_and_grad", autograd_value_and_grad(self.logp)
            )

    def with_dim(self, dim) -> "LogDensity":
        return dataclasses.replace(self, dim=dim)


def as_log_density(fn, dim=None) -> LogDensity:
    """Coerce user input into a :class:`LogDensity`: a ``LogDensity``, any
    object with ``logp`` and ``dim`` attributes (and optionally
    ``value_and_grad``), or a plain batched callable ``logp(x (K, d))``."""
    if isinstance(fn, LogDensity):
        if dim is not None and fn.dim is None:
            return fn.with_dim(dim)
        return fn
    if hasattr(fn, "logp"):
        d = fn.dim if getattr(fn, "dim", None) is not None else dim
        vg = getattr(fn, "value_and_grad", None)
        return LogDensity(logp=fn.logp, dim=d, value_and_grad=vg)
    if callable(fn):
        return LogDensity(logp=fn, dim=dim)
    raise TypeError(f"cannot interpret {type(fn)!r} as a log density")

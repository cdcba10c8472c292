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
    "from_pytree_logp",
    "PytreeTarget",
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
    ``logp`` itself, as the JAX package's ``cached_hessian`` is. It works on
    a copy of ``x``, so that a view (a block of a larger batch) costs no more
    than its own rows."""
    h = getattr(logp, "_pf_cached_hess", None)
    if h is None:
        rows = torch.func.vmap(torch.func.hessian(lambda x: logp(x[None])[0]))

        def h(x):
            # forward mode gives a view a tangent the size of its whole base:
            # a block of a batch of K rows would cost K·d values for each of
            # the d basis directions
            return rows(x.clone())

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


def _flatten(tree, leaves: list):
    """Append the leaves of a dict / tuple / list tree to ``leaves`` in the
    JAX package's order (a dict by sorted key) and return its structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [_flatten(tree[k], leaves) for k in keys])
    if isinstance(tree, (tuple, list)):
        return (type(tree), None, [_flatten(v, leaves) for v in tree])
    leaf = torch.as_tensor(tree)
    leaves.append(leaf)
    return ("leaf", tuple(leaf.shape), None)


def _unflatten(struct, x: torch.Tensor, at: list):
    """The tree of ``struct`` over consecutive slices of the last axis of
    ``x``; every leaf keeps ``x``'s leading axes."""
    kind, info, children = struct
    if kind == "leaf":
        n = 1
        for s in info:
            n *= s
        out = x[..., at[0]:at[0] + n].reshape(x.shape[:-1] + info)
        at[0] += n
        return out
    vals = [_unflatten(c, x, at) for c in children]
    return dict(zip(info, vals)) if kind == "dict" else kind(vals)


def from_pytree_logp(logp_tree: Callable, example_params) -> "PytreeTarget":
    """A flat-vector target from a log density over a parameter tree (dicts,
    tuples and lists of tensors), the idiom of PPL-style models.

    ``logp_tree(params)`` takes a tree shaped like ``example_params`` whose
    leaves carry a leading batch axis, ``(K, *shape)``, and returns
    ``(K,)``. Leaves are laid out in the JAX package's ``ravel_pytree``
    order (a dict by sorted key), so a flat vector means the same parameters
    in both packages. Returns a :class:`PytreeTarget`: its ``.target`` is a
    :class:`LogDensity` for ``pathfinder``/``multipathfinder``, and
    ``ravel``/``unravel`` move between the two views."""
    leaves: list = []
    struct = _flatten(example_params, leaves)
    flat0 = torch.cat([leaf.reshape(-1) for leaf in leaves]) if leaves else torch.zeros(0)

    def unravel(x):
        return _unflatten(struct, x, [0])

    def logp(x):
        return logp_tree(unravel(x))

    return PytreeTarget(LogDensity(logp=logp, dim=int(flat0.shape[0])), unravel, flat0)


@dataclasses.dataclass(frozen=True)
class PytreeTarget:
    """The flat-vector view of a tree-parameterized log density.
    ``unravel(x (..., dim))`` gives the tree with ``x``'s leading axes on
    every leaf, in ``x``'s dtype."""

    target: LogDensity
    unravel: Callable
    example_flat: torch.Tensor

    def ravel(self, params) -> torch.Tensor:
        """The flat ``(dim,)`` vector of an (unbatched) parameter tree."""
        leaves: list = []
        _flatten(params, leaves)
        return torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel_draws(self, draws: torch.Tensor):
        """A ``(dim, ndraws)`` draw matrix as a tree with a leading draws
        axis on every leaf."""
        return self.unravel(draws.mT)

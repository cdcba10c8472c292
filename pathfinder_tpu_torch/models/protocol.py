"""Target log-density protocol (counterpart of ``pathfinder_tpu/models/protocol.py``).

A target's ``logp`` takes a batch ``x`` of shape ``(K, d)`` and returns
``(K,)``. Gradients come from ``torch.autograd.grad(logp(x).sum(), x)``:
lanes are independent, so the gradient of the sum is each lane's own.
Hessians, ``hess(x (K, d)) -> (K, d, d)``, are the order-2 capability: a
target may bring its own, else :func:`batched_hessian` derives one with
``torch.func``.

Every batched evaluation the core makes goes through :func:`bounded_target`:
a batch of ``P`` points is handed to the target in blocks of at most ``B``
points, in order, and the results are joined. ``B`` is the caller's
(``target_points``), or on a CUDA device learned from the target itself
(:func:`target_bound`): its device bytes a point, measured once per target,
kind of evaluation, dtype and device (:func:`point_bytes`), and the most
points whose bytes fit in ``TARGET_SHARE`` of the card's total memory.
Where ``P ≤ B`` the target is called as it is.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading
from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.utils import tracing

__all__ = [
    "LogDensity",
    "as_log_density",
    "autograd_value_and_grad",
    "batched_hessian",
    "bounded_target",
    "point_bytes",
    "target_bound",
    "TARGET_SHARE",
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


_HESSIAN_LOCK = threading.Lock()


def batched_hessian(logp: Callable) -> Callable:
    """``x (K, d) -> (K, d, d)``: the Hessian of ``logp`` at every row, by
    ``torch.func.hessian`` (forward over reverse) under ``torch.func.vmap``.
    ``logp`` is called on one row as a batch of one, so it must be free of
    in-place updates and of ``.item()``. The derived function is kept on
    ``logp`` itself, as the JAX package's ``cached_hessian`` is. It works on
    a copy of ``x``, so that a view (a block of a larger batch) costs no more
    than its own rows. Calls from several host threads (a mesh's blocks) run
    one at a time: torch's forward-mode levels are global to the process,
    and two threads' forward passes at once invalidate each other's."""
    h = getattr(logp, "_pf_cached_hess", None)
    if h is None:
        rows = torch.func.vmap(torch.func.hessian(lambda x: logp(x[None])[0]))

        def h(x):
            # forward mode gives a view a tangent the size of its whole base:
            # a block of a batch of K rows would cost K·d values for each of
            # the d basis directions
            with _HESSIAN_LOCK:
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


# Of a card's total memory: what one bounded evaluation of the target may
# take (its temporaries, and autograd's graph for a gradient). The memory
# rule (``parallel/sharding.plan_launches``) plans a launch's lanes beside
# it in ``LAUNCH_SHARE`` (half) of the card. The total, not the free memory,
# so that the blocks, and with them a result's last bits, are the same on a
# card whatever else holds memory there.
TARGET_SHARE = 0.25
PROBE_POINTS = 16  # the points of the probe that measures a target's bytes a point
_PROBE_LOCK = threading.Lock()


def _owner(fn: Callable):
    """Where a target's learned figures are kept: a bound method's object,
    else the function itself."""
    return fn.__self__ if inspect.ismethod(fn) else fn


def _rise(fn: Callable, x: torch.Tensor) -> int:
    """The rise of ``torch.cuda.max_memory_allocated`` over the memory
    allocated before ``fn(x)``, its result included."""
    base = torch.cuda.memory_allocated(x.device)
    torch.cuda.reset_peak_memory_stats(x.device)
    out = fn(x)
    rise = torch.cuda.max_memory_allocated(x.device) - base
    del out
    return rise


def point_bytes(target: "LogDensity", kind: str, x: torch.Tensor) -> int:
    """The device bytes one point costs ``target``'s ``kind`` of evaluation
    (``"logp"`` or ``"value_and_grad"``) at its peak, on ``x``'s dtype and
    CUDA device, rounded up. Learned once from ``x``'s rows (repeated to
    ``2·PROBE_POINTS``): a first call at ``PROBE_POINTS`` points takes the
    target's fixed costs (data moved to the card, a library's workspace),
    then the rise of the peak over the memory allocated before a call is
    read at ``PROBE_POINTS`` and at twice as many points, and their
    difference is divided by ``PROBE_POINTS``, so a fixed cost of a call
    cancels. The probe's results are dropped; it resets the device's
    peak-memory statistic. The figure is kept on the target's ``logp`` (a
    bound method's object), as ``batched_hessian`` keeps its Hessian, for
    every later call with that target."""
    owner = _owner(target.logp)
    key = (kind, x.dtype, x.device)
    cache = getattr(owner, "_pf_point_bytes", None)
    if cache is not None and key in cache:
        return cache[key]
    fn = target.logp if kind == "logp" else target.value_and_grad
    n = PROBE_POINTS
    probe = x[torch.arange(2 * n, device=x.device) % x.shape[0]]
    with _PROBE_LOCK:
        fn(probe[:n])  # the target's fixed costs, kept out of the two rises
        one, two = _rise(fn, probe[:n]), _rise(fn, probe)
    per = max(1, -(-(two - one) // n))
    try:
        owner.__dict__.setdefault("_pf_point_bytes", {})[key] = per
    except AttributeError:
        pass  # no __dict__ (a functools.partial, a builtin): learned at each call
    return per


def target_bound(target: "LogDensity", kind: str, x: torch.Tensor,
                 points: Optional[int] = None) -> Optional[int]:
    """The most points one evaluation of ``target``'s ``kind`` is handed at
    ``x``'s dtype and device: ``points`` where given; else, on a CUDA
    device, the most whose bytes (:func:`point_bytes`) fit in
    ``TARGET_SHARE`` of the card's total memory, never fewer than one; else
    None, no bound."""
    if points is not None:
        return points
    if x.device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(x.device).total_memory
    return max(1, int(TARGET_SHARE * total) // point_bytes(target, kind, x))


def _bounded(target: "LogDensity", kind: str, points: Optional[int]) -> Callable:
    """``target``'s ``kind`` of evaluation, handed at most ``points`` points
    at a time (learned on a CUDA device where ``points`` is None)."""
    fn = target.logp if kind == "logp" else target.value_and_grad

    def evaluate(x: torch.Tensor):
        P = x.shape[0]
        key = tracing.current_call()
        tracing.count(tracing.TARGET_POINTS, P, key)
        # one point is never split (a Hessian's rows under torch.func)
        B = None if P <= 1 else target_bound(target, kind, x, points)
        if B is None or P <= B:
            return fn(x)
        tracing.count(tracing.TARGET_SPLITS, 1, key)
        n = -(-P // B)
        size = -(-P // n)  # n even blocks of at most B points
        outs = [fn(x[lo:lo + size]) for lo in range(0, P, size)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    return evaluate


def bounded_target(target: "LogDensity", points: Optional[int] = None) -> "LogDensity":
    """``target`` with its ``logp`` and ``value_and_grad`` handed at most
    ``points`` points a call: a batch of more is evaluated in blocks of at
    most that many points, in order, and the results are joined, so that
    every row is the target's own. With ``points=None`` the bound is learned
    on a CUDA device (:func:`target_bound`): the most points whose bytes fit
    in ``TARGET_SHARE`` of the card's total memory, never fewer than one; on
    any other device a batch is not split. Every evaluation counts its
    points (``target.points``) and every split one (``target.splits``) in
    the always-on counters of ``utils/tracing.py``. ``hess`` stays the
    target's own."""
    if points is not None and points < 1:
        raise ValueError(f"target_points must be positive or None; got {points}")
    return dataclasses.replace(target, logp=_bounded(target, "logp", points),
                               value_and_grad=_bounded(target, "value_and_grad", points))


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

"""Row groups: a core whose parameter rows are split over devices.

The JAX package shards ``d`` by annotating shardings and letting XLA
partition the jitted program, inserting every reduction over ``d`` as a
collective (``pathfinder_tpu/parallel/dim_sharding.py``). PyTorch has no
such partitioner for a Python target and hand-written kernels, so the port
does explicitly what GSPMD does implicitly: the ``w`` members of a
:class:`RowGroup` are host threads, member ``j`` holding the contiguous rows
``[j·d/w, (j+1)·d/w)`` of every ``d``-long axis on its own device, and each
runs the unchanged core on those rows. Every reduction over ``d`` in the
core goes through :func:`sum_rows` or :func:`max_rows`: each member puts
its partial in its slot, and after a barrier member 0 combines the slots in
rank order ``0..w−1`` on its device; every member then takes a copy of that
one result. So all members hold the same bits, every data-dependent host
decision (a loop's exit, a line search's branch) is the same on each, and
the result does not move with the order in which the threads arrive.

The target is evaluated whole (:func:`evaluate_rows`): the members' rows
are gathered on member 0's device, the target runs there once, and each
member takes the values and its rows of the gradient. This is where the
port does less than GSPMD, which also partitions the target's own program:
the results are the same, but the target's memory is not split. What cannot
be split for the same reason, a Newton step's dense ``eigh`` or a user's
optimizer, runs whole on the lead too (:func:`run_on_lead`), outside the
group, and each member takes its rows of the result; :func:`gather_rows`
gives every member the full rows of a vector (BFGS's products with its
row-split inverse Hessian).

Outside a group every helper is the plain local operation and returns its
argument unchanged, so a core that runs in no group keeps every bit.

No member can hang its peers: the barrier waits at most ``BARRIER_TIMEOUT``
seconds (``LEAD_TIMEOUT`` while :func:`run_on_lead` runs a whole optimizer
on the lead), and a member that raises breaks the barrier
(:meth:`RowGroup.member`), so its peers raise
``threading.BrokenBarrierError`` instead of waiting.
Across distinct CUDA devices a member's partial carries an event that member
0's stream waits on before the copy, and the result one that the others'
streams wait on; the barrier only orders the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import torch

__all__ = [
    "BARRIER_TIMEOUT",
    "LEAD_TIMEOUT",
    "RowGroup",
    "current",
    "in_group",
    "is_lead",
    "full_dim",
    "row_offset",
    "sum_rows",
    "max_rows",
    "evaluate_rows",
    "gather_rows",
    "run_on_lead",
    "row_target",
]

# seconds a member waits for its peers at one reduction before the barrier
# breaks: longer than any stretch of work between two reductions (the
# target's evaluation on the lead device included)
BARRIER_TIMEOUT = 300.0
# seconds the other members wait while the lead runs :func:`run_on_lead`'s
# function: a whole user optimizer, or a Newton step's Hessian and eigh, may
# take far longer than a target evaluation, but never without a bound
LEAD_TIMEOUT = 6 * 3600.0

_local = threading.local()


class RowGroup:
    """The ``w`` members of one row-split core: ``devices[j]`` holds rows
    ``[j·rows, (j+1)·rows)`` of the ``d`` rows, ``rows = d / w``."""

    def __init__(self, devices, d: int):
        self.devices = list(devices)
        self.width = len(self.devices)
        if d % self.width:
            raise ValueError(f"{d} rows do not split over {self.width} members")
        self.d, self.rows = d, d // self.width
        self._barrier = threading.Barrier(self.width, timeout=BARRIER_TIMEOUT)
        self._slots = [None] * self.width
        self._out = None
        # events order the members' streams where their devices differ
        self._events = any(
            dev.type == "cuda" and dev != self.devices[0] for dev in self.devices
        )

    @contextlib.contextmanager
    def member(self, rank: int):
        """Run the calling thread as member ``rank``; an exception breaks the
        barrier, so that the peers raise instead of waiting."""
        previous = getattr(_local, "member", None)
        _local.member = (self, rank)
        try:
            yield
        except BaseException:
            self._barrier.abort()
            raise
        finally:
            _local.member = previous

    def _event(self, dev):
        if not (self._events and dev.type == "cuda"):
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def exchange(self, rank: int, value, combine: Callable, timeout: float = None):
        """Put ``value`` in slot ``rank``; member 0 calls ``combine(values)``
        with every slot's value in rank order, on its device, and every
        member returns that one result (the same object). Two barriers: after
        the second, no member reads a slot, and no member passes the first of
        the next exchange before every member has taken this result. The
        second, where the others wait for ``combine``, waits at most
        ``timeout`` seconds (default ``BARRIER_TIMEOUT``)."""
        dev = self.devices[rank]
        self._slots[rank] = (value, self._event(dev))
        self._barrier.wait()
        if rank == 0:
            stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
            for _, ev in self._slots:
                if ev is not None:
                    stream.wait_event(ev)
            self._out = (combine([v for v, _ in self._slots]), self._event(dev))
        self._barrier.wait(timeout)
        out, ev = self._out
        if ev is not None and rank != 0 and dev.type == "cuda":
            torch.cuda.current_stream(dev).wait_event(ev)
        return out


def current():
    """``(group, rank)`` of the calling thread, or None outside a group."""
    return getattr(_local, "member", None)


def in_group() -> bool:
    return current() is not None


def is_lead() -> bool:
    """Whether the calling thread is member 0 of its group, or in none:
    the one that prints."""
    m = current()
    return m is None or m[1] == 0


def full_dim(n: int) -> int:
    """The full parameter dimension of an axis of ``n`` local rows."""
    m = current()
    return n if m is None else m[0].d


def row_offset() -> int:
    """The first of the calling member's rows (0 outside a group)."""
    m = current()
    return 0 if m is None else m[1] * m[0].rows


def _own(t: torch.Tensor, dev, rank: int) -> torch.Tensor:
    """Member ``rank``'s copy of the lead's result ``t``: the lead keeps it,
    every other member takes a copy on its own device."""
    return t if rank == 0 else t.to(dev, copy=True)


def _reduce(partials, op):
    m = current()
    if m is None:
        return partials[0] if len(partials) == 1 else partials
    group, rank = m
    lead = group.devices[0]

    def combine(slots):
        out = []
        for i in range(len(partials)):
            acc = slots[0][i]
            for r in range(1, group.width):  # in rank order
                acc = op(acc, slots[r][i].to(lead))
            out.append(acc)
        return out

    dev = group.devices[rank]
    result = [_own(t, dev, rank) for t in group.exchange(rank, partials, combine)]
    return result[0] if len(result) == 1 else tuple(result)


def sum_rows(*partials: torch.Tensor):
    """The sums over the group's members of each member's ``partials`` (a
    reduction over d of its own rows), added in rank order; one exchange
    for all of them. Outside a group: the partials themselves."""
    return _reduce(partials, torch.add)


def _maximum(a, b):
    return a | b if a.dtype == torch.bool else torch.maximum(a, b)


def max_rows(*partials: torch.Tensor):
    """The elementwise maxima (for bools: any) over the members, as
    :func:`sum_rows`; NaN propagates as in ``amax``."""
    return _reduce(partials, _maximum)


def evaluate_rows(fn: Callable, x: torch.Tensor, grad: bool = False):
    """``fn`` on the full rows of ``x (..., rows)``: the members' rows are
    gathered on the lead's device, ``fn`` runs there once, and each member
    takes the values (and, with ``grad``, from ``fn``'s ``(values,
    gradient)`` its rows of the gradient). Outside a group: ``fn(x)``."""
    m = current()
    if m is None:
        return fn(x)
    group, rank = m
    lead, dev = group.devices[0], group.devices[rank]

    def combine(slots):
        return fn(torch.cat([s.to(lead) for s in slots], dim=-1))

    out = group.exchange(rank, x, combine)
    if not grad:
        return _own(out, dev, rank)
    value, gradient = out
    lo = rank * group.rows
    rows = gradient[..., lo:lo + group.rows].to(dev, copy=True).contiguous()
    return _own(value, dev, rank), rows


def _joined(slots, n: int, lead) -> list:
    """The members' rows of each of their ``n`` tensors joined along the last
    axis in rank order, on ``lead``."""
    return [torch.cat([s[i].to(lead) for s in slots], dim=-1) for i in range(n)]


def gather_rows(*ts: torch.Tensor):
    """Every member's copy of the full rows of each row-split ``t (...,
    rows)``: the members' rows joined in rank order on the lead, one
    exchange for all of them. Outside a group: the tensors themselves."""
    m = current()
    if m is None:
        return ts[0] if len(ts) == 1 else ts
    group, rank = m
    lead, dev = group.devices[0], group.devices[rank]

    out = [_own(t, dev, rank)
           for t in group.exchange(rank, ts, lambda slots: _joined(slots, len(ts), lead))]
    return out[0] if len(out) == 1 else tuple(out)


@contextlib.contextmanager
def _outside_group():
    """Run the calling thread as in no group: every helper is then the plain
    local operation."""
    previous = getattr(_local, "member", None)
    _local.member = None
    try:
        yield
    finally:
        _local.member = previous


def run_on_lead(fn: Callable, *ts: torch.Tensor, split=True):
    """``fn`` run once, on the lead's device and outside the group, on the
    full rows of each row-split ``t (..., rows)`` (gathered in rank order);
    each member takes its rows (the last axis) of the outputs that ``split``
    marks and a copy of the others. ``fn`` returns a tensor (``split`` a
    bool) or a tuple of them (``split`` a bool for each). The other members
    wait at most ``LEAD_TIMEOUT`` for it. Outside a group: ``fn(*ts)``."""
    m = current()
    if m is None:
        return fn(*ts)
    group, rank = m
    lead, dev = group.devices[0], group.devices[rank]

    def combine(slots):
        with _outside_group():
            return fn(*_joined(slots, len(ts), lead))

    out = group.exchange(rank, ts, combine, timeout=LEAD_TIMEOUT)
    single = isinstance(split, bool)
    outs, flags = ((out,), (split,)) if single else (out, split)
    if len(flags) != len(outs):
        raise ValueError(f"split names {len(flags)} outputs; fn gave {len(outs)}")
    lo = rank * group.rows
    mine = tuple(
        t[..., lo:lo + group.rows].to(dev, copy=True).contiguous() if s else _own(t, dev, rank)
        for t, s in zip(outs, flags))
    return mine[0] if single else mine


def row_target(target):
    """``target`` (a ``LogDensity``) with its ``logp`` and ``value_and_grad``
    evaluated whole through the calling member's group (:func:`evaluate_rows`).
    Its ``hess`` stays the whole target's (the target's own, else
    ``torch.func``'s over the whole ``logp``), a function of the full rows:
    it runs on the lead, outside the group (:func:`run_on_lead`)."""
    from pathfinder_tpu_torch.models.protocol import batched_hessian

    logp, vg, own = target.logp, target.value_and_grad, target.hess

    def hess(x):
        if in_group():
            raise RuntimeError("the whole target's Hessian takes the full rows: call it "
                               "through run_on_lead")
        return (own if own is not None else batched_hessian(logp))(x)

    hess._pf_derived = own is None  # for the Newton optimizer's warning
    return dataclasses.replace(
        target,
        logp=lambda x: evaluate_rows(logp, x),
        value_and_grad=lambda x: evaluate_rows(vg, x, grad=True),
        hess=hess,
    )

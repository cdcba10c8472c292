"""Spans and counters inside the port's call, and the kernels' launch counter.

Tracing is on exactly while a torch profiler (``torch.profiler.profile`` or
``torch.autograd.profiler.profile``) records in this process; every site
reads that one flag and does nothing more while it is off. There is no other
switch.

- ``span(name)`` opens a range ``pf::<name>`` in the profiler's own event
  list, on the device trace's clock, around the aten ops and kernel launches
  it issues, and records ``Span(id, name, call, parent, thread, start_ns,
  end_ns)`` in memory when it closes (wall-clock nanoseconds, the clock of
  the profiler's events). The open spans form a stack per thread; a span
  inside an open span of the same name in its thread is not recorded (only
  the outermost ``target`` of a nested evaluation, only the outermost
  ``call`` of a ``multipathfinder`` inside another). A ``call`` span takes
  its own id as its call id and every span under it takes the same.
- ``sync(site)`` is the ``sync`` span of a device→host read at ``site`` (the
  module's path in the package), counted as ``sync.<site>``.
- ``count(name, n, key)`` adds to a counter while tracing is on. The family
  ``launch.`` (the kernels' launches by shape, ``ops/kernels``) is counted
  always: it is read with no profiler running.

The records of one profiler session replace the previous session's: the
first record made after a site found tracing off starts a new session (the
launch family is kept until :func:`reset`). They stay in memory until read
with :func:`spans` and :func:`counts`.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = [
    "LAUNCH",
    "Span",
    "adopt",
    "count",
    "counts",
    "counts_by_key",
    "current",
    "on",
    "reset",
    "span",
    "spanned",
    "spans",
    "sync",
]

# A function-scope range. A user-scope ``torch.profiler.record_function``
# also puts a copy of its range on the device's timeline, a CUDA event that
# spans the kernels it launched (seen on an H100 with torch 2.11): a reader of
# the profiler's device intervals would then count a whole ``call`` as busy.
_RANGE = torch._C._profiler._RecordFunctionFast

LAUNCH = "launch."  # the always-on counter family


class Span(NamedTuple):
    id: int
    name: str
    call: Optional[int]  # the id of the ``call`` span above it (None: outside any call)
    parent: Optional[int]  # the span directly above it: in its thread, or the one it was
    # started under (:func:`adopt`)
    thread: int
    start_ns: int
    end_ns: int


class _Frame:
    __slots__ = ("id", "name", "call", "parent", "range", "start_ns")


class _Null:
    """The one context every site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_lock = threading.Lock()
_spans: list = []
_counts: dict = {}  # name -> Counter over keys (None: a plain count)
_ids = itertools.count(1)
_local = threading.local()
_fresh = True  # tracing was found off since the last record: the next starts a session


def on() -> bool:
    """Whether a torch profiler records in this process."""
    global _fresh
    if _profiler._is_profiler_enabled:
        return True
    if not _fresh:
        _fresh = True
    return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _session() -> None:
    """Under ``_lock``, where tracing was found off since the last record:
    drop the previous session's records."""
    global _fresh
    if _fresh:  # again: another thread may have started the session
        _fresh = False
        _spans.clear()
        for name in [n for n in _counts if not n.startswith(LAUNCH)]:
            del _counts[name]


class _Open:
    __slots__ = ("name", "frame")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        if any(f.name == self.name for f in stack):
            self.frame = None
            return None
        if _fresh:
            with _lock:
                _session()
        f = self.frame = _Frame()
        parent = stack[-1] if stack else None
        f.id, f.name = next(_ids), self.name
        f.parent = None if parent is None else parent.id
        f.call = f.id if self.name == "call" else None if parent is None else parent.call
        f.range = _RANGE("pf::" + self.name)
        f.range.__enter__()
        stack.append(f)
        f.start_ns = time.time_ns()
        return None

    def __exit__(self, *exc):
        f = self.frame
        if f is None:
            return False
        end = time.time_ns()
        _stack().pop()
        f.range.__exit__(*exc)
        with _lock:
            _spans.append(Span(f.id, f.name, f.call, f.parent, threading.get_ident(),
                               f.start_ns, end))
        return False


def span(name: str):
    """A context that records the span ``name`` while tracing is on."""
    return _Open(name) if on() else _NULL


def spanned(name: str):
    """Decorate a function so that each call runs in the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return traced

    return wrap


def sync(site: str):
    """The ``sync`` span of one device→host read at ``site``, counted as
    ``sync.<site>``; put only the read inside it."""
    if not on():
        return _NULL
    count("sync." + site)
    return _Open("sync")


def count(name: str, n: int = 1, key=None) -> None:
    """Add ``n`` to the counter ``name`` (under ``key``) while tracing is
    on; the ``launch.`` family always."""
    always = name.startswith(LAUNCH)
    if not (always or on()):
        return
    with _lock:
        if not always and _fresh:
            _session()
        c = _counts.get(name)
        if c is None:
            c = _counts[name] = collections.Counter()
        c[key] += n


def current():
    """The innermost open span of this thread, to hand to :func:`adopt` in
    a thread this one starts (None where there is none)."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Adopt:
    __slots__ = ("frame",)

    def __init__(self, frame):
        self.frame = frame

    def __enter__(self):
        _stack().append(self.frame)

    def __exit__(self, *exc):
        _stack().pop()
        return False


def adopt(frame):
    """A context under which this thread's spans sit under ``frame``, an
    open span of the thread that started it (:func:`current`)."""
    return _NULL if frame is None else _Adopt(frame)


def spans() -> list:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_spans)


def counts(prefix: str = "") -> dict:
    """``{name: total}`` of the counters whose names start with ``prefix``."""
    with _lock:
        return {n: sum(c.values()) for n, c in _counts.items() if n.startswith(prefix)}


def counts_by_key(prefix: str = "") -> dict:
    """``{name: {key: count}}`` of the counters whose names start with
    ``prefix``."""
    with _lock:
        return {n: dict(c) for n, c in _counts.items() if n.startswith(prefix)}


def reset(prefix: Optional[str] = None) -> None:
    """Drop the counters whose names start with ``prefix``; with none, the
    spans and every counter."""
    with _lock:
        if prefix is None:
            _spans.clear()
        for name in [n for n in _counts if prefix is None or n.startswith(prefix)]:
            del _counts[name]

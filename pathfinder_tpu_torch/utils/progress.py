"""Throttled progress lines (counterpart of ``pathfinder_tpu/utils/progress.py``).

``multipathfinder(progress=True)`` reports paths that have succeeded after
each launch round; a line is written at most once per ``min_seconds`` and per
``min_fraction`` of the total, and the final state always.
"""

from __future__ import annotations

import sys
import time

__all__ = ["ThrottledProgress"]


class ThrottledProgress:
    """Progress printer: at most one update per ``min_seconds`` and per
    ``min_fraction`` of progress, each overwriting the last (``\\r``)."""

    def __init__(
        self,
        total: int,
        name: str = "Pathfinder",
        min_seconds: float = 0.1,
        min_fraction: float = 0.005,
        stream=None,
    ):
        self.total = max(total, 1)
        self.name = name
        self.min_seconds = min_seconds
        self.step = max(1, int(self.total * min_fraction))
        self.stream = stream or sys.stderr
        self._next_count = self.step
        self._next_time = time.monotonic() + min_seconds
        self._done = 0
        self._extra = ""
        self._last_len = 0

    def _emit(self, completed: int, extra: str) -> None:
        body = f"{self.name}: {completed}/{self.total} ({completed / self.total:.1%}) {extra}"
        # spaces, so that a shorter line fully overwrites a longer one
        pad = " " * max(0, self._last_len - len(body))
        self._last_len = len(body)
        self.stream.write("\r" + body + pad)
        self.stream.flush()

    def update(self, completed: int, extra: str = "") -> None:
        self._done, self._extra = completed, extra
        now = time.monotonic()
        if completed >= self.total or (completed >= self._next_count and now >= self._next_time):
            self._emit(completed, extra)
            self._next_count = completed + self.step
            self._next_time = now + self.min_seconds

    def close(self) -> None:
        """Write the last reported state, even if it was throttled away."""
        self._emit(self._done, self._extra)
        self.stream.write("\n")
        self.stream.flush()

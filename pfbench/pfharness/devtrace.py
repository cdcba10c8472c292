"""What a traced window's ``torch.profiler`` record says: the seconds in
which an operation ran on each card, the device time of each kernel name,
and the longest idle gaps by what the host was doing. The record is read in
memory; nothing is written to disk."""

from __future__ import annotations

import collections
import dataclasses
import re

import numpy as np


@dataclasses.dataclass
class DeviceProfile:
    busy_s: dict  # card index -> seconds with an operation running (union of intervals)
    op_seconds: dict  # device operation name -> seconds
    gap_seconds: dict  # what the host ran while no card ran anything -> seconds

    def busy_mean_s(self, cards) -> float:
        return float(np.mean([self.busy_s.get(c, 0.0) for c in cards]))

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the operations whose names match a pattern."""
        rx = [re.compile(p) for p in patterns]
        return sum(s for name, s in self.op_seconds.items() if any(r.search(name) for r in rx))

    def top_ops(self, n=10):
        return [[k, v] for k, v in sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n=10):
        return [[k, v] for k, v in sorted(self.gap_seconds.items(), key=lambda kv: -kv[1])[:n]]


def _span(e):
    start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
    dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
    return int(start), int(start) + int(dur)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals covering ``intervals (n, 2)``."""
    if len(intervals) == 0:
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def read(prof) -> DeviceProfile:
    """Reduce a finished ``torch.profiler.profile`` with CPU and CUDA
    activities."""
    events = prof.profiler.kineto_results.events()
    dev_iv = collections.defaultdict(list)
    op_ns = collections.Counter()
    cpu = []
    for e in events:
        kind = str(e.device_type())
        lo, hi = _span(e)
        if kind.endswith("CUDA"):
            dev_iv[int(e.device_index())].append((lo, hi))
            op_ns[e.name()] += hi - lo
        elif e.name().startswith("aten::"):
            cpu.append((lo, hi, e.name()))
    busy, gap_ns = {}, collections.Counter()
    cpu.sort()
    c_start = np.array([c[0] for c in cpu], dtype=np.int64)
    c_end = np.array([c[1] for c in cpu], dtype=np.int64)
    for dev, iv in dev_iv.items():
        u = _union(np.array(iv, dtype=np.int64))
        busy[dev] = float((u[:, 1] - u[:, 0]).sum()) * 1e-9
        if dev != min(dev_iv) or len(u) < 2:
            continue
        # each idle gap of the first card, named by the innermost host op at its middle
        lo, hi = u[:-1, 1], u[1:, 0]
        mid = (lo + hi) // 2
        at = np.searchsorted(c_start, mid, side="right") - 1
        for g, i, m in zip(hi - lo, at, mid):
            name = "host outside an aten op"
            for j in range(i, max(i - 8, -1), -1):
                if c_end[j] >= m:
                    name = cpu[j][2]
                    break
            gap_ns[name] += int(g)
    return DeviceProfile(
        busy_s=busy,
        op_seconds={k: v * 1e-9 for k, v in op_ns.items()},
        gap_seconds={k: v * 1e-9 for k, v in gap_ns.items()},
    )

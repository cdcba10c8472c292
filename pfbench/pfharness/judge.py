"""``correct``: every number the reference compares, under its limit."""

from __future__ import annotations

import math


def judge(readings: dict, limits: dict):
    """``(correct, {name: [value, limit]})`` over the numbers the cell's
    limits file names; a limit with no number is a fault of the benchmark
    and raises."""
    if not set(limits) <= set(readings):
        raise KeyError(f"limits {sorted(limits)} against numbers {sorted(readings)}")
    rows = {}
    ok = True
    for name in sorted(limits):
        value, limit = float(readings[name]), float(limits[name]["limit"])
        rows[name] = [value, limit]
        ok &= math.isfinite(value) and value <= limit
    return ok, rows

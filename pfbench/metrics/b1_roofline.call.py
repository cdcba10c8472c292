"""b1_roofline.call: b1's least time over its device time in the
traced window (metrics/_roofline.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_roofline = load_module(Path(__file__).with_name("_roofline.py"), "pfbench_metric__roofline")


def read(run):
    return _roofline.roofline_pct(run, "b1")

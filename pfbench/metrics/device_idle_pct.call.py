"""device_idle_pct: the share of the traced window in which no operation
runs on the cards (metrics/_idle.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_idle = load_module(Path(__file__).with_name("_idle.py"), "pfbench_metric__idle")


def read(run):
    return _idle.idle_pct(run)

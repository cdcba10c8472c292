"""syncs.call: the device→host reads a call, the program's ``sync.<site>``
counts (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.syncs(run)

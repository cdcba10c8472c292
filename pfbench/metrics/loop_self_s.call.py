"""loop_self_s.call: the self time of the ``trajectory`` spans a call: the
optimizer"s and line search"s own host work and device ops, without the
target and the device→host reads (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("trajectory",))

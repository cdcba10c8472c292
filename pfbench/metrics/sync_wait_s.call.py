"""sync_wait_s.call: the ``sync`` spans a call: the host blocked on the card at
a device→host read (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("sync",))

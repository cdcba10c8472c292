"""target_s.call: the ``target`` spans a call: the batched calls into the
user"s density, autograd included (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("target",))

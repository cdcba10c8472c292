"""entry_self_s.call: the self time of the ``call`` span a call: the entry, its
checks and launch plan, the retries" bookkeeping, the per-path core"s glue
and the result (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("call",))

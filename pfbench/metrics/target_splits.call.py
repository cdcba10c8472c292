"""target_splits.call: the batched evaluations a call whose points the
program's bound on the target's memory divided into blocks, its always-on
``target.splits`` counter, read as target_points.call reads
``target.points``; 0 where no evaluation was divided."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_points = load_module(Path(__file__).with_name("target_points.call.py"),
                      "pfbench_metric_target_points.call")


def read(run):
    return _points.per_call(run, "splits")

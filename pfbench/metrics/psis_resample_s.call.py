"""psis_resample_s.call: the self time of the ``psis`` and ``resample`` spans a
call: the ratios" logq (B2), the smoothing and the picks
(metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("psis", "resample"))

"""fits_elbo_s.call: the self time of the ``fits``, ``elbo`` and
``winner_draws`` spans a call: the fits, the ELBO"s draws and logq (B1), the
winners" rebuild and draws (metrics/_spans.py)."""

from pathlib import Path

from pfharness.registry import load_module  # noqa: E402

_spans = load_module(Path(__file__).with_name("_spans.py"), "pfbench_metric__spans")


def read(run):
    return _spans.self_seconds(run, ("fits", "elbo", "winner_draws"))

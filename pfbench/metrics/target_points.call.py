"""target_points.call: the points a call hands the target, over every
batched evaluation (the trajectory's, the ELBO chunks', the PSIS blocks'),
the program's always-on ``target.points`` counter
(``pathfinder_tpu_torch/utils/tracing.py``), keyed by the ``call`` span it
was counted in: the mean over the traced window's ``call`` spans (the
warm-up's counts, made before the profiler ran, carry no call). None without
a traced profile, without a call span, or where the program has no such
counter."""


def per_call(run, name: str):
    """The mean over the window's calls of the program's counter
    ``target.<name>`` (0 where it never counted)."""
    if run.profile is None:
        return None
    try:
        from pathfinder_tpu_torch.utils import tracing
    except ImportError:
        return None
    if not hasattr(tracing, "TARGET"):
        return None
    calls = [s.id for s in tracing.spans() if s.name == "call" and s.parent is None]
    if not calls:
        return None
    by_call = tracing.counts_by_key(tracing.TARGET + name).get(tracing.TARGET + name, {})
    return float(sum(by_call.get(c, 0) for c in calls)) / len(calls)


def read(run):
    return per_call(run, "points")

"""The port's own spans and sync counts over a traced window
(``pathfinder_tpu_torch/utils/tracing.py``), per call: the mean over the
window's ``call`` spans. A span's self time is its duration less the
spans directly under it, so the self times of every span of a call sum to
the call's duration. None where the program records no span: a program
without the module, an untraced run, or a window in which no call closed."""


def _tracing(run):
    if run.profile is None:
        return None
    try:
        from pathfinder_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def self_seconds(run, names):
    """The mean over the window's calls of the self time of the spans
    ``names``, in seconds."""
    tracing = _tracing(run)
    if tracing is None:
        return None
    spans = tracing.spans()
    calls = [s.id for s in spans if s.name == "call" and s.parent is None]
    if not calls:
        return None
    under = {}
    for s in spans:
        if s.parent is not None:
            under[s.parent] = under.get(s.parent, 0) + s.end_ns - s.start_ns
    mine = set(calls)
    total = sum(s.end_ns - s.start_ns - under.get(s.id, 0)
                for s in spans if s.name in names and s.call in mine)
    return total * 1e-9 / len(calls)


def syncs(run):
    """The device→host reads a call: the ``sync.<site>`` counts over the
    window's calls."""
    tracing = _tracing(run)
    if tracing is None:
        return None
    calls = sum(1 for s in tracing.spans() if s.name == "call" and s.parent is None)
    if not calls:
        return None
    return float(sum(tracing.counts("sync.").values())) / calls

"""evals_per_path.call: the program's own count of logp+grad evaluations a
path (``result.states.num_fn_evals``), the mean over the window's calls and
paths."""


def read(run):
    if not run.calls:
        return None
    return sum(c["evals_per_path"] for c in run.calls) / len(run.calls)

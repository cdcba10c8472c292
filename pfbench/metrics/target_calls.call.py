"""target_calls.call: batched calls of the target a multipathfinder call
(trajectory, ELBO and PSIS together), counted by the benchmark's wrapper
around the callable it hands in."""


def read(run):
    if not run.calls:
        return None
    return sum(c["target_calls"] for c in run.calls) / len(run.calls)

"""A kernel function's share of its roofline in a traced window: the least
time of the launches the program's counter saw (pfharness/roofline.py) over
the profiler's device time of the kernels that kernels.json maps to the
function. None where the window launched none of them."""

from pfharness import roofline


def least_s(run, function):
    total = 0.0
    for counter in run.cell.kernels[function]["counters"]:
        for (B, m, N, shared), n in run.launches.get(counter, {}).items():
            total += n * roofline.least_seconds(function, B, run.d, m, N, shared,
                                                run.itemsize)[0]
    return total


def roofline_pct(run, function):
    if run.profile is None:
        return None
    least = least_s(run, function)
    spent = run.profile.seconds_matching(run.cell.kernels[function]["kernels"])
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent

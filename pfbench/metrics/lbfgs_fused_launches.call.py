"""lbfgs_fused_launches.call: launches of the program's L-BFGS iteration
kernel a call, ``launch.lbfgs_iter`` of its always-on launch counter
(``pathfinder_tpu_torch/utils/tracing.py``; the window resets the family
before it opens) over the window's completed calls. None without a traced
profile, without a completed call, or where the program has no such counter.

The count is read after the window's check, which runs the plain reference
alone: it imports nothing of the program
(``pfbench/tests/test_pfbench_imports.py``), so it adds no launch. The metric
shows that the kernel takes every iteration of the trajectories (one launch
an iteration and one to start, a launch of the paths in a call); it is not a
goal of its own, and fewer iterations a call lower it."""


def read(run):
    if run.profile is None or not run.calls:
        return None
    try:
        from pathfinder_tpu_torch.utils import tracing
    except ImportError:
        return None
    name = tracing.LAUNCH + "lbfgs_iter"
    launches = tracing.counts(name).get(name)
    if launches is None:
        return None
    return float(launches) / len(run.calls)

#!/usr/bin/env python3
"""B2 over an x shared by every factor (the shared-x kernel of
``pathfinder_tpu_torch/csrc/woodbury_shared.cu``), alone, on one card.

    python3 tools/woodbury_shared_bench.py                # check and time every case
    python3 tools/woodbury_shared_bench.py --parent DIR   # also time DIR's kernels
    python3 tools/woodbury_shared_bench.py --phases       # cycles of each phase, timed cases
    python3 tools/woodbury_shared_bench.py --stages       # the mixture and Laplace stages

Builds the kernels, then runs ``chip_smoke.py``'s shared-x
phase (``shared_kernel_phase``): the mixture grid (100, m, 1000) and its odd
and small variants at ranks 0, 12, 40, 100 and 258 in float64, float32,
bfloat16 and float16, the float32 odd and wide shapes, the plans with rank
windows and a workspace, the ill-conditioned case and the serving-scale
launch (1024, 12, 5120). Each case is held against its plain version at
``chip_smoke.py``'s tolerances and launched twice for the same bits; the
d = 1000 cases are timed L2-cold (``chip_smoke.time_cold_ms``) beside the
plain version and both bounds (``chip_smoke.bound_us``, the CUDA-core bound
of the earlier kernels, and ``chip_smoke.tc_bound_us``, this kernel's
tensor-core bound). ``--parent DIR`` loads the kernel wrapper of another
checkout of the repo (``DIR/pathfinder_tpu_torch``; unpack it with ``git
archive <commit> pathfinder_tpu_torch | tar -x -C build/ab/x``) and times
its B2 over a shared x at the same cases in turns with this one (parent,
this, this, parent), from the same inputs. ``--phases`` runs the cases on a
copy of the wrapper and the shared-x source with ``PFS_PHASES`` defined
(under ``build/phases/``) and prints, for each timed case, the clock64 cycles
at which CTA 0 and the middle CTA ended each phase of their first item
(pass 1, pass 2, pass 3, sums), and the cycles that item's steps spent
waiting for copies, converting and computing. ``--stages`` runs the
headline mixture seeds of ``chip_smoke.py`` with this kernel and, given
``--parent``, the parent's (k̂, moment error, wall), then times the mixture
PSIS stage and ``laplace_resample`` of a mixture run (the shared-x kernel
at rank 0) with both in turns. ``--only "mixture m=12 float32,serving"`` picks cases by
substring. Exits 1 if a case fails. Prints the card's name and power limit
first; ``--out FILE`` writes every line to FILE as well.
"""

import argparse
import contextlib
import ctypes
import io
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk  # noqa: E402
from woodbury_general_bench import WRAPPER, load_wrapper  # noqa: E402

_lines = []


def say(line):
    print(line, flush=True)
    _lines.append(line)


def load_parent(path):
    """The kernel wrapper of the checkout at ``path``, its kernels loaded."""
    mod = load_wrapper(path, "parent_woodbury_kernels")
    mod.load_library()
    return mod


PHASES = ("pass1", "pass2", "pass3", "sums")


def load_phases_wrapper():
    """This checkout's wrapper over a copy of the shared-x source with its
    phase stamps on (``PFS_PHASES``), under ``build/phases/shared``; returns
    the wrapper and its shared-x library."""
    root = ROOT / "build" / "phases" / "shared"
    for rel, text in ((WRAPPER, (ROOT / WRAPPER).read_text()),
                      ("pathfinder_tpu_torch/csrc/woodbury_shared.cu",
                       "#define PFS_PHASES\n" + wk._SHARED_SOURCE.read_text())):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    mod = load_wrapper(root, "phases_woodbury_kernels")
    lib = mod.load_shared_library()
    lib.pfs_read_stamps.argtypes = [ctypes.c_void_p]
    lib.pfs_read_stamps.restype = ctypes.c_int
    return mod, lib


class Phases:
    """Wraps ``chip_smoke.time_cold_ms``: after each timing of this checkout's
    kernel, one more L2-cold launch and its phase stamps."""

    def __init__(self, lib):
        self.lib, self.inner = lib, cs.time_cold_ms

    def __call__(self, fn, reps=20):
        ms = self.inner(fn, reps)
        code = fn.__code__
        if "_whiten_sumsq_cuda" not in code.co_names or "parent" in code.co_freevars:
            return ms  # the plain version's timing, or the parent's
        flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
        stamps = torch.zeros(20, dtype=torch.int64)
        self.lib.pfs_read_stamps(stamps.data_ptr())  # the step sums start from zero
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        self.lib.pfs_read_stamps(stamps.data_ptr())
        st = stamps[:12].view(2, 6).tolist()
        steps = stamps[12:].view(2, 4).tolist()
        say("  phases " + "; ".join(
            f"{who} " + " ".join(f"{name}={row[k + 1] - row[0]}" for k, name in enumerate(PHASES)
                                 if row[k + 1])
            for who, row in zip(("first", "middle"), st))
            + "; steps of CTA 0's first item, cycles summed (waiting for copies, converting μ "
            + "and a½, converting X and the barrier, computing): thread 0 "
            + f"{steps[0]}, thread 224 {steps[1]}")
        return ms


def stages(parent):
    """The headline mixture runs of ``chip_smoke.py`` (seeds
    ``MIXTURE_SEEDS``) with this kernel and, given the parent, with the
    parent's (k̂, moment error, wall); then the mixture PSIS stage and
    laplace_resample of one headline mixture run, with this kernel and the
    parent's in turns (parent, this, this, parent), medians of 3 calls each."""
    import numpy as np

    import pathfinder_tpu_torch as pt
    from pathfinder_tpu_torch import multipath as mp
    from pathfinder_tpu_torch.models import zoo
    from pathfinder_tpu_torch.ops import mvnormal

    target = zoo.HierarchicalGaussian(cs.D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(cs.D, seed=0)
    mine = mvnormal.whiten_sumsq
    for who, b2 in [("this", mine)] + ([("parent", parent.whiten_sumsq)] if parent else []):
        mvnormal.whiten_sumsq = b2
        try:
            for seed in cs.MIXTURE_SEEDS:
                t0 = time.perf_counter()
                res = pt.multipathfinder(target, 1000, nruns=cs.K, maxiters=64, elbo_chunk=8,
                                         seed=seed, importance_denominator="mixture")
                torch.cuda.synchronize()
                draws = res.draws.double().cpu().numpy()
                merr = float(np.max(np.abs(draws.mean(axis=1) - mean_t) / sd_t))
                say(f"mixture run [{who} kernel] seed={seed}: khat={float(res.psis_result.pareto_shape):.4f} "
                    f"moment_err_mean_sd_units={merr:.4f} wall_s={time.perf_counter() - t0:.3f}")
        finally:
            mvnormal.whiten_sumsq = mine
    t0 = time.perf_counter()
    res = pt.multipathfinder(target, 1000, nruns=cs.K, maxiters=64, elbo_chunk=8, seed=0,
                             importance_denominator="mixture")
    torch.cuda.synchronize()
    say(f"stages: headline mixture run, seed 0: wall_s={time.perf_counter() - t0:.3f} "
        f"khat={float(res.psis_result.pareto_shape):.4f}")
    comps, dk = res.fit_distribution.components, res.draws_per_component
    work = {
        "PSIS with the mixture denominator": lambda: mp._compute_psis_result(
            target.logp, comps, dk, "mixture"),
        "laplace_resample of the mixture run": lambda: pt.laplace_resample(res, 1000),
    }
    mine = mvnormal.whiten_sumsq
    kernels = [("this", mine)] if parent is None else [
        ("parent", parent.whiten_sumsq), ("this", mine), ("this", mine), ("parent", parent.whiten_sumsq)]
    for name, fn in work.items():
        times = {}
        for who, b2 in kernels:
            mvnormal.whiten_sumsq = b2
            try:
                fn()  # warm
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times.setdefault(who, []).append(time.perf_counter() - t0)
            finally:
                mvnormal.whiten_sumsq = mine
        say(f"stage [{name}]: " + " ".join(
            f"{who}_s={statistics.median(v):.4f} (of {len(v)})" for who, v in times.items()))


def main():
    global wk
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="a checkout whose kernels are timed beside this one")
    parser.add_argument("--phases", action="store_true", help="cycles of each phase")
    parser.add_argument("--stages", action="store_true", help="time the mixture and Laplace stages")
    parser.add_argument("--only", help="run only the cases whose tag contains one of these texts")
    parser.add_argument("--out", help="a file to write every line to as well")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    if opts.phases:  # every case runs on the instrumented build
        wk, lib = load_phases_wrapper()
    else:
        wk.load_shared_library()
    parent = load_parent(opts.parent) if opts.parent else None
    say(f"build: {time.perf_counter() - t0:.1f}s")
    if opts.phases:
        cs.time_cold_ms = Phases(lib)
    failed = 0
    t0 = time.perf_counter()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            cs.shared_kernel_phase(wk, parent, opts.only.split(",") if opts.only else None)
    except SystemExit:  # chip_smoke.fail: the message went to stderr
        failed = 1
    except Exception as e:  # a launch error: report it after the lines so far
        failed = 1
        print(f"FAILED: {type(e).__name__}: {e}", file=out)
    for line in out.getvalue().splitlines():
        say(line)
    say(f"cases done in {time.perf_counter() - t0:.1f}s; failed={failed}")
    if opts.stages and not failed:
        stages(parent)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text("\n".join(_lines) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""B1 and B2 per factor on the general kernel (``factor_kernel`` of
``pathfinder_tpu_torch/csrc/woodbury_general.cu``), alone, on one card.

    python3 tools/woodbury_general_bench.py                # check and time every case
    python3 tools/woodbury_general_bench.py --no-time      # check only
    python3 tools/woodbury_general_bench.py --clusters     # also time each cluster size
    python3 tools/woodbury_general_bench.py --parent DIR   # also time DIR's general kernel
    python3 tools/woodbury_general_bench.py --phases       # cycles of each phase, timed cases

Builds the kernels, then runs the per-factor cases of
``chip_smoke.py``'s general phase: ``GENERAL_B1`` and ``GENERAL_B2`` at
ranks 0, 12, 40, 100 and 258 in float64, float32, bfloat16 and float16,
``CONFIG2_B1`` and the float64 winner shape. Each case is held against its
plain version at ``chip_smoke.py``'s tolerances and launched twice for the
same bits; the cases at d = 1000 and config 2's are timed L2-cold
(``chip_smoke.time_cold_ms``) beside the plain version, the bound and the
share of it. ``--clusters`` times the d = 1000 cases at every cluster size
that fits, for the plan's choice. ``--parent DIR`` loads the kernel wrapper
of another checkout of the repo (``DIR/pathfinder_tpu_torch``) and times its
general kernel at the same cases in turns with this one (parent, this, this,
parent), from the same inputs. ``--phases`` runs every case on a copy of
the wrapper and the general source with ``PFG_PHASES`` defined (under
``build/phases/``) instead and prints, for each timed case, the clock64
cycles at which the first cluster's rank-0 CTA and the middle cluster's
ended each phase (staged, pass 1, t, pass 2, s, pass 3, sums, end) after an
L2-cold launch. Every case runs even after one fails; the
exit code is 1 if any failed. Prints the card's name and power limit first;
``--out FILE`` writes every line to FILE as well.
"""

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk  # noqa: E402

_lines = []


def say(line):
    print(line, flush=True)
    _lines.append(line)


def cases():
    """``(name, label, B, d, m, N, dtype, timed)`` of every per-factor case,
    in ``chip_smoke.py``'s order, so that every case gets the same inputs as
    there."""
    for dt_name in cs.GENERAL_DTYPES:
        for m in cs.GENERAL_RANKS:
            for name, shapes in (("sample_and_logq", cs.GENERAL_B1), ("whiten_sumsq", cs.GENERAL_B2)):
                for label, B, d, N in shapes:
                    yield name, label, B, d, m, N, getattr(torch, dt_name), d == cs.D
    for label, B, d, m, N in cs.CONFIG2_B1:
        yield "sample_and_logq", label, B, d, m, N, torch.float32, True
    for label, B, d, m, N in cs.GENERAL_WINNER_B1:
        yield "sample_and_logq", label, B, d, m, N, torch.float64, True


WRAPPER = "pathfinder_tpu_torch/ops/kernels/woodbury_kernels.py"
BUILD = "pathfinder_tpu_torch/ops/kernels/_build.py"


def _exec(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_wrapper(root, name):
    """The kernel wrapper of the package under ``root`` as a module of its
    own, which builds and binds the sources of that package. Where that
    package has a build module of its own (``_build.py``), the wrapper gets
    it, with that package's flags, build directory and launch; where it has
    none (a copy of this checkout's wrapper), it gets this checkout's."""
    kernels = sys.modules["pathfinder_tpu_torch.ops.kernels"]
    own, ours = Path(root) / BUILD, kernels._build
    if own.exists():
        kernels._build = _exec(own, name + "_build")  # what the wrapper's import reads
    try:
        return _exec(Path(root) / WRAPPER, name)
    finally:
        kernels._build = ours


def load_parent(path):
    """The kernel wrapper of the checkout at ``path``, its general kernel loaded."""
    mod = load_wrapper(path, "parent_woodbury_kernels")
    mod.load_general_library()
    return mod


PHASES = ("staged", "pass1", "t", "pass2", "s", "pass3", "sums", "end")


def load_phases_wrapper():
    """This checkout's wrapper over a copy of the general source with its
    phase stamps on (``PFG_PHASES``), under ``build/phases/general``; returns
    the wrapper and its general library."""
    root = ROOT / "build" / "phases" / "general"
    for rel, text in ((WRAPPER, (ROOT / WRAPPER).read_text()),
                      ("pathfinder_tpu_torch/csrc/woodbury_general.cu",
                       "#define PFG_PHASES\n" + wk._GENERAL_SOURCE.read_text())):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    mod = load_wrapper(root, "phases_woodbury_kernels")
    lib = mod.load_general_library()
    lib.pfg_read_stamps.argtypes = [ctypes.c_void_p]
    lib.pfg_read_stamps.restype = ctypes.c_int
    return mod, lib


def phase_line(lib, fn):
    """Cycles since the kernel's start at the end of each phase, one L2-cold launch."""
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    stamps = torch.zeros(20, dtype=torch.int64)
    out = []
    for who in range(2):
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        lib.pfg_read_stamps(stamps.data_ptr())
        st = stamps.view(2, 10)[who].tolist()
        out.append(("first" if who == 0 else "middle") + " " + " ".join(
            f"{name}={st[k + 1] - st[0]}" for k, name in enumerate(PHASES) if st[k + 1]))
    return "; ".join(out)


def run_case(mod, name, args, plan=None):
    if name == "sample_and_logq":
        return mod._sample_and_logq_cuda(*args, general=True, plan=plan)
    return mod._whiten_sumsq_cuda(*args[:5], general=True, plan=plan)


def one_case(rng, name, label, B, d, m, N, dtype, timed, opts, parent):
    """Check one case and time it; raises SystemExit (from ``cs.fail``) on a
    wrong result."""
    draws = cs.general_inputs(rng, B, d, m, N, dtype, offset=1 if label.startswith("odd") else 0)
    plan = wk._general_rows_plan(B, d, m, N, dtype, wk._num_sms(0))
    tag = f"{name} [{label} B={B} d={d} m={m} N={N} {str(dtype).replace('torch.', '')}]"
    err = max(cs.check_general_case(wk, name, tag, a, dtype) for a in draws)
    args = draws[-1]
    line = f"{tag} plan={tuple(plan)} max_abs_err={err:.3e}"
    if timed and not opts.no_time:
        plain_fn = ((lambda: wk.sample_and_logq_torch(*args)) if name == "sample_and_logq" else
                    (lambda: wk.whiten_sumsq_torch(*args[:5])))
        itemsize = torch.finfo(dtype).bits // 8
        bound, by = cs.bound_us(name, B, d, m, N, False, itemsize)
        if parent is not None:
            old = lambda: run_case(parent, name, args)  # noqa: E731
            new = lambda: run_case(wk, name, args)  # noqa: E731
            t = [cs.time_cold_ms(f) for f in (old, new, new, old)]
            ms, old_ms = min(t[1], t[2]), min(t[0], t[3])
            line += f" parent_us={1e3 * t[0]:.1f}/{1e3 * t[3]:.1f}"
        else:
            ms = cs.time_cold_ms(lambda: run_case(wk, name, args))
            old_ms = None
        plain_ms = cs.time_cold_ms(plain_fn)
        line += (f" us={1e3 * ms:.1f} plain_us={1e3 * plain_ms:.1f} bound_us={bound:.2f} ({by})"
                 f" share={bound / (1e3 * ms):.3f}")
        if old_ms is not None:
            line += f" speedup={old_ms / ms:.2f}"
        if opts.phases:
            line += " | " + phase_line(opts.stamps, lambda: run_case(wk, name, args))
        if opts.clusters and d == cs.D:
            for c in (1, 2, 4, 8):
                try:
                    p = wk._general_rows_plan(B, d, m, N, dtype, cluster=c)
                except ValueError:
                    continue
                line += f" cluster{c}={1e3 * cs.time_cold_ms(lambda: run_case(wk, name, args, p)):.1f}"
    say(line)


def main():
    global wk
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--no-time", action="store_true", help="check only")
    parser.add_argument("--clusters", action="store_true", help="time every cluster size")
    parser.add_argument("--parent", help="a checkout whose general kernel is timed beside this one")
    parser.add_argument("--phases", action="store_true", help="cycles of each phase")
    parser.add_argument("--only", help="run only the cases whose tag contains this text")
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
        wk, opts.stamps = load_phases_wrapper()
    else:
        wk.load_general_library()
    parent = load_parent(opts.parent) if opts.parent else None
    say(f"build: {time.perf_counter() - t0:.1f}s")
    for (name, dt_name, nt), r in sorted(wk.general_kernel_resources().items(), key=str):
        say(f"resources {name} {dt_name} NT={nt}: "
            f"registers={r.get('registers')} spill_stores={r.get('spill_stores')}B "
            f"spill_loads={r.get('spill_loads')}B")
    rng = np.random.default_rng(2025)
    failed = 0
    t0 = time.perf_counter()
    for case in cases():
        if opts.only and not any(
                part in f"{case[0]} {case[1]} m={case[4]} {case[6]}" for part in opts.only.split(",")):
            continue
        try:
            one_case(rng, *case, opts, parent)
        except SystemExit:
            failed += 1
            say(f"FAILED {case[:7]}")
        except Exception as e:  # a launch error: report it and go on
            failed += 1
            say(f"FAILED {case[:7]}: {type(e).__name__}: {e}")
            torch.cuda.synchronize()
    say(f"cases done in {time.perf_counter() - t0:.1f}s; failed={failed}")
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text("\n".join(_lines) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""How far float32 B1 and B2 are from the truth where the rank m is at least
d, on one card.

    python3 tools/woodbury_float32_edge.py             # 5 draws a case
    python3 tools/woodbury_float32_edge.py --draws 20  # 20 draws a case

At m >= d with a random C (not a Woodbury factor's) the float32 result is
ill-conditioned, so cuBLAS itself lies near ``chip_smoke.X_TOL`` from the
truth. ``chip_smoke.py`` therefore holds the general kernel's float32 cases
at m >= d to the float64 plain version of the same inputs, over
``F32_EDGE_DRAWS`` independent draws. This script runs those cases (the
general phase's d = 25 shapes at m = 40, 100 and 258, and the workspace case
(4, 999, 1000, 5) with its 16 KB plan) over ``--draws`` independent draws
from its own seeded generator, and prints for each draw the largest
|error| / (atol + rtol |truth|) of the plain float32 version (cuBLAS) and of
the kernel against the float64 computation, with X_TOL on x and SUM_TOL on
the sums (``chip_smoke.py`` passes a case below 1). Prints the card's name
and power limit first; exits 1 if the kernel misses on any draw.
"""

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk  # noqa: E402


def edge_cases():
    """``(name, label, B, d, m, N, plan)`` of the general phase's float32
    cases with m >= d."""
    for m in cs.GENERAL_RANKS:
        for name, shapes in (("sample_and_logq", cs.GENERAL_B1), ("whiten_sumsq", cs.GENERAL_B2)):
            for label, B, d, N in shapes:
                if m >= d:
                    yield name, label, B, d, m, N, None
    for name in ("sample_and_logq", "whiten_sumsq"):
        B, d, m, N = 4, 999, 1000, 5
        yield name, "workspace", B, d, m, N, wk._general_rows_plan(
            B, d, m, N, torch.float32, smem_limit=16384)


def ratio(got, want, tol):
    rtol, atol = tol
    return float(((got.double() - want).abs() / (atol + rtol * want.abs())).max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--draws", type=int, default=cs.F32_EDGE_DRAWS, help="draws a case")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    wk.load_general_library()
    rng = np.random.default_rng(7)
    worst = 0.0
    for name, label, B, d, m, N, plan in edge_cases():
        for i in range(opts.draws):
            args = cs._seeded_inputs(rng, B, d, m, N, torch.float32, offset=int(label == "workspace"))
            f64 = tuple(a.double() for a in args)
            if name == "sample_and_logq":
                truth = wk.sample_and_logq_torch(*f64)
                plain = wk.sample_and_logq_torch(*args)
                kernel = wk._sample_and_logq_cuda(*args, general=True, plan=plan)
                pairs = (("x", 0, cs.X_TOL), ("logq", 1, cs.SUM_TOL))
            else:
                truth = (wk.whiten_sumsq_torch(*f64[:5]),)
                plain = (wk.whiten_sumsq_torch(*args[:5]),)
                kernel = (wk._whiten_sumsq_cuda(*args[:5], general=True, plan=plan),)
                pairs = (("maha", 0, cs.SUM_TOL),)
            torch.cuda.synchronize()
            parts = []
            for out, k, tol in pairs:
                pr, kr = ratio(plain[k], truth[k], tol), ratio(kernel[k], truth[k], tol)
                worst = max(worst, kr)
                parts.append(f"{out}: plain {pr:.3f} kernel {kr:.3f}")
            print(f"{name} [{label} B={B} d={d} m={m} N={N} float32] draw {i}: error / tolerance "
                  f"against float64, largest: " + ", ".join(parts), flush=True)
    print(f"largest kernel error / tolerance over every case and draw: {worst:.3f}", flush=True)
    sys.exit(1 if worst > 1 else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""How far float32 B1 is from the truth at the general phase's two cases
with rank m >= d, on one card.

    python3 tools/woodbury_float32_edge.py

``chip_smoke.py`` holds the general kernel at float32 to its plain version
(cuBLAS) within X_TOL on x. At m >= d with its random C the float32 result
is ill-conditioned, so both sit near that tolerance from the truth. This
script rebuilds the inputs of the two such cases exactly as ``chip_smoke.py``
draws them (every ``_seeded_inputs`` call of its general phase, in order):
B1 at (128, 25, 258, 5) and the workspace case (4, 999, 1000, 5) with its
16 KB plan. For each it prints the largest |error| / (atol + rtol |truth|)
of the plain version and of the kernel against a float64 computation of the
same inputs, and of the kernel against the plain version (what
``chip_smoke.py`` checks; it passes below 1).
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk  # noqa: E402


def general_phase_inputs():
    """Yield ``(label, args)`` for every input of the general phase, in the
    order ``chip_smoke.general_kernel_phase`` draws them."""
    rng = np.random.default_rng(2025)
    for dt_name in cs.GENERAL_DTYPES:
        for m in cs.GENERAL_RANKS:
            for shapes in (cs.GENERAL_B1, cs.GENERAL_B2):
                for label, B, d, N in shapes:
                    offset = 1 if label.startswith("odd") else 0
                    args = cs._seeded_inputs(rng, B, d, m, N, getattr(torch, dt_name), offset=offset)
                    yield (label, dt_name, m, False), args
            for B, d, N in cs.GENERAL_SHARED_DRAWS:
                cs._seeded_inputs(rng, B, d, m, N, getattr(torch, dt_name), True, int(d == 999))
    for label, B, d, m, N in cs.CONFIG2_B1:
        yield (label, "float32", m, False), cs._seeded_inputs(rng, B, d, m, N, torch.float32)
    for label, B, d, m, N in cs.GENERAL_WINNER_B1:
        yield (label, "float64", m, False), cs._seeded_inputs(rng, B, d, m, N, torch.float64)
    for B, N in ((cs.K * 8, 5), (cs.K, 10)):
        yield ("vs-fast", "float32", cs.M, False), cs._seeded_inputs(rng, B, cs.D, cs.M, N, torch.float32)
    cs._seeded_inputs(rng, cs.K, cs.D, cs.M, 1000, torch.float32, True)  # drawn, not used
    yield ("workspace", "float32", 1000, False), cs._seeded_inputs(
        rng, 4, 999, 1000, 5, torch.float32, False, offset=1)


def ratio(got, want):
    rtol, atol = cs.X_TOL
    return float(((got.double() - want).abs() / (atol + rtol * want.abs())).max())


def main():
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    wk.load_general_library()
    for key, args in general_phase_inputs():
        if key not in (("glm-elbo", "float32", 258, False), ("workspace", "float32", 1000, False)):
            continue
        B, d, N = args[0].shape
        m = args[2].shape[-1]
        plan = (wk._general_rows_plan(B, d, m, N, torch.float32, smem_limit=16384)
                if key[0] == "workspace" else None)
        truth = wk.sample_and_logq_torch(*(a.double() for a in args))[0]
        plain = wk.sample_and_logq_torch(*args)[0]
        kernel = wk._sample_and_logq_cuda(*args, general=True, plan=plan)[0]
        torch.cuda.synchronize()
        print(f"B1 [{key[0]} B={B} d={d} m={m} N={N} float32] error / tolerance, largest: plain vs "
              f"float64 {ratio(plain, truth):.3f}, kernel vs float64 {ratio(kernel, truth):.3f}, "
              f"kernel vs plain {ratio(kernel, plain.double()):.3f}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of kernels B1 and B2 goes, phase by phase, on one card.

    python3 tools/woodbury_kernel_phases.py

Builds an instrumented copy of ``pathfinder_tpu_torch/csrc/woodbury_kernels.cu``
into ``build/`` (the source itself is not changed): thread 0 of the first
CTA records ``clock64()`` at the start of the kernel and after each phase.
Then, at the main path's shapes and L2-cold (a 256 MB buffer is overwritten
before each launch), it prints the kernel's median time (CUDA events over
15 launches) and that CTA's cycles since its start at the end of each phase:

    staged   rows of the slab (and M) in shared memory (B2: whitened)
    pass1    partial Xᵀv of the CTA's rows reduced in shared memory
    core     the cluster's partials summed, s = M t formed
    pass2    x written in place and its bulk store issued (B1), or ‖w‖²
             summed (B2)
    sums     column sums reduced, exchanged across the cluster and written
    end      the kernel's last barrier passed and x read out (B1)

Needs a CUDA card and ``nvcc``; prints the card's name, power limit and SM
clocks first.
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk  # noqa: E402

PHASES = ("staged", "pass1", "core", "pass2", "sums", "end")
SHAPES = (  # (kernel, B, N) at d = 1000, m = 12
    ("sample_and_logq", 800, 5),
    ("sample_and_logq", 100, 5),
    ("sample_and_logq", 100, 10),
    ("whiten_sumsq", 100, 10),
)


def instrumented_source() -> str:
    src = wk._SOURCE.read_text()

    def stamp(k):
        return (f"  if (blockIdx.x == 0 && threadIdx.x == 0) pf_stamps[{k}] = clock64();\n")

    after = [
        "  extern __shared__ float4 smem4[];\n",
        "  if (resident) stage_tile(0);\n",
        "        pass1_flush<MR, NT>(acc, tp, NC, cc, nt);\n      }\n    }\n    __syncthreads();\n",
        "      s[e] = acc;\n    }\n    __syncthreads();\n",
        "      store_run(x_out + (b * d + r0) * N, su, pad[0], n * N);\n",
        "            SAMPLE ? -0.5f * (static_cast<float>(d) * kLog2Pi + ldb + q) : q;\n      }\n",
    ]
    for k, anchor in enumerate(after):
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, anchor + stamp(k))
    anchor = "  if (threadIdx.x == 0) bulk_wait_read();\n}\n\nstruct Plan"
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in the source: {anchor!r}")
    src = src.replace(anchor, anchor.replace("}\n\nstruct", stamp(6) + "}\n\nstruct"))
    return src.replace(
        "namespace cg = cooperative_groups;",
        "namespace cg = cooperative_groups;\n"
        "__device__ long long pf_stamps[8];\n"
        'extern "C" int pf_read_stamps(long long* h) {\n'
        "  return (int)cudaMemcpyFromSymbol(h, pf_stamps, sizeof(long long) * 8);\n}",
    )


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "woodbury_phases.cu").write_text(instrumented_source())
    cmd = [wk._nvcc(), *wk._NVCC_FLAGS, "-o", str(out / "woodbury_phases.so"),
           str(out / "woodbury_phases.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        sys.exit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out / "woodbury_phases.so"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pf_sample_logq.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.pf_whiten_sumsq.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.pf_read_stamps.argtypes = [p]
    return lib


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, device="cuda")  # 256 MB, more than the L2
    stamps = (ctypes.c_longlong * 8)()
    d, m = 1000, 12
    for name, B, N in SHAPES:
        def rand(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        u, X, C, mu = rand(B, d, N), rand(B, d, m) / d**0.5, 0.1 * rand(B, m, m), rand(B, d)
        a_half, logdet = rand(B, d).abs() + 0.5, rand(B)
        out = torch.empty_like(u), torch.empty(B, N, device="cuda")
        if name == "sample_and_logq":
            entry, tensors = lib.pf_sample_logq, (u, a_half, X, C, mu, logdet) + out
        else:
            entry, tensors = lib.pf_whiten_sumsq, (u, a_half, X, C, mu, out[1])
        plan = wk._launch_plan(B, d, m, N)
        stream = torch.cuda.current_stream().cuda_stream
        times = []
        for _ in range(15):
            flush.zero_()
            torch.cuda._sleep(1_000_000)  # the launch is queued before the start event
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            code = entry(*[t.data_ptr() for t in tensors], B, d, m, N, *plan, stream)
            end.record()
            torch.cuda.synchronize()
            if code:
                sys.exit(f"{name} launch failed: {code}")
            times.append(start.elapsed_time(end))
        lib.pf_read_stamps(ctypes.addressof(stamps))
        cycles = {ph: stamps[k + 1] - stamps[0] for k, ph in enumerate(PHASES)}
        print(f"{name} B={B} d={d} m={m} N={N} plan={plan} "
              f"ms={statistics.median(times):.4f} cta0_cycles={cycles}", flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The Hager-Zhang state update on one card: the kernel
(``csrc/linesearch_kernels.cu``) against the plain version it replaces.

    python3 tools/hz_step_bench.py                 # K = 100, d = 1000, float64
    python3 tools/hz_step_bench.py --K 16 --d 1000 --dtype float32

On the benchmark's hierarchical posterior (``tests/hz_kernel_cases.py``),
from a search's first evaluation at a steepest-descent direction:

- one step, ``--reps`` times: the host's microseconds a call of the kernel's
  ``step`` and of ``_hz_step_torch`` (the loop's wall over the calls, no
  synchronize inside it), and the card's microseconds a step (CUDA events
  around the steps, queued behind a ``torch.cuda._sleep`` long enough that
  the host has queued them all before the first starts: ``queued`` says
  whether it had; the plain step 4 at a time, which the card's launch
  queue holds);
- the L-BFGS run of the headline (``maxiters=64``, ``history_length=6``)
  with the kernel and with the plain step, in turns (plain, kernel, kernel,
  plain), both with the plain iteration (the L-BFGS iteration kernel off,
  so that the step is all that differs): seconds a run, and that the traces
  are the same bits.

Prints the card's name and power limit first and one JSON line last.
"""

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch  # noqa: E402

from hz_kernel_cases import (  # noqa: E402
    hiergauss_logp, plain_iterations, plain_steps, same_bits)
from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad  # noqa: E402
from pathfinder_tpu_torch.ops import linesearch as tls  # noqa: E402
from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk  # noqa: E402
from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace  # noqa: E402


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip()


def device_us(fn, reps: int, sleep_cycles: int) -> tuple:
    """``(µs a call on the card, whether the host queued every call before
    the first ran)``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()  # the sleep still runs: every call is queued behind it
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / reps, queued


def host_us(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, default=100)
    ap.add_argument("--d", type=int, default=1000)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--runs", type=int, default=2, help="L-BFGS runs of each kind")
    args = ap.parse_args(argv)
    print(f"card: {card()}", flush=True)
    dtype, K, d = getattr(torch, args.dtype), args.K, args.d
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2**33 + 29)
    obs = torch.randn(d - 1, generator=gen, device="cuda", dtype=dtype)
    x0 = (torch.rand(K, d, generator=gen, device="cuda", dtype=dtype) * 2 - 1) * 2.0
    vg = autograd_value_and_grad(lambda z: hiergauss_logp(z, obs))

    def neg_vg(z):
        lp, g = vg(z)
        return -lp, -g

    # a search's first evaluation: every lane runs
    f0, g0 = neg_vg(x0)
    p = -g0
    alpha0 = tls.initial_step_size(x0, f0, g0)
    s, k = tls._hz_start(x0, f0, g0, p, alpha0, None, 0.1, 0.9, 10**6, 5.0, 1e-6, 0.66, 0.5)
    x_c = x0 + s["c"][:, None] * p
    phi_c, g_c = neg_vg(x_c)
    dphi_c = torch.sum(g_c * p, dim=-1)
    fused = lk.pack(s, k)
    steps = {"kernel": lambda: lk.step(fused, phi_c, g_c, dphi_c, x0, p, k),
             "plain": lambda: tls._hz_step_torch(s, phi_c, g_c, dphi_c, x0, p, k)}
    step_rows = {}
    for name, fn in steps.items():
        reps = args.reps if name == "kernel" else max(args.reps // 4, 5)
        # the card's launch queue holds about a thousand launches: the plain
        # step's ≈ 175 ops a call fit behind the sleep 4 calls at a time
        dev_reps = args.reps if name == "kernel" else 4
        fn()  # the library and each eager op's first launch
        host = host_us(fn, reps)
        # a sleep of 1.5 times the host's time for the calls, at 2 GHz
        dev, queued = device_us(fn, dev_reps, int(3e3 * host * dev_reps) + 10**7)
        step_rows[name] = dict(host_us=host, device_us=dev, queued=queued, reps=reps,
                               device_reps=dev_reps)
    for name, row in step_rows.items():
        print(f"step {name}: host {row['host_us']:.2f} us a call, card {row['device_us']:.2f} us "
              f"a step (queued behind the sleep: {row['queued']})", flush=True)

    minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)  # warm-up
    runs, traces = [], {}
    for kind in ["plain", "kernel", "kernel", "plain"] * args.runs:
        with plain_iterations(), plain_steps() if kind == "plain" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr = minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        runs.append((kind, secs))
        traces.setdefault(kind, tr)
        evals = float(tr.num_fn_evals.double().mean())
        print(f"lbfgs {kind}: {secs:.4f} s, evals/path {evals:.3f}", flush=True)
    same = all(same_bits(getattr(traces["kernel"], f), getattr(traces["plain"], f))
               for f in ("xs", "log_densities", "gradients", "num_fn_evals", "num_valid"))
    print(json.dumps({"card": card(), "K": K, "d": d, "dtype": args.dtype, "step": step_rows,
                      "lbfgs_s": runs, "lbfgs_same_bits": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

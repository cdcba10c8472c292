#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
   builds the kernels from ``pathfinder_tpu_torch/csrc/`` and prints the
   build time.
2. Kernels against their plain torch versions on the card, at the shapes
   the main path gives them and at odd, wide, large and row-tiled ones,
   with random factors from a seeded numpy RNG; a repeated launch must give
   the same bits. Prints each one's launch plan, its L2-cold time beside
   the plain version's and its bound, and the registers and spills of the
   main path's kernel instantiations (``ptxas -v`` at build time).
3. The main path: ``multipathfinder`` on ``HierarchicalGaussian(1000)`` with
   100 paths for 5 seeds (the headline configuration), with every path
   succeeding, finite draws and k̂, both kernels launched in every run (the
   launches printed per kernel and shape (B, N)), the median k̂ and moment
   error inside the band of the JAX package, and bitwise-identical draws
   when a seed is repeated.

The second-to-last lines are a JSON summary of the kernels and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Quality band of the JAX package at the headline configuration (d=1000,
# K=100, maxiters=64, elbo_chunk=8, ndraws=1000, f32), run on CPU for keys
# 0..9: k̂ 1.545..2.223 and moment error (max over coordinates of
# |mean error| / posterior sd) 1.658..3.074. The band is [min − r/2,
# max + r/2] with r the range, because the port draws other random numbers
# and its median over 5 seeds carries Monte-Carlo error of its own.
KHAT_BAND = (1.21, 2.56)
MOMENT_ERR_BAND = (0.95, 3.78)

# Kernel vs plain version, f32 with a different summation order: x to
# rtol=atol=1e-5; the column sums (logq, Mahalanobis term, magnitude ~1e3)
# to rtol=1e-4.
X_TOL = (1e-5, 1e-5)
SUM_TOL = (1e-4, 1e-4)

D, K, M = 1000, 100, 12
SEEDS = (0, 1, 2, 3, 4)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_close(name, got, want, tol):
    import torch

    rtol, atol = tol
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version (max abs err {float(err.max())})")
    return float(err.max())


# Hopper peaks the bounds are taken against (NVIDIA's H100 SXM data sheet):
# HBM bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FLUSH_BYTES = 256 * 2**20  # more than the 50 MB L2: written before each timed launch


def time_cold_ms(fn, reps=20):
    """Median device time of one call with L2 cold (CUDA events): a 256 MB
    buffer is overwritten outside the timed window before every call, and
    the card is then kept busy for about half a millisecond, so that the
    call's host-side work is queued before the start event is reached."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_us(name, B, d, m, N):
    """Least time for the function's work on this card: each input read
    once, each output written once (f32), or its flops at the f32 rate,
    whichever is larger; and which of the two it is."""
    reads = B * (d * N + d * m + 2 * d + m * m) + (B if name == "sample_and_logq" else 0)
    writes = B * N + (B * d * N if name == "sample_and_logq" else 0)
    flops = B * N * (4 * d * m + 2 * m * m + 6 * d)
    t_bytes = 4 * (reads + writes) / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e6 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# (label, B, d, m, N): the main path's shapes first, then odd and large ones
B1_SHAPES = (
    ("elbo", K * 8, D, M, 5),  # an ELBO chunk: K paths × elbo_chunk 8 candidates
    ("winner", K, D, M, 5),  # the winner's replayed draws; the extra draws alike
    ("fresh", K, D, M, 10),  # fresh draws, ndraws / K = 10
    ("odd", 3, 999, 7, 3),
    ("wide", 4, 100, 12, 33),
    ("large", K, 10000, M, 10),
    ("tiled", 8, 30000, 32, 10),
)
B2_SHAPES = (
    ("psis", K, D, M, 10),  # own-component log densities of the K × 10 pooled draws
    ("odd", 3, 999, 7, 3),
    ("wide", 4, 100, 12, 33),
    ("large", K, 10000, M, 10),
    ("tiled", 8, 30000, 32, 10),
)
MAIN_PATH = {"sample_and_logq": ("elbo", "winner", "fresh"), "whiten_sumsq": ("psis",)}


def kernel_phase(wk):
    """B1 and B2 against their plain versions at the main path's shapes and
    at odd and large ones, L2-cold times beside the bound."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2024)

    def t(a, offset=0):
        # offset > 0 starts the tensor that many floats into its allocation,
        # so that the kernels' unaligned heads and tails are exercised
        a = torch.tensor(a, dtype=torch.float32)
        if not offset:
            return a.to("cuda")
        store = torch.empty(a.numel() + offset, dtype=torch.float32, device="cuda")
        view = store[offset:].view(a.shape)
        view.copy_(a)
        return view

    def factors(B, d, m, offset=0):
        return dict(
            a_half=t(rng.uniform(0.5, 1.5, (B, d)), offset),
            X=t(rng.standard_normal((B, d, m)) / np.sqrt(d), offset),
            C=t(0.1 * rng.standard_normal((B, m, m)), offset),
            mu=t(rng.standard_normal((B, d)), offset),
            logdet=t(10.0 * rng.standard_normal(B), offset),
        )

    results = {"sample_and_logq": [], "whiten_sumsq": []}
    for name, shapes in (("sample_and_logq", B1_SHAPES), ("whiten_sumsq", B2_SHAPES)):
        for label, B, d, m, N in shapes:
            offset = 1 if label == "odd" else 0
            f = factors(B, d, m, offset)
            u = t(rng.standard_normal((B, d, N)), offset)
            if name == "sample_and_logq":
                args = (u, f["a_half"], f["X"], f["C"], f["mu"], f["logdet"])
                x, logq = wk.sample_and_logq(*args)
                xr, logqr = wk.sample_and_logq_torch(*args)
                torch.cuda.synchronize()
                err = max(check_close(f"B1 x {label}", x, xr, X_TOL),
                          check_close(f"B1 logq {label}", logq, logqr, SUM_TOL))
                x2, logq2 = wk.sample_and_logq(*args)
                if not (torch.equal(x, x2) and torch.equal(logq, logq2)):
                    fail(f"B1 {label}: a repeated launch gave other bits")
                kernel, plain = wk.sample_and_logq, wk.sample_and_logq_torch
            else:
                args = (u, f["a_half"], f["X"], f["C"], f["mu"])
                maha = wk.whiten_sumsq(*args)
                mahar = wk.whiten_sumsq_torch(*args)
                torch.cuda.synchronize()
                err = check_close(f"B2 maha {label}", maha, mahar, SUM_TOL)
                if not torch.equal(maha, wk.whiten_sumsq(*args)):
                    fail(f"B2 {label}: a repeated launch gave other bits")
                kernel, plain = wk.whiten_sumsq, wk.whiten_sumsq_torch
            ms = time_cold_ms(lambda: kernel(*args))
            plain_ms = time_cold_ms(lambda: plain(*args))
            bound, bound_by = bound_us(name, B, d, m, N)
            plan = wk._launch_plan(B, d, m, N)
            row = dict(label=label, B=B, d=d, m=m, N=N, err=err, ms=ms, plain_ms=plain_ms,
                       bound_us=bound, bound_by=bound_by, plan=plan)
            results[name].append(row)
            print(f"kernel {name} [{label}: B={B} d={d} m={m} N={N}] "
                  f"plan(cluster,threads,smem,tile)={plan} max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_us={bound:.2f} "
                  f"({bound_by}) share={bound / (1e3 * ms):.3f}", flush=True)
    for (name, mr, nt), r in sorted(wk.kernel_resources().items()):
        if mr == 12 and nt == 5:  # the main path's instantiations (m = 12, N = 5 or 10)
            print(f"kernel {name} MR={mr} NT={nt}: registers={r.get('registers')} "
                  f"spill_stores={r.get('spill_stores')}B spill_loads={r.get('spill_loads')}B",
                  flush=True)
    return results


def main_path_phase(pt, wk, zoo):
    """The headline multipathfinder for every seed, then a repeated seed."""
    import numpy as np
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)

    totals = {name: 0 for name in wk.launch_counts()}

    def run(seed):
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grew = wk.launch_counts()
        by_shape = {n: {f"B={b},N={n_}": c for (b, n_), c in sorted(v.items())}
                    for n, v in wk.launch_counts_by_shape().items()}
        for n in totals:
            totals[n] += grew[n]
        return res, secs, grew, by_shape

    khats, merrs, times, runs = [], [], [], {}
    for seed in SEEDS:
        res, secs, grew, by_shape = run(seed)
        n_ok = int(res.states.success.sum())
        draws = res.draws.double().cpu().numpy()
        khat = float(res.psis_result.pareto_shape)
        if n_ok != K:
            fail(f"seed {seed}: {n_ok}/{K} paths succeeded")
        if tuple(res.draws.shape) != (D, 1000) or not np.isfinite(draws).all():
            fail(f"seed {seed}: draws of shape {tuple(res.draws.shape)} not all finite")
        if not np.isfinite(khat):
            fail(f"seed {seed}: k-hat is not finite")
        if min(grew.values()) <= 0:
            fail(f"seed {seed}: a kernel was not launched on the main path: {grew}")
        merr = float(np.max(np.abs(draws.mean(axis=1) - mean_t) / sd_t))
        sderr = float(np.max(np.abs(draws.std(axis=1) - sd_t) / sd_t))
        evals = int(res.states.num_fn_evals.sum())
        print(f"main path seed={seed}: paths_ok={n_ok}/{K} khat={khat:.4f} "
              f"moment_err_mean_sd_units={merr:.4f} moment_err_sd_rel={sderr:.4f} "
              f"logp_grad_evals={evals} wall_s={secs:.3f} launches={grew} "
              f"launches_by_shape={by_shape}", flush=True)
        khats.append(khat)
        merrs.append(merr)
        times.append(secs)
        runs[seed] = res
    repeat, secs, _, _ = run(SEEDS[0])
    times.append(secs)
    if not torch.equal(repeat.draws, runs[SEEDS[0]].draws):
        fail("a repeated seed gave different draws")
    med_k, med_m = statistics.median(khats), statistics.median(merrs)
    print(f"main path: median khat={med_k:.4f} band={KHAT_BAND}; median moment "
          f"error={med_m:.4f} band={MOMENT_ERR_BAND}; wall first={times[0]:.3f}s "
          f"steady median={statistics.median(times[1:]):.3f}s; "
          f"repeated seed bitwise identical", flush=True)
    if not KHAT_BAND[0] <= med_k <= KHAT_BAND[1]:
        fail(f"median k-hat {med_k} outside the JAX band {KHAT_BAND}")
    if not MOMENT_ERR_BAND[0] <= med_m <= MOMENT_ERR_BAND[1]:
        fail(f"median moment error {med_m} outside the JAX band {MOMENT_ERR_BAND}")
    return totals


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    # the plain versions and the port's own matmuls run in full f32, never
    # TF32 (PyTorch's default, stated here because the tolerances rely on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    try:
        import pathfinder_tpu_torch as pt
        from pathfinder_tpu_torch.models import zoo
        from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
    except ImportError as e:
        fail(f"the port is not beside this script: {e}")
    if Path(pt.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {pt.__file__}, not from this checkout")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    wk.load_library()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f}s", flush=True)

    kernels = kernel_phase(wk)
    counts = main_path_phase(pt, wk, zoo)

    source = "pathfinder_tpu_torch/csrc/woodbury_kernels.cu"
    replaces = {
        "sample_and_logq": "pathfinder_tpu/ops/pallas/woodbury_kernels.py:70",
        "whiten_sumsq": "pathfinder_tpu/ops/pallas/woodbury_kernels.py:146",
    }
    summary = []
    for name, rows in kernels.items():
        main = [r for r in rows if r["label"] in MAIN_PATH[name]]
        head = main[0]  # the largest main-path shape
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces[name],
            "launches": counts[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_us"] / 1e3,
            "bound_by": head["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
        })
        if counts[name] <= 0:
            fail(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

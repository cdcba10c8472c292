#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
   builds the kernels from ``pathfinder_tpu_torch/csrc/`` and prints the
   build time.
2. Kernels against their plain torch versions on the card, at the shapes
   the main path gives them, with random factors from a seeded numpy RNG;
   prints each one's time beside the plain version's.
3. The main path: ``multipathfinder`` on ``HierarchicalGaussian(1000)`` with
   100 paths for 5 seeds (the headline configuration), with every path
   succeeding, finite draws and k̂, both kernels launched in every run, the
   median k̂ and moment error inside the band of the JAX package, and
   bitwise-identical draws when a seed is repeated.

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


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(wk):
    """B1 and B2 against their plain versions at the main path's shapes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2024)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device="cuda")

    def factors(B, d, m):
        return dict(
            a_half=t(rng.uniform(0.5, 1.5, (B, d))),
            X=t(rng.standard_normal((B, d, m)) / np.sqrt(d)),
            C=t(0.1 * rng.standard_normal((B, m, m))),
            mu=t(rng.standard_normal((B, d))),
            logdet=t(10.0 * rng.standard_normal(B)),
        )

    results = {"sample_and_logq": [], "whiten_sumsq": []}
    # B1: the ELBO chunk (K paths × elbo_chunk 8 candidates), the winner's
    # replayed draws, the extra draws (ndraws − ndraws_elbo = 5) and the
    # fresh draws (ndraws = 10)
    for label, B, N in (("elbo", K * 8, 5), ("winner", K, 5), ("fresh", K, 10)):
        f = factors(B, D, M)
        u = t(rng.standard_normal((B, D, N)))
        args = (u, f["a_half"], f["X"], f["C"], f["mu"], f["logdet"])
        x, logq = wk.sample_and_logq(*args)
        xr, logqr = wk.sample_and_logq_torch(*args)
        torch.cuda.synchronize()
        err = max(check_close(f"B1 x {label}", x, xr, X_TOL),
                  check_close(f"B1 logq {label}", logq, logqr, SUM_TOL))
        ms = time_ms(lambda: wk.sample_and_logq(*args))
        plain_ms = time_ms(lambda: wk.sample_and_logq_torch(*args))
        results["sample_and_logq"].append((label, B, N, err, ms, plain_ms))
    # B2: own-component log densities of the K × ndraws_per_run pooled draws
    for label, B, N in (("psis", K, 10),):
        f = factors(B, D, M)
        x = t(rng.standard_normal((B, D, N)))
        args = (x, f["a_half"], f["X"], f["C"], f["mu"])
        maha = wk.whiten_sumsq(*args)
        mahar = wk.whiten_sumsq_torch(*args)
        torch.cuda.synchronize()
        err = check_close(f"B2 maha {label}", maha, mahar, SUM_TOL)
        ms = time_ms(lambda: wk.whiten_sumsq(*args))
        plain_ms = time_ms(lambda: wk.whiten_sumsq_torch(*args))
        results["whiten_sumsq"].append((label, B, N, err, ms, plain_ms))
    for name, rows in results.items():
        for label, B, N, err, ms, plain_ms in rows:
            print(f"kernel {name} [{label}: B={B} d={D} m={M} N={N}] "
                  f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    return results


def main_path_phase(pt, wk, zoo):
    """The headline multipathfinder for every seed, then a repeated seed."""
    import numpy as np
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)

    def run(seed):
        before = wk.launch_counts()
        t0 = time.perf_counter()
        res = pt.multipathfinder(
            target, 1000, nruns=K, maxiters=64, elbo_chunk=8, device="cuda", seed=seed
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = wk.launch_counts()
        grew = {n: after[n] - before[n] for n in after}
        return res, secs, grew

    wk.reset_launch_counts()
    khats, merrs, times, runs = [], [], [], {}
    for seed in SEEDS:
        res, secs, grew = run(seed)
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
              f"logp_grad_evals={evals} wall_s={secs:.3f} launches={grew}", flush=True)
        khats.append(khat)
        merrs.append(merr)
        times.append(secs)
        runs[seed] = res
    repeat, secs, _ = run(SEEDS[0])
    times.append(secs)
    if not torch.equal(repeat.draws, runs[SEEDS[0]].draws):
        fail("a repeated seed gave different draws")
    counts = wk.launch_counts()
    med_k, med_m = statistics.median(khats), statistics.median(merrs)
    print(f"main path: median khat={med_k:.4f} band={KHAT_BAND}; median moment "
          f"error={med_m:.4f} band={MOMENT_ERR_BAND}; wall first={times[0]:.3f}s "
          f"steady median={statistics.median(times[1:]):.3f}s; "
          f"repeated seed bitwise identical", flush=True)
    if not KHAT_BAND[0] <= med_k <= KHAT_BAND[1]:
        fail(f"median k-hat {med_k} outside the JAX band {KHAT_BAND}")
    if not MOMENT_ERR_BAND[0] <= med_m <= MOMENT_ERR_BAND[1]:
        fail(f"median moment error {med_m} outside the JAX band {MOMENT_ERR_BAND}")
    return counts


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
        label, B, N, _, ms, plain_ms = rows[0]  # the largest main-path shape
        summary.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces[name],
            "launches": counts[name],
            "max_abs_err": max(r[3] for r in rows),
            "ms": ms,
            "plain_ms": plain_ms,
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

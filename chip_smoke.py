#!/usr/bin/env python3
"""Drive the PyTorch port's main path, its k̂-remedy path, its warm-start
path (constrained models, NUTS and HMC from a Pathfinder result) and the
paths and dim axes of its device mesh on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. Device and build: requires CUDA, prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``),
   builds the kernels from ``pathfinder_tpu_torch/csrc/`` and prints the
   build time.
2. Kernels against their plain torch versions on the card, at the shapes
   the main path and the remedy path give them (both kernels at rank 0: the
   Laplace components) and at odd, wide, large and row-tiled ones, with
   random factors from a seeded numpy RNG; a repeated launch must give the
   same bits. Prints each one's launch plan, its L2-cold time beside the
   plain version's and its bound, and the registers and spills of the main
   path's kernel instantiations (``ptxas -v`` at build time). Then the
   general kernel (every dtype and rank the fast one does not take) in its
   two modes against its plain version at float64, float32, bfloat16 and
   float16 and ranks 0, 12, 40, 100 and 258 (d = 1000 timed L2-cold beside
   its bound; d = 999 unaligned; d = 25; float32 at m >= d against the
   float64 plain version over 5 draws), each case's launch plan printed,
   B1 at config 2's shapes and the float64 headline's winner shape timed
   too, at float32 against the fast kernel, with its sums in the global
   workspace (B1 and B2 with their rows in tiles), and its registers and
   spills. Then the shared-x kernel (B2 over an x shared by every factor:
   the mixture denominator) at the same dtypes and ranks at the mixture
   grid (timed L2-cold beside its plain version, the CUDA-core bound and
   its tensor-core bound), at d = 999 and d = 25, at odd, wide and small
   float32 shapes, with X's ranks in windows and its sums in the workspace,
   where draws lie 30 sd out along a factor's widest direction, and at
   serving scale, (1024, 12, 5120), checked in column blocks of 512 that
   each give the whole launch's bits. Then the Hager-Zhang state-update
   kernel (``csrc/linesearch_kernels.cu``) against its plain version at the
   main path's shapes (100 lanes of d = 1000) in float64 and float32, and on
   the (1, 2) mesh's two row blocks: a whole search on the headline target,
   every state entry, the trial point and the flag bit for bit after every
   evaluation; one step timed on the card and on the host beside the plain
   step, and its bound. Then the L-BFGS iteration kernel (the same source)
   against the plain iteration at (100, 1000) and (100, 56) in float64 and
   float32 (``tests/lbfgs_kernel_cases.py``: one launch from a crafted batch
   and one in start mode; integers, booleans, trace, history rows, search
   state and trial point bit for bit, the sums over d to rounding), then an
   L-BFGS run at each d in float64 with the kernel and with the plain
   iteration: the card's µs a launch beside its bound and the host's µs an
   iteration, kernel and plain.
3. The main path: ``multipathfinder`` on ``HierarchicalGaussian(1000)`` with
   100 paths for 5 seeds (the headline configuration), with every path
   succeeding, finite draws and k̂, both kernels and the line-search kernel
   launched in every run (the launches printed per kernel and shape (B, N)),
   the median k̂ and moment
   error inside the band of the JAX package, and bitwise-identical draws
   when a seed is repeated.
4. The remedy path on the same target: ``optimizer="auto",
   auto_laplace=True`` for 3 seeds and ``importance_denominator="mixture"``
   for 2, with every path succeeding, finite draws and k̂, both kernels
   launched at rank 0 in each auto run that tried the Laplace correction,
   the shared-x kernel launched over the pooled draws in each mixture run
   and at rank 0 in ``laplace_resample`` of a mixture run, the auto run's k̂
   not above the main path's on any seed, its median k̂ and moment error
   inside the band of the JAX package, bitwise-identical draws when a seed
   is repeated, and the mixture denominator in blocks of 7 paths' draws
   bitwise the unblocked one (its log q, and the PSIS log weights over it).
   Then the stages of one auto call, timed one by one.
5. The warm start at full width: the headline result of seed 0 →
   ``warm_start_chains(result, 4)`` → ``nuts_chains`` (100 warm-up + 200
   sampling transitions, ``max_depth=10``, the fixed Pathfinder metric), with
   finite samples, no divergence after warm-up, max R̂, min bulk ESS and the
   moment error against the exact posterior inside the band of the JAX
   package; its times per call, per transition and per leaf iteration. Then
   NUTS from random starts with windowed mass-matrix adaptation (300
   warm-up, 100 draws), for the leapfrogs the warm start saves.
6. Constrained models, each through ``multipathfinder(model, 1000, nruns=8)``
   and then ``nuts_chains`` on 4 warm-started chains: logistic regression
   (d = 25), ordered logistic regression (d = 7, ``Ordered`` + ``Identity``)
   and a ``BayesModel`` with Normal, HalfNormal, Beta and Dirichlet(3) priors;
   8/8 paths, finite k̂, constrained draws inside their support, both kernels
   launched at (B, N) = (8, 125), R̂ < 1.05 on every coordinate, and on the
   logistic regression the Pathfinder mean within 0.5 posterior sd of the
   NUTS mean. Then ``hmc_warm_start`` on the logistic regression, mean
   acceptance in [0.6, 0.95].
7. Serving scale on the headline target: 32768 paths with
   ``keep_traces=False`` in launches of 8192, states offloaded to pinned
   host memory, then the same on the card (bitwise equal at every stage:
   states, pooled draws, log ratios, PSIS weights, resampled component ids
   and draws; else the first stage that differs is named), then the memory
   rule's own cap and offload choice; every path
   succeeding, k̂ and moment error inside the headline band, both kernels
   launched at the serving shapes; wall, paths/s and peak device memory of
   each run. A ``save_result``/``load_result`` round trip of a 4096-path
   run (launches of 1024) whose ``resample`` is bitwise equal; the
   ``elbo_estimates`` replay of a headline path against its stored
   ``elbo_values``; and ``fit_distributions`` of a slim path raising.
8. The paths axis of a device mesh, on one card named twice
   (``paths_mesh(["cuda:0", "cuda:0"])``): the headline configuration over
   the mesh with launches of 100 lanes against no mesh with launches of 50
   (the same per-device width), with the component and with the mixture
   denominator, bitwise equal at every stage and launching the kernels as
   often; then ``nuts_chains`` on 4 chains warm-started from the headline
   result over the mesh (25 + 25 transitions), bitwise equal to two
   unsharded ``nuts`` calls with chain ids 0–1 and 2–3. Each run's wall time
   and peak device memory are printed beside the card's name and power
   limit.
9. The dim axis of the mesh. First, with the kernel phases: B1 split in row
   blocks, its partial (t = X_rᵀu_r and ‖u_r‖² of each block), the sums in
   rank order and its resume (x on each block, logq from the summed ‖u‖²
   and the full d), at the ELBO shape (800, 12, 5) with d = 1000 in 2 and 4
   blocks, fast float32 and general float64, against the plain split
   (``sample_and_logq_partial_torch``/``_resume_torch``) and the unsplit
   kernel at the tolerances above, a repeat bitwise equal, one block's
   launches timed L2-cold beside their plain versions and bounds, with the
   plan each takes. Then the headline over ``paths_dim_mesh(1, ["cuda:0"] *
   2)`` on 3 seeds and ``paths_dim_mesh(2, ["cuda:0"] * 4)`` on seed 0:
   every path, the median k̂ and moment error in the headline band, both
   split modes launched in every run, each mesh's repeat bitwise equal at
   every stage; a ``(2, 1)`` mesh bitwise ``paths_mesh(["cuda:0"] * 2)``;
   the float64 headline on the ``(1, 2)`` mesh against the unsharded run
   (paths with the same fit iteration). B2 split the same way: its partial
   (t = X_rᵀv_r of each block) and resume (each block's ‖w_r‖², summed in
   rank order) at the PSIS shape (100, 12, 10), d = 1000 in 2 and 4 blocks,
   fast float32 and general float64, timed alike, and on every route as B1;
   on its path, ``MvNormal.logpdf`` of a dim-mesh result's pooled draws
   under their components through ``dim_map`` on two entries of the card,
   float32 and float64, against the unsharded ``logpdf``, a repeat bitwise
   equal, both B2 split modes launched. B2 over a shared x split on the
   shared-x kernel (its partial: t of every (factor, column) pair of each
   block; its resume: each block's ‖w_r‖², summed in rank order) at the
   mixture shape (100, 12, 1000), d = 1000 in 2 and 4 blocks, float32 and
   float64, against the plain split and the unsplit kernel, a repeat bitwise
   equal, one block timed L2-cold beside its plain version and its
   tensor-core bound; on every dtype and rank, a block of 999 rows and the
   plans with rank windows and the workspace. On its path,
   ``UniformMixture.logpdf`` of the headline mixture run's components at its
   pooled draws through ``dim_map`` on 2 and 4 entries of the card, float32
   and float64, against the unsharded mixture ratios, both shared-x split
   parts launched and the unsplit kernel not, a repeat bitwise equal; the
   mixture's ``sample`` in a group against the unsharded draws and ids; a
   dense SPD covariance (d = 1000, m = 12) through ``dim_map`` on 2 entries,
   ``logpdf`` and ``rand_and_logpdf`` against the unsharded call, a repeat
   bitwise equal, its peak memory. Every optimizer on the ``(1, 2)``
   mesh: the remedy path (``optimizer="auto", auto_laplace=True``) on seeds
   0–2 with phase 4's winner on each and k̂ within 0.005 of it, the median
   in the auto band, a repeat bitwise equal; BFGS at the headline against
   the unsharded BFGS run (the same paths succeed, fit iterations equal on
   95% of paths, |Δk̂| ≤ 0.01), its peak beside ``lane_bytes``; Newton on
   config 2 against the unsharded run; the port's ``minimize_cg_trace`` as a
   user callable, its trajectory bitwise the unsharded ``optimizer="cg"``
   run's. Walls and peak device memory beside the card's name and power
   limit.
10. Dtypes and ranks, the general kernel's paths: BASELINE config 2
   (``pathfinder(CorrelatedGaussian(100), history_length=20)``) on 5 seeds
   with its moment errors inside the JAX band, ``history_length=50``, the
   headline at ``history_length`` 20 and 50, in float64 on 5 seeds (k̂ and
   moment error inside the JAX-x64 band) and single-path, and one headline
   and one single-path call each in bfloat16 and float16 with the JAX
   package's warning and outcome; each run launches the general kernel and
   never the fast one, and the earlier float32 phases never launch the
   general one. The float64 runs and the dim axis's headline runs launch the
   line-search kernel; the 16-bit runs never do (their searches take the
   plain step).
11. The memory rule: a chunked BFGS run and a blocked ``laplace_resample``
   at d = 1000 under the rule's own choice, each estimate at least the
   measured peak and at most twice it.

The second-to-last lines are a JSON summary of the kernels and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": {...}}``.
"""

import importlib
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

# The same for the remedy path, ``optimizer="auto", auto_laplace=True``, run
# with the JAX package on CPU for keys 0..9 (x64 off): k̂ 1.0088, 0.8313,
# 1.0858, 0.7636, 0.8856, 1.0593, 0.6965, 0.6934, 0.9014, 0.8482 and moment
# error 0.9462, 1.1181, 1.3706, 0.7980, 1.8921, 1.4432, 0.8654, 0.9081,
# 1.0687, 0.8217. cg won on every key; the Laplace correction was tried on
# 9 keys and kept on 7. Bands again [min − r/2, max + r/2].
AUTO_KHAT_BAND = (0.50, 1.28)
AUTO_MOMENT_ERR_BAND = (0.25, 2.44)
MIXTURE_SEEDS = (0, 1)

# The warm-start phase (phase 5) with the JAX package on the CPU (x64 off) for
# keys 0..9 at the same sizes (``tests/reference_bands_warm_start.py``):
# max R̂ 1.0342..1.0512, min bulk ESS (of 800 draws) 217.1..538.3, moment
# error 0.0846..0.1045, 15 leapfrogs in every sampling transition (depth 4),
# step sizes 0.22..0.26, no divergence after warm-up on any key. Bands again
# [min − r/2, max + r/2], with the lower ends of R̂ and of the error at their
# ideals: a chain that mixes better than the reference's is no fault.
NUTS_RHAT_BAND = (1.0, 1.0598)
NUTS_ESS_BAND = (56.49, 698.87)
NUTS_MOMENT_ERR_BAND = (0.0, 0.1144)
NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES = 4, 100, 200
# NUTS from random starts, the comparison: 300 warm-up transitions (windowed
# adaptation) and, since the serving phase shares the run's time, 100 draws
COLD_SAMPLES = 100
HMC_ACCEPT_BAND = (0.6, 0.95)

# The serving-scale phase (phase 7): paths, the launch cap of its first two
# runs, and the file round trip's paths and cap
SERVE_K, SERVE_CAP = 32768, 8192
FILE_K, FILE_CAP = 4096, 1024

# Kernel vs plain version, f32 with a different summation order: x to
# rtol=atol=1e-5; the column sums (logq, Mahalanobis term, magnitude ~1e3)
# to rtol=1e-4.
X_TOL = (1e-5, 1e-5)
SUM_TOL = (1e-4, 1e-4)

D, K, M = 1000, 100, 12
# the fast kernel (float32, rank <= 32: every phase before the dtype and rank
# phases) and the general one (every other dtype or rank)
FAST_KERNELS = ("sample_and_logq", "whiten_sumsq")
GENERAL_KERNELS = ("sample_and_logq_general", "whiten_sumsq_general")
SEEDS = (0, 1, 2, 3, 4)
# the auto runs of the remedy phase: the first three seeds, since the
# warm-start and constrained-model phases share the run's time
REMEDY_SEEDS = SEEDS[:3]


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
# HBM bytes/s, float32 FLOP/s outside the tensor cores (the rate of the
# float32 accumulation the 16-bit cases run in) and float64 FLOP/s outside
# them; dense TF32 and float64 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
TF32_TC_FLOPS_PER_S = 494.7e12
F64_TC_FLOPS_PER_S = 67e12
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


def bound_us(name, B, d, m, N, shared=False, itemsize=4):
    """Least time for the function's work on this card: each input read
    once, each output written once (``itemsize`` bytes a value), or its
    flops at the rate of its accumulation type (float64 for 8-byte values,
    float32 otherwise), whichever is larger; and which of the two it is. A
    ``shared`` x of N columns is one input of d·N values, whatever the number
    of factors."""
    x_floats = d * N if shared else B * d * N
    reads = x_floats + B * (d * m + 2 * d + m * m) + (B if name == "sample_and_logq" else 0)
    writes = B * N + (B * d * N if name == "sample_and_logq" else 0)
    flops = B * N * (4 * d * m + 2 * m * m + 6 * d)
    t_bytes = itemsize * (reads + writes) / HBM_BYTES_PER_S
    t_ops = flops / (F64_FLOPS_PER_S if itemsize == 8 else F32_FLOPS_PER_S)
    return 1e6 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tc_bound_us(B, d, m, P, itemsize=4):
    """The shared-x kernel's own bound for B2 over a shared x of P columns:
    its two products (2·d·m each, a factor and column) on the tensor cores at
    the rate of the split it uses (3 TF32 products each for float32; for
    16-bit values 3 in the first and 2 in the second, whose X is exact in
    TF32; DMMA for float64), the rest (s = Ci t, the whitening and the sums)
    at the CUDA-core rate of ``bound_us``, or the bytes, whichever takes
    longest; and which it is."""
    pairs = B * P
    if itemsize == 8:
        t_mma = 4 * d * m * pairs / F64_TC_FLOPS_PER_S
    else:
        t_mma = (3 + (3 if itemsize == 4 else 2)) * 2 * d * m * pairs / TF32_TC_FLOPS_PER_S
    t_rest = pairs * (2 * m * m + 6 * d) / (F64_FLOPS_PER_S if itemsize == 8 else F32_FLOPS_PER_S)
    t_bytes = itemsize * (d * P + B * (d * m + 2 * d + m * m) + pairs) / HBM_BYTES_PER_S
    t, by = max((t_mma, "tensor-core operations"), (t_rest, "operations"), (t_bytes, "bytes"))
    return 1e6 * t, by


# (label, B, d, m, N): the main path's shapes first, then the remedy path's
# (m = 0: the Laplace-corrected components), then odd and large ones. Labels
# that start with "odd" put every tensor one float off 16-byte alignment.
# the constrained-model path: d below the rank m, below a warp's lanes and
# below the row split's floor, and N = 125 = ndraws / nruns, which the kernel
# walks in rounds of 40, 40, 40 and 5 columns
SMALL_SHAPES = (
    ("glm25", 8, 25, M, 125),  # logistic regression at German-credit scale, 8 paths
    ("glm7", 8, 7, M, 125),  # ordered logistic, negative binomial
    ("glm2", 8, 2, M, 125),  # the banana
    ("glm25-K100", K, 25, M, 10),
    ("glm25-extra", 8, 25, M, 120),  # a path's draws beyond the 5 ELBO ones: rounds of 40
    ("glm25-elbo", 8 * 16, 25, M, 5),  # an ELBO chunk: 8 paths × 16 candidates
)
# the serving phase's launches of 8192 paths: an ELBO chunk of 8192 × 8
# candidates, the winners' draws, a PSIS block
SERVE_B1 = (("serving-elbo", SERVE_CAP * 8, D, M, 5), ("serving-winner", SERVE_CAP, D, M, 5))
SERVE_B2 = (("serving-psis", SERVE_CAP, D, M, 5),)
B1_SHAPES = (
    ("elbo", K * 8, D, M, 5),  # an ELBO chunk: K paths × elbo_chunk 8 candidates
    ("winner", K, D, M, 5),  # the winner's replayed draws; the extra draws alike
    ("fresh", K, D, M, 10),  # fresh draws, ndraws / K = 10
    ("laplace", K, D, 0, 10),  # draws from the K diagonal Laplace components
    ("odd", 3, 999, 7, 3),
    ("odd-m0", 3, 999, 0, 3),
    ("wide", 4, 100, 12, 33),
    ("wide-m0", 4, 1000, 0, 90),  # rank 0 over a cluster, three rounds of columns
    ("large", K, 10000, M, 10),
    ("tiled", 8, 30000, 32, 10),
) + SMALL_SHAPES + SERVE_B1
B2_SHAPES = (
    ("psis", K, D, M, 10),  # own-component log densities of the K × 10 pooled draws
    ("laplace", K, D, 0, 10),  # the same under the Laplace components
    ("odd", 3, 999, 7, 3),
    ("odd-m0", 3, 999, 0, 3),
    ("wide", 4, 100, 12, 33),
    ("wide-m0", 4, 1000, 0, 90),
    ("large", K, 10000, M, 10),
    ("tiled", 8, 30000, 32, 10),
) + SMALL_SHAPES + SERVE_B2
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
        if B * d * m > 10**8:  # the serving shapes: made on the card, seeded
            g = torch.Generator("cuda").manual_seed(B)
            r = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
            return dict(a_half=0.5 + torch.rand((B, d), generator=g, device="cuda"),
                        X=r(B, d, m) / d**0.5, C=0.1 * r(B, m, m), mu=r(B, d), logdet=10.0 * r(B))
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
            offset = 1 if label.startswith("odd") else 0
            f = factors(B, d, m, offset)
            if B * d * m > 10**8:
                u = torch.randn((B, d, N), generator=torch.Generator("cuda").manual_seed(N),
                                device="cuda")
            else:
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
            del f, u, args
            print(f"kernel {name} [{label}: B={B} d={d} m={m} N={N}] "
                  f"plan(cluster,threads,smem,tile)={plan} "
                  f"max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_us={bound:.2f} "
                  f"({bound_by}) share={bound / (1e3 * ms):.3f}", flush=True)
    for (name, mr, nt), r in sorted(wk.kernel_resources().items()):
        if mr in (4, 12) and nt == 5:  # the instantiations of m = 12 and m = 0 at N = 5, 10
            print(f"kernel {name} MR={mr} NT={nt}: registers={r.get('registers')} "
                  f"spill_stores={r.get('spill_stores')}B spill_loads={r.get('spill_loads')}B",
                  flush=True)
    return results


# The general kernel (float16, bfloat16, float32, float64; any rank) against
# its plain version: both accumulate in float64 for float64 and in float32
# otherwise, and round each output to the storage dtype once. Tolerances:
# float64 rtol = atol = 1e-12 (the same arithmetic summed in another order);
# float32 as the fast kernel's, X_TOL on x and SUM_TOL on the sums; float16
# and bfloat16 4 ulps of the storage dtype at the output's magnitude,
# |got − want| <= 4·eps·max(|want|, mean |want|): the float32 sums of the two
# versions differ in their last bits, and rounding once to 16 bits can then
# land one ulp apart; the floor at the mean magnitude covers values that
# cancel to near zero. The general kernel at float32 and rank 12 against the
# fast kernel: rtol = atol = 1e-5 on everything.
GENERAL_DTYPES = ("float64", "float32", "bfloat16", "float16")
GENERAL_RANKS = (0, 12, 40, 100, 258)
GENERAL_F64_TOL = (1e-12, 1e-12)
GENERAL_VS_FAST_TOL = (1e-5, 1e-5)
ULPS_16 = 4
# (label, B, d, N): B1's ELBO chunk and B2's PSIS ratios at the headline
# width (timed); the same at d = 999, one value off 16-byte alignment, and at
# d = 25, the constrained models' width
GENERAL_B1 = (("elbo", K * 8, D, 5), ("odd-elbo", 8, 999, 5), ("glm-elbo", 128, 25, 5))
GENERAL_B2 = (("psis", K, D, 10), ("odd-psis", 8, 999, 10), ("glm-psis", K, 25, 10))
# float32 at rank m >= d (d = 25 at m = 40, 100, 258; the workspace case):
# C is random, not a Woodbury factor's, and the float32 result is
# ill-conditioned enough that cuBLAS itself lies near X_TOL from the truth
# (PERF.md §7), so these cases are held to the float64 plain version of the
# same inputs, at the same tolerances, over F32_EDGE_DRAWS independent draws
F32_EDGE_DRAWS = 5
# the main paths of the general kernel: the float64 headline (d = 1000, m =
# 12) and BASELINE config 2 (CorrelatedGaussian(100), history_length = 20:
# m = 40, single path: an ELBO chunk of 16 candidates × 100 draws, 2000
# output draws)
GENERAL_MAIN = {"sample_and_logq": ("float64", "elbo", 12), "whiten_sumsq": ("float64", "psis", 12)}
CONFIG2_B1 = (("config2-elbo", 16, 100, 40, 100), ("config2-draws", 1, 100, 40, 2000))
# the float64 headline's other B1 launch: the K winners' replayed draws (timed)
GENERAL_WINNER_B1 = (("winner", K, D, M, 5),)


def _seeded_inputs(rng, B, d, m, N, dtype, shared=False, offset=0):
    """``(u or x, a_half, X, C, mu, logdet)`` on the card in ``dtype``:
    numpy's ``rng`` up to 10⁷ values of u and X, a seeded card generator
    above.
    ``offset`` starts every tensor that many values into its allocation."""
    import numpy as np
    import torch

    if B * d * (m + N) > 10**7:
        g = torch.Generator("cuda").manual_seed(B * 7 + m)
        r = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
        u = r(d, N).mT.contiguous().mT if shared else r(B, d, N)
        out = (u, 0.5 + torch.rand((B, d), generator=g, device="cuda"), r(B, d, m) / d**0.5,
               0.1 * r(B, m, m), r(B, d), 10.0 * r(B))
        return tuple(a.to(dtype) for a in out)

    def t(a):
        a = torch.tensor(a, dtype=dtype)
        store = torch.empty(a.numel() + offset, dtype=dtype, device="cuda")
        view = store[offset:].view(a.shape)
        view.copy_(a)
        return view

    u = t(rng.standard_normal((N, d))).mT if shared else t(rng.standard_normal((B, d, N)))
    return (u, t(rng.uniform(0.5, 1.5, (B, d))), t(rng.standard_normal((B, d, m)) / np.sqrt(d)),
            t(0.1 * rng.standard_normal((B, m, m))), t(rng.standard_normal((B, d))),
            t(10.0 * rng.standard_normal(B)))


def check_general(name, got, want, dtype):
    """The general kernel's output against its plain version at the
    tolerance of ``dtype`` (above); the max abs error."""
    import torch

    if dtype == torch.float64:
        return check_close(name, got, want, GENERAL_F64_TOL)
    if dtype == torch.float32:
        return check_close(name, got, want, X_TOL if name.endswith(" x") else SUM_TOL)
    g, w = got.double(), want.double()
    err = (g - w).abs()
    floor = w.abs().mean()
    bad = err > ULPS_16 * torch.finfo(dtype).eps * torch.maximum(w.abs(), floor)
    if not torch.isfinite(g).all() or bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version (max abs err {float(err.max())})")
    return float(err.max())


def general_kernel_phase(wk):
    """The general kernel in its two modes against its plain version, for
    each dtype and rank, repeat launches bitwise equal; the general kernel
    at float32 against the fast kernel; a plan with its sums in the global
    workspace; the ptxas registers and spills of each instantiation."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2025)
    rows = []
    for dt_name in GENERAL_DTYPES:
        dtype = getattr(torch, dt_name)
        for m in GENERAL_RANKS:
            for name, shapes in (("sample_and_logq", GENERAL_B1), ("whiten_sumsq", GENERAL_B2)):
                for label, B, d, N in shapes:
                    rows.append(_general_case(wk, rng, name, label, B, d, m, N, dtype,
                                              timed=d == D))
    for label, B, d, m, N in CONFIG2_B1:
        rows.append(_general_case(wk, rng, "sample_and_logq", label, B, d, m, N, torch.float32,
                                  timed=True))
    for label, B, d, m, N in GENERAL_WINNER_B1:
        rows.append(_general_case(wk, rng, "sample_and_logq", label, B, d, m, N, torch.float64,
                                  timed=True))
    # the general kernel at float32, rank 12, against the fast kernel
    for name, B, N in (("sample_and_logq", K * 8, 5), ("whiten_sumsq", K, 10)):
        args = _seeded_inputs(rng, B, D, M, N, torch.float32)
        if name == "sample_and_logq":
            fast = wk._sample_and_logq_cuda(*args, general=False)
            gen = wk._sample_and_logq_cuda(*args, general=True)
            err = max(check_close(f"general vs fast B1 x B={B}", gen[0], fast[0], GENERAL_VS_FAST_TOL),
                      check_close(f"general vs fast B1 logq B={B}", gen[1], fast[1], GENERAL_VS_FAST_TOL))
        else:
            fast = wk._whiten_sumsq_cuda(*args[:5], general=False)
            gen = wk._whiten_sumsq_cuda(*args[:5], general=True)
            err = check_close(f"general vs fast B2 B={B} N={N}", gen, fast, GENERAL_VS_FAST_TOL)
        print(f"general kernel vs fast kernel {name} [B={B} d={D} m={M} N={N} float32]: "
              f"max_abs_err={err:.3e} tol={GENERAL_VS_FAST_TOL}", flush=True)
    # the global workspace: a plan whose sums do not fit a 16 KB CTA (rows in
    # tiles, the sums of one column tile in the workspace)
    for name in ("sample_and_logq", "whiten_sumsq"):
        B, d, m, N = 4, 999, 1000, 5
        plan = wk._general_rows_plan(B, d, m, N, torch.float32, smem_limit=16384)
        if not plan.ws:
            fail(f"the 16 KB plan {plan} did not put its sums in the workspace")
        err = max(check_general_case(wk, name, f"workspace {name}", args, torch.float32, plan)
                  for args in general_inputs(rng, B, d, m, N, torch.float32, offset=1))
        print(f"general kernel {name} with its sums in the workspace [B={B} d={d} m={m} N={N} "
              f"float32] plan={tuple(plan)}: max_abs_err={err:.3e} against the float64 plain "
              f"version over {F32_EDGE_DRAWS} draws", flush=True)
    for (name, dt_name, nt), r in sorted(wk.general_kernel_resources().items(), key=str):
        print(f"kernel {name} {dt_name}{'' if nt is None else f' NT={nt}'}: "
              f"registers={r.get('registers')} spill_stores={r.get('spill_stores')}B "
              f"spill_loads={r.get('spill_loads')}B", flush=True)
    return rows


def general_inputs(rng, B, d, m, N, dtype, offset=0):
    """The inputs of one general-kernel case: one draw, or F32_EDGE_DRAWS
    independent ones at float32 with m >= d."""
    import torch

    draws = F32_EDGE_DRAWS if dtype == torch.float32 and m >= d else 1
    return [_seeded_inputs(rng, B, d, m, N, dtype, offset=offset) for _ in range(draws)]


def check_general_case(wk, name, tag, args, dtype, plan=None):
    """The general kernel against its plain version on ``args`` (the float64
    plain version at float32 with m >= d) and a repeated launch bitwise
    equal; the max abs error."""
    import torch

    m, d = args[2].shape[-1], args[2].shape[-2]
    edge = dtype == torch.float32 and m >= d
    ref = tuple(a.double() for a in args) if edge else args
    if name == "sample_and_logq":
        kernel = lambda: wk._sample_and_logq_cuda(*args, general=True, plan=plan)  # noqa: E731
        got, want = kernel(), wk.sample_and_logq_torch(*ref)
        torch.cuda.synchronize()
        err = max(check_general(f"general B1 [{tag}] x", got[0], want[0], dtype),
                  check_general(f"general B1 [{tag}] logq", got[1], want[1], dtype))
        again = kernel()
        same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    else:
        kernel = lambda: wk._whiten_sumsq_cuda(*args[:5], general=True, plan=plan)  # noqa: E731
        got, want = kernel(), wk.whiten_sumsq_torch(*ref[:5])
        torch.cuda.synchronize()
        err = check_general(f"general B2 [{tag}]", got, want, dtype)
        same = torch.equal(got, kernel())
    if not same:
        fail(f"general {name} [{tag}]: a repeated launch gave other bits")
    return err


def _general_case(wk, rng, name, label, B, d, m, N, dtype, timed):
    """One case of the general kernel's phase; returns its row."""
    import torch

    draws = general_inputs(rng, B, d, m, N, dtype, offset=1 if label.startswith("odd") else 0)
    dt_name = str(dtype).replace("torch.", "")
    tag = f"{label} B={B} d={d} m={m} N={N} {dt_name}"
    err = max(check_general_case(wk, name, tag, args, dtype) for args in draws)
    args = draws[-1]
    if name == "sample_and_logq":
        kernel, plain = wk._sample_and_logq_cuda, wk.sample_and_logq_torch
    else:
        args = args[:5]
        kernel, plain = wk._whiten_sumsq_cuda, wk.whiten_sumsq_torch
    plan = wk._general_rows_plan(B, d, m, N, dtype, wk._num_sms(0))
    plan_text = f"plan(cluster,threads,tile,nc,colblk,whole,mres,smem,ws)={tuple(plan)}"
    row = dict(label=label, name=name, dtype=dt_name, B=B, d=d, m=m, N=N, err=err,
               plan=tuple(plan))
    line = f"kernel {name}_general [{tag}] {plan_text} max_abs_err={err:.3e}"
    if len(draws) > 1:
        line += f" (against the float64 plain version, {len(draws)} draws)"
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        row["ms"] = time_cold_ms(lambda: kernel(*args, general=True))
        row["plain_ms"] = time_cold_ms(lambda: plain(*args))
        row["bound_us"], row["bound_by"] = bound_us(name, B, d, m, N, itemsize=itemsize)
        line += (f" kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                 f"bound_us={row['bound_us']:.2f} ({row['bound_by']}) "
                 f"share={row['bound_us'] / (1e3 * row['ms']):.3f}")
    print(line, flush=True)
    del args, draws
    return row


# B2 over an x shared by every factor (the mixture denominator) on the
# shared-x kernel, against its plain version at the general phase's
# tolerances (float64 1e-12, float32 SUM_TOL, 16 bits 4 ulps), a repeated
# launch bitwise equal. (label, B, d, P) at every dtype and every rank of
# GENERAL_RANKS: the headline's mixture grid (timed), one value off 16-byte
# alignment, the constrained models' width
SHARED_SWEEP = (("mixture", K, D, 1000), ("odd-mixture", 8, 999, 1000), ("glm-mixture", 8, 25, 1000))
# (label, B, d, m, P) in float32: odd, wide and small shapes; "contiguous" hands
# x in as a contiguous (d, P) block, which the wrapper transposes once
SHARED_F32 = (
    ("odd-shared", 3, 999, 7, 77),
    ("wide-shared", 4, 20000, 12, 64),
    ("tiled-shared", 8, 30000, 32, 50),
    ("glm25-mixture", 8, 25, M, 1000),
    ("glm7-mixture", 8, 7, M, 1000),
    ("contiguous-m0", K, D, 0, 1000),
)
# one block of a 1024-path run's pooled 5 draws a path, held against the
# plain version in column blocks of at most SERVE_CHECK_COLS (whole, its v
# alone would take 21 GB)
SERVE_MIXTURE = ("serving-mixture", 1024, D, M, 5120)
SERVE_CHECK_COLS = 512
# (label, B, d, m, P, smem_limit): plans with X's ranks in windows, and with
# t and s in the workspace besides
SHARED_LIMITED = (("windows", 4, 999, 258, 77, 65536), ("workspace", 4, 999, 1000, 77, 65536))
# the ill-conditioned case: real Woodbury factors (rank 12), the first with
# one direction 100 of its other sds wide, and draws 30 of that direction's
# sds out along it. Whitening cancels most of each draw's length there, and
# the float32 plain version (cuBLAS) is itself up to 1.8e-4 off the float64
# one on an H100: the kernel is held to the plain version computed in float64
# from the same rounded inputs, at the float32 tolerance.
ILL_SD_OUT, ILL_WIDTH = 30.0, 1e4


def _shared_args(rng, B, d, m, P, dtype, offset=0, contiguous=False):
    x, a_half, X, Ci, mu, _ = _seeded_inputs(rng, B, d, m, P, dtype, True, offset)
    return (x.contiguous() if contiguous else x), a_half, X, Ci, mu


def shared_case(wk, label, args, timed, plan=None, parent=None, want=None):
    """One case of the shared-x kernel: checked against ``want`` (by default
    its plain version on the same inputs), launched again for the same bits
    and, where ``timed``, timed L2-cold beside its plain version, both bounds
    and (with ``parent``, another checkout's kernel module) the parent's
    kernel in turns (parent, this, this, parent). Returns its row."""
    import torch

    x, a_half, X, Ci, mu = args
    B, d, m, P, dtype = X.shape[0], X.shape[1], X.shape[2], x.shape[1], x.dtype
    dt_name = str(dtype).replace("torch.", "")
    tag = f"{label} B={B} d={d} m={m} P={P} {dt_name}"
    run = lambda: wk._whiten_sumsq_cuda(*args, plan=plan)  # noqa: E731
    got = run()
    want = wk.whiten_sumsq_torch(*args) if want is None else want
    torch.cuda.synchronize()
    err = check_general(f"shared-x B2 [{tag}]", got, want, dtype)
    if not torch.equal(got, run()):
        fail(f"shared-x B2 [{tag}]: a repeated launch gave other bits")
    plan = plan or wk._shared_plan(B, d, m, P, dtype)
    row = dict(label=label, dtype=dt_name, B=B, d=d, m=m, N=P, err=err, plan=tuple(plan))
    line = f"kernel whiten_sumsq_shared [{tag}] plan(W,F,NC,R,kw,ws,smem)={tuple(plan)} max_abs_err={err:.3e}"
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        if parent is not None:
            old = lambda: parent._whiten_sumsq_cuda(*args)  # noqa: E731
            t = [time_cold_ms(f) for f in (old, run, run, old)]
            row["ms"], row["parent_ms"] = min(t[1], t[2]), min(t[0], t[3])
            line += f" parent_us={1e3 * t[0]:.1f}/{1e3 * t[3]:.1f}"
        else:
            row["ms"] = time_cold_ms(run)
        row["plain_ms"] = time_cold_ms(lambda: wk.whiten_sumsq_torch(*args))
        row["bound_us"], row["bound_by"] = bound_us("whiten_sumsq", B, d, m, P, True, itemsize)
        row["tc_bound_us"], row["tc_bound_by"] = tc_bound_us(B, d, m, P, itemsize)
        line += (f" us={1e3 * row['ms']:.1f} plain_us={1e3 * row['plain_ms']:.1f} "
                 f"bound_us={row['bound_us']:.2f} ({row['bound_by']}) "
                 f"share={row['bound_us'] / (1e3 * row['ms']):.3f} "
                 f"tc_bound_us={row['tc_bound_us']:.2f} ({row['tc_bound_by']}) "
                 f"tc_share={row['tc_bound_us'] / (1e3 * row['ms']):.3f}")
        if parent is not None:
            line += f" speedup={row['parent_ms'] / row['ms']:.2f}"
    print(line, flush=True)
    return row


def _serving_mixture_case(wk, parent=None):
    """The serving-scale launch, held against the plain version block by
    block; each column block launched alone gives the whole launch's bits."""
    import torch

    label, B, d, m, P = SERVE_MIXTURE
    g = torch.Generator("cuda").manual_seed(P)
    r = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    args = (r(P, d).mT, 0.5 + torch.rand((B, d), generator=g, device="cuda"), r(B, d, m) / d**0.5,
            0.1 * r(B, m, m), r(B, d))
    x, rest = args[0], args[1:]
    got = wk._whiten_sumsq_cuda(*args)
    blocks = [(j, min(P, j + SERVE_CHECK_COLS)) for j in range(0, P, SERVE_CHECK_COLS)]
    err = 0.0
    for j0, j1 in blocks:
        part = (x[:, j0:j1],) + rest
        err = max(err, check_general(f"shared-x B2 [{label} columns {j0}:{j1}]", got[:, j0:j1],
                                     wk.whiten_sumsq_torch(*part), torch.float32))
        if not torch.equal(wk._whiten_sumsq_cuda(*part), got[:, j0:j1]):
            fail(f"shared-x B2 [{label}]: columns {j0}:{j1} launched alone gave other bits")
    if not torch.equal(got, wk._whiten_sumsq_cuda(*args)):
        fail(f"shared-x B2 [{label}]: a repeated launch gave other bits")
    run = lambda: wk._whiten_sumsq_cuda(*args)  # noqa: E731
    row = dict(label=label, dtype="float32", B=B, d=d, m=m, N=P, err=err,
               plan=tuple(wk._shared_plan(B, d, m, P, torch.float32)))
    if parent is not None:
        old = lambda: parent._whiten_sumsq_cuda(*args)  # noqa: E731
        t = [time_cold_ms(f, reps=5) for f in (old, run, run, old)]
        row["ms"], row["parent_ms"] = min(t[1], t[2]), min(t[0], t[3])
    else:
        row["ms"] = time_cold_ms(run, reps=5)
    row["plain_ms"] = time_cold_ms(
        lambda: [wk.whiten_sumsq_torch(x[:, j0:j1], *rest) for j0, j1 in blocks], reps=5)
    row["bound_us"], row["bound_by"] = bound_us("whiten_sumsq", B, d, m, P, True)
    row["tc_bound_us"], row["tc_bound_by"] = tc_bound_us(B, d, m, P)
    print(f"kernel whiten_sumsq_shared [{label} B={B} d={d} m={m} P={P} float32] "
          f"plan(W,F,NC,R,kw,ws,smem)={row['plan']} max_abs_err={err:.3e} "
          f"column blocks of {SERVE_CHECK_COLS} bitwise the whole launch's "
          + (f"parent_us={1e3 * t[0]:.1f}/{1e3 * t[3]:.1f} " if parent is not None else "")
          + f"us={1e3 * row['ms']:.1f} plain_us(in blocks)={1e3 * row['plain_ms']:.1f} "
          f"bound_us={row['bound_us']:.2f} ({row['bound_by']}) "
          f"share={row['bound_us'] / (1e3 * row['ms']):.3f} tc_bound_us={row['tc_bound_us']:.2f} "
          f"({row['tc_bound_by']}) tc_share={row['tc_bound_us'] / (1e3 * row['ms']):.3f}", flush=True)
    return row


def _ill_conditioned_args(dtype, B=16, P=1000):
    """Real Woodbury factors (the port's ``WoodburyPDMat``, d = 1000, rank
    12, made in float64 and rounded to ``dtype``), the first with one
    direction ``sqrt(ILL_WIDTH)`` times wider than its others, and ``P``
    draws ``ILL_SD_OUT`` of that direction's sds out along it; the factor's
    whitening cancels most of each draw's length."""
    import torch

    from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat

    g = torch.Generator("cuda").manual_seed(30)
    f64 = dict(dtype=torch.float64, device="cuda")
    A = 0.5 + torch.rand((B, D), generator=g, **f64)
    Bm = torch.randn((B, D, M), generator=g, **f64) / D**0.5
    wide = torch.ones((B, M), **f64)
    wide[:, 0] = ILL_WIDTH
    F = WoodburyPDMat.from_parts(A, Bm, torch.diag_embed(wide)).factor
    mu = torch.randn((B, D), generator=g, **f64)
    u = Bm[0, :, 0] / Bm[0, :, 0].norm()
    proj = Bm[0].mT @ u
    sd = torch.sqrt((A[0] * u * u).sum() + (proj * wide[0] * proj).sum())
    noise = A[0].sqrt()[:, None] * torch.randn((D, P), generator=g, **f64)
    x = (mu[0, :, None] + ILL_SD_OUT * sd * u[:, None] + noise).mT.contiguous().mT
    return tuple(t.to(dtype) for t in (x, F.a_half, F.X, F.Ci, mu))


def shared_kernel_phase(wk, parent=None, only=None):
    """The shared-x kernel: every case above against its plain version, a
    repeated launch bitwise equal, the d = 1000 cases timed L2-cold against
    both bounds (and the parent's kernel, given its module); the plans with
    windows and a workspace; the registers and spills of each
    instantiation. ``only``: run the cases whose tag holds one of these
    texts."""
    import numpy as np
    import torch

    def wanted(tag):
        return only is None or any(part in tag for part in only)

    rng = np.random.default_rng(2026)
    rows = []
    for dt_name in GENERAL_DTYPES:
        dtype = getattr(torch, dt_name)
        for m in GENERAL_RANKS:
            for label, B, d, P in SHARED_SWEEP:
                args = _shared_args(rng, B, d, m, P, dtype, offset=int(label.startswith("odd")))
                if wanted(f"{label} m={m} {dt_name}"):
                    rows.append(shared_case(wk, label, args, timed=d == D, parent=parent))
                del args
    for label, B, d, m, P in SHARED_F32:
        args = _shared_args(rng, B, d, m, P, torch.float32, offset=int(label.startswith("odd")),
                            contiguous=label.startswith("contiguous"))
        if wanted(f"{label} m={m} float32"):
            rows.append(shared_case(wk, label, args, timed=False))
    for label, B, d, m, P, limit in SHARED_LIMITED:
        plan = wk._shared_plan(B, d, m, P, torch.float32, smem_limit=limit)
        if plan.kw >= 8 * -(-m // 8) or (label == "workspace") != plan.ws:
            fail(f"the {limit} B plan {plan} has no rank windows, or not the workspace it should")
        args = _shared_args(rng, B, d, m, P, torch.float32, offset=1)
        if wanted(f"{label} m={m} float32"):
            rows.append(shared_case(wk, label, args, timed=False, plan=plan))
    for dt_name in ("float32", "float64"):
        dtype = getattr(torch, dt_name)
        if not wanted(f"ill-conditioned m={M} {dt_name}"):
            continue
        args = _ill_conditioned_args(dtype)
        truth = wk.whiten_sumsq_torch(*(a.double() for a in args))
        got = wk._whiten_sumsq_cuda(*args).double()
        plain = wk.whiten_sumsq_torch(*args).double()
        rel = lambda v: float(((v - truth).abs() / truth.abs()).max())  # noqa: E731
        print(f"shared-x B2 [ill-conditioned {dt_name}]: factor 0's maha "
              f"{float(truth[0].min()):.1f}..{float(truth[0].max()):.1f}; largest relative error "
              f"against the float64 plain version: kernel {rel(got):.3e}, plain {rel(plain):.3e}",
              flush=True)
        rows.append(shared_case(wk, "ill-conditioned", args, timed=False,
                                want=truth if dtype == torch.float32 else None))
    if wanted(f"{SERVE_MIXTURE[0]} m={M} float32"):
        rows.append(_serving_mixture_case(wk, parent))
    for (name, dt_name, mode), r in sorted(wk.shared_kernel_resources().items()):
        print(f"kernel {name} {dt_name} {mode}: registers={r.get('registers')} "
              f"spill_stores={r.get('spill_stores')}B spill_loads={r.get('spill_loads')}B", flush=True)
    return rows


def _check_result(label, res, mean_t, sd_t):
    """Paths, draws and k̂ of one result; returns ``(k̂, moment error)``."""
    import numpy as np

    n_ok = int(res.states.success.sum())
    draws = res.draws.double().cpu().numpy()
    khat = float(res.psis_result.pareto_shape)
    if n_ok != K:
        fail(f"{label}: {n_ok}/{K} paths succeeded")
    if tuple(res.draws.shape) != (D, 1000) or not np.isfinite(draws).all():
        fail(f"{label}: draws of shape {tuple(res.draws.shape)} not all finite")
    if not np.isfinite(khat):
        fail(f"{label}: k-hat is not finite")
    return khat, float(np.max(np.abs(draws.mean(axis=1) - mean_t) / sd_t))


def main_path_phase(pt, wk, zoo):
    """The headline multipathfinder for every seed, then a repeated seed."""
    import numpy as np
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)

    totals = dict({name: 0 for name in wk.launch_counts()}, hz_step=0, lbfgs_iter=0)

    def run(seed):
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=seed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        grew = dict(wk.launch_counts(), hz_step=_hz_launches(), lbfgs_iter=_iter_launches())
        by_shape = {n: {f"B={b},m={m},N={n_}": c for (b, m, n_, _), c in sorted(v.items())}
                    for n, v in wk.launch_counts_by_shape().items()}
        for n in totals:
            totals[n] += grew[n]
        return res, secs, grew, by_shape

    khats, merrs, times, runs = [], [], [], {}
    for seed in SEEDS:
        res, secs, grew, by_shape = run(seed)
        khat, merr = _check_result(f"seed {seed}", res, mean_t, sd_t)
        if min(grew[n] for n in FAST_KERNELS + ("hz_step", "lbfgs_iter")) <= 0:
            fail(f"seed {seed}: a kernel was not launched on the main path: {grew}")
        draws = res.draws.double().cpu().numpy()
        sderr = float(np.max(np.abs(draws.std(axis=1) - sd_t) / sd_t))
        evals = int(res.states.num_fn_evals.sum())
        print(f"main path seed={seed}: paths_ok={K}/{K} khat={khat:.4f} "
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
    return totals, dict(zip(SEEDS, khats)), runs[SEEDS[0]]


def remedy_phase(pt, wk, zoo, main_khats):
    """The k̂-remedy path at the headline configuration: the optimizer
    competition with the Laplace escalation, and the mixture denominator."""
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    totals = {name: 0 for name in wk.launch_counts()}

    def run(seed, **options):
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=seed,
                                 **options)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by_shape = wk.launch_counts_by_shape()
        for n, c in wk.launch_counts().items():
            totals[n] += c
        return res, secs, by_shape

    def shapes_text(by_shape):
        return {n: {f"B={b},m={m},N={n_}{',shared' if sh else ''}": c
                    for (b, m, n_, sh), c in sorted(v.items())} for n, v in by_shape.items()}

    def rank0(by_shape, name):
        return sum(c for (_, m, _, _), c in by_shape[name].items() if m == 0)

    auto = dict(optimizer="auto", auto_laplace=True)
    khats, merrs, times, first = [], [], [], None
    auto_runs = {}  # seed -> (winner, k-hat), for the dim phase's remedy path
    for seed in REMEDY_SEEDS:
        res, secs, by_shape = run(seed, **auto)
        khat, merr = _check_result(f"auto seed {seed}", res, mean_t, sd_t)
        kept = res.fit_distribution.components.cov.B.shape[-1] == 0
        # the correction is tried exactly when no candidate got below 0.7
        tried = kept or khat >= 0.7
        at_rank0 = {n: rank0(by_shape, n) for n in FAST_KERNELS}
        if tried and min(at_rank0.values()) <= 0:
            fail(f"auto seed {seed}: Laplace tried, but launches at rank 0 are {at_rank0}")
        if not tried and max(at_rank0.values()) > 0:
            fail(f"auto seed {seed}: launches at rank 0 without a Laplace correction")
        if khat > main_khats[seed]:
            fail(f"auto seed {seed}: k-hat {khat} above the main path's {main_khats[seed]}")
        print(f"remedy auto seed={seed}: winner={res.config.optimizer} laplace_tried={tried} "
              f"laplace_kept={kept} khat_main_path={main_khats[seed]:.4f} khat={khat:.4f} "
              f"moment_err_mean_sd_units={merr:.4f} "
              f"logp_grad_evals={int(res.states.num_fn_evals.sum())} wall_s={secs:.3f} "
              f"launches_by_shape={shapes_text(by_shape)}", flush=True)
        khats.append(khat)
        merrs.append(merr)
        times.append(secs)
        auto_runs[seed] = (res.config.optimizer, khat)
        first = first if first is not None else res
    repeat, secs, _ = run(SEEDS[0], **auto)
    times.append(secs)
    if not torch.equal(repeat.draws, first.draws):
        fail("auto: a repeated seed gave different draws")
    med_k, med_m = statistics.median(khats), statistics.median(merrs)
    med_main = statistics.median(main_khats[seed] for seed in REMEDY_SEEDS)
    print(f"remedy auto: median khat={med_k:.4f} band={AUTO_KHAT_BAND} (main path "
          f"{med_main:.4f}); median moment error={med_m:.4f} band={AUTO_MOMENT_ERR_BAND}; "
          f"wall first={times[0]:.3f}s steady median={statistics.median(times[1:]):.3f}s; "
          f"repeated seed bitwise identical", flush=True)
    if not AUTO_KHAT_BAND[0] <= med_k <= AUTO_KHAT_BAND[1]:
        fail(f"auto: median k-hat {med_k} outside the JAX band {AUTO_KHAT_BAND}")
    if not AUTO_MOMENT_ERR_BAND[0] <= med_m <= AUTO_MOMENT_ERR_BAND[1]:
        fail(f"auto: median moment error {med_m} outside the JAX band {AUTO_MOMENT_ERR_BAND}")
    if not med_k < med_main:
        fail(f"auto: median k-hat {med_k} not below the main path's {med_main}")

    first = None
    for seed in MIXTURE_SEEDS + MIXTURE_SEEDS[:1]:
        res, secs, by_shape = run(seed, importance_denominator="mixture")
        khat, merr = _check_result(f"mixture seed {seed}", res, mean_t, sd_t)
        if by_shape["whiten_sumsq_shared"].get((K, M, 1000, True), 0) <= 0:
            fail(f"mixture seed {seed}: the shared-x kernel was not launched over the pooled draws")
        print(f"remedy mixture seed={seed}: khat_main_path={main_khats[seed]:.4f} "
              f"khat={khat:.4f} moment_err_mean_sd_units={merr:.4f} "
              f"logp_grad_evals={int(res.states.num_fn_evals.sum())} wall_s={secs:.3f} "
              f"launches_by_shape={shapes_text(by_shape)}", flush=True)
        if first is not None and seed == MIXTURE_SEEDS[0] and not torch.equal(res.draws, first.draws):
            fail("mixture: a repeated seed gave different draws")
        first = first if first is not None else res
    print("remedy mixture: repeated seed bitwise identical", flush=True)

    # the Laplace correction of a mixture run: the shared-x kernel at rank 0
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    lap = pt.laplace_resample(first, 1000)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    by_shape = wk.launch_counts_by_shape()
    for n, c in wk.launch_counts().items():
        totals[n] += c
    if by_shape["whiten_sumsq_shared"].get((K, 0, 1000, True), 0) <= 0:
        fail("laplace_resample of a mixture run: the shared-x kernel was not launched at rank 0")
    print(f"remedy laplace_resample of mixture seed {MIXTURE_SEEDS[0]}: "
          f"khat {float(first.psis_result.pareto_shape):.4f} -> "
          f"{float(lap.psis_result.pareto_shape):.4f} wall_s={secs:.3f} "
          f"launches_by_shape={shapes_text(by_shape)}", flush=True)

    # The mixture denominator in blocks of 7 paths' draws gives the unblocked
    # bits, and so does PSIS over it. The target's own log density, evaluated
    # block by block as _compute_psis_result does, is not held to that: its
    # torch.sum over a draw's coordinates may round otherwise at another
    # batch size on the card; its effect is printed.
    from pathfinder_tpu_torch import multipath as mp
    from pathfinder_tpu_torch.ops.psis import psis

    comps, dk = first.fit_distribution.components, first.draws_per_component
    whole = mp._log_importance_ratios_mixture(comps, dk)
    blocks = torch.cat([mp._log_importance_ratios_mixture(comps, dk[lo:lo + 7])
                        for lo in range(0, dk.shape[0], 7)])
    log_p = target.logp(dk.reshape(-1, D)).reshape(dk.shape[:2])
    psis_whole, psis_blocks = psis((log_p - whole).reshape(-1)), psis((log_p - blocks).reshape(-1))
    same_q = torch.equal(blocks, whole)
    same_w = torch.equal(psis_blocks.log_weights, psis_whole.log_weights)
    chunked = mp._compute_psis_result(target.logp, comps, dk, "mixture", chunk=7)
    gap = float((chunked.log_weights - psis_whole.log_weights).abs().max())
    print(f"remedy mixture in blocks of 7 paths: log q bitwise equal={same_q}, PSIS log weights "
          f"over it bitwise equal={same_w}, k-hat {float(psis_blocks.pareto_shape):.4f} / "
          f"{float(psis_whole.pareto_shape):.4f}; with the target's log density evaluated block "
          f"by block as well: largest |change| of a log weight {gap:.3e}, k-hat "
          f"{float(chunked.pareto_shape):.4f}", flush=True)
    if not (same_q and same_w):
        fail("remedy mixture: the blocked mixture denominator differs from the unblocked one")
    return totals, auto_runs


def remedy_stage_times(pt, zoo):
    """Where one ``optimizer="auto", auto_laplace=True`` call spends its
    time: its stages run one by one (seed 0), a synchronize after each."""
    import torch

    from pathfinder_tpu_torch import multipath as mp
    from pathfinder_tpu_torch.models.protocol import batched_hessian
    from pathfinder_tpu_torch.ops.mvnormal import MvNormal
    from pathfinder_tpu_torch.ops.resample import resample_draws
    from pathfinder_tpu_torch.utils import rng

    target = zoo.HierarchicalGaussian(D, seed=0)
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    def candidate(opt):
        return pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=0,
                                  optimizer=opt, _suppress_khat_hint=True)

    timed("candidate run lbfgs", lambda: candidate("lbfgs"))
    res = timed("candidate run cg", lambda: candidate("cg"))
    comps = res.fit_distribution.components
    torch.cuda.reset_peak_memory_stats()
    negH = timed("100 Hessians (torch.func)", lambda: -batched_hessian(target.logp)(comps.mean))
    peak = torch.cuda.max_memory_allocated()
    cov = timed("Laplace covariances (diag)",
                lambda: mp._laplace_covariances(negH, comps.cov.diag(), "diag"))
    corrected = MvNormal(comps.mean, cov)
    paths = torch.arange(K, device="cuda")
    draws_knd = timed("Laplace draws (B1 at rank 0)", lambda: corrected.sample(
        rng.Stream(0, paths, 1, rng.LAPLACE_DRAWS), 10).mT.contiguous())
    psis_result = timed("PSIS (B2 at rank 0, target logp, smoothing)",
                        lambda: mp._compute_psis_result(target.logp, corrected, draws_knd))
    timed("resampling", lambda: resample_draws(
        rng.Stream(0, 0, 1, rng.LAPLACE_RESAMPLE), draws_knd, psis_result, 1000))
    timed("PSIS with the mixture denominator (B2 over shared draws)",
          lambda: mp._compute_psis_result(target.logp, comps, res.draws_per_component, "mixture"))
    total = sum(v for k, v in stages.items() if "mixture" not in k)
    for name, secs in stages.items():
        print(f"remedy stage [{name}]: {secs:.4f}s", flush=True)
    print(f"remedy stages: sum without the mixture line {total:.4f}s; peak device memory "
          f"while the Hessians were formed {peak / 2**20:.0f} MiB", flush=True)


class CountedTarget:
    """``value_and_grad`` with its batched calls counted: inside a sampler
    each call is one leapfrog of every chain, a leaf iteration."""

    def __init__(self, value_and_grad):
        self.value_and_grad, self.calls = value_and_grad, 0

    def __call__(self, x):
        self.calls += 1
        return self.value_and_grad(x)


def _run_nuts(nuts_mod, seed, vg, metric, x0s, **options):
    """``nuts_chains`` timed with a synchronize: ``(out, summary, seconds,
    leaf iterations)``."""
    import torch

    counted = CountedTarget(vg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, summary = nuts_mod.nuts_chains(seed, counted, metric, x0s, **options)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, summary, secs, counted.calls - 2  # the two evaluations of the start points


def _nuts_line(label, out, summary, secs, leaf_iters):
    import torch

    n_trans = out.warmup_n_leapfrogs.shape[1] + out.n_leapfrogs.shape[1]
    lf = out.n_leapfrogs
    total = int(lf.sum() + out.warmup_n_leapfrogs.sum())
    ess_min = float(summary["ess_bulk"].min())
    print(f"{label}: chains={lf.shape[0]} transitions={n_trans} wall_s={secs:.3f} "
          f"ms_per_transition={1e3 * secs / n_trans:.3f} leaf_iterations={leaf_iters} "
          f"ms_per_leaf_iteration={1e3 * secs / max(leaf_iters, 1):.3f} "
          f"leapfrogs_per_transition_median={float(lf.double().median()):.0f} "
          f"max={int(lf.max())} leapfrogs_total={total} "
          f"tree_depths={torch.bincount(out.tree_depths.flatten()).tolist()} "
          f"step_size={[round(float(e), 4) for e in out.step_size]} "
          f"divergent_after_warmup={int(out.diverging.sum())} "
          f"rhat_max={float(summary['rhat'].max()):.4f} ess_bulk_min={ess_min:.1f} "
          f"ess_per_s={ess_min / secs:.2f}", flush=True)
    return total


def warm_start_phase(pt, zoo, result):
    """NUTS warm-started from the headline Pathfinder result of seed 0, then
    NUTS from random starts with its own mass-matrix adaptation."""
    import numpy as np
    import torch

    from pathfinder_tpu_torch.utils import rng

    nuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    vg, metric, x0s = nuts.warm_start_chains(result, NUTS_CHAINS)
    if x0s.device.type != "cuda" or metric.device.type != "cuda":
        fail("the warm start left the card")
    out, summary, secs, leaf_iters = _run_nuts(
        nuts, 0, vg, metric, x0s, num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES, max_depth=10)
    warm_total = _nuts_line("warm start (fixed Pathfinder metric)", out, summary, secs, leaf_iters)
    xs = out.samples.double().reshape(-1, D).cpu().numpy()
    if tuple(out.samples.shape) != (NUTS_CHAINS, NUTS_SAMPLES, D) or not np.isfinite(xs).all():
        fail(f"warm start: samples of shape {tuple(out.samples.shape)} not all finite")
    if int(out.diverging.sum()):
        fail(f"warm start: {int(out.diverging.sum())} divergences after warm-up")
    rhat, ess = float(summary["rhat"].max()), float(summary["ess_bulk"].min())
    merr = float(np.max(np.abs(xs.mean(axis=0) - mean_t) / sd_t))
    print(f"warm start: rhat_max={rhat:.4f} band={NUTS_RHAT_BAND} ess_bulk_min={ess:.1f} "
          f"band={NUTS_ESS_BAND} moment_err_mean_sd_units={merr:.4f} band={NUTS_MOMENT_ERR_BAND}",
          flush=True)
    for name, v, (lo, hi) in (("max R-hat", rhat, NUTS_RHAT_BAND), ("min bulk ESS", ess, NUTS_ESS_BAND),
                              ("moment error", merr, NUTS_MOMENT_ERR_BAND)):
        if not lo <= v <= hi:
            fail(f"warm start: {name} {v} outside the JAX band {(lo, hi)}")

    # the same chains without Pathfinder: random starts, the identity metric,
    # windowed adaptation over a warm-up of 300, then 100 draws
    starts = rng.Stream(0, torch.arange(NUTS_CHAINS, device="cuda"), 0, rng.INIT).uniform(
        D, torch.float32, "cuda") * 4.0 - 2.0
    cold, cold_summary, secs, leaf_iters = _run_nuts(
        nuts, 0, target.value_and_grad, None, starts, num_warmup=300, num_samples=COLD_SAMPLES,
        max_depth=10, adapt_mass_matrix=True)
    cold_total = _nuts_line("cold start (identity metric, windowed adaptation)", cold, cold_summary,
                            secs, leaf_iters)
    pf_evals = int(result.states.num_fn_evals.sum())
    print(f"gradient evaluations: Pathfinder {pf_evals} ({K} paths) + warm-started NUTS {warm_total} "
          f"(4 chains) = {pf_evals + warm_total}; NUTS from random starts {cold_total} (4 chains); "
          f"warm-up alone {int(out.warmup_n_leapfrogs.sum())} against "
          f"{int(cold.warmup_n_leapfrogs.sum())}", flush=True)
    if not torch.isfinite(cold.samples).all():
        fail("cold start: samples not all finite")


def _bayes_model():
    """A model with a Normal, a HalfNormal, a Beta and a Dirichlet(3) prior:
    location/scale observations, a binomial and a multinomial count."""
    import torch

    from pathfinder_tpu_torch.models import bayes

    data = torch.tensor([1.2, 0.8, 1.1, 0.9, 1.0, 1.3], device="cuda")
    counts = torch.tensor([3.0, 5.0, 2.0], device="cuda")

    def loglik(p):
        w = torch.cat([p["w"], 1.0 - p["w"].sum(-1, keepdim=True)], dim=-1)
        mu, sigma = p["mu"][..., None], p["sigma"][..., None]
        return (torch.sum(-0.5 * ((data - mu) / sigma) ** 2 - torch.log(sigma), dim=-1)
                + 7.0 * torch.log(p["theta"]) + 3.0 * torch.log1p(-p["theta"])
                + torch.sum(counts * torch.log(w), dim=-1))

    return bayes.BayesModel(
        [("mu", bayes.Normal(0.0, 10.0)), ("sigma", bayes.HalfNormal(2.0)),
         ("theta", bayes.Beta(2.0, 2.0)), ("w", bayes.Dirichlet([1.0, 2.0, 1.5]))], loglik)


def constrained_phase(pt, wk, zoo):
    """Three constrained models through multipathfinder and warm-started
    NUTS, then HMC on the first; returns the kernels' launches."""
    import torch

    # the submodules: the package exports the functions hmc and nuts under their names
    hmc = importlib.import_module("pathfinder_tpu_torch.integrations.hmc")
    nuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")

    X, y, _ = zoo.german_credit_synthetic()
    Xo, yo, _, _ = zoo.ordered_logistic_synthetic()
    models = (
        ("logistic regression d=25", zoo.LogisticRegression(X, y)),
        ("ordered logistic d=7", zoo.OrderedLogisticRegression(Xo, yo, n_cats=4)),
        ("BayesModel d=5", _bayes_model()),
    )
    totals = {name: 0 for name in wk.launch_counts()}
    first = None
    for label, model in models:
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        res = pt.multipathfinder(model, 1000, nruns=8, seed=0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        by_shape = wk.launch_counts_by_shape()
        for n, c in wk.launch_counts().items():
            totals[n] += c
        n_ok, khat = int(res.states.success.sum()), float(res.psis_result.pareto_shape)
        d = res.draws.shape[0]
        if n_ok != 8:
            fail(f"{label}: {n_ok}/8 paths succeeded")
        if khat != khat or not torch.isfinite(res.draws).all():
            fail(f"{label}: k-hat {khat} or draws not finite")
        for name in ("sample_and_logq", "whiten_sumsq"):
            if by_shape[name].get((8, M, 125, False), 0) <= 0:
                fail(f"{label}: {name} was not launched at (B, m, N) = (8, {M}, 125): {by_shape[name]}")
        dt = res.draws_transformed
        if label.startswith("ordered"):
            if tuple(dt.shape) != (d, 1000) or not bool((torch.diff(dt[:3], dim=0) > 0).all()):
                fail(f"{label}: cutpoints not increasing")
        elif label.startswith("BayesModel"):
            w_sum = dt["w"].sum(-1) + (1.0 - dt["w"].sum(-1))
            inside = (bool((dt["sigma"] > 0).all()) and bool(((dt["theta"] > 0) & (dt["theta"] < 1)).all())
                      and bool((dt["w"] > 0).all()) and bool((dt["w"].sum(-1) < 1).all())
                      and bool(((w_sum - 1.0).abs() < 1e-5).all()))
            if not inside or not torch.isfinite(dt["logjoint"]).all():
                fail(f"{label}: constrained draws outside their support")
        elif dt is not res.draws:
            fail(f"{label}: a plain target came back with transformed draws")
        print(f"constrained [{label}]: paths_ok=8/8 khat={khat:.4f} "
              f"logp_grad_evals={int(res.states.num_fn_evals.sum())} wall_s={secs:.3f} "
              f"launches_by_shape={ {n: {f'B={b},m={m},N={n_}': c for (b, m, n_, _), c in sorted(v.items())} for n, v in by_shape.items()} }",
              flush=True)
        vg, metric, x0s = nuts.warm_start_chains(res, NUTS_CHAINS)
        out, summary, secs, leaf_iters = _run_nuts(
            nuts, 0, vg, metric, x0s, num_warmup=NUTS_WARMUP, num_samples=NUTS_SAMPLES)
        _nuts_line(f"constrained [{label}] NUTS", out, summary, secs, leaf_iters)
        if not torch.isfinite(out.samples).all():
            fail(f"{label}: NUTS samples not all finite")
        rhat = float(summary["rhat"].max())
        if not rhat < 1.05:
            fail(f"{label}: max R-hat {rhat} not below 1.05")
        if first is None:
            first = res
            gap = float(((res.draws.mean(1) - summary["mean"]).abs() / summary["sd"]).max())
            print(f"constrained [{label}]: Pathfinder mean within {gap:.4f} posterior sd of the "
                  f"NUTS mean (limit 0.5)", flush=True)
            if not gap < 0.5:
                fail(f"{label}: Pathfinder mean {gap} posterior sd from the NUTS mean")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = hmc.hmc_warm_start(0, first, num_warmup=300, num_samples=200)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc = float(h.accept_prob.mean())
    print(f"hmc_warm_start [logistic regression d=25]: transitions=500 leapfrogs_per_transition=16 "
          f"wall_s={secs:.3f} ms_per_leapfrog={1e3 * secs / 8000:.3f} step_size={float(h.step_size):.4f} "
          f"mean_accept={acc:.4f} band={HMC_ACCEPT_BAND}", flush=True)
    if tuple(h.samples.shape) != (200, 25) or not torch.isfinite(h.samples).all():
        fail("hmc_warm_start: samples not finite")
    if not HMC_ACCEPT_BAND[0] <= acc <= HMC_ACCEPT_BAND[1]:
        fail(f"hmc_warm_start: mean acceptance {acc} outside {HMC_ACCEPT_BAND}")
    return totals


def first_differing_stage(a, b, target):
    """The first stage whose tensors differ between two results of one run
    (offloaded and on the card), as ``(stage, detail)``, or None: the paths'
    states, the pooled draws, the log importance ratios (recomputed on the
    card from each result's components and draws), the PSIS weights, the
    resampled component ids and the resampled draws."""
    import torch

    from pathfinder_tpu_torch import multipath as mp
    from pathfinder_tpu_torch.utils.misc import tree_map

    def leaves(tree):
        out = []
        tree_map(lambda t: out.append(t) if torch.is_tensor(t) else None, tree)
        return out

    def ratios(res):
        comps = tree_map(lambda t: t.to("cuda"), res.fit_distribution.components)
        dk = res.draws_per_component.to("cuda")
        K, N, d = dk.shape
        log_q = mp._log_importance_ratios_fit(comps, dk)
        return target.logp(dk.reshape(-1, d)).to(log_q.dtype).reshape(K, N) - log_q

    stages = (
        ("states", lambda r: leaves(r.states)),
        ("pooled draws", lambda r: [r.draws_per_component]),
        ("log ratios", lambda r: [ratios(r)]),
        ("PSIS weights", lambda r: [r.psis_result.log_weights]),
        ("resampled component ids", lambda r: [r.draw_component_ids]),
        ("resampled draws", lambda r: [r.draws]),
    )
    for name, get in stages:
        for k, (x, y) in enumerate(zip(get(a), get(b))):
            x, y = x.detach().cpu(), y.detach().cpu()
            if x.shape != y.shape:
                return name, f"tensor {k}: shapes {tuple(x.shape)} and {tuple(y.shape)}"
            differ = (x != y) & ~(torch.isnan(x) & torch.isnan(y)) if x.is_floating_point() else x != y
            if bool(differ.any()):
                gap = float((x.double() - y.double()).abs()[differ].max())
                return name, f"tensor {k} of shape {tuple(x.shape)}: {int(differ.sum())} values differ, by up to {gap:.3e}"
    return None


def serving_phase(pt, wk, zoo, headline):
    """32768 paths in slim launches of 8192, offloaded and on the card, then
    the memory rule's own choice; the result file round trip; the replays
    on the headline result. Returns the kernels' launches."""
    import numpy as np
    import torch

    from pathfinder_tpu_torch.parallel import sharding
    from pathfinder_tpu_torch.utils.serialize import load_result, save_result

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    totals = {name: 0 for name in wk.launch_counts()}
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    t_phase = time.perf_counter()

    def run(K, **options):
        wk.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        card = sharding.device_memory_bytes(torch.device("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=0,
                                 keep_traces=False, **options)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for n, c in wk.launch_counts().items():
            totals[n] += c
        by_shape = {n: {f"B={b},m={m},N={n_}": c for (b, m, n_, _), c in sorted(v.items())}
                    for n, v in wk.launch_counts_by_shape().items()}
        n_ok = int(res.states.success.sum())
        khat = float(res.psis_result.pareto_shape)
        draws = res.draws.double().cpu().numpy()
        merr = float(np.max(np.abs(draws.mean(axis=1) - mean_t) / sd_t))
        offloaded = res.states.draws.device.type == "cpu"
        print(f"serving K={K} options={options}: cap={res.max_paths_per_launch} offloaded={offloaded} "
              f"paths_ok={n_ok}/{K} tries_max={int(res.num_tries.max())} khat={khat:.4f} "
              f"moment_err_mean_sd_units={merr:.4f} wall_s={secs:.3f} paths_per_s={K / secs:.1f} "
              f"peak_device_bytes={torch.cuda.max_memory_allocated()} device_bytes={card} "
              f"logp_grad_evals={int(res.states.num_fn_evals.sum())} launches_by_shape={by_shape}",
              flush=True)
        if n_ok != K or not np.isfinite(draws).all() or khat != khat:
            fail(f"serving {options}: {n_ok}/{K} paths, or draws or k-hat not finite")
        if not (KHAT_BAND[0] <= khat <= KHAT_BAND[1] and MOMENT_ERR_BAND[0] <= merr <= MOMENT_ERR_BAND[1]):
            fail(f"serving {options}: k-hat {khat} or moment error {merr} outside the headline band")
        return res, by_shape, torch.cuda.max_memory_allocated()

    off, by_shape, _ = run(SERVE_K, max_paths_per_launch=SERVE_CAP, offload_launches=True)
    for name, (label, B, _, m, N) in (("sample_and_logq", SERVE_B1[0]), ("whiten_sumsq", SERVE_B2[0])):
        if by_shape[name].get(f"B={B},m={m},N={N}", 0) <= 0:
            fail(f"serving: {name} was not launched at its {label} shape (B, N) = ({B}, {N})")
    st = off.states.draws
    if not (st.device.type == "cpu" and st.is_pinned() and off.states.fit_distribution.mean.is_pinned()):
        fail("serving: offloaded states are not pinned host tensors")
    print(f"serving: offloaded states are pinned host tensors ({st.device}, pinned={st.is_pinned()})",
          flush=True)
    on, _, _ = run(SERVE_K, max_paths_per_launch=SERVE_CAP, offload_launches=False)
    if on.states.draws.device.type != "cuda":
        fail("serving: the states left the card without offload")
    stage = first_differing_stage(off, on, target)
    if stage is not None:
        fail(f"serving: offload on and off first differ in the {stage[0]}: {stage[1]}")
    print("serving: offload on and off bitwise equal (states, pooled draws, log ratios, PSIS "
          "weights, resampled component ids and draws)", flush=True)
    del on
    torch.cuda.empty_cache()
    est = sharding.lane_bytes(D, 64, 6, 5, 8, 5)
    auto, _, peak = run(SERVE_K)
    lanes = auto.max_paths_per_launch or SERVE_K
    # the target's terms, as the run learned them (kept on the target)
    per_lane, held = sharding.target_bytes(target, torch.zeros(1, D, device="cuda"), 8 * 5)
    print(f"serving: memory rule chose cap={auto.max_paths_per_launch} "
          f"offload={auto.states.draws.device.type == 'cpu'} from lane_bytes={est} "
          f"target_per_lane={per_lane} target_held={held} "
          f"state_bytes={sharding.state_bytes(D, 64, 6, 5, keep_traces=False)} "
          f"(LAUNCH_SHARE={sharding.LAUNCH_SHARE}, OFFLOAD_SHARE={sharding.OFFLOAD_SHARE}); "
          f"max_memory_allocated={peak}, per lane of a launch {peak / lanes:.0f} (with the "
          f"{SERVE_K} states)", flush=True)
    del auto
    torch.cuda.empty_cache()

    small, _, _ = run(FILE_K, max_paths_per_launch=FILE_CAP, offload_launches=True)
    path = ROOT / "build" / "serving_result"  # build/ is ignored by git; the file is deleted below
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    save_result(path, small)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_result(path, fn=target)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    size = path.with_suffix(".npz").stat().st_size
    path.with_suffix(".npz").unlink()
    again, want = pt.resample(loaded, 1000), pt.resample(small, 1000)
    if not (torch.equal(again.draws, want.draws) and torch.equal(again.draw_component_ids,
                                                                  want.draw_component_ids)):
        fail("serving: resample on the loaded result differs from resample on the result")
    print(f"serving file K={FILE_K} cap={FILE_CAP}: bytes={size} save_s={t_save:.3f} "
          f"load_s={t_load:.3f}; resample of the loaded result bitwise equal", flush=True)

    for k in (0, 1, 2):
        p = headline.path_result(k)
        est_k, stored = p.elbo_estimates.value, p.elbo_values
        nan = torch.isnan(stored)
        if not torch.equal(torch.isnan(est_k), nan) or int((~nan).sum()) == 0:
            fail(f"replay path {k}: NaN pattern of elbo_estimates differs from elbo_values")
        got, want = est_k[~nan], stored[~nan]
        print(f"replay path {k}: {int((~nan).sum())} candidates not NaN, "
              f"{int((got == want).sum())} bitwise equal", flush=True)
        if not torch.equal(got, want):
            fail(f"replay path {k}: elbo_estimates do not replay elbo_values bit for bit")
    try:
        off.path_result(0).fit_distributions
    except ValueError as e:
        print(f"slim path_result(0).fit_distributions raises: {e}", flush=True)
    else:
        fail("fit_distributions of a slim path did not raise")
    print(f"serving phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return totals


# BASELINE config 2 with the JAX package on the CPU (f32, x64 off) for keys
# 0..9 (``tests/reference_bands_dtype_rank.py config2``): every key succeeds,
# fit iterations 2..7, moment error of the means 0.1906..2.7440 sd, of the
# sds 0.2318..0.4948 (relative). Bands [min − r/2, max + r/2], the lower end
# of the mean error at its ideal.
CONFIG2_MEAN_ERR_BAND = (0.0, 4.0207)
CONFIG2_SD_ERR_BAND = (0.1004, 0.6263)
# The headline in float64 with the JAX package on the CPU (x64 on) for keys
# 0..9 (``... headline64``): 100/100 paths on every key, k̂ 1.3819..2.0863,
# moment error 1.8879..3.3218.
F64_KHAT_BAND = (1.0297, 2.4385)
F64_MOMENT_ERR_BAND = (1.1709, 4.0388)
# The headline at 16 bits with the JAX package on the CPU (x64 off), ntries=2,
# keys 0..2 (``... lowp``): bfloat16 runs to its end with 0/100 paths
# succeeding and a NaN k̂, and the single-path pathfinder fails both tries;
# float16 raises NotImplementedError in both (no float16 triangular solve);
# all warn that their optimization state is unusable.
LOW_PRECISION_OUTCOME = {"bfloat16": 0, "float16": NotImplementedError}
LOW_PRECISION_SINGLE = {"bfloat16": False, "float16": NotImplementedError}
# the memory rule's runs: BFGS paths at d = 1000, more than one launch of the
# rule's cap holds; a chunked result whose Laplace correction the rule blocks
MEM_BFGS_K = 2048
MEM_LAPLACE_K, MEM_LAPLACE_CAP = 4096, 1024


def _counted(wk, fn):
    """``fn()`` with the launch counts set to 0 before and read after."""
    wk.reset_launch_counts()
    out = fn()
    return out, wk.launch_counts()


def _uses_general_only(label, grew, names):
    if min(grew[n] for n in names) <= 0:
        fail(f"{label}: the general kernel was not launched ({grew})")
    if max(grew[n] for n in FAST_KERNELS) > 0:
        fail(f"{label}: the fast kernel was launched off its case ({grew})")


def config2_phase(pt, wk, zoo):
    """BASELINE config 2 (rank 40) on 5 seeds, then history_length 50 (rank
    100) single-path and 20 on the multipath headline; the launches."""
    import numpy as np
    import torch

    target = zoo.CorrelatedGaussian(100, seed=0)
    sd_t = np.sqrt(np.diag(target.cov))
    totals = {n: 0 for n in wk.launch_counts()}

    def add(grew):
        for n, c in grew.items():
            totals[n] += c

    mean_errs, sd_errs = [], []
    for seed in SEEDS:
        t0 = time.perf_counter()
        r, grew = _counted(wk, lambda: pt.pathfinder(
            target, seed=seed, ndraws=2000, maxiters=128, history_length=20, ndraws_elbo=100))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        add(grew)
        x = r.draws.double().cpu().numpy()
        me = float(np.max(np.abs(x.mean(axis=1) - target.mean) / sd_t))
        se = float(np.max(np.abs(x.std(axis=1) - sd_t) / sd_t))
        print(f"config2 seed={seed}: success={r.success} tries={r.num_tries} "
              f"fit_iteration={r.fit_iteration} moment_err_mean_sd_units={me:.4f} "
              f"moment_err_sd_rel={se:.4f} wall_s={secs:.3f} launches={grew}", flush=True)
        if not r.success or tuple(r.draws.shape) != (100, 2000) or not np.isfinite(x).all():
            fail(f"config2 seed {seed}: no success, or draws not finite")
        _uses_general_only(f"config2 seed {seed}", grew, ("sample_and_logq_general",))
        mean_errs.append(me)
        sd_errs.append(se)
    med_m, med_s = statistics.median(mean_errs), statistics.median(sd_errs)
    print(f"config2: median moment error of the means {med_m:.4f} band={CONFIG2_MEAN_ERR_BAND}, "
          f"of the sds {med_s:.4f} band={CONFIG2_SD_ERR_BAND}", flush=True)
    if not (CONFIG2_MEAN_ERR_BAND[0] <= med_m <= CONFIG2_MEAN_ERR_BAND[1]
            and CONFIG2_SD_ERR_BAND[0] <= med_s <= CONFIG2_SD_ERR_BAND[1]):
        fail("config2: median moment errors outside the JAX band")

    r, grew = _counted(wk, lambda: pt.pathfinder(
        target, seed=0, ndraws=2000, maxiters=128, history_length=50, ndraws_elbo=100))
    add(grew)
    print(f"config2 history_length=50: success={r.success} fit_iteration={r.fit_iteration} "
          f"launches_by_shape={wk.launch_counts_by_shape()['sample_and_logq_general']}", flush=True)
    if not r.success or not torch.isfinite(r.draws).all():
        fail("history_length=50: no success, or draws not finite")
    _uses_general_only("history_length=50", grew, ("sample_and_logq_general",))

    head = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_h = zoo.hierarchical_gaussian_truth(D, seed=0)
    res, grew = _counted(wk, lambda: pt.multipathfinder(
        head, 1000, nruns=K, maxiters=64, elbo_chunk=8, history_length=20, seed=0))
    add(grew)
    khat, merr = _check_result("headline history_length=20", res, mean_t, sd_h)
    print(f"headline history_length=20: paths_ok={K}/{K} khat={khat:.4f} "
          f"moment_err_mean_sd_units={merr:.4f} launches={grew}", flush=True)
    _uses_general_only("headline history_length=20", grew, GENERAL_KERNELS)
    res, grew = _counted(wk, lambda: pt.multipathfinder(
        head, 1000, nruns=K, maxiters=64, elbo_chunk=8, history_length=50, seed=0))
    add(grew)
    khat, merr = _check_result("headline history_length=50", res, mean_t, sd_h)
    print(f"headline history_length=50: paths_ok={K}/{K} khat={khat:.4f} "
          f"moment_err_mean_sd_units={merr:.4f} launches={grew}", flush=True)
    _uses_general_only("headline history_length=50", grew, GENERAL_KERNELS)
    return totals


def float64_phase(pt, wk, zoo):
    """The headline in float64 on 5 seeds: every path, k̂ and moment error
    in the JAX-x64 band, the general kernel only."""
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    totals = {n: 0 for n in wk.launch_counts()}
    khats, merrs = [], []
    for seed in SEEDS:
        t0 = time.perf_counter()
        res, grew = _counted(wk, lambda: pt.multipathfinder(
            target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=seed, dtype=torch.float64))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hz = _hz_launches()
        for n, c in grew.items():
            totals[n] += c
        if hz <= 0:
            fail(f"float64 seed {seed}: the line-search kernel was not launched")
        if res.draws.dtype != torch.float64:
            fail(f"float64 seed {seed}: draws are {res.draws.dtype}")
        khat, merr = _check_result(f"float64 seed {seed}", res, mean_t, sd_t)
        _uses_general_only(f"float64 seed {seed}", grew, GENERAL_KERNELS)
        print(f"float64 headline seed={seed}: paths_ok={K}/{K} khat={khat:.4f} "
              f"moment_err_mean_sd_units={merr:.4f} "
              f"logp_grad_evals={int(res.states.num_fn_evals.sum())} wall_s={secs:.3f} "
              f"launches={grew} hz_step_launches={hz}", flush=True)
        khats.append(khat)
        merrs.append(merr)
    med_k, med_m = statistics.median(khats), statistics.median(merrs)
    print(f"float64 headline: median khat={med_k:.4f} band={F64_KHAT_BAND}; median moment "
          f"error={med_m:.4f} band={F64_MOMENT_ERR_BAND}", flush=True)
    one, grew = _counted(wk, lambda: pt.pathfinder(target, seed=0, maxiters=64, dtype=torch.float64))
    for n, c in grew.items():
        totals[n] += c
    print(f"float64 single path: success={one.success} tries={one.num_tries} "
          f"draws={one.draws.dtype} launches={grew}", flush=True)
    if not one.success or one.draws.dtype != torch.float64 or not torch.isfinite(one.draws).all():
        fail("float64 single path: no success, or draws not finite float64")
    _uses_general_only("float64 single path", grew, ("sample_and_logq_general",))
    if not (F64_KHAT_BAND[0] <= med_k <= F64_KHAT_BAND[1]
            and F64_MOMENT_ERR_BAND[0] <= med_m <= F64_MOMENT_ERR_BAND[1]):
        fail("float64 headline: median k-hat or moment error outside the JAX-x64 band")
    return totals


def low_precision_phase(pt, wk, zoo):
    """One headline call each in bfloat16 and float16 (ntries=2): the
    warning and the outcome of the JAX package on the CPU."""
    import warnings

    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    totals = {n: 0 for n in wk.launch_counts()}
    runs = (
        ("headline", LOW_PRECISION_OUTCOME, GENERAL_KERNELS, lambda dtype: pt.multipathfinder(
            target, 1000, nruns=K, maxiters=64, elbo_chunk=8, ntries=2, dtype=dtype, seed=0)),
        ("single path", LOW_PRECISION_SINGLE, ("sample_and_logq_general",), lambda dtype: pt.pathfinder(
            target, maxiters=64, ntries=2, dtype=dtype, seed=0)),
    )
    for label, outcomes, used, run in runs:
        for dt_name, want in outcomes.items():
            wk.reset_launch_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    res = run(getattr(torch, dt_name))
                    outcome = int(res.states.success.sum()) if label == "headline" else res.success
                except Exception as e:  # the outcome is the exception's type
                    outcome, res = type(e), e
            torch.cuda.synchronize()
            grew, hz = wk.launch_counts(), _hz_launches()
            for n, c in grew.items():
                totals[n] += c
            if hz:  # 16-bit searches update their state by the plain step
                fail(f"{dt_name} {label}: the line-search kernel launched {hz} times; it takes "
                     f"float32 and float64 only")
            warned = any("optimization state is almost always" in str(w.message) for w in caught)
            print(f"{dt_name} {label}: outcome={getattr(outcome, '__name__', outcome)} "
                  f"({str(res)[:120] if isinstance(res, Exception) else 'ran to its end'}) "
                  f"warned={warned} wall_s={time.perf_counter() - t0:.3f} launches={grew}; the JAX "
                  f"package on the CPU: {getattr(want, '__name__', want)}", flush=True)
            if outcome != want or not warned:
                fail(f"{dt_name} {label}: outcome {outcome} (warned {warned}) differs from JAX's")
            if dt_name == "bfloat16":
                _uses_general_only(f"bfloat16 {label}", grew, used)
    return totals


def memory_rule_phase(pt, zoo):
    """A chunked BFGS run and a Laplace correction of a chunked result at
    d = 1000, each under the rule's own choice: its estimate of the peak
    against the measured one."""
    import torch

    from pathfinder_tpu_torch.parallel import sharding

    target = zoo.HierarchicalGaussian(D, seed=0)
    f = 4
    card = sharding.device_memory_bytes(torch.device("cuda"))

    def measured(fn):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base, time.perf_counter() - t0

    def held_to(label, estimate, peak):
        print(f"memory rule [{label}]: estimate={estimate} measured_peak={peak} "
              f"estimate/measured={estimate / peak:.3f} (card {card} B)", flush=True)
        if not peak <= estimate <= 2 * peak:
            fail(f"memory rule [{label}]: estimate {estimate} not within [1, 2] x the peak {peak}")

    res, peak, secs = measured(lambda: pt.multipathfinder(
        target, 1000, nruns=MEM_BFGS_K, maxiters=64, elbo_chunk=8, seed=0, optimizer="bfgs",
        keep_traces=False))
    cap = res.max_paths_per_launch
    ok = int(res.states.success.sum())
    print(f"memory rule BFGS K={MEM_BFGS_K}: cap={cap} offloaded={res.states.draws.device.type == 'cpu'} "
          f"paths_ok={ok}/{MEM_BFGS_K} khat={float(res.psis_result.pareto_shape):.4f} "
          f"wall_s={secs:.3f}", flush=True)
    if cap is None or cap >= MEM_BFGS_K or ok != MEM_BFGS_K:
        fail("memory rule: the BFGS run was not chunked, or paths failed")
    lanes = min(cap, MEM_BFGS_K)
    states = MEM_BFGS_K * sharding.state_bytes(D, 64, 6, 5, keep_traces=False)
    per_lane, held = sharding.target_bytes(target, torch.zeros(1, D, device="cuda"), 8 * 5)
    held_to(f"BFGS, launches of {cap}",
            lanes * sharding.lane_bytes(D, 64, 6, 5, 8, 5, torch.float32, "bfgs")
            + min(lanes * per_lane, held) + states, peak)
    del res

    res = pt.multipathfinder(target, 1000, nruns=MEM_LAPLACE_K, maxiters=64, elbo_chunk=8, seed=0,
                             max_paths_per_launch=MEM_LAPLACE_CAP, keep_traces=False)
    N = res.draws_per_component.shape[1]
    block = sharding.laplace_block(MEM_LAPLACE_K, D, N, torch.float32, "diag", "cuda")
    lap, peak, secs = measured(lambda: pt.laplace_resample(res, 1000))
    print(f"memory rule laplace_resample of K={MEM_LAPLACE_K} (launches of {MEM_LAPLACE_CAP}): "
          f"block={block} khat {float(res.psis_result.pareto_shape):.4f} -> "
          f"{float(lap.psis_result.pareto_shape):.4f} wall_s={secs:.3f}", flush=True)
    if block is None or block >= MEM_LAPLACE_K or not torch.isfinite(lap.draws).all():
        fail("memory rule: laplace_resample was not blocked, or its draws are not finite")
    pool = MEM_LAPLACE_K * f * (D * N + 4 * D)  # the corrected components and their draws
    held_to(f"laplace_resample, blocks of {block}",
            block * sharding.laplace_lane_bytes(D, N, torch.float32) + pool, peak)


# The mesh phase: the paths axis of a device mesh on one card, whose blocks
# are entries of the same card (as the JAX tests' virtual CPU devices share
# the host). The headline over MESH_BLOCKS blocks with launches of K lanes (K
# / MESH_BLOCKS a block) against no mesh with launches of K / MESH_BLOCKS:
# the same per-device width, so bitwise equal at every stage; and nuts_chains
# over the mesh against unsharded blocks with the same chain ids.
MESH_BLOCKS = 2
# 25 + 25 transitions: short, since the whole script must end within its time
# limit (the dim phase's optimizer paths took the time of the rest); the
# comparison is bitwise at every transition
MESH_NUTS_WARMUP = MESH_NUTS_SAMPLES = 25


def _bitwise_equal(a, b) -> bool:
    """Equal shapes and bits, NaN where the other has NaN."""
    import torch

    if a.shape != b.shape:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def mesh_phase(pt, wk, zoo, headline, smi):
    """The headline and the mixture denominator over a mesh of MESH_BLOCKS
    blocks on one card against the unsharded run at the same per-device
    launch width, bitwise at every stage, both launching B1 and B2 as often;
    then nuts_chains over the mesh against unsharded blocks. Returns the
    kernels' launches of the mesh runs."""
    import torch

    nuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")
    mesh = pt.paths_mesh(["cuda:0"] * MESH_BLOCKS)
    target = zoo.HierarchicalGaussian(D, seed=0)
    totals = {name: 0 for name in wk.launch_counts()}
    t_phase = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    for denom in ("component", "mixture"):
        runs = {}
        for label, options in (("no mesh", dict(max_paths_per_launch=K // MESH_BLOCKS)),
                               (f"mesh of {MESH_BLOCKS}", dict(mesh=mesh, max_paths_per_launch=K))):
            wk.reset_launch_counts()
            res, secs, peak = timed(lambda: pt.multipathfinder(
                target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=0,
                importance_denominator=denom, **options))
            grew = dict(wk.launch_counts(), lbfgs_iter=_iter_launches())
            if grew["lbfgs_iter"] <= 0:
                fail(f"mesh phase [{denom}, {label}]: the L-BFGS iteration kernel was not "
                     f"launched: {grew}")
            del grew["lbfgs_iter"]
            if label != "no mesh":
                for n, c in grew.items():
                    totals[n] += c
            b2 = grew["whiten_sumsq_shared" if denom == "mixture" else "whiten_sumsq"]
            if grew["sample_and_logq"] <= 0 or b2 <= 0:
                fail(f"mesh phase [{denom}, {label}]: B1 or B2 not launched: {grew}")
            print(f"mesh phase [{denom} denominator, {label}, launches of "
                  f"{options['max_paths_per_launch']} lanes]: wall_s={secs:.3f} "
                  f"peak_device_bytes={peak} khat={float(res.psis_result.pareto_shape):.4f} "
                  f"paths_ok={int(res.states.success.sum())}/{K} launches={grew} card: {smi}",
                  flush=True)
            runs[label] = (res, grew)
        (a, ca), (b, cb) = runs.values()
        if ca != cb:
            fail(f"mesh phase [{denom}]: the kernels' launches differ: {ca} and {cb}")
        stage = first_differing_stage(b, a, target)
        if stage is not None:
            fail(f"mesh phase [{denom}]: the mesh run differs from the unsharded one first in "
                 f"the {stage[0]}: {stage[1]}")
        print(f"mesh phase [{denom} denominator]: mesh of {MESH_BLOCKS} and no mesh bitwise equal "
              f"(states, pooled draws, log ratios, PSIS weights, resampled component ids and "
              f"draws); kernel launches equal", flush=True)
        del runs, a, b

    vg, metric, x0s = nuts.warm_start_chains(headline, NUTS_CHAINS)
    options = dict(num_warmup=MESH_NUTS_WARMUP, num_samples=MESH_NUTS_SAMPLES)
    (out, _), secs, peak = timed(lambda: nuts.nuts_chains(0, vg, metric, x0s, mesh=mesh, **options))
    per = NUTS_CHAINS // MESH_BLOCKS
    parts, secs_one, peak_one = [], 0.0, 0
    for lo in range(0, NUTS_CHAINS, per):
        part, s_, p_ = timed(lambda: nuts.nuts(0, vg, metric, x0s[lo:lo + per],
                                               chain_ids=list(range(lo, lo + per)), **options))
        parts.append(part)
        secs_one, peak_one = secs_one + s_, max(peak_one, p_)
    for name, got, *blocks in zip(out._fields, out, *parts):
        if got is not None and not _bitwise_equal(got, torch.cat(blocks)):
            fail(f"mesh phase NUTS: {name} over the mesh differs from the unsharded blocks")
    print(f"mesh phase NUTS [{NUTS_CHAINS} chains, {MESH_NUTS_WARMUP} + {MESH_NUTS_SAMPLES} "
          f"transitions]: mesh of {MESH_BLOCKS} wall_s={secs:.3f} peak_device_bytes={peak}; "
          f"{MESH_BLOCKS} unsharded calls of {per} chains wall_s={secs_one:.3f} "
          f"peak_device_bytes={peak_one}; bitwise equal in every field; card: {smi}", flush=True)
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return totals


# The dim axis (phase 9): B1's row-split modes at the main path's ELBO shape,
# (800, 12, 5), and B2's at the component denominator's PSIS shape, (100, 12,
# 10), at d = 1000 in row blocks of 500 and 250, fast float32 and general
# float64; then the headline over a (paths, dim) mesh on the one card.
DIM_SPLIT_CASES = (("float32", 2), ("float32", 4), ("float64", 2), ("float64", 4))
DIM_SEEDS = SEEDS[:3]  # the (1, 2) mesh's headline seeds, beside one run of the (2, 2) mesh
SPLIT_KERNELS = ("sample_and_logq_partial", "sample_and_logq_resume")
B2_SPLIT_KERNELS = ("whiten_sumsq_partial", "whiten_sumsq_resume")
# B2 over an x shared by every factor split the same way, on the shared-x
# kernel (the mixture denominator on the dim axis): at the mixture shape
# (100, 12, 1000), d = 1000 in 2 and 4 blocks, float32 and float64 (timed);
# then every dtype at every rank of GENERAL_RANKS on (8, 1000, m, 77), a block
# of odd rows (d = 1998 in 2 blocks of 999) and the plans with X's ranks in
# windows and with t and s in the workspace (a 64 KB limit), in 2 blocks
SHARED_SPLIT_KERNELS = ("whiten_sumsq_shared_partial", "whiten_sumsq_shared_resume")
SHARED_SPLIT_B, SHARED_SPLIT_P = 8, 77
SHARED_SPLIT_ODD = (8, 1998, M, 77)
SHARED_SPLIT_LIMITED = (("windows", 4, D, 258, 77, 65536), ("workspace", 4, D, 1000, 77, 65536))


def split_bound_us(mode, B, d_r, m, N, itemsize):
    """The bound of one row-block launch (as :func:`bound_us`): B1's partial
    reads u and X and writes t and ‖u‖² (in the accumulation type); its
    resume reads u, X, a½, μ, C, logdet, t and ‖u‖² and writes x and logq.
    B2's partial ("whiten partial") reads x, X, a½ and μ and writes t; its
    resume reads x, X, a½, μ, Ci and t and writes the block's ‖w‖² (in the
    accumulation type): the whitening (2 operations a value), X s (2·m),
    w = v + X s and its square summed (3)."""
    acc = 8 if itemsize == 8 else 4
    if mode == "partial":
        moved = itemsize * B * d_r * (N + m) + acc * B * N * (m + 1)
        flops = B * N * (2 * d_r * m + 2 * d_r)
    elif mode == "whiten partial":
        moved = itemsize * B * d_r * (N + m + 2) + acc * B * N * m
        flops = B * N * (2 * d_r * m + 2 * d_r)
    elif mode == "whiten resume":
        moved = itemsize * (B * d_r * (N + m + 2) + B * m * m) + acc * B * N * (m + 1)
        flops = B * N * (2 * m * m + 2 * d_r * m + 5 * d_r)
    else:
        moved = (itemsize * (B * d_r * (2 * N + m + 2) + B * m * m + B + B * N)
                 + acc * B * N * (m + 1))
        flops = B * N * (2 * m * m + 2 * d_r * m + 4 * d_r)
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / (F64_FLOPS_PER_S if itemsize == 8 else F32_FLOPS_PER_S)
    return 1e6 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def shared_split_bound_us(mode, B, d_r, m, P, itemsize, tensor_cores=True):
    """The bound of one row-block launch of the shared-x kernel's split, as
    :func:`tc_bound_us`: the partial's product Xᵀv (2·d_r·m a factor and
    column; 3 TF32 products for 4- and 2-byte values, DMMA for float64) and
    its whitening (2·d_r) against x, X, a½ and μ read and t written (in the
    accumulation type); the resume's product X s (3 TF32 products for float32,
    2 for 16-bit, DMMA for float64), s = Ci t (2·m²) and w = v + X s with its
    square summed (4·d_r) against x, X, a½, μ, Ci and t read and the block's
    ‖w‖² written. The longest of the tensor-core, CUDA-core and bytes times,
    and which it is; without ``tensor_cores``, as :func:`bound_us`: the
    product's 2·d_r·m operations at the CUDA-core rate too."""
    pairs, acc = B * P, 8 if itemsize == 8 else 4
    if not tensor_cores:
        t_mma = 0.0
    elif itemsize == 8:
        t_mma = 2 * d_r * m * pairs / F64_TC_FLOPS_PER_S
    else:
        n = 3 if mode == "partial" or itemsize == 4 else 2
        t_mma = n * 2 * d_r * m * pairs / TF32_TC_FLOPS_PER_S
    if mode == "partial":
        rest = 2 * d_r
        moved = itemsize * (d_r * P + B * d_r * (m + 2)) + acc * pairs * m
    else:
        rest = 2 * m * m + 4 * d_r
        moved = itemsize * (d_r * P + B * (d_r * (m + 2) + m * m)) + acc * pairs * (m + 1)
    rest += 0 if tensor_cores else 2 * d_r * m
    t_rest = pairs * rest / (F64_FLOPS_PER_S if itemsize == 8 else F32_FLOPS_PER_S)
    t, by = max((t_mma, "tensor-core operations"), (t_rest, "operations"),
                (moved / HBM_BYTES_PER_S, "bytes"))
    return 1e6 * t, by


def _shared_blocks(args, blocks):
    """The row blocks of a shared-x case ``(x (d, P), a½, X, Ci, μ)``: each
    block's ``x`` in the kernel's ``(P, d_r)`` layout (as ``MvNormal.logpdf``
    hands a member's rows to both launches), a½, X and μ contiguous."""
    x, a_half, X, _, mu = args
    r = X.shape[1] // blocks
    cut = [slice(j * r, (j + 1) * r) for j in range(blocks)]
    return [(x[c].mT.contiguous().mT, a_half[:, c].contiguous(), X[:, c].contiguous(),
             mu[:, c].contiguous()) for c in cut]


def _split_run_shared(wk, args, blocks, kernel=True, plan=None):
    """B2 over a shared x on ``args`` (x, a½, X, Ci, μ) split in ``blocks``
    row blocks: the partial of every block, t summed in rank order, the resume
    of every block and its ‖w‖² summed in rank order (as a row group sums
    them), in the accumulation type, on the shared-x kernel (``plan``: its
    plan at a block's rows) or on the plain split."""
    Ci, d = args[3], args[2].shape[1]
    if kernel:
        partial = lambda *b: wk._whiten_sumsq_partial_cuda(*b, d, plan=plan)  # noqa: E731
        resume = lambda xb, ab, Xb, mub, t: wk._whiten_sumsq_resume_cuda(  # noqa: E731
            xb, ab, Xb, Ci, mub, t, d, plan=plan)
    else:
        partial = wk.whiten_sumsq_partial_torch
        resume = lambda xb, ab, Xb, mub, t: wk.whiten_sumsq_resume_torch(  # noqa: E731
            xb, ab, Xb, Ci, mub, t)
    blk = _shared_blocks(args, blocks)
    ts = [partial(*b) for b in blk]
    t = ts[0]
    for p in ts[1:]:
        t = t + p
    qs = [resume(*b, t) for b in blk]
    q = qs[0]
    for p in qs[1:]:
        q = q + p
    return q


def check_shared_split_case(wk, tag, args, blocks, plan=None, whole_plan=None):
    """B2 over a shared x split on the shared-x kernel against the plain
    split and the unsplit kernel (``whole_plan`` its plan), both in the
    storage dtype at the unsplit kernel's tolerances, and a repeat bitwise
    equal. The max abs error."""
    import torch

    dtype = args[0].dtype
    got = _split_run_shared(wk, args, blocks, plan=plan)
    torch.cuda.synchronize()
    plain = _split_run_shared(wk, args, blocks, kernel=False)
    whole = wk._whiten_sumsq_cuda(*args, plan=whole_plan)
    err = max(check_general(f"shared-x B2 split [{tag}] maha", got.to(dtype), plain.to(dtype), dtype),
              check_general(f"shared-x B2 split against unsplit [{tag}] maha", got.to(dtype), whole,
                            dtype))
    if not torch.equal(_split_run_shared(wk, args, blocks, plan=plan), got):
        fail(f"shared-x B2 split [{tag}]: a repeat gave other bits")
    return err


def dim_split_shared(wk, rng):
    """The shared-x kernel's split: at the mixture shape in row blocks
    (DIM_SPLIT_CASES), against the plain split and the unsplit kernel, a
    repeat bitwise equal, one block's launches timed L2-cold beside their
    plain versions and bounds; then on the kernel's other routes
    (SHARED_SPLIT_B..SHARED_SPLIT_LIMITED). The rows of the kernels' line."""
    import torch

    B, d, m, P = K, D, M, 1000
    rows_out = []
    for dt_name, blocks in DIM_SPLIT_CASES:
        dtype = getattr(torch, dt_name)
        args = _shared_args(rng, B, d, m, P, dtype)
        r = d // blocks
        tag = f"mixture {dt_name} d={d} in {blocks} blocks"
        err = check_shared_split_case(wk, tag, args, blocks)
        xb, ab, Xb, mub = _shared_blocks(args, blocks)[0]
        Ci = args[3]
        t_sum = wk._whiten_sumsq_partial_cuda(xb, ab, Xb, mub, d)
        item = torch.finfo(dtype).bits // 8
        plan = wk._shared_plan(B, r, m, P, dtype)
        for mode, kernel, plain in (
                ("partial", lambda: wk._whiten_sumsq_partial_cuda(xb, ab, Xb, mub, d),
                 lambda: wk.whiten_sumsq_partial_torch(xb, ab, Xb, mub)),
                ("resume", lambda: wk._whiten_sumsq_resume_cuda(xb, ab, Xb, Ci, mub, t_sum, d),
                 lambda: wk.whiten_sumsq_resume_torch(xb, ab, Xb, Ci, mub, t_sum))):
            ms, plain_ms = time_cold_ms(kernel), time_cold_ms(plain)
            bound, by = shared_split_bound_us(mode, B, r, m, P, item)
            cuda_bound, cuda_by = shared_split_bound_us(mode, B, r, m, P, item, False)
            name = f"whiten_sumsq_shared_{mode}"
            rows_out.append(dict(name=name, dtype=dt_name, blocks=blocks, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_us=bound, bound_by=by,
                                 cuda_core_bound_us=cuda_bound))
            print(f"kernel {name} [{tag}: one block B={B} d_r={r} m={m} P={P}] "
                  f"plan(W,F,NC,R,kw,ws,smem)={tuple(plan)} max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} tc_bound_us={bound:.2f} ({by}) "
                  f"share={bound / (1e3 * ms):.3f} cuda_core_bound_us={cuda_bound:.2f} ({cuda_by})",
                  flush=True)
        del args, t_sum
    B, P = SHARED_SPLIT_B, SHARED_SPLIT_P
    cases = [(dt, B, D, mm, P, None) for dt in GENERAL_DTYPES for mm in GENERAL_RANKS]
    cases.append(("float32",) + SHARED_SPLIT_ODD + (None,))
    cases += [("float32", b, dd, mm, pp, limit) for _, b, dd, mm, pp, limit in SHARED_SPLIT_LIMITED]
    for dt_name, b, dd, mm, pp, limit in cases:
        dtype = getattr(torch, dt_name)
        plan = whole_plan = None
        if limit is not None:
            plan = wk._shared_plan(b, dd // 2, mm, pp, dtype, smem_limit=limit)
            whole_plan = wk._shared_plan(b, dd, mm, pp, dtype, smem_limit=limit)
            if plan.kw >= 8 * -(-mm // 8) or (mm == 1000) != plan.ws:
                fail(f"the {limit} B split plan {plan} has no rank windows, or not the workspace "
                     "it should")
        args = _shared_args(rng, b, dd, mm, pp, dtype, offset=1)
        tag = f"B={b} d={dd} m={mm} P={pp} {dt_name} in 2 blocks"
        err = check_shared_split_case(wk, tag, args, 2, plan, whole_plan)
        print(f"shared-x B2 split [{tag}] plan(W,F,NC,R,kw,ws,smem)="
              f"{tuple(plan or wk._shared_plan(b, dd // 2, mm, pp, dtype))}: max_abs_err={err:.3e}",
              flush=True)
    return rows_out


def _split_run(wk, args, blocks, kernel=True, plan=None):
    """B1 on ``args`` (u, a½, X, C, μ, logdet) split in ``blocks`` row blocks:
    the partial of every block, the sums in rank order (as a row group sums
    them), the resume of every block; ``(x, logq)``, on the kernels or on the
    plain split. Fails if the blocks' logq differ."""
    import torch

    u, a_half, X, C, mu, logdet = args
    d = u.shape[1]
    r = d // blocks
    cut = [(slice(None), slice(j * r, (j + 1) * r)) for j in range(blocks)]
    if kernel:
        partial = lambda u_, X_: wk._sample_and_logq_partial_cuda(u_, X_, d, plan=plan)  # noqa: E731
        resume = lambda *a: wk._sample_and_logq_resume_cuda(*a, plan=plan)  # noqa: E731
    else:
        partial, resume = wk.sample_and_logq_partial_torch, wk.sample_and_logq_resume_torch
    parts = [partial(u[c].contiguous(), X[c].contiguous()) for c in cut]
    t, usq = parts[0]
    for p in parts[1:]:
        t, usq = t + p[0], usq + p[1]
    outs = [resume(u[c].contiguous(), a_half[c].contiguous(), X[c].contiguous(), C,
                   mu[c].contiguous(), logdet, t, usq, d) for c in cut]
    if any(not torch.equal(o[1], outs[0][1]) for o in outs):
        fail(f"B1 split in {blocks} blocks: the blocks' logq differ")
    return torch.cat([o[0] for o in outs], dim=1), outs[0][1]


def check_split_case(wk, tag, args, blocks, dtype, plan=None):
    """B1 split on the kernels against the plain split and the unsplit kernel
    (the general kernel where ``plan`` is given), a repeat bitwise equal; at
    float32 with m >= d against the float64 plain version instead (as
    :func:`check_general_case`). The max abs error."""
    import torch

    m, d = args[2].shape[-1], args[2].shape[-2]
    got = _split_run(wk, args, blocks, plan=plan)
    torch.cuda.synchronize()
    if dtype == torch.float32 and m >= d:
        want = wk.sample_and_logq_torch(*(a.double() for a in args))
        err = max(check_general(f"B1 split [{tag}] x", got[0], want[0], dtype),
                  check_general(f"B1 split [{tag}] logq", got[1], want[1], dtype))
    else:
        plain = _split_run(wk, args, blocks, kernel=False)
        whole = wk._sample_and_logq_cuda(*args, general=True if plan else None, plan=plan)
        err = max(check_general(f"B1 split [{tag}] x", got[0], plain[0], dtype),
                  check_general(f"B1 split [{tag}] logq", got[1], plain[1], dtype),
                  check_general(f"B1 split against unsplit [{tag}] x", got[0], whole[0], dtype),
                  check_general(f"B1 split against unsplit [{tag}] logq", got[1], whole[1],
                                dtype))
    again = _split_run(wk, args, blocks, plan=plan)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        fail(f"B1 split [{tag}]: a repeat gave other bits")
    return err


def _split_run_b2(wk, args, blocks, kernel=True, plan=None):
    """B2 on ``args`` (x, a½, X, Ci, μ, ·) split in ``blocks`` row blocks: the
    partial of every block, t summed in rank order, the resume of every
    block and its ‖w‖² summed in rank order (as a row group sums them): the
    Mahalanobis terms in the accumulation type, on the kernels or on the
    plain split."""
    x, a_half, X, Ci, mu, _ = args
    d = x.shape[1]
    r = d // blocks
    cut = [(slice(None), slice(j * r, (j + 1) * r)) for j in range(blocks)]
    if kernel:
        partial = lambda *a: wk._whiten_sumsq_partial_cuda(*a, d, plan=plan)  # noqa: E731
        resume = lambda *a: wk._whiten_sumsq_resume_cuda(*a, d, plan=plan)  # noqa: E731
    else:
        partial, resume = wk.whiten_sumsq_partial_torch, wk.whiten_sumsq_resume_torch
    blk = [tuple(a[c].contiguous() for a in (x, a_half, X, mu)) for c in cut]
    ts = [partial(*b) for b in blk]
    t = ts[0]
    for p in ts[1:]:
        t = t + p
    qs = [resume(xb, ab, Xb, Ci, mub, t) for xb, ab, Xb, mub in blk]
    q = qs[0]
    for p in qs[1:]:
        q = q + p
    return q


def check_b2_split_case(wk, tag, args, blocks, dtype, plan=None):
    """B2 split on the kernels against the plain split and the unsplit kernel,
    both in the storage dtype, and a repeat bitwise equal; at float32 with
    m >= d against the float64 plain version instead. The max abs error."""
    import torch

    m, d = args[2].shape[-1], args[2].shape[-2]
    got = _split_run_b2(wk, args, blocks, plan=plan)
    torch.cuda.synchronize()
    name = f"B2 split [{tag}] maha"
    if dtype == torch.float32 and m >= d:
        err = check_general(name, got, wk.whiten_sumsq_torch(*(a.double() for a in args[:5])),
                            dtype)
    else:
        plain = _split_run_b2(wk, args, blocks, kernel=False)
        whole = wk._whiten_sumsq_cuda(*args[:5], general=True if plan else None, plan=plan)
        err = max(check_general(name, got.to(dtype), plain.to(dtype), dtype),
                  check_general(f"B2 split against unsplit [{tag}] maha", got.to(dtype), whole,
                                dtype))
    if not torch.equal(_split_run_b2(wk, args, blocks, plan=plan), got):
        fail(f"B2 split [{tag}]: a repeat gave other bits")
    return err


# B1's split modes on the kernels' other routes, in 2 blocks, untimed: every
# dtype at every rank of GENERAL_RANKS on (8, 1000, m, 5) (float32 m = 0 and
# 12 on the fast kernel, every other case on the general one); float32 at
# d_r <= m < d ((8, 50, 40, 5), blocks of 25 rows) and at m >= d ((8, 26,
# m, 5), the double-register instantiation, against the float64 plain
# version over F32_EDGE_DRAWS draws); the general kernel's plan with its sums
# in the global workspace ((4, 1000, 1000, 5) at a 16 KB limit)
SPLIT_ROUTES_B, SPLIT_ROUTES_N = 8, 5
SPLIT_EDGE = ((50, 40), (26, 40), (26, 100), (26, 258))
SPLIT_WORKSPACE = (4, 1000, 1000, 5)


def split_routes(wk, rng):
    """The cases of SPLIT_ROUTES..SPLIT_WORKSPACE for B1's split and B2's;
    one line each."""
    import torch

    B, N = SPLIT_ROUTES_B, SPLIT_ROUTES_N
    cases = [(dt, D, m) for dt in GENERAL_DTYPES for m in GENERAL_RANKS]
    cases += [("float32", d, m) for d, m in SPLIT_EDGE]
    checks = (("B1", check_split_case), ("B2", check_b2_split_case))
    for dt_name, d, m in cases:
        dtype = getattr(torch, dt_name)
        tag = f"B={B} d={d} m={m} N={N} {dt_name} in 2 blocks"
        route = "fast" if wk.uses_fast_kernel(dtype, m) else "general"
        for which, check in checks:
            err = max(check(wk, tag, args, 2, dtype)
                      for args in general_inputs(rng, B, d, m, N, dtype))
            print(f"{which} split [{tag}] {route} kernel: max_abs_err={err:.3e}", flush=True)
    B, d, m, N = SPLIT_WORKSPACE
    plan = wk._general_rows_plan(B, d // 2, m, N, torch.float32, smem_limit=16384)
    if not plan.ws:
        fail(f"the 16 KB split plan {plan} did not put its sums in the workspace")
    tag = f"workspace B={B} d={d} m={m} N={N} float32 in 2 blocks"
    for which, check in checks:
        err = max(check(wk, tag, args, 2, torch.float32, plan)
                  for args in general_inputs(rng, B, d, m, N, torch.float32))
        print(f"{which} split [{tag}] general kernel plan={tuple(plan)}: max_abs_err={err:.3e} "
              "(against the float64 plain version)", flush=True)


def dim_split_phase(wk):
    """B1 split in row blocks on the card: the partial of every block, the
    sums in rank order, the resume of every block, against the plain split
    and the unsplit kernel, a repeat bitwise equal, at the headline's ELBO
    chunk (DIM_SPLIT_CASES) and on the kernels' other routes
    (:func:`split_routes`); L2-cold times of one block's launches at the
    headline beside their plain versions and bounds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(12)
    B, d, m, N = K * 8, D, M, 5
    rows_out = dim_split_b2(wk, rng) + dim_split_shared(wk, rng)
    for dt_name, blocks in DIM_SPLIT_CASES:
        dtype = getattr(torch, dt_name)
        args = _seeded_inputs(rng, B, d, m, N, dtype)
        u, a_half, X, C, mu, logdet = args
        r = d // blocks
        tag = f"{dt_name} d={d} in {blocks} blocks"
        err = check_split_case(wk, tag, args, blocks, dtype)
        c = (slice(None), slice(0, r))
        ub, Xb, ab, mub = (t[c].contiguous() for t in (u, X, a_half, mu))
        t_sum, usq_sum = wk._sample_and_logq_partial_cuda(ub, Xb, d)
        item = torch.finfo(dtype).bits // 8
        general = not wk.uses_fast_kernel(dtype, m)
        plan = (wk._general_rows_plan(B, r, m, N, dtype) if general
                else wk._launch_plan(B, r, m, N))
        for mode, kernel, plain in (
                ("partial", lambda: wk._sample_and_logq_partial_cuda(ub, Xb, d),
                 lambda: wk.sample_and_logq_partial_torch(ub, Xb)),
                ("resume", lambda: wk._sample_and_logq_resume_cuda(
                    ub, ab, Xb, C, mub, logdet, t_sum, usq_sum, d),
                 lambda: wk.sample_and_logq_resume_torch(
                    ub, ab, Xb, C, mub, logdet, t_sum, usq_sum, d))):
            ms, plain_ms = time_cold_ms(kernel), time_cold_ms(plain)
            bound, by = split_bound_us(mode, B, r, m, N, item)
            name = f"sample_and_logq_{mode}" + ("_general" if general else "")
            rows_out.append(dict(name=name, dtype=dt_name, blocks=blocks, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_us=bound, bound_by=by))
            print(f"kernel {name} [{tag}: one block B={B} d_r={r} m={m} N={N}] plan={tuple(plan)} "
                  f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_us={bound:.2f} ({by}) share={bound / (1e3 * ms):.3f}", flush=True)
    split_routes(wk, rng)
    return rows_out


def dim_split_b2(wk, rng):
    """B2 split in row blocks at the PSIS shape (DIM_SPLIT_CASES), against
    the plain split and the unsplit kernel, a repeat bitwise equal; one
    block's launches timed L2-cold beside their plain versions and bounds.
    The rows of the kernels' line."""
    import torch

    B, d, m, N = K, D, M, 10
    rows_out = []
    for dt_name, blocks in DIM_SPLIT_CASES:
        dtype = getattr(torch, dt_name)
        args = _seeded_inputs(rng, B, d, m, N, dtype)
        x, a_half, X, Ci, mu, _ = args
        r = d // blocks
        tag = f"{dt_name} d={d} in {blocks} blocks"
        err = check_b2_split_case(wk, tag, args, blocks, dtype)
        c = (slice(None), slice(0, r))
        xb, Xb, ab, mub = (t[c].contiguous() for t in (x, X, a_half, mu))
        t_sum = wk._whiten_sumsq_partial_cuda(xb, ab, Xb, mub, d)
        item = torch.finfo(dtype).bits // 8
        general = not wk.uses_fast_kernel(dtype, m)
        plan = (wk._general_rows_plan(B, r, m, N, dtype) if general
                else wk._launch_plan(B, r, m, N))
        for mode, kernel, plain in (
                ("partial", lambda: wk._whiten_sumsq_partial_cuda(xb, ab, Xb, mub, d),
                 lambda: wk.whiten_sumsq_partial_torch(xb, ab, Xb, mub)),
                ("resume", lambda: wk._whiten_sumsq_resume_cuda(xb, ab, Xb, Ci, mub, t_sum, d),
                 lambda: wk.whiten_sumsq_resume_torch(xb, ab, Xb, Ci, mub, t_sum))):
            ms, plain_ms = time_cold_ms(kernel), time_cold_ms(plain)
            bound, by = split_bound_us(f"whiten {mode}", B, r, m, N, item)
            name = f"whiten_sumsq_{mode}" + ("_general" if general else "")
            rows_out.append(dict(name=name, dtype=dt_name, blocks=blocks, err=err, ms=ms,
                                 plain_ms=plain_ms, bound_us=bound, bound_by=by))
            print(f"kernel {name} [{tag}: one block B={B} d_r={r} m={m} N={N}] plan={tuple(plan)} "
                  f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_us={bound:.2f} ({by}) share={bound / (1e3 * ms):.3f}", flush=True)
    return rows_out


def dim_phase(pt, wk, zoo, smi, main_khats, auto_runs):
    """The headline over a (paths, dim) mesh on the one card:
    ``paths_dim_mesh(1, ["cuda:0"] * 2)`` on DIM_SEEDS and
    ``paths_dim_mesh(2, ["cuda:0"] * 4)`` on seed 0, every path succeeding, the
    median k̂ and moment error in the headline band, repeats bitwise equal,
    the split kernels launched on every run; a (2, 1) mesh bitwise the paths
    mesh of the same two entries; the float64 headline on the (1, 2) mesh
    against the unsharded run. Returns the kernels' launches of the float32
    dim-mesh runs and of the float64 one."""
    import torch

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    totals = {name: 0 for name in wk.launch_counts()}
    t_phase = time.perf_counter()

    def add(grew):
        for n, c in grew.items():
            totals[n] += c

    hz = {}  # label -> the line-search kernel's launches (each member launches its own)

    def timed(label, count=True, target=target, **options):
        wk.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        options = dict(dict(nruns=K, maxiters=64, elbo_chunk=8), **options)
        res = pt.multipathfinder(target, 1000, **options)
        torch.cuda.synchronize()
        secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        grew, hz[label] = wk.launch_counts(), _hz_launches()
        if count:
            add(grew)
        print(f"dim phase [{label}]: wall_s={secs:.3f} peak_device_bytes={peak} "
              f"paths_ok={int(res.states.success.sum())}/{res.states.success.numel()} "
              f"khat={float(res.psis_result.pareto_shape):.4f} "
              f"split_launches={ {n: c for n, c in grew.items() if n.startswith(SPLIT_KERNELS) and c} } "
              f"hz_step_launches={hz[label]} card: {smi}", flush=True)
        return res, grew

    khats, merrs, first = [], [], {}
    for blocks, entries, seeds in ((1, 2, DIM_SEEDS), (2, 4, DIM_SEEDS[:1])):
        mesh = pt.paths_dim_mesh(blocks, ["cuda:0"] * entries)
        shape = tuple(mesh.devices.shape)  # (paths, dim)
        for seed in seeds:
            res, grew = timed(f"mesh {shape} seed {seed}", mesh=mesh, seed=seed)
            khat, merr = _check_result(f"dim mesh {shape} seed {seed}", res, mean_t, sd_t)
            if min(grew[n] for n in SPLIT_KERNELS) <= 0:
                fail(f"dim mesh {shape} seed {seed}: a split kernel was not launched: {grew}")
            if hz[f"mesh {shape} seed {seed}"] <= 0:
                fail(f"dim mesh {shape} seed {seed}: the line-search kernel was not launched")
            print(f"dim phase [mesh {shape} seed {seed}]: khat={khat:.4f} (no mesh "
                  f"{main_khats[seed]:.4f}) moment_err_mean_sd_units={merr:.4f} "
                  f"logp_grad_evals={int(res.states.num_fn_evals.sum())}", flush=True)
            khats.append(khat)
            merrs.append(merr)
            first.setdefault(shape, res)
        again, _ = timed(f"mesh {shape} seed {seeds[0]}, repeat", mesh=mesh, seed=seeds[0])
        stage = first_differing_stage(again, first[shape], target)
        if stage is not None:
            fail(f"dim mesh {shape}: a repeat differs first in the {stage[0]}: {stage[1]}")
        del again
    med_k, med_m = statistics.median(khats), statistics.median(merrs)
    print(f"dim phase: median khat={med_k:.4f} band={KHAT_BAND}; median moment error="
          f"{med_m:.4f} band={MOMENT_ERR_BAND}; repeats bitwise equal", flush=True)
    if not KHAT_BAND[0] <= med_k <= KHAT_BAND[1]:
        fail(f"dim mesh: median k-hat {med_k} outside the JAX band {KHAT_BAND}")
    if not MOMENT_ERR_BAND[0] <= med_m <= MOMENT_ERR_BAND[1]:
        fail(f"dim mesh: median moment error {med_m} outside the JAX band {MOMENT_ERR_BAND}")
    add(dim_logpdf_path(wk, first[(1, 2)], "float32", smi))
    del first

    one, _ = timed("mesh (2, 1) seed 0", count=False,
                   mesh=pt.paths_dim_mesh(2, ["cuda:0"] * 2), seed=0)
    paths, _ = timed("paths mesh of 2 seed 0", count=False,
                     mesh=pt.paths_mesh(["cuda:0"] * 2), seed=0)
    stage = first_differing_stage(one, paths, target)
    if stage is not None:
        fail(f"dim width 1: differs from the paths mesh first in the {stage[0]}: {stage[1]}")
    print("dim phase: a (2, 1) mesh bitwise the paths mesh of 2 at every stage", flush=True)
    del one, paths

    r64, _ = timed("float64 mesh (1, 2) seed 0", mesh=pt.paths_dim_mesh(1, ["cuda:0"] * 2),
                   seed=0, dtype=torch.float64)
    if hz["float64 mesh (1, 2) seed 0"] <= 0:
        fail("dim mesh float64: the line-search kernel was not launched")
    u64, _ = timed("float64 no mesh seed 0", count=False, seed=0, dtype=torch.float64)
    same = int((r64.states.fit_iteration == u64.states.fit_iteration).sum())
    gap = float((r64.states.fit_distribution.mean - u64.states.fit_distribution.mean).abs().max())
    print(f"dim phase float64: {same}/{K} paths with the unsharded fit iteration; paths_ok="
          f"{int(r64.states.success.sum())}/{int(u64.states.success.sum())}; largest gap of the "
          f"fitted means {gap:.3e}", flush=True)
    if int(r64.states.success.sum()) != K:
        fail(f"dim mesh float64: {int(r64.states.success.sum())}/{K} paths succeeded")
    add(dim_logpdf_path(wk, r64, "float64", smi))
    del r64, u64
    add(dim_mixture_path(pt, wk, zoo, smi))
    add(dim_optimizer_paths(pt, wk, zoo, smi, auto_runs, timed))
    print(f"dim phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return totals


def dim_logpdf_path(wk, res, dt_name, smi):
    """B2's split on its path: ``MvNormal.logpdf`` of a dim-mesh result's
    pooled draws under their own components (the component denominator's
    PSIS log q, (100, 12, 10) at d = 1000) through ``dim_map`` on
    ``dim_mesh(["cuda:0"] * 2)``, the user's way: the leaves placed with d
    leading by ``shard_dim``, the normals built inside the function. Against
    the same function unsharded, at the B2 split's tolerances; a repeat
    bitwise equal; both B2 split modes launched and the unsplit B2 not.
    Returns the launches of the first driven run."""
    import torch

    from pathfinder_tpu_torch.ops.mvnormal import MvNormal
    from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
    from pathfinder_tpu_torch.parallel.dim_sharding import dim_map, dim_mesh, shard_dim

    comps = res.fit_distribution.components
    cov = comps.cov
    leaves = (cov.A.mT, cov.B.transpose(0, 1), cov.D, comps.mean.mT,
              res.draws_per_component.permute(2, 0, 1))  # d leading: (d, K), (d, K, m), ...

    def logq(A, B, D_, mean, x):
        W = WoodburyPDMat.from_parts(A.mT, B.transpose(0, 1), D_)
        return MvNormal(mean.mT.contiguous(), W).logpdf(x.transpose(0, 1).contiguous())

    mesh = dim_mesh(["cuda:0"] * 2)
    run = dim_map(logq, mesh, out_split=False)
    placed = shard_dim(leaves, mesh, dim=D)
    want = logq(*leaves)
    torch.cuda.synchronize()
    wk.reset_launch_counts()
    t0 = time.perf_counter()
    got = run(*placed).gather()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grew = wk.launch_counts()
    dtype = getattr(torch, dt_name)
    split = [n + ("_general" if dtype == torch.float64 else "") for n in B2_SPLIT_KERNELS]
    unsplit = "whiten_sumsq" + ("_general" if dtype == torch.float64 else "")
    if min(grew[n] for n in split) <= 0 or grew[unsplit] > 0:
        fail(f"dim logpdf [{dt_name}]: B2's split modes not launched, or the unsplit one was: "
             f"{grew}")
    err = check_close(f"dim logpdf [{dt_name}] against the unsharded logpdf", got, want,
                      GENERAL_F64_TOL if dtype == torch.float64 else SUM_TOL)
    if not torch.equal(run(*placed).gather(), got):
        fail(f"dim logpdf [{dt_name}]: a repeat gave other bits")
    print(f"dim phase [logpdf {dt_name} via dim_map on 2 entries, B={K} d={D} m={M} N="
          f"{leaves[-1].shape[-1]}]: max_abs_err={err:.3e} against the unsharded logpdf, repeat "
          f"bitwise equal, wall_s={secs:.3f} launches={ {n: grew[n] for n in split} } card: {smi}",
          flush=True)
    return grew


# The mixture denominator and a dense covariance on the dim axis: the headline
# mixture run's (seed 0) components and pooled draws through dim_map on
# DIM_MIXTURE_ENTRIES entries of the card, float32 and float64; its sample of
# DIM_MIXTURE_DRAWS in a group of 2; a dense SPD A at d = 1000, m = 12 on 2
# entries, its logpdf at and rand_and_logpdf of DIM_MIXTURE_DRAWS columns.
DIM_MIXTURE_ENTRIES = (2, 4)
DIM_MIXTURE_DRAWS = 1000


def dim_mixture_path(pt, wk, zoo, smi):
    """The shared-x split on its path: ``UniformMixture.logpdf`` of the
    headline mixture run's components at its pooled draws ((100, 12, 1000) at
    d = 1000) through ``dim_map`` on 2 and 4 entries of the card, the leaves
    placed with d leading by ``shard_dim``, against the port's unsharded
    ``_log_importance_ratios_mixture`` and the same function unsharded, at the
    B2 split's tolerances (the components placed whole, their factor too, so
    that no member factorizes them again); both shared-x split parts launched
    and the unsplit one not; a repeat bitwise equal. The mixture's ``sample``
    in a group of 2
    against the unsharded draws and ids. A dense covariance on 2 entries:
    ``logpdf`` and ``rand_and_logpdf`` against the unsharded call, a repeat
    bitwise equal, its peak memory. Returns the launches of the driven runs."""
    import torch

    from pathfinder_tpu_torch import multipath
    from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
    from pathfinder_tpu_torch.ops.woodbury import WoodburyFactor, WoodburyPDMat
    from pathfinder_tpu_torch.parallel.dim_sharding import dim_map, dim_mesh, shard_dim
    from pathfinder_tpu_torch.utils import rng

    target = zoo.HierarchicalGaussian(D, seed=0)
    totals = {name: 0 for name in wk.launch_counts()}

    def driven(fn):
        """``fn()`` on the card, timed (host clock around a synchronized call),
        its peak memory and the launches it made added to the totals."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wk.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs, peak, grew = time.perf_counter() - t0, torch.cuda.max_memory_allocated(), wk.launch_counts()
        for n, c in grew.items():
            totals[n] += c
        return out, secs, peak, grew

    def placed_leaves(comps):
        """The fitted components' leaves with d leading, as ``shard_dim``
        splits them (the factor's too, so that no member factorizes again)."""
        cov, F = comps.cov, comps.cov.factor
        return (comps.mean.mT, cov.A.mT, cov.B.transpose(0, 1), cov.D, F.a_half.mT,
                F.X.transpose(0, 1), F.C, F.Ci, F.log_det)

    def mixture_of(mean, A, B, D_, a_half, X, C, Ci, log_det):
        F = WoodburyFactor(a_half.mT, X.transpose(0, 1), C, Ci, log_det)
        W = WoodburyPDMat(A.mT, B.transpose(0, 1), D_, F)
        return UniformMixture(MvNormal(mean.mT.contiguous(), W))

    def logq(x, *leaves):
        return mixture_of(*leaves).logpdf(x)

    stream = rng.Stream(0, 0, 0, rng.RESAMPLE_FRESH)

    def sample(*leaves):
        return mixture_of(*leaves).sample(stream, DIM_MIXTURE_DRAWS)

    for dt_name in ("float32", "float64"):
        dtype = getattr(torch, dt_name)
        f64 = dtype == torch.float64
        res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=0,
                                 dtype=dtype, importance_denominator="mixture")
        comps, draws = res.fit_distribution.components, res.draws_per_component  # (K, N, d)
        x = draws.reshape(-1, D).mT  # the pool (d, K·N), a column's rows side by side
        leaves = placed_leaves(comps)
        want = multipath._log_importance_ratios_mixture(comps, draws).reshape(-1)
        same_fn = logq(x, *leaves)
        tol = GENERAL_F64_TOL if f64 else SUM_TOL
        for entries in DIM_MIXTURE_ENTRIES:
            mesh = dim_mesh(["cuda:0"] * entries)
            run = dim_map(logq, mesh, out_split=False)
            placed = shard_dim((x,) + leaves, mesh, dim=D)
            tag = f"mixture logpdf {dt_name} via dim_map on {entries} entries"
            got, secs, peak, grew = driven(lambda: run(*placed).gather())
            if min(grew[n] for n in SHARED_SPLIT_KERNELS) <= 0 or grew["whiten_sumsq_shared"] > 0:
                fail(f"dim {tag}: the shared-x split parts not launched, or the unsplit one was: "
                     f"{grew}")
            err = max(check_close(f"dim {tag} against the unsharded mixture ratios", got, want, tol),
                      check_close(f"dim {tag} against the same function unsharded", got, same_fn,
                                  tol))
            if not torch.equal(run(*placed).gather(), got):
                fail(f"dim {tag}: a repeat gave other bits")
            print(f"dim phase [{tag}, B={K} d={D} m={M} P={x.shape[1]}]: max_abs_err={err:.3e} "
                  f"against the unsharded mixture ratios, repeat bitwise equal, wall_s={secs:.3f} "
                  f"peak_device_bytes={peak} launches="
                  f"{ {n: grew[n] for n in SHARED_SPLIT_KERNELS} } card: {smi}", flush=True)
        mesh = dim_mesh(["cuda:0"] * 2)
        tag = f"mixture sample {dt_name} in a group of 2"
        placed = shard_dim(leaves, mesh, dim=D)
        (got_x, got_k), secs, _, grew = driven(
            lambda: dim_map(sample, mesh, out_split=(True, False))(*placed))
        want_x, want_k = sample(*leaves)
        split = [n + ("_general" if f64 else "") for n in SPLIT_KERNELS]
        if min(grew[n] for n in split) <= 0:
            fail(f"dim {tag}: B1's split modes were not launched: {grew}")
        # the B1 split's tolerance times the components' largest |C|: the core
        # multiplies t, whose sum over the members runs in another order
        core = max(1.0, float(comps.cov.factor.C.abs().max()))
        err = check_close(f"dim {tag} draws", got_x.gather(), want_x,
                          tuple(core * v for v in (GENERAL_F64_TOL if f64 else X_TOL)))
        if not torch.equal(got_k.gather(), want_k):
            fail(f"dim {tag}: the component ids differ from the unsharded ones")
        print(f"dim phase [{tag}, {DIM_MIXTURE_DRAWS} draws]: max_abs_err={err:.3e} against the "
              f"unsharded draws (tolerance x{core:.1f}, the largest |C|), ids equal, "
              f"wall_s={secs:.3f} card: {smi}", flush=True)
        del res, comps, draws, x, leaves, placed

    g = torch.Generator("cuda").manual_seed(D)
    f64 = dict(dtype=torch.float64, device="cuda")
    G = torch.randn((D, D), generator=g, **f64) / D**0.5
    A = 0.5 * torch.eye(D, **f64) + G @ G.mT
    base = ((A + A.mT) / 2, torch.randn((D, M), generator=g, **f64) / D**0.5,
            0.5 * torch.eye(M, **f64), torch.randn(D, generator=g, **f64),
            torch.randn((D, DIM_MIXTURE_DRAWS), generator=g, **f64))
    noise = rng.Stream(1, 0, 0, rng.EXTRA)

    def dense(A, B, D_, mean, x):
        normal = MvNormal(mean, WoodburyPDMat.from_parts(A, B, D_))
        return (normal.logpdf(x),) + normal.rand_and_logpdf(noise, DIM_MIXTURE_DRAWS)

    mesh = dim_mesh(["cuda:0"] * 2)
    for dt_name in ("float32", "float64"):
        dtype = getattr(torch, dt_name)
        args = tuple(a.to(dtype) for a in base)
        run = dim_map(dense, mesh, out_split=(False, True, False))
        placed = shard_dim(args, mesh, dim=D)
        tag = f"dense covariance {dt_name} via dim_map on 2 entries"
        got, secs, peak, _ = driven(lambda: [o.gather() for o in run(*placed)])
        want = dense(*args)
        big = GENERAL_F64_TOL if dtype == torch.float64 else SUM_TOL
        err = max(check_close(f"dim {tag} logpdf", got[0], want[0], big),
                  check_close(f"dim {tag} draws", got[1], want[1],
                              GENERAL_F64_TOL if dtype == torch.float64 else X_TOL),
                  check_close(f"dim {tag} logq", got[2], want[2], big))
        if not all(torch.equal(a, b) for a, b in zip([o.gather() for o in run(*placed)], got)):
            fail(f"dim {tag}: a repeat gave other bits")
        print(f"dim phase [{tag}, A ({D}, {D}) m={M}, {DIM_MIXTURE_DRAWS} columns]: "
              f"max_abs_err={err:.3e} against the unsharded call, repeat bitwise equal, "
              f"wall_s={secs:.3f} peak_device_bytes={peak} for both members card: {smi}",
              flush=True)
    return totals


# the dim axis's other optimizers: k̂ of the remedy path's winner on the (1,
# 2) mesh within this of the unsharded run's on each seed; BFGS's fit
# iterations equal on at least this share of paths and its median |Δk̂| at
# most this (float32 reductions in another order); Newton on BASELINE config
# 2 (CorrelatedGaussian(100), history_length=20) with 8 paths
AUTO_DIM_KHAT_TOL = 0.005
BFGS_DIM_FIT_SHARE = 0.95
BFGS_DIM_KHAT_TOL = 0.01
NEWTON_DIM_PATHS = 8


def dim_optimizer_paths(pt, wk, zoo, smi, auto_runs, timed):
    """Every optimizer on ``paths_dim_mesh(1, ["cuda:0"] * 2)``: the remedy
    path (``optimizer="auto", auto_laplace=True``) on REMEDY_SEEDS against
    phase 4's winners and k̂, a repeat bitwise equal; BFGS at the headline on
    seed 0 against the unsharded BFGS run, its peak beside ``lane_bytes``;
    Newton on config 2 against the unsharded run; the port's CG as a user
    callable against the unsharded ``optimizer="cg"`` run, its trajectory
    bitwise. ``timed`` is the dim phase's runner. Returns the launches of
    the mesh runs."""
    import torch

    from pathfinder_tpu_torch.ops.cg import minimize_cg_trace
    from pathfinder_tpu_torch.parallel import sharding

    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    mesh = pt.paths_dim_mesh(1, ["cuda:0"] * 2)
    totals = {name: 0 for name in wk.launch_counts()}

    def on_mesh(label, **options):
        res, grew = timed(label, count=False, mesh=mesh, **options)
        # config 2's rank 40 takes the general kernel's split modes
        if min(grew[n] + grew[n + "_general"] for n in SPLIT_KERNELS) <= 0:
            fail(f"dim {label}: a split kernel of B1 was not launched: {grew}")
        for n, c in grew.items():
            totals[n] += c
        return res

    khats, first = [], None
    for seed in REMEDY_SEEDS:
        res = on_mesh(f"auto mesh (1, 2) seed {seed}", seed=seed, optimizer="auto",
                      auto_laplace=True)
        khat, merr = _check_result(f"dim auto seed {seed}", res, mean_t, sd_t)
        winner, khat0 = auto_runs[seed]
        print(f"dim phase [auto mesh (1, 2) seed {seed}]: winner={res.config.optimizer} "
              f"(no mesh {winner}) khat={khat:.4f} (no mesh {khat0:.4f}) "
              f"moment_err_mean_sd_units={merr:.4f}", flush=True)
        if res.config.optimizer != winner or abs(khat - khat0) > AUTO_DIM_KHAT_TOL:
            fail(f"dim auto seed {seed}: winner {res.config.optimizer} k-hat {khat} against "
                 f"{winner} {khat0} without the mesh")
        khats.append(khat)
        first = first if first is not None else res
    again = on_mesh(f"auto mesh (1, 2) seed {REMEDY_SEEDS[0]}, repeat", seed=REMEDY_SEEDS[0],
                    optimizer="auto", auto_laplace=True)
    stage = first_differing_stage(again, first, target)
    if stage is not None:
        fail(f"dim auto: a repeat differs first in the {stage[0]}: {stage[1]}")
    med_k = statistics.median(khats)
    print(f"dim phase auto: median khat={med_k:.4f} band={AUTO_KHAT_BAND}; repeat bitwise equal",
          flush=True)
    if not AUTO_KHAT_BAND[0] <= med_k <= AUTO_KHAT_BAND[1]:
        fail(f"dim auto: median k-hat {med_k} outside the JAX band {AUTO_KHAT_BAND}")
    del first, again

    ref, _ = timed("bfgs no mesh seed 0", count=False, seed=0, optimizer="bfgs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = on_mesh("bfgs mesh (1, 2) seed 0", seed=0, optimizer="bfgs")
    peak = torch.cuda.max_memory_allocated()
    est = (sharding.lane_bytes(D, 64, 6, 5, 8, 10, torch.float32, "bfgs", dim_width=2)
           + sharding.target_bytes(target, torch.zeros(1, D, device="cuda"), 8 * 5)[0])
    same = float((got.states.fit_iteration == ref.states.fit_iteration).float().mean())
    dk = abs(float(got.psis_result.pareto_shape) - float(ref.psis_result.pareto_shape))
    print(f"dim phase [bfgs mesh (1, 2) seed 0]: paths_ok={int(got.states.success.sum())}/"
          f"{int(ref.states.success.sum())} fit iterations equal on {same:.2%} of paths, "
          f"|dkhat|={dk:.4f}; peak_device_bytes={peak} for both members on the one card, "
          f"{peak / 2 / K:.0f} a lane a member against lane_bytes(dim_width=2) and the "
          f"target's bytes a lane={est} "
          f"(the first member's) card: {smi}", flush=True)
    if not torch.equal(got.states.success, ref.states.success):
        fail("dim bfgs: the paths that succeeded differ from the unsharded run's")
    if same < BFGS_DIM_FIT_SHARE or dk > BFGS_DIM_KHAT_TOL:
        fail(f"dim bfgs: fit iterations equal on {same:.2%} of paths, |dkhat| {dk}")
    del ref, got

    config2 = zoo.CorrelatedGaussian(100, seed=0)
    kw = dict(target=config2, nruns=NEWTON_DIM_PATHS, maxiters=128, history_length=20,
              ndraws_elbo=100, seed=0, optimizer="newton")
    ref, _ = timed("newton config 2 no mesh", count=False, **kw)
    got = on_mesh("newton config 2 mesh (1, 2)", **kw)
    same = int((got.states.fit_iteration == ref.states.fit_iteration).sum())
    gap = float((got.states.fit_distribution.mean - ref.states.fit_distribution.mean).abs().max())
    print(f"dim phase [newton config 2]: paths_ok={int(got.states.success.sum())}/"
          f"{NEWTON_DIM_PATHS}, {same}/{NEWTON_DIM_PATHS} at the unsharded fit iteration, largest "
          f"gap of the fitted means {gap:.3e}", flush=True)
    if not (bool(got.states.success.all()) and torch.equal(got.states.success,
                                                            ref.states.success)):
        fail("dim newton: a path failed, or the paths that succeeded differ")
    if same < BFGS_DIM_FIT_SHARE * NEWTON_DIM_PATHS:
        fail(f"dim newton: {same}/{NEWTON_DIM_PATHS} paths at the unsharded fit iteration")
    del ref, got

    ref, _ = timed("cg no mesh seed 0", count=False, seed=0, optimizer="cg")
    got = on_mesh("cg as a user callable mesh (1, 2) seed 0", seed=0,
                  optimizer=minimize_cg_trace)
    for name in ("xs", "gradients", "num_fn_evals"):
        if not torch.equal(getattr(got.states.trace, name), getattr(ref.states.trace, name)):
            fail(f"dim callable: the trace's {name} differ from the unsharded cg run's")
    print("dim phase [cg as a user callable mesh (1, 2) seed 0]: its trajectory (xs, gradients, "
          "evaluations) bitwise the unsharded optimizer='cg' run", flush=True)
    return totals


def _iter_launches() -> int:
    """The L-BFGS iteration kernel's launches since the launch counters'
    last reset."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk
    from pathfinder_tpu_torch.utils import tracing

    return tracing.counts(lk.ITER_COUNTER).get(lk.ITER_COUNTER, 0)


def _hz_launches() -> int:
    """The Hager-Zhang state-update kernel's launches since the launch
    counters' last reset (``wk.reset_launch_counts`` resets them all)."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk
    from pathfinder_tpu_torch.utils import tracing

    return tracing.counts(lk.COUNTER).get(lk.COUNTER, 0)


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaNs and signed zeros included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    if a.dtype in ints:
        a, b = a.contiguous().view(ints[a.dtype]), b.contiguous().view(ints[b.dtype])
    return torch.equal(a, b)


# the line-search kernel's searches: each lane's first trial step is one of
# these, in turn (the line-search tests' first steps), so that lanes expand,
# take secants, bisect and back off from non-finite values; one lane in 11
# is left out; the (1, 2) mesh's row blocks
HZ_STEPS = (1.0, 1e-3, 0.3, 7.0, 60.0, 1e-6, 1e4)
HZ_BLOCKS = 2


def hz_step_phase(pt, zoo):
    """The Hager-Zhang state-update kernel (``csrc/linesearch_kernels.cu``)
    against its plain version ``_hz_step_torch`` at the main path's shapes,
    K = 100 lanes of d = 1000, in float64 and float32: a whole search on the
    headline target driven with both steps from the same state, after every
    evaluation every state entry, the trial point and the flag bit for bit,
    then the search's results; beside it the kernel launched on each of the
    (1, 2) mesh's row blocks (500 rows, the whole lanes' scalars and the
    full dφ, as a row group's member launches it), each block's rows and
    every scalar against the plain version's. Then one step at (100, 1000)
    on the card (CUDA events behind a sleep, so the host has queued every
    step before the first starts) and on the host, beside the plain step,
    and the kernel's bound: x and p read, the trial point written, the
    state's rows read and written, once each."""
    import torch

    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    target = zoo.HierarchicalGaussian(D, seed=0)

    def vg(z):  # the search minimizes -logp, as the optimizers give it
        lp, g = target.value_and_grad(z)
        return -lp, -g

    def device_us(fn, reps, sleep_cycles):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the sleep still ran: every step was queued behind it
        torch.cuda.synchronize()
        return 1e3 * start.elapsed_time(end) / reps, queued

    def host_us(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * secs / reps

    rows_out = []
    r = D // HZ_BLOCKS
    cols = [slice(j * r, (j + 1) * r) for j in range(HZ_BLOCKS)]
    c1 = tls.resolve_c1(None, "hager_zhang")
    for dtype in (torch.float64, torch.float32):
        dt_name = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2**33 + 41)
        x = (torch.rand(K, D, generator=gen, device="cuda", dtype=dtype) * 2 - 1) * 2.0
        f0, g0 = vg(x)
        p = -g0
        alpha0 = torch.tensor(HZ_STEPS, dtype=dtype, device="cuda").repeat(K)[:K]
        active = torch.arange(K, device="cuda") % 11 != 10

        def start():
            return tls._hz_start(x, f0, g0, p, alpha0, active, c1, 0.9, 12, 5.0, 1e-6, 0.66, 0.5)

        plain, k = start()
        whole = lk.pack(plain, k)
        blocks = [lk.pack(dict(plain, g_a=plain["g_a"][:, c], g_acc=plain["g_acc"][:, c]), k)
                  for c in cols]
        more = bool(tls._hz_running(plain, k.max_evals).any())
        x_c = x + plain["c"][:, None] * p
        evals, stages = 0, set()
        while more:
            phi_c, g_c = vg(x_c)
            dphi_c = torch.sum(g_c * p, dim=-1)
            plain, x_p, more_p = tls._hz_step_torch(plain, phi_c, g_c, dphi_c, x, p, k)
            whole, x_k, more_k = lk.step(whole, phi_c, g_c, dphi_c, x, p, k)
            parts = [lk.step(b, phi_c, g_c[:, c], dphi_c, x[:, c], p[:, c], k)
                     for b, c in zip(blocks, cols)]
            blocks = [b for b, _, _ in parts]
            evals += 1
            more = bool(more_p)
            tag = f"hz_step {dt_name} evaluation {evals}"
            if bool(more_k) != more or any(bool(flag) != more for _, _, flag in parts):
                fail(f"{tag}: the kernel's flag differs from the plain version's")
            if not _same_bits(x_k, x_p) or not _same_bits(
                    torch.cat([xb for _, xb, _ in parts], 1), x_p):
                fail(f"{tag}: the trial point differs from the plain version's")
            for key, want in plain.items():
                got = [whole[key]]
                if want.dim() == 2:  # g_a, g_acc: each block holds its rows
                    got.append(torch.cat([b[key] for b, _, _ in parts], 1))
                else:
                    got += [b[key] for b, _, _ in parts]
                if not all(_same_bits(t, want) for t in got):
                    fail(f"{tag}: state entry {key} differs from the plain version's")
            stages.update(plain["stage"].tolist())
            x_c = x_p
        want, got = tls._hz_result(plain, k, g0), tls._hz_result(whole, k, g0)
        for field in ("step_size", "f", "g", "num_evals", "ok", "exhausted"):
            if not _same_bits(getattr(got, field), getattr(want, field)):
                fail(f"hz_step {dt_name}: the search's {field} differs from the plain version's")
        if evals < 2:
            fail(f"hz_step {dt_name}: the search ended after {evals} evaluation")

        # one step at a search's first evaluation, every active lane running
        s0, k0 = start()
        x_c = x + s0["c"][:, None] * p
        phi_c, g_c = vg(x_c)
        dphi_c = torch.sum(g_c * p, dim=-1)
        fused = lk.pack(s0, k0)
        item = torch.finfo(dtype).bits // 8
        steps = {"kernel": lambda: lk.step(fused, phi_c, g_c, dphi_c, x, p, k0),
                 "plain": lambda: tls._hz_step_torch(s0, phi_c, g_c, dphi_c, x, p, k0)}
        times = {}
        for name, fn in steps.items():
            fn()  # the library's and each eager op's first launch
            host = host_us(fn, 200 if name == "kernel" else 50)
            # the card's launch queue holds about a thousand launches: the
            # plain step's ≈ 175 ops fit behind the sleep 4 steps at a time;
            # a sleep of 1.5 times the host's time for the steps, at 2 GHz
            reps = 200 if name == "kernel" else 4
            dev, queued = device_us(fn, reps, int(3e3 * host * reps) + 10**7)
            if not queued:
                fail(f"hz_step {dt_name} {name}: the steps were not all queued behind the sleep")
            times[name] = (host, dev)
        moved = item * (3 * K * D + (2 * len(lk.FIELDS) + len(lk.CONSTANTS) + 2) * K) + 8 * 4 * K
        bound = 1e6 * moved / HBM_BYTES_PER_S
        (host, dev), (plain_host, plain_dev) = times["kernel"], times["plain"]
        rows_out.append(dict(name="hz_step", dtype=dt_name, err=0.0, ms=dev / 1e3,
                             plain_ms=plain_dev / 1e3, host_us=host, plain_host_us=plain_host,
                             bound_us=bound, bound_by="bytes"))
        print(f"kernel hz_step [{dt_name} K={K} d={D}, and {HZ_BLOCKS} row blocks of {r}]: "
              f"{evals} evaluations bit for bit at every state entry, trial point and flag "
              f"(stages seen {sorted(stages)}); one step: card {dev:.3f} us, host {host:.2f} us; "
              f"the plain step: card {plain_dev:.2f} us, host {plain_host:.2f} us; "
              f"bound_us={bound:.3f} (bytes) share={bound / dev:.3f}", flush=True)
    return rows_out


ITER_HISTORY = 6  # the main path's history_length
ITER_DIMS = (D, 56)  # the two cells' d


def lbfgs_iter_phase():
    """The L-BFGS iteration kernel (``lbfgs_iter_kernel`` of
    ``csrc/linesearch_kernels.cu``) against the plain iteration at K = 100
    lanes of each d of ITER_DIMS, in float64 and float32: one launch from a
    crafted batch (lanes frozen, first, rejecting the curvature pair,
    aborting, converged, stalled, exhausted, ``pos`` wrapping) and one in
    start mode, checked by ``tests/lbfgs_kernel_cases.py`` (integers,
    booleans, trace, history rows, search state and trial point bit for
    bit; the direction, diagonal, step and dφ(0) to rounding). Then L-BFGS
    on the hierarchical posterior at each d in float64, with the kernel and
    with the plain iteration: the card's µs a launch (the profiler's device
    time of a run's launches) beside the bound, each byte the launch must move once
    (x, p, g, the search's gradient, α and the lane's 2J history rows read;
    the trace's two rows, x, g, α, the history's two new rows, p, g_a, g_acc
    and the trial point written: (16 + 2J) d values a lane), and the host's
    µs an iteration in the iteration's own work, kernel and plain."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    import lbfgs_kernel_cases as lc

    for dtype in (torch.float64, torch.float32):
        for d in ITER_DIMS:
            it = lc.check_iteration(K, d, ITER_HISTORY, dtype)
            start = lc.check_start(K, d, ITER_HISTORY, dtype)
            print(f"kernel lbfgs_iter [{it['dtype']} K={K} d={d} J={ITER_HISTORY}]: one launch "
                  f"against the plain iteration: {it['moved']} lanes moved, {it['done']} done, "
                  f"{it['running']} run on; start mode: {start['running']} run; integers, "
                  f"booleans, trace, history rows, search state and trial point bit for bit, "
                  f"the sums over d to rounding", flush=True)
    rows = []
    for d in ITER_DIMS:
        t = lc.iteration_times(K, d, torch.float64)
        bound = 1e6 * 8 * K * d * (16 + 2 * ITER_HISTORY) / HBM_BYTES_PER_S
        rows.append(dict(name="lbfgs_iter", dtype="float64", d=d, err=0.0, ms=t["card_us"] / 1e3,
                         host_us=t["host_us"], plain_host_us=t["plain_host_us"],
                         bound_us=bound, bound_by="bytes"))
        print(f"kernel lbfgs_iter [float64 K={K} d={d} J={ITER_HISTORY}]: L-BFGS on the "
              f"hierarchical posterior, {t['launches']} launches (plain: {t['plain_iterations']} "
              f"iterations): card {t['card_us']:.3f} us a launch, "
              f"bound_us={bound:.3f} (bytes) share={bound / t['card_us']:.3f}; host an "
              f"iteration {t['host_us']:.2f} us, the plain iteration's {t['plain_host_us']:.2f} "
              f"us; the run {t['run_s']:.3f} s, plain {t['plain_run_s']:.3f} s; "
              f"num_valid max {t['num_valid_max']}", flush=True)
    return rows


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
        from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk
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

    t_start = t0 = time.perf_counter()
    wk.load_library()
    lk.load_library()
    print(f"build: kernels built and loaded in {time.perf_counter() - t0:.2f}s", flush=True)

    def stamp(name):
        print(f"chip_smoke: {name} starts at {time.perf_counter() - t_start:.1f}s", flush=True)

    kernels = kernel_phase(wk)
    stamp("the general kernel phase")
    general_rows = general_kernel_phase(wk)
    stamp("the shared-x kernel phase")
    shared_rows = shared_kernel_phase(wk)
    stamp("the split kernel phase")
    split_rows = dim_split_phase(wk)
    stamp("the line-search kernel phase")
    hz_rows = hz_step_phase(pt, zoo)
    stamp("the L-BFGS iteration kernel phase")
    iter_rows = lbfgs_iter_phase()
    if "--kernels-only" in sys.argv[1:]:  # for work on the kernels: stop after their phase
        print("kernel phase passed; stopping before the model phases", flush=True)
        return
    stamp("the main path phase")
    counts, main_khats, headline = main_path_phase(pt, wk, zoo)
    stamp("the remedy phase")
    remedy_counts, auto_runs = remedy_phase(pt, wk, zoo, main_khats)
    old_phases = [remedy_counts]
    remedy_stage_times(pt, zoo)
    stamp("the warm-start phase")
    warm_start_phase(pt, zoo, headline)
    stamp("the constrained-model phase")
    old_phases.append(constrained_phase(pt, wk, zoo))
    for name, c in old_phases[-1].items():
        if name in FAST_KERNELS and c <= 0:
            fail(f"{name} was not launched on the constrained-model path")
    stamp("the serving phase")
    old_phases.append(serving_phase(pt, wk, zoo, headline))
    stamp("the mesh phase")
    old_phases.append(mesh_phase(pt, wk, zoo, headline, smi))
    for phase in old_phases:
        for name, c in phase.items():
            counts[name] += c
    if max(counts[n] for n in GENERAL_KERNELS) > 0:
        fail(f"a float32 phase at rank <= {wk.MAX_RANK} left the fast kernel: {counts}")
    stamp("the dim phase")
    # the dim phase adds the launches of the split modes only: its other
    # launches (the PSIS tail, float64) belong to paths counted above
    for name, c in dim_phase(pt, wk, zoo, smi, main_khats, auto_runs).items():
        if name.startswith(SPLIT_KERNELS + B2_SPLIT_KERNELS + SHARED_SPLIT_KERNELS):
            counts[name] += c
    stamp("the dtype, rank and memory phases")
    t_new = time.perf_counter()
    for phase in (config2_phase, float64_phase, low_precision_phase):
        for name, c in phase(pt, wk, zoo).items():
            counts[name] += c
    memory_rule_phase(pt, zoo)
    print(f"dtype, rank and memory phases: {time.perf_counter() - t_new:.1f}s", flush=True)

    replaces = {
        "sample_and_logq": "pathfinder_tpu/ops/pallas/woodbury_kernels.py:70",
        "whiten_sumsq": "pathfinder_tpu/ops/pallas/woodbury_kernels.py:146",
    }
    summary = []

    def entry(name, source, rows, head, replaced):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces[replaced],
            "launches": counts[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_us"] / 1e3,
            "bound_by": head["bound_by"],
            "library_ms": None,  # no single PyTorch call computes it
        }

    for name, rows in kernels.items():
        main = [r for r in rows if r["label"] in MAIN_PATH[name]]
        head = main[0]  # the largest main-path shape
        summary.append(entry(name, "pathfinder_tpu_torch/csrc/woodbury_kernels.cu", rows, head, name))
    for name, (dt_name, label, m) in GENERAL_MAIN.items():
        # the head: the float64 headline's shape; the error: the largest over
        # that dtype's cases (a 16-bit error is at its own scale)
        rows = [r for r in general_rows if r["name"] == name and r["dtype"] == dt_name]
        head = next(r for r in rows if r["label"] == label and r["m"] == m)
        summary.append(entry(name + "_general", "pathfinder_tpu_torch/csrc/woodbury_general.cu",
                             rows, head, name))
    # the shared-x kernel: the head is the mixture launch of the main path's
    # configuration (float32, rank 12); bound_ms is its tensor-core bound,
    # cuda_core_bound_ms the bound of the earlier rows; the error the largest
    # over the float32 cases
    rows = [r for r in shared_rows if r["dtype"] == "float32"]
    head = next(r for r in rows if r["label"] == "mixture" and r["m"] == M)
    item = entry("whiten_sumsq_shared", "pathfinder_tpu_torch/csrc/woodbury_shared.cu", rows, head,
                 "whiten_sumsq")
    item.update(bound_ms=head["tc_bound_us"] / 1e3, bound_by="operations",
                cuda_core_bound_ms=head["bound_us"] / 1e3)
    summary.append(item)
    # B1's and B2's row-split modes: the head is the (1, 2) mesh's block, the
    # ELBO chunk's (B1) or the PSIS ratios' (B2) 500 rows; the error the
    # largest over that dtype's cases
    for name in SPLIT_KERNELS + B2_SPLIT_KERNELS:
        for general, dt_name, source in (
                ("", "float32", "pathfinder_tpu_torch/csrc/woodbury_kernels.cu"),
                ("_general", "float64", "pathfinder_tpu_torch/csrc/woodbury_general.cu")):
            rows = [r for r in split_rows if r["name"] == name + general]
            head = next(r for r in rows if r["blocks"] == 2)
            summary.append(entry(name + general, source, rows, head,
                                 "sample_and_logq" if name in SPLIT_KERNELS else "whiten_sumsq"))
    # the shared-x kernel's split parts: the head is the (1, 2) mesh's block of
    # the mixture shape, 500 rows in float32; bound_ms is its tensor-core bound
    for name in SHARED_SPLIT_KERNELS:
        rows = [r for r in split_rows if r["name"] == name and r["dtype"] == "float32"]
        head = next(r for r in rows if r["blocks"] == 2)
        item = entry(name, "pathfinder_tpu_torch/csrc/woodbury_shared.cu", rows, head,
                     "whiten_sumsq")
        item.update(bound_by="operations", cuda_core_bound_ms=head["cuda_core_bound_us"] / 1e3)
        summary.append(item)
    # the Hager-Zhang state update: the head is the benchmark's float64 step at
    # (100, 1000); the launches the main path's (float32); bit for bit
    head = next(r for r in hz_rows if r["dtype"] == "float64")
    summary.append({
        "name": "hz_step", "route": "cuda", "source": "pathfinder_tpu_torch/csrc/linesearch_kernels.cu",
        "replaces": "pathfinder_tpu_torch/ops/linesearch.py:_hz_step_torch (the port's own: the "
                    "JAX package's search is compiled by XLA)",
        "launches": counts["hz_step"], "max_abs_err": 0.0, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_us"] / 1e3, "bound_by": "bytes",
        "library_ms": None, "host_us": head["host_us"], "plain_host_us": head["plain_host_us"],
    })
    # the L-BFGS iteration: the head is the benchmark's float64 launch at (100,
    # 1000); the launches the main path's (float32); bit for bit where no sum
    # over d enters, to rounding where one does
    head = next(r for r in iter_rows if r["d"] == D)
    summary.append({
        "name": "lbfgs_iter", "route": "cuda",
        "source": "pathfinder_tpu_torch/csrc/linesearch_kernels.cu",
        "replaces": "pathfinder_tpu_torch/ops/trajectory.py:advance, ops/lbfgs.py:"
                    "_lbfgs_direction and _lbfgs_update, ops/linesearch.py:_hz_start and "
                    "_hz_result (the port's own: the JAX package's loop is compiled by XLA)",
        "launches": counts["lbfgs_iter"], "max_abs_err": None, "ms": head["ms"],
        "plain_ms": None, "bound_ms": head["bound_us"] / 1e3, "bound_by": "bytes",
        "library_ms": None, "host_us": head["host_us"], "plain_host_us": head["plain_host_us"],
    })
    for item in summary:
        if item["launches"] <= 0:
            fail(f"{item['name']} was not launched on its path")
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

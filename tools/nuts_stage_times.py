#!/usr/bin/env python3
"""Where the time of one warm-started NUTS call goes, on one card.

    python3 tools/nuts_stage_times.py

At the headline configuration (``HierarchicalGaussian(1000)``, 100 Pathfinder
paths, 4 chains warm-started from the result, the fixed Pathfinder metric) it
prints, each the median of 50 repeats with a ``torch.cuda.synchronize()``
around it (host clock):

* the pieces of a leaf iteration of the tree loop: the leapfrog's two
  metric products and the target's value and gradient, the energy, the
  multinomial update and the masked state update, a checkpoint store, a
  U-turn check of one block, and the device→host read of the loop condition;
* the pieces of a transition outside the tree: the momentum draw (Philox and
  ``L⁻ᵀz``), the tree's direction, merge and leaf uniforms (one Philox call),
  the dual-averaging step;
* ``summarize`` over the ``(4, 200, 1000)`` sample stack.

Then it runs 20 sampling transitions at the adapted step size under
``torch.profiler`` and prints the wall time, the leaf iterations, the number
of device kernels and their summed device time: how far a leaf iteration is
from the device time of its kernels.

Needs a CUDA card and ``nvcc``; prints the card's name and power limit first.
"""

import importlib
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import pathfinder_tpu_torch as pt  # noqa: E402
# the submodules: the package exports the functions hmc and nuts under their names
hmc = importlib.import_module("pathfinder_tpu_torch.integrations.hmc")
nuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")
from pathfinder_tpu_torch.models import zoo  # noqa: E402
from pathfinder_tpu_torch.utils import diagnostics  # noqa: E402

D, K, CHAINS = 1000, 100, 4


def timed_ms(fn, reps=50):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {smi}", flush=True)

    target = zoo.HierarchicalGaussian(D, seed=0)
    res = pt.multipathfinder(target, 1000, nruns=K, maxiters=64, elbo_chunk=8, seed=0)
    vg, metric, x0s = nuts.warm_start_chains(res, CHAINS)
    noise = hmc.StreamNoise(0, torch.arange(CHAINS, device="cuda"), D, torch.float32, "cuda")
    x = x0s
    logp, g = vg(x)
    p = metric.sample_momentum(noise.momentum(0))
    eps = torch.full((CHAINS,), 0.24, device="cuda")
    run = torch.ones(CHAINS, dtype=torch.bool, device="cuda")
    h0 = logp - metric.kinetic_energy(p)
    ckpt = torch.zeros(11, CHAINS, D, device="cuda")

    def multinomial_and_state():
        delta = (logp - metric.kinetic_energy(p)) - h0
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        lsw = torch.logaddexp(h0, delta)
        take = torch.log(eps) < (delta - lsw)
        prop = nuts._where(run & take, (x, g, logp), (x, g, logp))
        cur = nuts._where(run, nuts._Point(x, p, g, logp), nuts._Point(x, p, g, logp))
        return prop, cur, torch.where(run, lsw, h0), delta < -1000.0

    def checkpoint_store():
        ckpt[3] = nuts._where(run, p, ckpt[3])
        ckpt[4] = nuts._where(run, x, ckpt[4])

    def uturn_block():
        rho_block = x - ckpt[3]
        v_end = metric.grad_kinetic(p)
        return (nuts._dot(rho_block, metric.grad_kinetic(ckpt[4])) <= 0) | (nuts._dot(rho_block, v_end) <= 0)

    da = hmc.da_init(0.1, torch.float32, (CHAINS,), "cuda")
    stack = torch.randn(CHAINS, 200, D, device="cuda")
    pieces = [
        ("leaf: target value_and_grad (4, 1000)", lambda: vg(x)),
        ("leaf: metric.grad_kinetic (W p, low rank)", lambda: metric.grad_kinetic(p)),
        ("leaf: whole leapfrog_step", lambda: hmc.leapfrog_step(vg, metric, x, p, g, eps)),
        ("leaf: energy, multinomial update, masked state update", multinomial_and_state),
        ("leaf: checkpoint store (even leaves)", checkpoint_store),
        ("leaf: U-turn check of one block (odd leaves)", uturn_block),
        ("leaf: loop condition read on the host, bool(run.any())", lambda: bool(run.any())),
        ("transition: momentum normals (Philox + Box-Muller)", lambda: noise.momentum(1)),
        ("transition: metric.sample_momentum (L^-T z)", lambda: metric.sample_momentum(x)),
        ("transition: direction, merge and leaf uniforms of the tree", lambda: noise.tree(1, 10)),
        ("transition: dual-averaging update", lambda: hmc.da_update(da, eps, 0.8)),
        ("call: summarize (4, 200, 1000)", lambda: diagnostics.summarize(stack)),
    ]
    with torch.no_grad():
        for name, fn in pieces:
            print(f"stage [{name}]: {timed_ms(fn):.4f} ms", flush=True)

    # 20 sampling transitions at a fixed step size under the profiler
    calls = [0]

    def counted(xx):
        calls[0] += 1
        return vg(xx)

    kw = dict(num_warmup=0, num_samples=20, max_depth=10, init_step_size=0.24)
    nuts.nuts(0, counted, metric, x0s, **kw)  # warm
    calls[0] = 0
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = nuts.nuts(0, counted, metric, x0s, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    leaf_iters = calls[0] - 1
    print(f"20 transitions, not profiled: wall_s={wall:.4f} leaf_iterations={leaf_iters} "
          f"ms_per_leaf_iteration={1e3 * wall / leaf_iters:.3f} "
          f"leapfrogs={out.n_leapfrogs.sum(1).tolist()}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nuts.nuts(0, counted, metric, x0s, **kw)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    device_us, kernels = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            device_us += t
            kernels += ev.count
    if device_us <= 0:
        print("profiler: no device time recorded: device share not measured", flush=True)
    else:
        print(f"20 transitions, profiled: wall_s={wall_p:.4f} device_kernels={kernels} "
              f"device_time_s={device_us / 1e6:.4f} device_busy_share={device_us / 1e6 / wall_p:.4f} "
              f"kernels_per_leaf_iteration={kernels / leaf_iters:.1f} "
              f"device_us_per_leaf_iteration={device_us / leaf_iters:.1f} "
              f"wall_us_per_leaf_iteration_unprofiled={1e6 * wall / leaf_iters:.1f}", flush=True)


if __name__ == "__main__":
    main()

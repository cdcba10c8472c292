#!/usr/bin/env python3
"""Peak device memory of one launch of B lanes against the memory rule's
estimates, on one card.

    python3 tools/serving_memory.py [B ...]          # default: 512 1024 2048
    python3 tools/serving_memory.py --remedies [B]   # default B: 256
    python3 tools/serving_memory.py --dim [B] [OPT]  # default B: 512, OPT: lbfgs

At the headline configuration (``HierarchicalGaussian(1000)``, maxiters=64,
history_length=6, ndraws_elbo=5, elbo_chunk=8, 5 draws a path, f32) the
first form runs ``pathfinder_core`` once on B paths (one launch, traces
kept, as ``multipathfinder`` runs each chunk) and prints, for each B:

* the wall time of the launch (host clock, a synchronize on each side);
* ``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``,
  less what was allocated before, in all and per lane, beside
  ``parallel.sharding.lane_bytes`` with the target's bytes a lane
  (``parallel.sharding.target_bytes``), the estimate that
  ``multipathfinder``'s memory rule plans a launch's lanes with;
* the bytes of the state one lane keeps, traces kept and slim, beside
  ``parallel.sharding.state_bytes``.

The second form measures, per lane, one launch of B paths under each
optimizer the rule names (``lbfgs``, ``cg``, ``bfgs``, ``newton``) against
``lane_bytes(optimizer=...)`` and the target's bytes a lane; ``laplace_resample``'s correction of B
components (``diag`` and ``full``) against ``laplace_lane_bytes``; and the
mixture denominator over a block of B paths' draws with every one of 4·B
components against the term ``lane_bytes`` adds for it.

The third runs the executor of a ``paths_dim_mesh(1, devices)`` on B
paths, the lanes' rows split over the ``dim`` axis: over 2 and over 4
distinct cards where the machine has them, and over one card named twice.
For each device it prints the peak above what was allocated before, per
lane, beside the estimate that device's entry is planned with: the group's
first device against ``lane_bytes(dim_width=w)`` and the target's bytes a
lane (its rows, the target's full-width evaluation and the joined state),
every other against
``lane_bytes`` at ``d / w`` rows; a card named twice holds two entries and
is planned for twice the first's estimate (``mesh_device_bytes``). With
``OPT`` (``bfgs``, ``newton``) the launch runs that optimizer: BFGS holds
its row blocks of H on every member (``DENSE_COPIES`` of ``(d/w, d)``), so
a member's estimate adds them; Newton's Hessian and ``eigh`` run on the
first device only.

Needs a CUDA card and ``nvcc``; prints the card's name and power limit first.
"""

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from pathfinder_tpu_torch.models import zoo  # noqa: E402
from pathfinder_tpu_torch.multipath import (  # noqa: E402
    _log_importance_ratios_mixture,
    _slim_traces,
    laplace_corrected_components_and_draws,
)
from pathfinder_tpu_torch.parallel import sharding  # noqa: E402
from pathfinder_tpu_torch.singlepath import PathfinderConfig, pathfinder_core  # noqa: E402
from pathfinder_tpu_torch.utils import rng  # noqa: E402
from pathfinder_tpu_torch.utils.misc import tree_map  # noqa: E402

D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS = 1000, 64, 6, 5, 8, 5


def leaf_bytes(state) -> int:
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), state)
    return sum(total)


def peak_of(fn):
    """``(fn(), peak bytes above what was allocated before, seconds)``."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before, time.perf_counter() - t0


def starts(B):
    ids = torch.arange(B, device="cuda")
    return ids, rng.Stream(0, ids, 0, rng.INIT).uniform(D, torch.float32, "cuda") * 4.0 - 2.0


def target_lane(target):
    """The target's bytes for the points one lane hands it at once, as the
    memory rule learns them (``sharding.target_bytes``)."""
    return sharding.target_bytes(target, starts(16)[1], max(CHUNK * N_ELBO, NDRAWS))[0]


def launches(target, sizes):
    cfg = PathfinderConfig(maxiters=MAXITERS, history_length=J, ndraws_elbo=N_ELBO,
                           ndraws=NDRAWS, elbo_chunk=CHUNK)
    estimate = sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS) + target_lane(target)
    for B in [64] + sizes:  # the first launch builds the kernels and warms up
        ids, x0s = starts(B)
        state, peak, secs = peak_of(lambda: pathfinder_core(target, x0s, cfg, 0, ids, 0))
        if B == 64:
            continue
        full, slim = leaf_bytes(state) / B, leaf_bytes(_slim_traces(state)) / B
        print(f"launch B={B}: wall_s={secs:.3f} paths_ok={int(state.success.sum())}/{B} "
              f"peak_bytes={peak} peak_per_lane={peak / B:.0f} lane_bytes_estimate={estimate} "
              f"estimate/measured={estimate / (peak / B):.3f} "
              f"state_per_lane={full:.0f} (state_bytes {sharding.state_bytes(D, MAXITERS, J, NDRAWS)}) "
              f"slim_state_per_lane={slim:.0f} "
              f"(state_bytes {sharding.state_bytes(D, MAXITERS, J, NDRAWS, keep_traces=False)})",
              flush=True)
        del state


def remedies(target, B):
    for opt in ("lbfgs", "cg", "bfgs", "newton"):
        cfg = PathfinderConfig(maxiters=MAXITERS, history_length=J, ndraws_elbo=N_ELBO,
                               ndraws=NDRAWS, elbo_chunk=CHUNK, optimizer=opt)
        ids, x0s = starts(B)
        pathfinder_core(target, x0s[:8], cfg, 0, ids[:8], 0)  # warm up
        state, peak, secs = peak_of(lambda: pathfinder_core(target, x0s, cfg, 0, ids, 0))
        est = (sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS, torch.float32, opt)
               + target_lane(target))
        print(f"optimizer={opt} B={B}: wall_s={secs:.3f} paths_ok={int(state.success.sum())}/{B} "
              f"peak_per_lane={peak / B:.0f} lane_bytes_estimate={est} "
              f"estimate/measured={est / (peak / B):.3f}", flush=True)
        if opt == "lbfgs":
            comps = state.fit_distribution
            draws = state.draws.mT.contiguous()
        del state
    for method in ("diag", "full"):
        stream = rng.Stream(0, torch.arange(B, device="cuda"), 1, rng.LAPLACE_DRAWS)
        _, peak, secs = peak_of(lambda: laplace_corrected_components_and_draws(
            target.logp, comps, stream, NDRAWS, method))
        est = sharding.laplace_lane_bytes(D, NDRAWS, torch.float32, method)
        print(f"laplace_resample method={method} block={B}: wall_s={secs:.3f} "
              f"peak_per_component={peak / B:.0f} laplace_lane_bytes={est} "
              f"estimate/measured={est / (peak / B):.3f}", flush=True)
    # the mixture denominator over one block of B paths' draws, with every
    # component of a pool of 4·B (the pool's components stacked four times)
    every = tree_map(lambda t: torch.cat([t] * 4), comps)
    _, peak, secs = peak_of(lambda: (_log_importance_ratios_mixture(every, draws),
                                     target.logp(draws.reshape(-1, D))))
    full = sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS, torch.float32,
                               importance_denominator="mixture", nruns=4 * B)
    est = full - sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS)
    print(f"mixture denominator block={B} paths x {4 * B} components: wall_s={secs:.3f} "
          f"peak_per_path={peak / B:.0f} lane_bytes_mixture_term={est} "
          f"estimate/measured={est / (peak / B):.3f}", flush=True)


def dim_meshes(target, B, opt="lbfgs"):
    cfg = PathfinderConfig(maxiters=MAXITERS, history_length=J, ndraws_elbo=N_ELBO,
                           ndraws=NDRAWS, elbo_chunk=CHUNK, optimizer=opt)
    count = torch.cuda.device_count()
    layouts = [[f"cuda:{i}" for i in range(w)] for w in (2, 4) if w <= count]
    layouts.append(["cuda:0"] * 2)
    for names in layouts:
        w = len(names)
        mesh = sharding.paths_dim_mesh(1, names)
        executor = sharding.make_path_executor(mesh)
        lead_est = sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS, torch.float32, opt,
                                       dim_width=w) + target_lane(target)
        member_est = sharding.lane_bytes(D // w, MAXITERS, J, N_ELBO, CHUNK, NDRAWS)
        if opt == "bfgs":  # a member's row blocks of H
            member_est += sharding.DENSE_COPIES["bfgs"] * 4 * (D // w) * D
        for lanes in (64, B):  # the first launch warms every device up
            ids, x0s = starts(lanes)
            devices = list(dict.fromkeys(torch.device(n) for n in names))
            for dev in devices:
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            before = {dev: torch.cuda.memory_allocated(dev) for dev in devices}
            for dev in devices:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state = executor(ids, x0s, target, cfg, 0, 0)
            for dev in devices:
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            if lanes == 64:
                del state
                continue
            for dev in devices:
                per = (torch.cuda.max_memory_allocated(dev) - before[dev]) / lanes
                entries = names.count(str(dev))
                if dev == devices[0]:
                    est = lead_est + (entries - 1) * member_est
                    planned = entries * lead_est
                    role = "first device" + (f", {entries} entries" if entries > 1 else "")
                else:
                    est = planned = member_est
                    role = "member"
                print(f"dim mesh {names} optimizer={opt} B={lanes}: {dev} ({role}) wall_s={secs:.3f} "
                      f"paths_ok={int(state.success.sum())}/{lanes} peak_per_lane={per:.0f} "
                      f"estimate={est} estimate/measured={est / per:.3f} planned={planned} "
                      f"planned/measured={planned / per:.3f}", flush=True)
            del state


def main():
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    target = zoo.HierarchicalGaussian(D, seed=0)
    args = sys.argv[1:]
    if args and args[0] == "--remedies":
        remedies(target, int(args[1]) if len(args) > 1 else 256)
    elif args and args[0] == "--dim":
        dim_meshes(target, int(args[1]) if len(args) > 1 else 512,
                   args[2] if len(args) > 2 else "lbfgs")
    else:
        launches(target, [int(a) for a in args] or [512, 1024, 2048])


if __name__ == "__main__":
    main()

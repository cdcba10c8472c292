#!/usr/bin/env python3
"""Peak device memory and wall time of one launch of B lanes, on one card.

    python3 tools/serving_memory.py [B ...]      # default: 512 1024 2048

At the headline configuration (``HierarchicalGaussian(1000)``, maxiters=64,
history_length=6, ndraws_elbo=5, elbo_chunk=8, 5 draws a path, f32) it runs
``pathfinder_core`` once on B paths (one launch, traces kept, as
``multipathfinder`` runs each chunk) and prints, for each B:

* the wall time of the launch (host clock, a synchronize on each side);
* ``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``,
  less what was allocated before, in all and per lane, beside
  ``parallel.sharding.lane_bytes``, the estimate that ``multipathfinder``'s
  memory rule divides the card's memory by;
* the bytes of the state one lane keeps, traces kept and slim, beside
  ``parallel.sharding.state_bytes``.

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
from pathfinder_tpu_torch.multipath import _slim_traces  # noqa: E402
from pathfinder_tpu_torch.parallel import sharding  # noqa: E402
from pathfinder_tpu_torch.singlepath import PathfinderConfig, pathfinder_core  # noqa: E402
from pathfinder_tpu_torch.utils import rng  # noqa: E402
from pathfinder_tpu_torch.utils.misc import tree_map  # noqa: E402

D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS = 1000, 64, 6, 5, 8, 5


def leaf_bytes(state) -> int:
    total = []
    tree_map(lambda t: total.append(t.numel() * t.element_size()), state)
    return sum(total)


def main():
    if not torch.cuda.is_available():
        sys.exit("a CUDA card is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    target = zoo.HierarchicalGaussian(D, seed=0)
    cfg = PathfinderConfig(maxiters=MAXITERS, history_length=J, ndraws_elbo=N_ELBO,
                           ndraws=NDRAWS, elbo_chunk=CHUNK)
    estimate = sharding.lane_bytes(D, MAXITERS, J, N_ELBO, CHUNK, NDRAWS)
    sizes = [int(a) for a in sys.argv[1:]] or [512, 1024, 2048]
    for B in [64] + sizes:  # the first launch builds the kernels and warms up
        ids = torch.arange(B, device="cuda")
        x0s = rng.Stream(0, ids, 0, rng.INIT).uniform(D, torch.float32, "cuda") * 4.0 - 2.0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = pathfinder_core(target, x0s, cfg, 0, ids, 0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
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


if __name__ == "__main__":
    main()

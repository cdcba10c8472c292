#!/usr/bin/env python3
"""The serving check of ``chip_smoke.py`` alone, repeated: a K = 32768
headline run in launches of 8192, offloaded and on the card, compared stage
by stage, on one card.

    python3 tools/serving_determinism.py            # 5 pairs
    python3 tools/serving_determinism.py --runs 8   # 8 pairs

Each pair runs ``multipathfinder`` on ``HierarchicalGaussian(1000)`` with
``keep_traces=False`` and ``max_paths_per_launch=8192``, first with
``offload_launches=True``, then on the card, and prints the first stage whose
tensors differ (``chip_smoke.first_differing_stage``: the paths' states, the
pooled draws, the log importance ratios, the PSIS weights, the resampled
component ids and draws), or that all are bitwise equal, with each run's
k̂ and moment error. Exits 1 if any pair differs. Prints the card's name and
power limit first.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=5, help="pairs to run")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    import pathfinder_tpu_torch as pt
    from pathfinder_tpu_torch.models import zoo

    target = zoo.HierarchicalGaussian(cs.D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(cs.D, seed=0)
    differ = 0
    for i in range(opts.runs):
        runs = {}
        for offload in (True, False):
            t0 = time.perf_counter()
            res = pt.multipathfinder(target, 1000, nruns=cs.SERVE_K, maxiters=64, elbo_chunk=8,
                                     seed=0, keep_traces=False,
                                     max_paths_per_launch=cs.SERVE_CAP, offload_launches=offload)
            torch.cuda.synchronize()
            draws = res.draws.double().cpu().numpy()
            merr = float(np.max(np.abs(draws.mean(axis=1) - mean_t) / sd_t))
            print(f"pair {i} offload={offload}: khat={float(res.psis_result.pareto_shape):.4f} "
                  f"moment_err_mean_sd_units={merr:.4f} wall_s={time.perf_counter() - t0:.3f}",
                  flush=True)
            runs[offload] = res
        stage = cs.first_differing_stage(runs[True], runs[False], target)
        if stage is None:
            print(f"pair {i}: bitwise equal at every stage", flush=True)
        else:
            differ += 1
            print(f"pair {i}: first differ in the {stage[0]}: {stage[1]}", flush=True)
        del runs
        torch.cuda.empty_cache()
    print(f"pairs: {opts.runs}, differing: {differ}", flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()

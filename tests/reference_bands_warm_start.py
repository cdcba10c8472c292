"""Reference bands for the warm-start phase of ``chip_smoke.py``, from the JAX
package on the CPU (f32, x64 off), keys 0..9, at the headline sizes:

    JAX_PLATFORMS=cpu python tests/reference_bands_warm_start.py

``HierarchicalGaussian(1000, seed=0)``; ``multipathfinder(target, 1000,
nruns=100, maxiters=64, elbo_chunk=8)``; ``warm_start_chains(result, 4)``;
``nuts_chains(num_warmup=100, num_samples=200, max_depth=10)`` with the fixed
Pathfinder metric. Prints per key the max R̂, the min bulk ESS, the moment
error (max over coordinates of |mean − true mean| / posterior sd), the
divergences after warm-up, the adapted step sizes and the leapfrogs, then the
bands ``[min − r/2, max + r/2]`` (r the range over the keys) that
``chip_smoke.py`` holds the port to. Not a test: pytest does not collect it.
"""

import importlib
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

from pathfinder_tpu import multipathfinder  # noqa: E402
from pathfinder_tpu.models import zoo  # noqa: E402

nuts = importlib.import_module("pathfinder_tpu.integrations.nuts")

D, K = 1000, 100


def band(values):
    lo, hi = min(values), max(values)
    r = hi - lo
    return round(lo - r / 2, 4), round(hi + r / 2, 4)


def main():
    keys = [int(a) for a in sys.argv[1:]] or list(range(10))
    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    rows = []
    for k in keys:
        t0 = time.perf_counter()
        res = multipathfinder(target, 1000, key=jax.random.key(k), nruns=K, maxiters=64, elbo_chunk=8)
        vg, metric, x0s = nuts.warm_start_chains(res, 4)
        out, summary = nuts.nuts_chains(jax.random.key(1000 + k), vg, metric, x0s,
                                        num_warmup=100, num_samples=200, max_depth=10)
        xs = np.asarray(out.samples, dtype=np.float64).reshape(-1, D)
        row = dict(
            key=k,
            rhat_max=float(np.max(np.asarray(summary["rhat"]))),
            ess_min=float(np.min(np.asarray(summary["ess_bulk"]))),
            moment_err=float(np.max(np.abs(xs.mean(axis=0) - mean_t) / sd_t)),
            divergent=int(np.asarray(out.diverging).sum()),
            step_size=[round(float(s), 4) for s in np.asarray(out.step_size)],
            leapfrogs_median=float(np.median(np.asarray(out.n_leapfrogs))),
            leapfrogs_max=int(np.max(np.asarray(out.n_leapfrogs))),
            leapfrogs_total=int(np.asarray(out.n_leapfrogs).sum() + np.asarray(out.warmup_n_leapfrogs).sum()),
            depth_mean=float(np.mean(np.asarray(out.tree_depths))),
            finite=bool(np.isfinite(xs).all()),
            seconds=round(time.perf_counter() - t0, 1),
        )
        rows.append(row)
        print(row, flush=True)
    for name in ("rhat_max", "ess_min", "moment_err"):
        vals = [r[name] for r in rows]
        print(f"{name}: values {[round(v, 4) for v in vals]} band {band(vals)}", flush=True)
    print("divergent after warm-up:", [r["divergent"] for r in rows])


if __name__ == "__main__":
    main()

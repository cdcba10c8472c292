"""Reference outcomes and bands for the dtype and rank phases of
``chip_smoke.py``, from the JAX package on the CPU:

    JAX_PLATFORMS=cpu python tests/reference_bands_dtype_rank.py config2 [keys]
    JAX_PLATFORMS=cpu python tests/reference_bands_dtype_rank.py lowp [keys]
    JAX_PLATFORMS=cpu python tests/reference_bands_dtype_rank.py headline64 [keys]

* ``config2``: BASELINE config 2 (``bench.py`` ``run_all_configs``):
  ``pathfinder(CorrelatedGaussian(100, seed=0), ndraws=2000, maxiters=128,
  history_length=20, ndraws_elbo=100)`` in float32 (x64 off), keys 0..9: the
  success flag and the moment errors against the target's mean and
  covariance (max over coordinates of |mean error| / sd and of
  |sd error| / sd, as ``bench.py`` ``_moment_errors``).
* ``lowp``: the headline ``multipathfinder(HierarchicalGaussian(1000, seed=0),
  1000, nruns=100, maxiters=64, elbo_chunk=8, ntries=2)`` and the single-path
  ``pathfinder(HierarchicalGaussian(1000, seed=0), maxiters=64, ntries=2)``
  with ``dtype=bfloat16`` and ``float16`` (x64 off), keys 0..2: the
  warnings, and the paths that succeed or the type of the exception raised.
* ``headline64``: the same headline with ``dtype=float64`` (x64 on), keys
  0..9: paths succeeding, k̂ and the moment error of the draw means.

Prints a line per key, then the bands ``[min − r/2, max + r/2]`` (r the range
over the keys) that ``chip_smoke.py`` holds the port to. Not a test: pytest
does not collect it.
"""

import sys
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

MODE = sys.argv[1] if len(sys.argv) > 1 else "config2"
jax.config.update("jax_enable_x64", MODE == "headline64")

import jax.numpy as jnp  # noqa: E402

from pathfinder_tpu import multipathfinder, pathfinder  # noqa: E402
from pathfinder_tpu.models import zoo  # noqa: E402

D, K = 1000, 100


def band(values):
    lo, hi = min(values), max(values)
    r = hi - lo
    return round(lo - r / 2, 4), round(hi + r / 2, 4)


def moment_errors(draws, mean_t, sd_t):
    x = np.asarray(draws, dtype=np.float64)
    return (float(np.max(np.abs(x.mean(axis=1) - mean_t) / sd_t)),
            float(np.max(np.abs(x.std(axis=1) - sd_t) / sd_t)))


def config2(keys):
    target = zoo.CorrelatedGaussian(100, seed=0)
    sd_t = np.sqrt(np.diag(target.cov))
    mean_errs, sd_errs = [], []
    for k in keys:
        t0 = time.perf_counter()
        r = pathfinder(target, key=jax.random.key(k), ndraws=2000, maxiters=128,
                       history_length=20, ndraws_elbo=100)
        me, se = moment_errors(r.draws, target.mean, sd_t)
        print(f"config2 key={k}: success={bool(r.success)} tries={r.num_tries} "
              f"fit_iteration={r.fit_iteration} mean_err={me:.4f} sd_err={se:.4f} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        mean_errs.append(me)
        sd_errs.append(se)
    print(f"config2 bands: mean_err {band(mean_errs)} sd_err {band(sd_errs)}", flush=True)


def lowp(keys):
    target = zoo.HierarchicalGaussian(D, seed=0)
    runs = {
        "multipathfinder": lambda k, dt: multipathfinder(
            target, 1000, key=jax.random.key(k), nruns=K, maxiters=64, elbo_chunk=8, ntries=2,
            dtype=dt),
        "pathfinder": lambda k, dt: pathfinder(
            target, key=jax.random.key(k), maxiters=64, ntries=2, dtype=dt),
    }
    for entry, run in runs.items():
        for dt in (jnp.bfloat16, jnp.float16):
            for k in keys:
                t0 = time.perf_counter()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    try:
                        r = run(k, dt)
                        outcome = f"paths_ok={int(np.asarray(r.states.success).sum())}" if hasattr(
                            r, "states") else f"success={bool(r.success)} tries={r.num_tries}"
                    except Exception as e:  # the outcome is the exception's type
                        outcome = f"raised {type(e).__name__}"
                below_32 = any("optimization state is almost always" in str(w.message)
                               for w in caught)
                print(f"lowp {entry} {jnp.dtype(dt).name} key={k}: {outcome} "
                      f"warned_below_32_bits={below_32} ({time.perf_counter() - t0:.1f}s)",
                      flush=True)


def headline64(keys):
    target = zoo.HierarchicalGaussian(D, seed=0)
    mean_t, sd_t = zoo.hierarchical_gaussian_truth(D, seed=0)
    khats, merrs = [], []
    for k in keys:
        t0 = time.perf_counter()
        r = multipathfinder(target, 1000, key=jax.random.key(k), nruns=K, maxiters=64,
                            elbo_chunk=8, dtype=jnp.float64)
        khat = float(r.psis_result.pareto_shape)
        merr = moment_errors(r.draws, mean_t, sd_t)[0]
        print(f"headline64 key={k}: paths_ok={int(np.asarray(r.states.success).sum())}/{K} "
              f"khat={khat:.4f} moment_err={merr:.4f} draws_dtype={r.draws.dtype} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        khats.append(khat)
        merrs.append(merr)
    print(f"headline64 bands: khat {band(khats)} moment_err {band(merrs)}", flush=True)


if __name__ == "__main__":
    given = [int(a) for a in sys.argv[2:]]
    {"config2": lambda: config2(given or range(10)),
     "lowp": lambda: lowp(given or range(3)),
     "headline64": lambda: headline64(given or range(10))}[MODE]()

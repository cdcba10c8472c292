#!/usr/bin/env python3
"""The serving check of ``chip_smoke.py`` alone, repeated: a K = 32768
headline run in launches of 8192, offloaded and on the card, compared stage
by stage, on one card; or, with ``--ordered``, repeat pairs of the
constrained phase's ordered-logistic run.

    python3 tools/serving_determinism.py            # 5 pairs
    python3 tools/serving_determinism.py --runs 8   # 8 pairs
    python3 tools/serving_determinism.py --ordered  # 5 ordered-logistic pairs

Each pair runs ``multipathfinder`` on ``HierarchicalGaussian(1000)`` with
``keep_traces=False`` and ``max_paths_per_launch=8192``, first with
``offload_launches=True``, then on the card, and prints the first stage whose
tensors differ (``chip_smoke.first_differing_stage``: the paths' states, the
pooled draws, the log importance ratios, the PSIS weights, the resampled
component ids and draws), or that all are bitwise equal, with each run's
k̂ and moment error. Exits 1 if any pair differs. Prints the card's name and
power limit first.

``--ordered`` runs ``multipathfinder(OrderedLogisticRegression, 1000,
nruns=8, seed=0)`` twice a pair (the ``Ordered`` bijector's scan runs in its
log density, its gradient and the constrained draws) and compares the same
stages and then the constrained draws. It first counts the bit patterns 40
calls give of the model's ``value_and_grad`` at 8 rows, of the ``Ordered``
scan and its gradient at (8, 3) and (4096, 4), and of a ``torch.gather``
gradient at the model's shape (600 observations gathered from 5 cutpoints a
row, 8 rows): the gather's gradient is a scatter-add.
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
    parser.add_argument("--ordered", action="store_true",
                        help="repeat pairs of the ordered-logistic constrained run")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    import pathfinder_tpu_torch as pt
    from pathfinder_tpu_torch.models import zoo

    if opts.ordered:
        sys.exit(ordered_pairs(pt, zoo, opts.runs))
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


def patterns(fn, calls=40):
    """Distinct bit patterns of ``fn()``'s tensors over ``calls`` calls."""
    seen = set()
    for _ in range(calls):
        seen.add(b"".join(t.detach().cpu().numpy().tobytes() for t in fn()))
    return len(seen)


def op_repeats(model, yo):
    """Bit patterns of the ordered model's pieces over 40 calls each."""
    from pathfinder_tpu_torch.integrations.transforms import Ordered

    g = torch.Generator("cuda").manual_seed(0)
    z = torch.randn((8, 7), generator=g, device="cuda")

    def scan(rows, cols):
        w = torch.randn((rows, cols), generator=g, device="cuda")

        def run():
            zr = w.detach().requires_grad_(True)
            x = Ordered().forward(zr)
            return x, torch.autograd.grad((x * x).sum(), zr)[0]
        return run

    idx = torch.as_tensor(yo, device="cuda").expand(8, -1)
    c = torch.randn((8, 5), generator=g, device="cuda")
    wt = torch.randn(idx.shape, generator=g, device="cuda")

    def gather():
        cr = c.detach().requires_grad_(True)
        return (torch.autograd.grad((torch.gather(cr, -1, idx) * wt).sum(), cr)[0],)

    for label, fn in (("the model's value_and_grad at (8, 7)", lambda: model.unconstrained.value_and_grad(z)),
                      ("Ordered and its gradient at (8, 3)", scan(8, 3)),
                      ("Ordered and its gradient at (4096, 4)", scan(4096, 4)),
                      (f"torch.gather's gradient, {idx.shape[1]} observations from 5 cutpoints, 8 rows",
                       gather)):
        print(f"bit patterns in 40 calls of {label}: {patterns(fn)}", flush=True)


def ordered_pairs(pt, zoo, runs):
    """Repeat pairs of the ordered-logistic run; returns the exit code."""
    Xo, yo, _, _ = zoo.ordered_logistic_synthetic()
    model = zoo.OrderedLogisticRegression(Xo, yo, n_cats=4)
    op_repeats(model, yo)
    differ = 0
    for i in range(runs):
        pair = []
        for _ in range(2):
            t0 = time.perf_counter()
            res = pt.multipathfinder(model, 1000, nruns=8, seed=0)
            torch.cuda.synchronize()
            print(f"pair {i}: khat={float(res.psis_result.pareto_shape):.4f} "
                  f"wall_s={time.perf_counter() - t0:.3f}", flush=True)
            pair.append(res)
        a, b = pair
        stage = cs.first_differing_stage(a, b, a.target)
        if stage is None and not torch.equal(a.draws_transformed, b.draws_transformed):
            stage = ("constrained draws", "the Ordered forward map of equal draws")
        if stage is None:
            print(f"pair {i}: bitwise equal at every stage and in the constrained draws", flush=True)
        else:
            differ += 1
            print(f"pair {i}: first differ in the {stage[0]}: {stage[1]}", flush=True)
    print(f"ordered-logistic pairs: {runs}, differing: {differ}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    main()

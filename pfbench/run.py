"""Run one cell of the port's benchmark once and print its result's line.

    python3 pfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Runs only on
CUDA cards (as many as the cell asks for) and exits with code 1, printing
no result, where there are fewer.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
# the program under test is the checkout's own
sys.path[:0] = [str(BENCH), str(CHECKOUT)]
# a library that loads JAX by itself is kept from doing so
os.environ.setdefault("USE_FLAX", "0")
# one process with one host thread of torch's own: the calls are host-bound,
# and a pool of spinning threads makes their times swing
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cards_missing(chips: int) -> str:
    """Why the run cannot start on this machine, or ``""``."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card: the benchmark runs only on the card"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards, {torch.cuda.device_count()} are present"
    return ""


def main(argv=None) -> int:
    args = parse(argv)
    from pfharness.registry import find_cell

    cell = find_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    why = cards_missing(cell.chips)
    if why:
        print(why, file=sys.stderr)
        return 1
    try:
        import pathfinder_tpu_torch
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 1
    if CHECKOUT not in Path(pathfinder_tpu_torch.__file__).resolve().parents:
        print(f"pathfinder_tpu_torch comes from {pathfinder_tpu_torch.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 1
    from pfharness.imports import forbidden_loaded
    from pfharness.window import run

    line = run(cell, args.seed, args.seconds, bool(args.trace), T0)
    # last, after every metric reader has run: no result where JAX or the
    # JAX package was loaded
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

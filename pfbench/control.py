"""The readings a cell's limits are set from: for each seed, one call at the
cell's own size, held against the float64 reference (the lower readings),
and on the control seeds the control too, the reference computed in the
precision next below the configuration's, put in the program's place (the
upper readings). The benchmark's own runs
do not run this.

    python3 pfbench/control.py --workload <name> --seeds 1,2,... --control 1,2,3 \\
        [--out control-<name>.jsonl]

Prints one JSON line a seed and, last, the largest program reading and the
smallest control reading of each number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    p.add_argument("--control", default="", help="the seeds that also read the control")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from pfharness.registry import find_cell
    from pfharness.window import prepare

    cell = find_cell(args.workload)
    import torch

    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    lines, lower, upper = [], {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        ses = prepare(cell, seed)
        res, init = ses.call(0)
        t1 = time.perf_counter()
        line = {"workload": cell.name, "seed": seed, "call_s": t1 - t0,
                "khat": float(res.psis_result.pareto_shape),
                "program": ses.readings(res, init)}
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        if seed in control:
            line["control"] = ses.readings(res, init, control=True)
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        line["check_s"] = time.perf_counter() - t1
        print(json.dumps(line), flush=True)
        lines.append(line)
        del res, ses
    summary = {"workload": cell.name, "seeds": seeds, "control_seeds": sorted(control),
               "lower": lower, "upper": upper}
    print(json.dumps(summary), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

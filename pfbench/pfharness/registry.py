"""Finds everything of a cell by the names in ``BENCHMARK.json``, as files
of their own, so that a cell, a configuration, a traffic mix or a metric is
added by adding files:

- ``configs/<config>.json``: the sizes (the ``file`` that ``BENCHMARK.json``
  names), with ``configs/<config>.py`` beside it: the target in plain torch,
  ``make_data(cfg, generator, device)`` and ``logp(x, data, mm)``;
- ``traffic/<traffic>.json``: the call's arguments and the loop's settings;
- ``metrics/<metric>.py``: ``read(run) -> float or None``, one a metric;
- ``limits/<workload>.json``: under ``numbers`` the limit of each number the
  check compares, with the readings it was set from; under ``readings`` the
  seeds and the numbers left uncompared;
- ``kernels/<function>/<kernel>.json``: a kernel of the port that computes
  ``function`` (``b1``, ``b2``, ``b2_shared``): its launch counter's names and
  its profiler names (regular expressions).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    target: object  # the config's module: make_data, logp
    traffic: dict
    limits: dict  # number -> {"limit": ...}
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    kernels: dict  # function -> {"counters": [...], "kernels": [...]}
    bench_dir: Path  # the benchmark's folder in the checkout

    def metric_reader(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py", f"pfbench_metric_{name}")


def load_kernels(folder: Path) -> dict:
    """``{function: {"counters": [...], "kernels": [...]}}`` over every
    kernel file of each function's folder."""
    out = {}
    for fn_dir in sorted(p for p in folder.iterdir() if p.is_dir()):
        both = out.setdefault(fn_dir.name, {"counters": [], "kernels": []})
        for f in sorted(fn_dir.glob("*.json")):
            entry = load_json(f)
            both["counters"] += entry["counters"]
            both["kernels"] += entry["kernels"]
    return out


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``KeyError`` if it has none."""
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = root / cfg_entry["file"]
    config = load_json(cfg_file)
    target = load_module(cfg_file.with_suffix(".py"), f"pfbench_config_{w['config']}")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        target=target,
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json")["numbers"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        kernels=load_kernels(bench_dir / "kernels"),
        bench_dir=bench_dir,
    )

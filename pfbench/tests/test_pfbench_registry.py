"""Every cell, configuration, traffic mix, limit and metric that
BENCHMARK.json names is found as a file of its own, and a cell added as new
files is picked up with no file edited."""

import json

from conftest import BENCH, ROOT, make_root
from pfharness.registry import find_cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_in_benchmark_json_is_a_file():
    for c in BENCHMARK["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for w in BENCHMARK["workloads"]:
        cell = find_cell(w["name"], ROOT)
        assert cell.chips == w["chips"]
        assert hasattr(cell.target, "make_data") and hasattr(cell.target, "logp")
        assert cell.limits
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.metric_reader(m["name"]), "read")


def test_per_layer_cells_report_the_metric_they_move():
    for m in BENCHMARK["per_layer"]:
        moved = {e["name"]: e for e in BENCHMARK["end_to_end"]}[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w]), (m["name"], w)


def test_a_cell_added_as_new_files_is_picked_up(tmp_path):
    cfg = json.loads((BENCH / "configs" / "hiergauss1000-f64.json").read_text())
    cfg.update(_from="hiergauss1000-f64", name="hg-wide", dim=2000, reduced=["maxiters", "dim"])
    traffic = {"k64": {"why": "x", "nruns": 64, "ndraws": 500, "mesh": None, "trace_seconds": 4,
                       "call": {"importance_denominator": "component", "keep_traces": True}}}
    cell = {"name": "hg2000-k64", "config": "hg-wide", "traffic": "k64", "chips": 1,
            "why": "a cell of new files"}
    limits = {"hg2000-k64": {"numbers": {"x0_gap": {"limit": 0}}, "readings": {}}}
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()}
    root = make_root(tmp_path, ["hg1000-k100-f64", cell], configs={"hg-wide": cfg},
                     traffic=traffic, limits=limits)
    new = find_cell("hg2000-k64", root)
    assert new.config["dim"] == 2000 and new.traffic["nruns"] == 64
    assert new.limits == limits["hg2000-k64"]["numbers"]
    assert find_cell("hg1000-k100-f64", root).traffic["nruns"] == 100
    copied = root / BENCH.name
    for p, data in before.items():
        assert (copied / p.relative_to(BENCH)).read_bytes() == data

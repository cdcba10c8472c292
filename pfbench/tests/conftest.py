"""CPU tests of the benchmark harness: ``python -m pytest pfbench/tests``
from the root of the repository. Tests marked ``cuda`` need the card and
skip inside the test where there is none."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def make_root(tmp: Path, workloads: list, configs: dict = None, traffic: dict = None,
              limits: dict = None) -> Path:
    """A checkout in ``tmp``: a copy of the benchmark's folder and a
    ``BENCHMARK.json`` whose cells are ``workloads`` (entries of the real
    one, or new ones), with extra ``configs``, ``traffic`` and ``limits``
    files ``{name: dict}`` added as new files."""
    shutil.copytree(BENCH, tmp / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in (configs or {}).items():
        base = cfg.pop("_from")
        (tmp / BENCH.name / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        shutil.copy(BENCH / "configs" / f"{base}.py", tmp / BENCH.name / "configs" / f"{name}.py")
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"{BENCH.name}/configs/{name}.json",
                                 "reduced": cfg["reduced"], "why": "a test's configuration"})
    for name, tr in (traffic or {}).items():
        (tmp / BENCH.name / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for name, lim in (limits or {}).items():
        (tmp / BENCH.name / "limits" / f"{name}.json").write_text(json.dumps(lim))
    known = {w["name"]: w for w in bench["workloads"]}
    bench["workloads"] = [known.get(w, w) if isinstance(w, str) else w for w in workloads]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def small_cell(tmp: Path, K: int = 8, d: int = 1000) -> Path:
    """A checkout with one new cell ``small`` on the hierarchical posterior
    in float64: ``K`` paths at ``d``, 200 draws, the limits of
    ``hg1000-k100-f64``."""
    cfg = json.loads((BENCH / "configs" / "hiergauss1000-f64.json").read_text())
    cfg.update(_from="hiergauss1000-f64", dim=d,
               reduced=cfg["reduced"] + (["dim"] if d != cfg["dim"] else []))
    tr = json.loads((BENCH / "traffic" / "k100.json").read_text())
    tr.update(nruns=K, ndraws=200)
    lim = json.loads((BENCH / "limits" / "hg1000-k100-f64.json").read_text())
    cell = {"name": "small", "config": "hgsmall", "traffic": "small", "chips": 1,
            "why": "a test's cell"}
    return make_root(tmp, [cell], configs={"hgsmall": cfg}, traffic={"small": tr},
                     limits={"small": lim})


def describe_cpu(devices, peak, log=print) -> dict:
    """The result's ``device`` of a run that a test drives on the CPU."""
    return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": peak}


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

"""The configuration covtype-synthetic-f64 on the CPU at 2,000 rows: its data's
columns, its log density against an independent NumPy one (the Gamma prior
and the Jacobian of log α included), a whole multipathfinder call on it held
to the reference under the limits of covtype-synth-k100-f64, and the readers
of the program's target counters."""

import dataclasses
import json
import math
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, describe_cpu, make_root
from pfharness import registry

CONFIG, CELL = "covtype-synthetic-f64", "covtype-synth-k100-f64"
ROWS = 2000
READERS = ("target_points.call", "target_splits.call")


def _module():
    return registry.load_module(BENCH / "configs" / f"{CONFIG}.py", "pfbench_test_covtype")


def _data(seed=2**33 + 21):
    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg["rows"] = ROWS
    return cfg, _module().make_data(cfg, torch.Generator().manual_seed(seed), "cpu")


def test_the_data_has_the_sources_columns():
    cfg, data = _data()
    X, y = data["X"], data["y"]
    assert X.shape == (ROWS, cfg["features"] + 1) and X.dtype == torch.float64
    cont, wild, soil, ones = X[:, :10], X[:, 10:14], X[:, 14:54], X[:, 54]
    torch.testing.assert_close(cont.mean(0), torch.zeros(10, dtype=torch.float64), atol=1e-12,
                               rtol=0)
    torch.testing.assert_close(cont.std(0), torch.ones(10, dtype=torch.float64))
    for group in (wild, soil):  # one-hots: a single 1 in each row
        assert set(group.unique().tolist()) == {0.0, 1.0}
        assert torch.equal(group.sum(1), torch.ones(ROWS, dtype=torch.float64))
    assert torch.equal(ones, torch.ones(ROWS, dtype=torch.float64))
    share = soil.mean(0).sort(descending=True).values
    assert share[0] > 0.1 and share[-10:].sum() < 0.02  # skewed, with rare levels
    assert abs(float(y.mean()) - 0.49) < 0.04 and set(y.unique().tolist()) == {0.0, 1.0}


def test_logp_against_numpy():
    """Σ_n [y z − log(1 + e^z)] + (p/2) log α − (α/2)‖w‖² − 0.01 α + log α,
    p = 55, written in NumPy from the model's definition."""
    _, data = _data()
    g = torch.Generator().manual_seed(4)
    x = 0.3 * torch.randn(7, 56, generator=g, dtype=torch.float64)
    x[:, -1] = torch.linspace(-3.0, 3.0, 7, dtype=torch.float64)  # log α over a wide range
    got = _module().logp(x, data).numpy()
    X, y, xs = data["X"].numpy(), data["y"].numpy(), x.numpy()
    w, log_alpha = xs[:, :55], xs[:, 55]
    z = X @ w.T
    loglik = (y[:, None] * z - np.logaddexp(0.0, z)).sum(0)
    alpha = np.exp(log_alpha)
    # Gamma(1, rate 0.01): log b − b α + (a − 1) log α, constants dropped; the
    # prior of w: (p/2) log α − (α/2)‖w‖²; the Jacobian of α = e^{log α}: log α
    want = loglik + 27.5 * log_alpha - 0.5 * alpha * (w * w).sum(1) - 0.01 * alpha + log_alpha
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced window on the CPU of the cell at 2,000 rows and 16 paths,
    its bound on the target forced to 200 points so that it splits:
    ``(cell, run, line)``."""
    from pfharness import window

    cfg = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    cfg.update(_from=CONFIG, rows=ROWS, reduced=cfg["reduced"] + ["rows"])
    tr = json.loads((BENCH / "traffic" / "k100.json").read_text())
    tr.update(nruns=16, ndraws=200)
    tr["call"] = dict(tr["call"], target_points=200)
    lim = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    cell = {"name": "covsmall", "config": "covsmall", "traffic": "covsmall", "chips": 1,
            "why": "a test's cell"}
    root = make_root(tmp_path_factory.mktemp("covtype") / "checkout", [cell],
                     configs={"covsmall": cfg}, traffic={"covsmall": tr},
                     limits={"covsmall": lim})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("covsmall")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.find_cell("covsmall", root)
    kept = {}
    with pytest.MonkeyPatch.context() as mp:
        real = window._log_calls
        mp.setattr(window, "_log_calls", lambda run_, log: (kept.setdefault("run", run_),
                                                            real(run_, log)))
        line = window.run(cell, 2**33 + 23, 0.001, True, time.perf_counter(), device="cpu",
                          log=lambda *a: None, describe=describe_cpu)
    return cell, kept["run"], line


def test_a_small_call_meets_the_cells_limits(traced):
    _, run, line = traced
    assert run.completed == 1
    assert line["correct"] is True, line["check"]
    assert set(line["check"]) == set(json.loads(
        (BENCH / "limits" / f"{CELL}.json").read_text())["numbers"])


def test_the_readers_read_the_counters(traced):
    from pathfinder_tpu_torch.utils import tracing

    _, run, line = traced
    (call,) = [s.id for s in tracing.spans() if s.name == "call" and s.parent is None]
    by_key = tracing.counts_by_key(tracing.TARGET)
    points = line["metrics"]["target_points.call"]["value"]
    splits = line["metrics"]["target_splits.call"]["value"]
    assert points == by_key[tracing.TARGET_POINTS][call]
    assert splits == by_key[tracing.TARGET_SPLITS][call] > 0
    # 16 points a trajectory evaluation, 16·16·5 an ELBO chunk: more than 200
    assert points > 16 * run.calls[0]["target_calls"] and math.isfinite(splits)


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_profile_or_a_call(traced, name):
    from pathfinder_tpu_torch.utils import tracing

    cell, run, _ = traced
    reader = cell.metric_reader(name)
    assert reader.read(dataclasses.replace(run, profile=None)) is None
    tracing.reset()
    assert reader.read(run) is None


def test_the_benchmark_lists_the_cell():
    cell = registry.find_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.config["rows"] == 464809 and cell.config["dim"] == 56
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    hg = {m["name"] for m in registry.find_cell("hg1000-k100-f64", ROOT).per_layer}
    assert names == hg

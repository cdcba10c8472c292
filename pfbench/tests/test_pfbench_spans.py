"""The readers of the program's spans (metrics/_spans.py and the seven
metrics that read it) over one traced window on the CPU: each reads a finite
number, the six seconds sum to the traced calls' mean duration, the target
spans are the benchmark's count of target calls, and each reads None where
no ``call`` span was recorded."""

import dataclasses
import json
import math
import time

import pytest

from conftest import describe_cpu, small_cell

SECONDS = ("entry_self_s.call", "loop_self_s.call", "target_s.call", "sync_wait_s.call",
           "fits_elbo_s.call", "psis_resample_s.call")
READERS = SECONDS + ("syncs.call",)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced window of one call in a small cell whose per-layer
    metrics include the seven: ``(cell, run, line, spans)``."""
    from pathfinder_tpu_torch.utils import tracing
    from pfharness import registry, window

    root = small_cell(tmp_path_factory.mktemp("spans") / "checkout", K=4, d=16)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("small")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.find_cell("small", root)
    kept = {}
    with pytest.MonkeyPatch.context() as mp:
        real = window._log_calls
        mp.setattr(window, "_log_calls", lambda run_, log: (kept.setdefault("run", run_),
                                                            real(run_, log)))
        line = window.run(cell, 2**33 + 11, 0.001, True, time.perf_counter(), device="cpu",
                          log=lambda *a: None, describe=describe_cpu)
    return cell, kept["run"], line, tracing.spans()


def test_each_reader_reads_a_finite_number(traced):
    _, run, line, spans = traced
    assert run.completed == 1
    values = {name: line["metrics"][name]["value"] for name in READERS}
    assert all(math.isfinite(v) and v >= 0 for v in values.values()), values
    syncs = values["syncs.call"]
    assert syncs == int(syncs) > 0


def test_the_six_seconds_sum_to_the_calls(traced):
    _, run, line, spans = traced
    calls = [s for s in spans if s.name == "call" and s.parent is None]
    mean = sum(s.end_ns - s.start_ns for s in calls) * 1e-9 / len(calls)
    total = sum(line["metrics"][name]["value"] for name in SECONDS)
    assert total == pytest.approx(mean, rel=1e-6)
    (call,) = calls
    assert sum(s.name == "target" for s in spans if s.call == call.id) == \
        run.calls[0]["target_calls"]


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_call_span(traced, name):
    from pathfinder_tpu_torch.utils import tracing

    cell, run, _, _ = traced
    reader = cell.metric_reader(name)
    assert reader.read(dataclasses.replace(run, profile=None)) is None
    tracing.reset()
    assert reader.read(run) is None

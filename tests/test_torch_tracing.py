"""The port's spans and counters (``pathfinder_tpu_torch/utils/tracing.py``)
on the CPU, at d=8, K=4 (8 on a paths mesh of 2), maxiters=12, float64.

* With no profiler a call records no span and no count outside the kernels'
  launch family; under ``torch.profiler`` it runs the same tensor ops and
  device→host reads in the same order and gives the same bits.
* Every span's parents lead to its ``call`` span, one call id a call, also
  from a mesh's block threads and through retries; the self times of the six
  parts the benchmark reads sum to the ``call`` span.
* The outermost ``target`` spans are the user's calls; the trajectory's
  ``sync`` count is its iterations plus its last check.
* Each ``pf::`` range is in the profiler's own events, around aten ops.
* One profiler session's records replace the last; the table under threads.
"""

import collections
import sys
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pathfinder_tpu_torch import multipathfinder, paths_mesh
from pathfinder_tpu_torch.ops import trajectory
from pathfinder_tpu_torch.utils import tracing

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

pytestmark = [pytest.mark.filterwarnings("ignore:Pareto k-hat"),
              pytest.mark.filterwarnings("ignore:.* Pathfinder runs failed")]

D, K, MAXITERS = 8, 4, 12
NAMES = {"call", "trajectory", "target", "sync", "fits", "elbo", "winner_draws", "psis",
         "resample"}
# the benchmark's six parts of a call (pfbench/metrics/*_s.call.py)
PARTS = (("call",), ("trajectory",), ("target",), ("sync",), ("fits", "elbo", "winner_draws"),
         ("psis", "resample"))


class Counting:
    """A batched standard normal in ``D`` dimensions, scaled per axis, that
    counts its calls; ``flaky`` makes its density NaN outside a cube of
    half-width 1.5, so that starts from U[−2, 2] fail and retries run."""

    def __init__(self, flaky=False):
        self.flaky, self.calls = flaky, 0
        self._lock = threading.Lock()

    def __call__(self, x):
        with self._lock:
            self.calls += 1
        scale = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype, device=x.device)
        lp = -0.5 * (x * x / scale).sum(-1)
        if not self.flaky:
            return lp
        return torch.where(x.abs().amax(-1) > 1.5, torch.full_like(lp, torch.nan), lp)


CASES = {
    "one device": (dict(nruns=K), False),
    "retries": (dict(nruns=K, ntries=3), True),
    "paths mesh": (dict(nruns=2 * K, mesh=paths_mesh(["cpu", "cpu"])), False),
}


def _call(target, **kw):
    return multipathfinder(target, 100, seed=3, dim=D, maxiters=MAXITERS, device="cpu",
                           dtype=torch.float64, **kw)


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU): its result and the profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _self_ns(spans):
    """``{span id: duration less the spans directly under it}``."""
    under = collections.Counter()
    for s in spans:
        if s.parent is not None:
            under[s.parent] += s.end_ns - s.start_ns
    return {s.id: s.end_ns - s.start_ns - under[s.id] for s in spans}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_untraced_records_nothing_and_traced_runs_the_same_ops():
    """Off, nothing but the always-on families (launches, the target's
    points) is recorded; on, the same ops (reads included) run and the
    outputs are bitwise equal."""
    tracing.reset()
    tracing.count(tracing.LAUNCH + "sample_and_logq", key=(1, 2, 3, False))
    with _Ops() as off_ops:
        off = _call(Counting(), nruns=K)
    assert tracing.spans() == []
    points = tracing.counts_by_key(tracing.TARGET).pop(tracing.TARGET_POINTS)
    assert set(points) == {None} and points[None] > 0  # counted, keyed by no call
    assert {n: c for n, c in tracing.counts().items() if not n.startswith(tracing.TARGET)} == {
        tracing.LAUNCH + "sample_and_logq": 1}
    tracing.count("sync.elsewhere")
    assert tracing.counts("sync.") == {}

    with _Ops() as on_ops:
        on, _ = _profiled(lambda: _call(Counting(), nruns=K))
    assert {s.name for s in tracing.spans()} == NAMES
    assert on_ops.names == off_ops.names
    assert "aten._local_scalar_dense.default" in off_ops.names
    for a, b in ((off.draws, on.draws), (off.psis_result.log_weights, on.psis_result.log_weights),
                 (off.states.num_fn_evals, on.states.num_fn_evals)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert tracing.counts(tracing.LAUNCH) == {tracing.LAUNCH + "sample_and_logq": 1}
    tracing.reset()


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_of_a_call(case, monkeypatch):
    """Two calls in one session: each span's parents lead to its call, the
    parts sum to the call, the target spans are the user's calls and the
    trajectory's reads are its iterations plus its last check."""
    kw, flaky = CASES[case]
    searches = []
    real = trajectory.resolve_line_search

    def counted(name):
        ls = real(name)

        def run(*a, **k):
            searches.append(1)
            return ls(*a, **k)

        return run

    monkeypatch.setattr(trajectory, "resolve_line_search", counted)
    targets = [Counting(flaky), Counting(flaky)]
    _call(Counting(), nruns=K)  # untraced: the session below is a new one
    searches.clear()
    results, _ = _profiled(lambda: [_call(t, **kw) for t in targets])
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    calls = [s for s in spans if s.name == "call"]
    assert len(calls) == 2 and all(c.parent is None and c.call == c.id for c in calls)
    assert {s.name for s in spans} == NAMES
    if flaky:
        assert any(int(r.num_tries.max()) > 1 for r in results)
    for s in spans:
        top = s
        while top.parent is not None:
            top = by_id[top.parent]
        assert top.name == "call" and top.id == s.call

    own = _self_ns(spans)
    for c, target in zip(sorted(calls, key=lambda c: c.start_ns), targets):
        mine = [s for s in spans if s.call == c.id]
        assert sum(s.name == "target" for s in mine) == target.calls
        if "mesh" in kw:
            continue  # the blocks' threads overlap in time: the parts partition each thread
        assert all(by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
                   for s in mine if s.parent is not None)
        parts = [sum(own[s.id] for s in mine if s.name in names) for names in PARTS]
        assert all(p >= 0 for p in parts)
        assert sum(parts) == pytest.approx(c.end_ns - c.start_ns, rel=0.01)
    n_traj = sum(s.name == "trajectory" for s in spans)
    assert tracing.counts()["sync.ops/trajectory.py"] == len(searches) + n_traj
    assert sum(tracing.counts("sync.").values()) == sum(s.name == "sync" for s in spans)
    tracing.reset()


def test_ranges_in_the_profilers_events():
    """Each span is a ``pf::`` range of the profiler's own events with an
    aten op inside it."""
    _, prof = _profiled(lambda: _call(Counting(), nruns=K))
    around = collections.defaultdict(bool)
    for e in prof.events():
        if e.name.startswith("pf::"):
            around[e.name[4:]] |= any(c.name.startswith("aten::") for c in e.cpu_children)
    assert set(around) == NAMES and all(around.values()), dict(around)
    tracing.reset()


@pytest.mark.parametrize("value, expected", [(torch.tensor(True), True), (torch.tensor(7), 7),
                                             (torch.tensor(0.25, dtype=torch.float64), 0.25)])
def test_read_returns_the_value_in_one_counted_sync_span(value, expected):
    """``read`` gives ``value.item()``; while a profiler records, it counts
    ``sync.<site>`` once and records one ``sync`` span, and otherwise
    nothing."""
    tracing.reset()
    got = tracing.read(value, "here.py")
    assert got == expected and type(got) is type(expected)
    assert tracing.counts("sync.") == {} and tracing.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = tracing.read(value, "here.py")
    assert got == expected and type(got) is type(expected)
    assert tracing.counts("sync.") == {"sync.here.py": 1}
    assert [s.name for s in tracing.spans()] == ["sync"]
    tracing.reset()


def test_sessions_and_threads():
    """A new profiler session replaces the last one's records (the launch
    family stays); spans and counts from more threads than cores, under a
    parent handed to each, are all kept."""
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("call"):
            tracing.count("sync.a")
    assert [s.name for s in tracing.spans()] == ["call"]
    tracing.count(tracing.LAUNCH + "whiten_sumsq", key=(1, 2, 3, False))
    assert not tracing.on()  # the profiler is off: the next record starts a session

    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("call"):
                parent = tracing.current()
                together = threading.Barrier(n_threads, timeout=60)

                def work():
                    together.wait()  # all alive at once: each its own thread id
                    with tracing.adopt(parent):
                        for _ in range(n_spans):
                            with tracing.span("target"):
                                tracing.count("sync.t")

                threads = [threading.Thread(target=work) for _ in range(n_threads)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tracing.spans()
    (call,) = [s for s in spans if s.name == "call"]
    targets = [s for s in spans if s.name == "target"]
    assert len(targets) == n_threads * n_spans
    assert all(s.parent == call.id and s.call == call.id for s in targets)
    assert len({s.thread for s in targets}) == n_threads
    assert tracing.counts() == {"sync.t": n_threads * n_spans, tracing.LAUNCH + "whiten_sumsq": 1}
    tracing.reset()

"""One run of one cell: set-up, the measured window, the metrics, the check.

The window is a closed loop with one caller: back-to-back
``pathfinder_tpu_torch.multipathfinder`` calls, each ending in a
synchronize of every card it used, started while the window's time is under
its length. Call ``i`` draws its initial points from the run's seed and
``i`` and takes its own call seed, so every call starts from new points.
The last call's result is kept and held against the plain reference once
the window has closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import subprocess
import sys
import threading
import time
import traceback
from typing import Optional

import torch

from pfharness import devtrace, roofline
from pfharness.judge import judge
from pfharness.registry import Cell

WARMUP_CALL = (1 << 20) - 1


def derived_seed(seed: int, i: int) -> int:
    """The seed of stream ``i`` of a run (0: the data; ``i + 1``: call ``i``)."""
    return ((int(seed) % (1 << 42)) << 20) | (int(i) % (1 << 20))


class CountingTarget:
    """The user's target as the program gets it, a batched ``logp(x (K,
    d))`` that computes where ``x`` lies (its data has a copy on each card of
    the mesh), counting its calls (each is one batched host round trip; a
    mesh's blocks call it from threads of their own)."""

    def __init__(self, density, data_by_device: dict):
        # no attribute named logp: the program would take this for a target object
        self.density, self.data_by_device, self.calls = density, data_by_device, 0
        self._lock = threading.Lock()

    def __call__(self, x):
        with self._lock:
            self.calls += 1
        return self.density(x, self.data_by_device[x.device])


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    d: int
    itemsize: int
    setup_s: float
    window_s: float
    calls: list  # per completed call: seconds, paths, evals_per_path, target_calls
    attempted: int
    failed: int
    peak_bytes: int
    launches: dict  # the kernels' launch counter over the window
    profile: Optional[devtrace.DeviceProfile]
    cards: list  # indices of the cards used

    @property
    def completed(self) -> int:
        return len(self.calls)

    @property
    def paths(self) -> int:
        return sum(c["paths"] for c in self.calls)


def _sync(devices):
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def extract(res, device) -> dict:
    """The program's outputs that the reference judges, on ``device``."""
    st = res.states
    tr, F = st.trace, st.fit_distribution.cov.factor
    kept = tr.xs.shape[1] > 0

    def on(t):
        return None if t is None else t.to(device)

    return dict(
        path_id=on(st.path_id), num_tries=on(res.num_tries), success=on(st.success),
        xs=on(tr.xs) if kept else None, lps=on(tr.log_densities) if kept else None,
        gs=on(tr.gradients) if kept else None, nvalid=on(tr.num_valid),
        fit_iteration=on(st.fit_iteration), elbo_values=on(st.elbo_values),
        mean=on(st.fit_distribution.mean), a_half=on(F.a_half), logdet=on(F.log_det),
        X=on(F.X), C=on(F.C), pool=on(res.draws_per_component),
        log_weights=on(res.psis_result.log_weights),
        khat=float(res.psis_result.pareto_shape), draws=on(res.draws),
        ids=on(res.draw_component_ids), seed=res.seed, denominator=res.importance_denominator,
        optimizer=res.config.optimizer,
    )


def describe_cards(devices: list, peak: int, log=print) -> dict:
    """The result's ``device``: the cards' name and number, and the peak
    of the fullest; the cards' power limit goes on an earlier line."""
    log(f"card: {power_limit()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(devices[0]),
            "count": len(devices), "memory_peak_bytes": int(peak)}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclasses.dataclass
class Session:
    """A cell's inputs on its cards, made from one seed, and its call."""

    cell: Cell
    seed: int
    devices: list
    data: dict
    target: CountingTarget
    mesh: object

    @property
    def settings(self) -> dict:
        cfg = self.cell.config
        return dict(history_length=int(cfg["history_length"]),
                    ndraws_elbo=int(cfg["ndraws_elbo"]), epsilon_curvature=1e-12)

    def sync(self):
        _sync(self.devices)

    def call(self, i: int):
        """Call ``i``: ``(result, init)``, ended in a synchronize."""
        import pathfinder_tpu_torch as pft

        cfg, tr = self.cell.config, self.cell.traffic
        dev0, dtype = self.devices[0], getattr(torch, cfg["dtype"])
        K, d = int(tr["nruns"]), int(cfg["dim"])
        g = torch.Generator(device=dev0)
        g.manual_seed(derived_seed(self.seed, i + 1))
        scale = float(cfg["init_scale"])
        init = (torch.rand(K, d, generator=g, device=dev0, dtype=dtype) * 2 - 1) * scale
        res = pft.multipathfinder(
            self.target, int(tr["ndraws"]), seed=derived_seed(self.seed, i + 1), nruns=K,
            init=init, maxiters=int(cfg["maxiters"]),
            history_length=int(cfg["history_length"]), ndraws_elbo=int(cfg["ndraws_elbo"]),
            elbo_chunk=int(cfg["elbo_chunk"]), mesh=self.mesh, device=dev0, dtype=dtype,
            **tr.get("call", {}),
        )
        self.sync()
        return res, init

    def readings(self, res, init, control: bool = False) -> dict:
        """The check's numbers for a call's result: the program's against the
        float64 reference, or (``control``) those of the reference in the
        precision below the configuration's, put in its place, against the
        same float64 reference."""
        from reference.check import control_outputs, derive, readings
        from reference.precision import Prec

        outputs = extract(res, self.devices[0])
        inputs = dict(init=init, logp=self.cell.target.logp, data=self.data)
        ref = derive(outputs, inputs, self.settings, Prec("f64"))
        if control:
            below = Prec(Prec.BELOW[self.cell.config["dtype"]])
            outputs = control_outputs(outputs, inputs, self.settings, below)
        return readings(outputs, inputs, self.settings, ref)


def prepare(cell: Cell, seed: int, device: str = "cuda") -> Session:
    """Load the program and its kernels, and make the cell's data from the
    seed on its first card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import pathfinder_tpu_torch as pft
    from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk

    names = ([f"cuda:{i}" for i in range(cell.chips)] if device == "cuda"
             else [device] * cell.chips)
    devices = [torch.device(n) for n in names]
    if devices[0].type == "cuda":
        wk.load_library()  # the three kernel libraries: built on a checkout's first run
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(derived_seed(seed, 0))
    data = cell.target.make_data(cell.config, gen, devices[0])
    copies = {dev: {k: v.to(dev) if torch.is_tensor(v) else v for k, v in data.items()}
              for dev in devices}
    mesh = pft.paths_mesh(names) if cell.traffic["mesh"] == "paths" else None
    return Session(cell, seed, devices, data, CountingTarget(cell.target.logp, copies), mesh)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        log=print, describe=describe_cards) -> dict:
    """Run the cell once and return the result's line. ``device`` and
    ``describe`` (the line's ``device`` from the cards used and the peak)
    let a test drive a run on the CPU."""
    from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk

    cfg, tr = cell.config, cell.traffic
    ses = prepare(cell, seed, device)
    devices, dev0, target, call = ses.devices, ses.devices[0], ses.target, ses.call
    dtype = getattr(torch, cfg["dtype"])
    K, d = int(tr["nruns"]), int(cfg["dim"])

    call(WARMUP_CALL)  # one call at the cell's own shapes
    _sync(devices)
    wk.reset_launch_counts()
    target.calls = 0
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    length = min(float(seconds), float(tr["trace_seconds"])) if trace else float(seconds)
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA])
            if trace else contextlib.nullcontext())
    records, kept = [], None
    attempted = raised = 0
    with prof:
        # the window opens once the profiler runs (starting it takes seconds)
        w0 = w_end = time.perf_counter()
        setup_s = w0 - t0
        while time.perf_counter() - w0 < length:
            i = attempted
            attempted += 1
            c0, n0 = time.perf_counter(), target.calls
            try:
                res, init = call(i)
            except Exception:  # a failed call is counted, and the loop goes on
                raised += 1
                w_end = time.perf_counter()
                traceback.print_exc(file=sys.stderr)
                continue
            w_end = time.perf_counter()
            records.append(dict(
                seconds=w_end - c0, paths=K, target_calls=target.calls - n0,
                evals=res.states.num_fn_evals, success=res.states.success,
                khat=res.psis_result.pareto_shape, finite=torch.isfinite(res.draws).all(),
                cap=res.max_paths_per_launch, states_on=str(res.states.draws.device),
            ))
            if w_end - w0 >= length:
                kept = (res, init, i)
            del res
    window_s = w_end - w0
    peak = max((torch.cuda.max_memory_allocated(dev) for dev in devices if dev.type == "cuda"),
               default=0)
    launches = wk.launch_counts_by_shape()
    profile = devtrace.read(prof) if trace else None

    calls, failed = [], raised
    for r in records:
        khat = float(r["khat"])
        if not (bool(r["finite"]) and math.isfinite(khat)):
            failed += 1
        calls.append(dict(seconds=r["seconds"], paths=r["paths"], target_calls=r["target_calls"],
                          evals_per_path=float(r["evals"].double().mean()),
                          ok_paths=int(r["success"].sum()), khat=khat,
                          cap=r["cap"], states_on=r["states_on"]))
    cards = sorted({dev.index or 0 for dev in devices})
    run_ = Run(cell, d, torch.finfo(dtype).bits // 8, setup_s, window_s, calls, attempted,
               failed, peak, launches, profile, cards)
    _log_calls(run_, log)

    # the reference, once the window has closed and the peak is read
    rows, correct = {}, False
    if kept is not None:
        res, init, i = kept
        c0 = time.perf_counter()
        if dev0.type == "cuda":
            torch.cuda.empty_cache()
        numbers = ses.readings(res, init)
        del res
        correct, rows = judge(numbers, cell.limits)
        for name in sorted(set(numbers) - set(rows)):
            log(f"not compared {name}: {numbers[name]!r}")
        log(f"check: call {i} of the window against the plain reference in "
            f"{time.perf_counter() - c0:.3f} s")
    else:
        log("check: no call of the window completed")

    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = cell.metric_reader(entry["name"]).read(run_)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev_info = describe(devices, peak, log)
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info}
    if trace and profile is not None:
        dev_info["busy_s"] = profile.busy_mean_s(cards)
        dev_info["window_s"] = window_s
        line["breakdown"] = {"device_ops": profile.top_ops(), "idle_gaps": profile.top_gaps()}
    for name, (value, limit) in rows.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    line["check"] = {name: {"value": v, "limit": lim} for name, (v, lim) in rows.items()}
    return line


def _log_calls(run_: Run, log) -> None:
    """The earlier lines: each call's time and paths, k̂, the memory rule's
    cap, and the launches by kernel and shape with the bound that applies
    (the card's power limit follows on the line ``card:``)."""
    secs = sorted(c["seconds"] for c in run_.calls)
    if secs:
        p50 = secs[len(secs) // 2]
        p90 = secs[min(len(secs) - 1, math.ceil(0.9 * len(secs)) - 1)]
        log(f"window: {run_.completed} calls completed of {run_.attempted} in "
            f"{run_.window_s:.4f} s; call p50 {p50:.4f} s, p90 {p90:.4f} s; setup "
            f"{run_.setup_s:.4f} s")
    for n, c in enumerate(run_.calls):
        log(f"call {n}: {c['seconds']:.4f} s, {c['ok_paths']}/{c['paths']} paths, k-hat "
            f"{c['khat']:.4f}, evals/path {c['evals_per_path']:.3f}, target calls "
            f"{c['target_calls']}, launch cap {c['cap']}, states on {c['states_on']}")
    function = {c: fn for fn, k in run_.cell.kernels.items() for c in k["counters"]}
    for name, shapes in run_.launches.items():
        for (B, m, N, shared), n in shapes.items():
            bound = ""
            if name in function:
                t, kind = roofline.least_seconds(function[name], B, run_.d, m, N, shared,
                                                 run_.itemsize)
                bound = f", least {1e6 * t:.3f} us a launch, bound by {kind}"
            log(f"launches {name} (B, m, N, shared)={(B, m, N, shared)}: {n}{bound}")

"""Path parallelism: the device mesh's ``paths`` and ``dim`` axes and
serving-scale launches (counterpart of ``pathfinder_tpu/parallel/sharding.py``).

Across devices, a :class:`Mesh` with a ``paths`` axis splits each launch's
lanes into one contiguous block per mesh entry, the counterpart of the JAX
package's ``shard_map`` over ``P("paths")``: :func:`make_path_executor` runs
each block on its device from a host thread of its own (so that one device's
syncs overlap another's host work) and gathers the blocks, in block order,
onto the mesh's first device. Paths never communicate, so a block is the
unsharded run of its lanes: at a fixed per-device launch width every bit is
that of the run without a mesh. A mesh may name one device several times;
its blocks then share that device, as the JAX tests' virtual CPU devices
share the host.

A mesh with a ``dim`` axis (:func:`paths_dim_mesh`) also splits each
block's parameter rows over that axis, the counterpart of the JAX
package's GSPMD run of the whole core on ``P("paths", "dim")``-sharded
inputs: each block's lanes run as a row group (``utils/rows.py``), one host
thread a ``dim`` entry, each running ``pathfinder_core`` on its contiguous
rows of ``d`` and summing every reduction over ``d`` with its peers in rank
order. The target is evaluated whole, on the group's first device, where
GSPMD would partition it too: the results are the same, only the target's
memory is not split. Every optimizer runs there, with every line search:
L-BFGS and CG on their rows, BFGS with its inverse Hessian split by rows,
Newton with its Hessian, ``eigh`` and direction whole on the group's first
device, and a user's callable whole there too (``ops/optimizers.py``). The
row blocks of a block are joined along ``d`` and the blocks gathered as on
the ``paths`` axis, so everything after the core runs on the full states. A ``dim`` width of 1 is the run without it.

Tens of thousands of paths do not fit one batch: one lane's trace, history
and ELBO chunk are megabytes at d=1000. :func:`chunk_launches` runs a batch
of paths as launches of one fixed lane count, and can stream each launch's
output into host memory as it completes, so that the card holds one or two
launches and never the whole pool. Every random number of a path comes from
its ``(seed, path id, round)`` streams, so the cap, the mesh and the offload
change no random number. Offload changes no bit. The per-device launch width
can change the last bits (on a CUDA device a kernel's launch plan and a
library's algorithm follow the batch), and through them, rarely, a decision
that sits on a tie, such as the step at which a path's ``ftol`` test stops
it.

The defaults come from the card's memory: :func:`plan_launches` takes the
card's total memory, a per-lane estimate of one launch's peak
(:func:`lane_bytes`) and of the state a lane keeps (:func:`state_bytes`),
all three fixed for a card and a configuration. The plan is taken from the
total, not the free memory, because the cap can change a result's last bits,
so the same card and the same options always choose the same cap. Memory
that other work holds on the card is the caller's to leave room for, by
passing ``max_paths_per_launch``. The estimates know the optimizer (BFGS
and Newton hold ``(d, d)`` matrices a lane) and the mixture denominator
(whose pooled-draw blocks are sized by the same cap); ``laplace_resample``
sizes its blocks by its own estimate, :func:`laplace_lane_bytes`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from pathfinder_tpu_torch.ops.kernels import linesearch_kernels
from pathfinder_tpu_torch.ops.kernels.woodbury_kernels import load_library
from pathfinder_tpu_torch.singlepath import SinglePathState, pathfinder_core
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.misc import indexed_device, resolve_device, tree_map
from pathfinder_tpu_torch.utils.rows import RowGroup, row_target

__all__ = [
    "Mesh",
    "paths_mesh",
    "paths_dim_mesh",
    "make_path_executor",
    "paths_devices",
    "paths_width",
    "dim_width",
    "run_on_devices",
    "run_row_groups",
    "check_mesh",
    "mesh_device_bytes",
    "pad_paths",
    "chunk_launches",
    "lane_bytes",
    "state_bytes",
    "plan_launches",
    "laplace_lane_bytes",
    "laplace_block",
    "device_memory_bytes",
    "LAUNCH_SHARE",
    "OFFLOAD_SHARE",
    "PATHS_AXIS",
    "DIM_AXIS",
]

# Of the card's memory: what one launch's estimated peak may take (the rest
# is for the caching allocator's fragmentation, the accumulated states and
# the PSIS tail), and what the accumulated states of all launches may take
# before they are streamed to the host instead.
LAUNCH_SHARE = 0.5
OFFLOAD_SHARE = 0.25


PATHS_AXIS = "paths"
DIM_AXIS = "dim"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices in an array with named axes, the counterpart of
    ``jax.sharding.Mesh``: ``devices`` is a numpy array of
    ``torch.device``s with one dimension per name in ``axis_names``. Every
    CUDA device carries its index, and every entry is of one device type.
    An entry may repeat."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        devices = np.asarray(self.devices, dtype=object)
        flat = [indexed_device(resolve_device(d)) for d in devices.flat]
        if not flat:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh's devices are of one type; got {flat}")
        arr = np.empty(devices.shape, dtype=object)
        arr.flat[:] = flat
        names = tuple(self.axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"{arr.ndim}-dimensional devices for the axes {names}")
        object.__setattr__(self, "devices", arr)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        """``{axis name: width}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def device_list(devices, name: str) -> np.ndarray:
    """``devices`` as a 1-D object array, by default every CUDA device,
    ``cuda:0`` to ``cuda:n−1``; without CUDA the default raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}() names every CUDA device, but CUDA is not available")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr


def paths_mesh(devices=None) -> Mesh:
    """A 1-D mesh with a ``paths`` axis over ``devices`` (torch devices or
    their names), by default every CUDA device, ``cuda:0`` to ``cuda:n−1``.
    Without CUDA the default raises: nothing falls back to the CPU. A device
    named several times gives a mesh of several blocks on it (``["cpu"] *
    4``, or ``["cuda:0"] * 2`` on one card)."""
    return Mesh(device_list(devices, "paths_mesh"), (PATHS_AXIS,))


def paths_dim_mesh(n_paths_axis: int, devices=None) -> Mesh:
    """A 2-D ``('paths', 'dim')`` mesh of ``n_paths_axis`` rows over
    ``devices`` (default: every CUDA device), in order: the paths split over
    the first axis and, within each block, the parameter dimension over the
    second. Raises ``ValueError`` where the devices do not factor."""
    arr = device_list(devices, "paths_dim_mesh")
    if arr.size % n_paths_axis != 0:
        raise ValueError(
            f"{arr.size} devices do not factor into a ({n_paths_axis}, ·) paths×dim mesh"
        )
    return Mesh(arr.reshape(n_paths_axis, -1), (PATHS_AXIS, DIM_AXIS))


def check_mesh(mesh: Optional[Mesh]) -> None:
    """Raise for a mesh whose axes are not ``paths`` and ``dim``, each named
    at most once. Both axes are ported; on the ``dim`` axis the executor
    runs the core with its rows split (:func:`make_path_executor`)."""
    if mesh is None:
        return
    names = mesh.axis_names
    if len(set(names)) != len(names) or not set(names) <= {PATHS_AXIS, DIM_AXIS}:
        raise ValueError(f"a mesh's axes are '{PATHS_AXIS}' and '{DIM_AXIS}'; got {names}")


def dim_width(mesh: Optional[Mesh]) -> int:
    """Row blocks a path's ``d`` splits into: the ``dim`` axis's width (1
    without one)."""
    return 1 if mesh is None else mesh.shape.get(DIM_AXIS, 1)


def paths_width(mesh: Optional[Mesh]) -> int:
    """Blocks a launch splits into: the ``paths`` axis's width (1 without a
    mesh or without the axis)."""
    return 1 if mesh is None else mesh.shape.get(PATHS_AXIS, 1)


def _block_grid(mesh: Mesh) -> np.ndarray:
    """The devices as a ``(paths, dim)`` grid: row ``i`` is block ``i``'s
    row group."""
    names, grid = mesh.axis_names, mesh.devices
    if PATHS_AXIS not in names:
        grid, names = grid[None], (PATHS_AXIS,) + names
    if DIM_AXIS not in names:
        grid, names = grid[..., None], names + (DIM_AXIS,)
    return np.transpose(grid, (names.index(PATHS_AXIS), names.index(DIM_AXIS)))


def paths_devices(mesh: Mesh) -> list:
    """The device of each block: along the ``paths`` axis, the first entry
    of the ``dim`` axis (where the block's states are joined)."""
    return list(_block_grid(mesh)[:, 0])


def pad_paths(n: int, mesh: Optional[Mesh] = None, cap: Optional[int] = None) -> int:
    """Lanes that ``n`` paths occupy: ``n`` rounded up to a multiple of the
    mesh's ``paths`` width, then, with a ``cap`` below that, to whole
    launches of ``cap`` lanes. The padding lanes repeat the leading paths
    and their results are dropped."""
    size = paths_width(mesh)
    K = -(-n // size) * size
    if cap is None or cap >= K:
        return K
    return -(-K // cap) * cap


def chunk_launches(executor: Callable, cap: Optional[int], mesh: Optional[Mesh] = None,
                   offload: bool = False) -> Callable:
    """Wrap ``executor(path_ids (B,), x0s (B, d)) -> state`` (batched over
    ``B``) so that a batch of more than ``cap`` paths runs as launches of
    ``cap`` lanes each, the last padded by repeating the leading lanes.
    ``cap`` counts lanes over the whole mesh: it is rounded down to a
    multiple of the mesh's ``paths`` width, never below one lane a block,
    so that every launch uses the whole mesh.

    The chunks' outputs are written into buffers of the batch's own row
    count, one per leaf: on the device, or with ``offload`` in host memory
    (pinned where the executor runs on a CUDA device). An offloaded chunk is
    copied on a side stream while the next chunk runs: the wrapper launches
    chunk c+1 before it waits on chunk c's copy, so at most two chunk
    outputs live on the card. The copies move bits, so the values are those
    of the un-offloaded run. ``offload`` also moves a batch that runs as one
    launch.
    """
    if cap is not None and cap <= 0:
        raise ValueError(f"max_paths_per_launch must be positive; got {cap}")
    if cap is not None:
        size = paths_width(mesh)
        cap = max((cap // size) * size, size)

    def run(path_ids: torch.Tensor, x0s: torch.Tensor):
        K = path_ids.shape[0]
        c = K if cap is None else min(cap, K)
        n_chunks = -(-K // c)
        if n_chunks == 1 and not offload:
            return executor(path_ids, x0s)
        pad = n_chunks * c - K
        if pad:
            path_ids = torch.cat([path_ids, path_ids[:pad]])
            x0s = torch.cat([x0s, x0s[:pad]])
        dev = x0s.device
        pin = offload and dev.type == "cuda"
        side = torch.cuda.Stream(dev) if pin else None
        bufs = None
        pending = None  # (a chunk's output, the event its copy records)
        for i in range(n_chunks):
            out = executor(path_ids[i * c:(i + 1) * c], x0s[i * c:(i + 1) * c])
            if bufs is None:
                bufs = tree_map(
                    lambda t: torch.empty(
                        (K,) + t.shape[1:], dtype=t.dtype,
                        device="cpu" if offload else dev, pin_memory=pin,
                    ),
                    out,
                )
            lo, rows = i * c, min(c, K - i * c)

            def put(buf, t):
                return buf[lo:lo + rows].copy_(t[:rows], non_blocking=pin)

            if side is None:
                tree_map(put, bufs, out)
                continue
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                side.wait_event(ready)
                tree_map(put, bufs, out)
                done = torch.cuda.Event()
                done.record(side)
            if pending is not None:
                pending[1].synchronize()  # chunk i-1's copy; chunk i has run
            # the output stays referenced until its copy is done, so the
            # caching allocator cannot hand its memory to the next chunk early
            pending = (out, done)
        if pending is not None:
            pending[1].synchronize()
        return bufs

    return run


def make_path_executor(mesh: Optional[Mesh] = None, finish: Optional[Callable] = None):
    """Build ``executor(path_ids (K,), x0s (K, d), target, config, seed,
    round_idx) -> SinglePathState`` batched over the ``K`` lanes.

    Without a mesh it runs ``pathfinder_core`` on the lanes where ``x0s``
    lies. With a mesh, ``K`` must divide by its ``paths`` width
    (:func:`pad_paths`): the lanes split into that many contiguous blocks,
    block ``i`` moves to the ``i``-th device and runs there from a host
    thread of its own, on the stream the caller has current on that device,
    and the blocks are gathered in block order onto the mesh's first device.
    ``finish`` (``keep_traces=False`` slims the traces) is applied to each
    block on its device before the gather. An exception in any block
    propagates once every block has ended; no block is retried elsewhere.

    With a ``dim`` axis of width ``w > 1``, ``d`` must divide by ``w``, and
    block ``i`` runs as a row group over row ``i`` of the mesh's ``(paths,
    dim)`` grid (the module docstring): the core of member ``j`` takes rows
    ``[j·d/w, (j+1)·d/w)`` of the block's ``x0s``, on its device, from a
    host thread of its own, and the members' states are joined along ``d``
    on the block's first device, whatever the optimizer. The kernels are
    built before the threads start, so that no member waits on another's
    first build."""
    check_mesh(mesh)

    def one(path_ids, x0s, target, config, seed, round_idx):
        st = pathfinder_core(target, x0s, config, seed, path_ids, round_idx)
        return st if finish is None else finish(st)

    if mesh is None:
        return one
    size, width = paths_width(mesh), dim_width(mesh)
    grid = _block_grid(mesh)

    def sharded(path_ids, x0s, target, config, seed, round_idx):
        K, d = x0s.shape
        if K % size:
            raise ValueError(
                f"{K} lanes do not divide over the {size}-wide '{PATHS_AXIS}' mesh axis; "
                "pad them with pad_paths"
            )
        if d % width:
            raise ValueError(
                f"parameter dimension {d} is not divisible by the {width}-wide "
                f"'{DIM_AXIS}' mesh axis"
            )
        per, rows = K // size, d // width

        def block(i, j, dev):
            lo = i * per
            ids, x = path_ids[lo:lo + per].to(dev), x0s[lo:lo + per].to(dev)
            if width == 1:
                return one(ids, x, target, config, seed, round_idx)
            x = x[:, j * rows:(j + 1) * rows].contiguous()
            return one(ids, x, row_target(target), config, seed, round_idx)

        shards = run_row_groups(grid, d, block)
        blocks = [join_rows(shards[i * width:(i + 1) * width], grid[i, 0])
                  for i in range(size)]
        if size == 1:
            return blocks[0]
        first = grid[0, 0]
        return tree_map(lambda *ts: torch.cat([t.to(first) for t in ts]), *blocks)

    return sharded


def join_rows(shards: list, device) -> SinglePathState:
    """The states of a row group's members (rank order) as one state on
    ``device``, member 0's: every array with a ``d`` axis (the trace's points
    and gradients, the fitted normal's mean, diagonal and factors, the
    draws) joined along it; the rest, which every member holds alike, as
    member 0 has it."""
    if len(shards) == 1:
        return shards[0]

    def cat(get, axis):
        return torch.cat([get(s).to(device) for s in shards], dim=axis)

    head = shards[0]
    fit = head.fit_distribution
    factor = dataclasses.replace(fit.cov.factor,
                                 a_half=cat(lambda s: s.fit_distribution.cov.factor.a_half, -1),
                                 X=cat(lambda s: s.fit_distribution.cov.factor.X, -2))
    cov = dataclasses.replace(fit.cov, A=cat(lambda s: s.fit_distribution.cov.A, -1),
                              B=cat(lambda s: s.fit_distribution.cov.B, -2), factor=factor)
    trace = dataclasses.replace(head.trace, xs=cat(lambda s: s.trace.xs, -1),
                                gradients=cat(lambda s: s.trace.gradients, -1))
    fit = dataclasses.replace(fit, mean=cat(lambda s: s.fit_distribution.mean, -1), cov=cov)
    return dataclasses.replace(head, trace=trace, fit_distribution=fit,
                               draws=cat(lambda s: s.draws, -2))


def run_on_devices(devices: list, fn: Callable) -> list:
    """``[fn(i, devices[i]) for i ...]``, each call from a host thread of its
    own (one device: the calling thread) with its device current. On CUDA
    devices a thread enters the caller's current stream on every device, so
    that its work and the caller's are ordered on one stream a device; on the
    CPU it takes the caller's intra-op thread count, which a new thread does
    not inherit; its tracing spans sit under the caller's open span
    (``utils/tracing.py``). An exception in any call propagates once every
    call has ended: the first in call order that is not a peer's broken
    barrier (a row group's members raise ``threading.BrokenBarrierError``
    when one of them fails, ``utils/rows.py``). On CUDA devices torch's
    linear-algebra library is loaded first (:func:`_load_cuda_linalg`)."""
    streams = [torch.cuda.current_stream(d) for d in dict.fromkeys(devices) if d.type == "cuda"]
    threads = torch.get_num_threads()
    parent = tracing.current()
    if streams and len(devices) > 1:
        _load_cuda_linalg(next(d for d in devices if d.type == "cuda"))

    def call(i):
        with contextlib.ExitStack() as stack:
            stack.enter_context(tracing.adopt(parent))
            if devices[i].type == "cuda":
                for s in streams:
                    stack.enter_context(torch.cuda.stream(s))
                stack.enter_context(torch.cuda.device(devices[i]))
            else:
                torch.set_num_threads(threads)
            return fn(i, devices[i])

    if len(devices) == 1:
        return [call(0)]
    with ThreadPoolExecutor(max_workers=len(devices), thread_name_prefix="pathfinder-mesh") as pool:
        futures = [pool.submit(call, i) for i in range(len(devices))]
        errors = [f.exception() for f in futures]
    causes = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if causes or any(errors):
        raise (causes or [e for e in errors if e is not None])[0]
    return [f.result() for f in futures]


def run_row_groups(grid, d: int, fn: Callable) -> list:
    """``fn(i, j, device)`` for every entry of the ``(blocks, width)`` device
    grid, each from a host thread of its own (:func:`run_on_devices`); the
    results in grid order, block by block. With ``width > 1`` the calls of
    block ``i`` run as the members ``j`` of one :class:`RowGroup` over ``d``
    rows (``utils/rows.py``), and on CUDA the kernels are built before the
    threads start, so that no member waits on another's first build; with
    ``width == 1`` they run in no group."""
    grid = np.asarray(grid, dtype=object)
    width = grid.shape[1]
    groups = [RowGroup(row, d) for row in grid] if width > 1 else None
    devices = list(grid.flat)  # block i's member j is entry i·width + j
    if groups is not None and devices[0].type == "cuda":
        load_library()
        linesearch_kernels.load_library()

    def call(k, dev):
        i, j = divmod(k, width)
        with groups[i].member(j) if groups is not None else contextlib.nullcontext():
            return fn(i, j, dev)

    return run_on_devices(devices, call)


_linalg_lock = threading.Lock()
_linalg_loaded = False


def _load_cuda_linalg(device) -> None:
    """Load torch's CUDA linear-algebra library, once a process. torch loads
    it at the first call that needs it (a triangular solve, a Cholesky), and
    that loading raises ("lazy wrapper should be called at most once") when
    two threads make their first such call at once, as a mesh's threads do
    in a process whose first run is a mesh run."""
    global _linalg_loaded
    with _linalg_lock:
        if not _linalg_loaded:
            one = torch.ones(1, 1, device=device)
            torch.linalg.solve_triangular(one, one, upper=True)
            _linalg_loaded = True


def mesh_device_bytes(mesh: Mesh) -> int:
    """The memory a mesh entry may plan with: the smallest device total
    divided by the entries it holds (a device named twice runs two blocks,
    or two members of a row group, at once)."""
    devices = list(mesh.devices.flat)
    return min(device_memory_bytes(d) // devices.count(d) for d in set(devices))


def state_bytes(d: int, maxiters: int, history_length: int, ndraws: int,
                dtype=torch.float32, keep_traces: bool = True) -> int:
    """Bytes of one lane's ``SinglePathState``: the trace (none with
    ``keep_traces=False``), the ELBO values, the fitted normal and its
    factor, the draws, ten int64 counters and ids, and the success flag.
    ``ndraws`` is the draws per path."""
    m, L = 2 * history_length, maxiters
    trace = (2 * (L + 1) * d + (L + 1)) if keep_traces else 0
    fit = d + (d + d * m + m * m) + (d + d * m + 2 * m * m + 1)  # mean; A, B, D; the factor
    floats = trace + 2 * L + fit + d * ndraws
    return floats * (torch.finfo(dtype).bits // 8) + 8 * 10 + 1


# (d, d) matrices of the working dtype a lane holds at once at its peak.
# HESSIAN_COPIES: torch.func's forward-over-reverse Hessian of a lane with
# its intermediates (``models/protocol.batched_hessian``): 7.0–7.3 measured
# for ``HierarchicalGaussian(1000)`` (``tools/serving_memory.py``, PERF.md
# §5); a target whose gradient builds larger intermediates needs more.
# "newton" (``ops/newton.py``): the Hessian sets the peak; its negation,
# symmetrized and masked copies and eigh's vectors that follow hold fewer.
# "bfgs" (``ops/bfgs.py``): counted from the code, eight at the rank-two
# update (the first H, which the caller's carry keeps, the carried H, the
# direction's H, H_base, s·(Hy)ᵀ and three temporaries of the update);
# measured, nine (``tools/serving_memory.py``); the estimate takes ten.
HESSIAN_COPIES = 8
DENSE_COPIES = {"bfgs": 10, "newton": HESSIAN_COPIES}
# (K, columns) arrays of the mixture denominator's block at once: the
# Mahalanobis terms, the densities and their temporaries, and logsumexp's
MIXTURE_COPIES = 5


def lane_bytes(d: int, maxiters: int, history_length: int, ndraws_elbo: int,
               elbo_chunk: int, ndraws: int, dtype=torch.float32, optimizer="lbfgs",
               importance_denominator: str = "component", nruns: int = 0,
               dim_width: int = 1) -> int:
    """An upper estimate of one lane's share of a launch's peak device
    memory.

    For L-BFGS (and CG, and any optimizer not named below) the peak falls in
    the ELBO stage: the trace and the history arrays that rebuild a fit at
    any point (steps, gradient differences, diagonals and their stack) are
    held while one chunk of ``C`` candidates is either built (history
    windows, factors and their temporaries, about ``11·J·d`` floats a
    candidate) or sampled (the factors kept, ``(4·J + 3)·d`` floats, the
    noise, the draws and the target's temporaries, ``4·d·N``, and the
    noise's Philox words, int64, about 40 bytes a normal at the stream's
    peak). The winner's ``ndraws`` draws are sampled alike, one candidate a
    lane. ``optimizer="bfgs"`` or ``"newton"`` holds ``DENSE_COPIES`` dense
    ``(d, d)`` matrices a lane during the trajectory, which then sets the
    peak where it is larger. With ``importance_denominator="mixture"`` a
    lane's ``N`` pooled draws also take a column of each of the ``nruns``
    components in the denominator's block (``MIXTURE_COPIES`` arrays of
    them), since those blocks are a launch's paths. Measured on the card:
    ``tools/serving_memory.py``.

    On a mesh whose ``dim`` axis is ``dim_width > 1`` wide a lane's rows are
    split: a member holds the estimate at ``r = d / dim_width`` rows, and
    the group's first member also the target's evaluation at the full width,
    an ELBO chunk's gathered draws and the target's temporaries (``4·d·N``
    a candidate, as above), or what an optimizer holds whole there, if more:
    BFGS's ``DENSE_COPIES`` row blocks ``(r, d)`` of H on every member,
    Newton's ``HESSIAN_COPIES`` ``(d, d)`` matrices on the first member only,
    a user callable's whole trace (``2·(L + 1)·d``) on the first member. The
    estimate is that first member's, which every member of the mesh plans
    with."""
    f = torch.finfo(dtype).bits // 8
    J, L, C = history_length, maxiters, min(elbo_chunk, maxiters)
    if dim_width > 1:
        r = -(-d // dim_width)
        rows = lane_bytes(r, maxiters, history_length, ndraws_elbo, elbo_chunk, ndraws, dtype,
                          "lbfgs", importance_denominator, nruns)
        lead = [C * f * 4 * d * ndraws_elbo]
        if optimizer == "bfgs":
            lead.append(DENSE_COPIES["bfgs"] * f * r * d)
        elif optimizer == "newton":
            lead.append(DENSE_COPIES["newton"] * f * d * d)
        elif callable(optimizer):
            lead.append(f * 2 * (L + 1) * d)
        return rows + max(lead)
    held = f * (2 * (L + 1) * d + (L + 1) + (2 * L + 2 * (L + 1)) * d)

    def sample(n):
        return f * ((4 * J + 3) * d + 4 * d * n) + 40 * d * n

    stages = [C * f * 11 * J * d, C * sample(ndraws_elbo), sample(ndraws)]
    if isinstance(optimizer, str) and optimizer in DENSE_COPIES:
        stages.append(DENSE_COPIES[optimizer] * f * d * d)
    mixture = MIXTURE_COPIES * f * ndraws * nruns if importance_denominator == "mixture" else 0
    return held + max(stages) + mixture


def laplace_lane_bytes(d: int, ndraws_per_run: int, dtype=torch.float32,
                       method: str = "diag") -> int:
    """An upper estimate of one component's share of a ``laplace_resample``
    block's peak device memory: its Hessian with torch.func's intermediates
    (``HESSIAN_COPIES``) and the negated copy; the corrected factor (a dense
    covariance with ``method="full"``, whose eigh and scaled copies come
    after the Hessian's peak and stay below it); and its draws with their
    noise and Philox words (as :func:`lane_bytes`)."""
    f = torch.finfo(dtype).bits // 8
    dense = HESSIAN_COPIES + 1
    factor = (d * d if method == "full" else 0) + 4 * d
    draws = f * 4 * d * ndraws_per_run + 40 * d * ndraws_per_run
    return f * (dense * d * d + factor) + draws


def laplace_block(K: int, d: int, ndraws_per_run: int, dtype, method: str, device) -> Optional[int]:
    """Components per ``laplace_resample`` block on ``device``: on a CUDA
    device the fewest even blocks whose estimated peak fits in
    ``LAUNCH_SHARE`` of the card (:func:`plan_launches`), ``None`` (one
    block) on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    per = laplace_lane_bytes(d, ndraws_per_run, dtype, method)
    return plan_launches(K, per, 0, device_memory_bytes(device), offload=False)[0]


def plan_launches(K: int, peak_per_lane: int, state_per_lane: int, device_bytes: int,
                  cap: Optional[int] = None, offload: Optional[bool] = None, width: int = 1):
    """``(cap, offload)`` for ``K`` paths on a card of ``device_bytes`` of
    memory. A ``cap`` or ``offload`` that is given is kept.

    Without a cap the paths run in the fewest launches whose estimated peak
    fits in ``LAUNCH_SHARE`` of the card's memory, split evenly (``None``:
    one launch). Without an offload choice the states go to the host when
    the run is chunked and the states of all ``K`` lanes would pass
    ``OFFLOAD_SHARE`` of it. On a mesh of ``width`` blocks the fit is a
    block's, ``ceil(K / width)`` lanes against ``device_bytes`` (a block's
    memory, :func:`mesh_device_bytes`), the cap counts lanes over the mesh,
    and the states of all ``K`` lanes, gathered on the first device, count
    against its share."""
    if cap is None:
        Kd = -(-K // width)
        fit = max(1, int(LAUNCH_SHARE * device_bytes) // max(1, peak_per_lane))
        n_chunks = -(-Kd // fit)
        cap = None if n_chunks == 1 else -(-Kd // n_chunks) * width
    if offload is None:
        chunked = cap is not None and cap < K
        offload = chunked and K * state_per_lane > OFFLOAD_SHARE * device_bytes
    return cap, bool(offload)


def device_memory_bytes(device) -> int:
    """The card's total memory, as the CUDA runtime reports it."""
    return torch.cuda.mem_get_info(device)[1]

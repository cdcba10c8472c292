"""Woodbury sample+logq (B1) and whiten+sumsq (B2): CUDA kernels and their
plain torch versions.

They replace the JAX package's Pallas TPU kernels ``_sample_kernel`` and
``_whiten_kernel`` (``pathfinder_tpu/ops/pallas/woodbury_kernels.py`` at
commit ``c548d16^``). The CUDA source, with the notes on what bounds the
kernels and how they are laid out, is ``pathfinder_tpu_torch/csrc/
woodbury_kernels.cu``.

Each wrapper takes tensors on the CPU through the plain version, and
tensors on a CUDA device through the kernel; on a CUDA tensor it launches
the kernel or raises, and never falls back. The kernel is built with
``nvcc`` at first use, from the sources in the package, into the ``build/``
directory beside the package, and bound with ``ctypes``. How a launch is
cut into clusters, threads and row tiles is decided here, by
:func:`_launch_plan`, and checked by the kernel against its own layout.

Shapes (batch ``B`` of independent factors, dimension ``d``, rank ``m``,
``N`` draws): ``u``/``x`` ``(B, d, N)``, ``a_half``/``mu`` ``(B, d)``,
``X`` ``(B, d, m)``, ``C``/``Ci`` ``(B, m, m)``, ``logdet`` ``(B,)``. The rank
may be 0 (a diagonal factor). B2 also takes one block ``x (d, P)`` shared by
all ``B`` factors and returns ``(B, P)``: one launch over (factor, column
tile), with no copy of ``x`` per factor.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = [
    "sample_and_logq",
    "sample_and_logq_torch",
    "whiten_sumsq",
    "whiten_sumsq_torch",
    "launch_counts",
    "launch_counts_by_shape",
    "reset_launch_counts",
    "load_library",
    "kernel_resources",
]

_LOG_2PI = math.log(2.0 * math.pi)
_PKG_DIR = Path(__file__).resolve().parents[2]
_SOURCE = _PKG_DIR / "csrc" / "woodbury_kernels.cu"
_BUILD_DIR = _PKG_DIR.parent / "build" / "pathfinder_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
MAX_RANK = 32

# Hopper limits the launch plan works within (H100 SXM)
NUM_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use
MAX_CLUSTER = 8  # the portable cluster size
_CHUNK = 40  # columns the kernel handles per round (csrc: kChunk)
_MIN_ROWS = 64  # rows below which a factor is not split further
_COL_TILES = (40, 20, 10, 5)  # widths of a column tile of a shared x, widest first
_MIN_PAIR_TILE = 10  # narrower tiles are not worth a second CTA on the SM
# shared memory of a CTA that leaves room for a second one on its SM (228 KB
# an SM, 1 KB of it reserved per CTA)
_SMEM_PAIR = 233_472 // 2 - 1024

# launches of each kernel since the last reset, in all and per shape
# ``(B, m, N, shared)`` (plain-version calls on CPU tensors do not count)
_launches = {"sample_and_logq": 0, "whiten_sumsq": 0}
_launches_by_shape = {name: collections.Counter() for name in _launches}
_lib = None
_lib_log = ""  # what nvcc (ptxas -v) said when it built the library
_lib_lock = threading.Lock()


def launch_counts() -> dict:
    return dict(_launches)


def launch_counts_by_shape() -> dict:
    """``{kernel: {(B, m, N, shared): launches}}`` since the last reset;
    ``shared`` marks B2 launches over a shared ``x`` of ``N`` columns."""
    return {name: dict(c) for name, c in _launches_by_shape.items()}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
        _launches_by_shape[name].clear()


# -- plain versions -----------------------------------------------------------


def sample_and_logq_torch(u, a_half, X, C, mu, logdet):
    """``x = a½ ∘ (u + X (C (Xᵀ u))) + μ`` and
    ``logq = −(d·log2π + logdet + ‖u‖²)/2`` per column."""
    d = u.shape[-2]
    core = u + X @ (C @ (X.mT @ u))
    x = a_half[..., None] * core + mu[..., None]
    usq = torch.sum(u * u, dim=-2)
    logq = -0.5 * (d * _LOG_2PI + logdet[..., None] + usq)
    return x, logq


def whiten_sumsq_torch(x, a_half, X, Ci, mu):
    """``‖v + X (Ci (Xᵀ v))‖²`` per column, ``v = (x − μ)/a½``; ``x`` is
    ``(..., d, N)``, or ``(d, P)`` shared by all factors."""
    v = (x - mu[..., None]) / a_half[..., None]
    w = v + X @ (Ci @ (X.mT @ v))
    return torch.sum(w * w, dim=-2)


# -- launch plan --------------------------------------------------------------


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _rank_tile(m: int) -> int:
    """The rank the kernel is instantiated for: m rounded up to 4."""
    return max(4, _round4(m))


def _threads(m: int) -> int:
    """32 · (MR/4 rank groups) · (row parts), MR = ``_rank_tile(m)``."""
    mr = _rank_tile(m)
    return 32 * (mr // 4) * max(1, 32 // mr)


def _smem_bytes(tile: int, m: int, N: int, threads: int, shared: bool = False) -> int:
    """Dynamic shared memory of one CTA; mirrors ``Layout`` in the source.
    With ``shared`` (B2 over a shared ``x``) ``N`` is the width of a column
    tile, whose columns are staged one after the other."""
    mr = _rank_tile(m)
    warps = threads // 32
    parts = warps // (mr // 4)
    nc = min(N, _CHUNK)
    slab = N * (_round4(tile) + 4) if shared else tile * N + 4
    floats = (
        4  # the mbarrier
        + _round4(slab) + _round4(tile * m + 4) + 2 * _round4(tile + 4)
        + _round4(m * m + 4)
        + _round4(parts * mr * nc) + 2 * _round4(mr * nc) + _round4(mr * (nc + 4))
        + _round4(warps * nc) + _round4(nc)
    )
    return 4 * floats


def _cta_rows(d: int, cluster: int, rank: int) -> tuple:
    """Rows ``[r0, r1)`` of a factor that CTA ``rank`` of its cluster owns
    (the kernel's own split)."""
    per = -(-d // cluster)
    r0 = min(d, rank * per)
    return r0, min(d, r0 + per)


def _launch_plan(B: int, d: int, m: int, N: int, num_sms: int = NUM_SMS) -> tuple:
    """``(cluster, threads, smem_bytes, tile_rows)`` for ``B`` factors.

    The cluster splits each factor's d rows over 1, 2, 4 or 8 CTAs: the
    fewest that give every SM a CTA (never below ``_MIN_ROWS`` rows a CTA),
    and more where a CTA's rows would not fit in shared memory. Where they
    do not fit even at 8, ``tile_rows`` is smaller than a CTA's rows and
    the kernel stages them tile by tile, reading them twice.
    """
    if min(B, d, N) < 1 or not 0 <= m <= MAX_RANK:
        raise ValueError(f"no launch plan for B={B}, d={d}, m={m}, N={N}")
    threads = _threads(m)
    cluster = 1
    while (
        cluster < MAX_CLUSTER
        and B * cluster < num_sms
        and -(-d // (2 * cluster)) >= _MIN_ROWS
    ):
        cluster *= 2
    while cluster < MAX_CLUSTER and _smem_bytes(-(-d // cluster), m, N, threads) > SMEM_LIMIT:
        cluster *= 2
    rows = -(-d // cluster)
    tile = rows
    if _smem_bytes(tile, m, N, threads) > SMEM_LIMIT:
        fixed = _smem_bytes(0, m, N, threads)
        tile = (SMEM_LIMIT - fixed) // (4 * (N + m + 2))
        while tile > 0 and _smem_bytes(tile, m, N, threads) > SMEM_LIMIT:
            tile -= 1
        if tile < 1:
            raise ValueError(f"N={N} columns of one row do not fit in shared memory")
        tile = -(-rows // -(-rows // tile))  # equal tiles
    return cluster, threads, _smem_bytes(tile, m, N, threads), tile


def _launch_plan_shared(B: int, d: int, m: int, P: int, num_sms: int = NUM_SMS) -> tuple:
    """``(cluster, threads, smem_bytes, tile_rows, col_tile)`` for B2 over an
    ``x`` of ``P`` columns shared by ``B`` factors.

    The grid runs over (factor, column tile); a cluster stages its factor's
    rows and one tile of ``col_tile`` columns. A CTA loads, then computes,
    so two CTAs on an SM overlap where one would idle: the tile is the
    widest of ``_COL_TILES`` that leaves room for two, from
    ``_MIN_PAIR_TILE`` columns up, else the widest that fits alone. The
    cluster grows while no tile fits and while the card would not be
    filled. Where not even the narrowest tile fits at 8 CTAs, the rows are
    tiled too and staged twice.
    """
    if min(B, d, P) < 1 or not 0 <= m <= MAX_RANK:
        raise ValueError(f"no launch plan for B={B}, d={d}, m={m}, P={P}")
    threads = _threads(m)
    widths = sorted({min(w, P) for w in _COL_TILES}, reverse=True)

    def widest(rows):
        """The tile for a CTA of ``rows`` rows; 0 where none fits."""
        smem = {w: _smem_bytes(rows, m, w, threads, True) for w in widths}
        pair = [w for w in widths if smem[w] <= _SMEM_PAIR and w >= min(_MIN_PAIR_TILE, P)]
        alone = [w for w in widths if smem[w] <= SMEM_LIMIT]
        return (pair or alone or [0])[0]

    cluster = 1
    while cluster < MAX_CLUSTER and not widest(-(-d // cluster)):
        cluster *= 2
    while (
        cluster < MAX_CLUSTER
        and B * -(-P // max(1, widest(-(-d // cluster)))) * cluster < num_sms
        and -(-d // (2 * cluster)) >= _MIN_ROWS
    ):
        cluster *= 2
    rows = -(-d // cluster)
    tile, width = rows, widest(rows)
    if not width:
        width = widths[-1]
        fixed = _smem_bytes(0, m, width, threads, True)
        tile = (SMEM_LIMIT - fixed) // (4 * (width + m + 2)) & ~3
        while tile > 0 and _smem_bytes(tile, m, width, threads, True) > SMEM_LIMIT:
            tile -= 4
        if tile < 1:
            raise ValueError(f"one row of {width} columns does not fit in shared memory")
        tile = min(rows, _round4(-(-rows // -(-rows // tile))))  # equal tiles
    if -(-P // width) > 65535:
        raise ValueError(f"P={P} columns need more column tiles than a grid has")
    return cluster, threads, _smem_bytes(tile, m, width, threads, True), tile, width


# -- build and bind -----------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the kernels' library."""
    global _lib, _lib_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = _BUILD_DIR / f"woodbury_kernels_{tag}.so"
        log_path = so_path.with_suffix(".log")
        if not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
        _lib_log = log_path.read_text() if log_path.exists() else ""
        lib = ctypes.CDLL(str(so_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pf_sample_logq.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.pf_sample_logq.restype = i
        lib.pf_whiten_sumsq.argtypes = [p] * 6 + [i] * 8 + [p]
        lib.pf_whiten_sumsq.restype = i
        lib.pf_whiten_sumsq_shared.argtypes = [p] * 6 + [i] * 9 + [p]
        lib.pf_whiten_sumsq_shared.restype = i
        lib.pf_max_rank.argtypes = []
        lib.pf_max_rank.restype = i
        if lib.pf_max_rank() != MAX_RANK:
            raise RuntimeError("kernel library and wrapper disagree on MAX_RANK")
        _lib = lib
        return lib


def kernel_resources() -> dict:
    """Registers and spills of each kernel instantiation as ``ptxas -v``
    reported them at build time: ``{(name, MR, NT): {"registers": r,
    "spill_stores": bytes, "spill_loads": bytes}}``; B2 over a shared ``x``
    is listed as ``whiten_sumsq_shared``."""
    load_library()
    out, key = {}, None
    for line in _lib_log.splitlines():
        found = re.search(r"woodbury_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and found:
            mr, nt, mode = found.groups()
            name = ("sample_and_logq", "whiten_sumsq", "whiten_sumsq_shared")[int(mode)]
            key = (name, int(mr), int(nt))
            out[key] = {}
        elif key is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[key].update(spill_stores=int(st), spill_loads=int(ld))
        elif key is not None and "Used" in line and "registers" in line:
            out[key]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- wrappers -----------------------------------------------------------------


def _check_cuda_args(names_shapes, device):
    for name, t, shape in names_shapes:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _flat_shapes(u, X):
    if u.ndim < 2 or X.ndim != u.ndim:
        raise ValueError(
            f"expected u/x (..., d, N) and X (..., d, m); got {tuple(u.shape)}, "
            f"{tuple(X.shape)}"
        )
    batch = tuple(u.shape[:-2])
    d, N = u.shape[-2:]
    m = X.shape[-1]
    if d == 0:
        raise ValueError("the kernels need d >= 1")
    if m > MAX_RANK:
        raise ValueError(f"rank m={m} exceeds the kernel's cap of {MAX_RANK}")
    return batch, math.prod(batch), d, m, N


def _launch(name, entry, tensors, plan, device, B, d, m, N, shared=False):
    """Launch ``entry`` on the current stream with ``plan`` and count it. A
    tensor without elements (``X`` and the core at m = 0) may have no
    address of its own; the kernel never reads it and gets a valid one."""
    pointers = [t.data_ptr() or tensors[1].data_ptr() for t in tensors]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = entry(*pointers, B, d, m, N, *plan, stream)
    if code == -1:
        raise RuntimeError(f"{name} kernel rejected the launch plan {plan}")
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {code}")
    _launches[name] += 1
    _launches_by_shape[name][(B, m, N, shared)] += 1


def sample_and_logq(u, a_half, X, C, mu, logdet):
    """B1: fused ``(x, logq)`` from standard-normal draws ``u (..., d, N)``."""
    if u.device.type == "cpu":
        return sample_and_logq_torch(u, a_half, X, C, mu, logdet)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    batch, B, d, m, N = _flat_shapes(u, X)
    _check_cuda_args(
        [
            ("u", u, batch + (d, N)),
            ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)),
            ("C", C, batch + (m, m)),
            ("mu", mu, batch + (d,)),
            ("logdet", logdet, batch),
        ],
        u.device,
    )
    x = torch.empty_like(u)
    logq = torch.empty(batch + (N,), dtype=u.dtype, device=u.device)
    if B == 0 or N == 0:
        return x, logq
    plan = _launch_plan(B, d, m, N, _num_sms(u.device.index))
    _launch("sample_and_logq", load_library().pf_sample_logq,
            (u, a_half, X, C, mu, logdet, x, logq), plan, u.device, B, d, m, N)
    return x, logq


def whiten_sumsq(x, a_half, X, Ci, mu):
    """B2: Mahalanobis terms ``‖L⁻¹(x − μ)‖²`` for the columns of ``x``:
    ``x (..., d, N)`` with a block of columns per factor gives ``(..., N)``;
    ``x (d, P)`` beside batched factors is shared by all of them and gives
    ``(..., P)``."""
    if x.device.type == "cpu":
        return whiten_sumsq_torch(x, a_half, X, Ci, mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim == 2 and X.ndim > 2:
        return _whiten_sumsq_shared(x, a_half, X, Ci, mu)
    batch, B, d, m, N = _flat_shapes(x, X)
    _check_cuda_args(
        [
            ("x", x, batch + (d, N)),
            ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)),
            ("Ci", Ci, batch + (m, m)),
            ("mu", mu, batch + (d,)),
        ],
        x.device,
    )
    maha = torch.empty(batch + (N,), dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return maha
    plan = _launch_plan(B, d, m, N, _num_sms(x.device.index))
    _launch("whiten_sumsq", load_library().pf_whiten_sumsq,
            (x, a_half, X, Ci, mu, maha), plan, x.device, B, d, m, N)
    return maha


def _whiten_sumsq_shared(x, a_half, X, Ci, mu):
    """B2 with ``x (d, P)`` shared by the factors ``X (..., d, m)``. The
    kernel reads ``x`` in the ``(P, d)`` layout, a column's rows side by
    side: an ``x`` that is the transpose of a contiguous ``(P, d)`` block
    (pooled draws) goes in as it is, any other is transposed once."""
    batch = tuple(X.shape[:-2])
    B = math.prod(batch)
    d, m = X.shape[-2:]
    P = x.shape[1]
    if d == 0:
        raise ValueError("the kernels need d >= 1")
    if m > MAX_RANK:
        raise ValueError(f"rank m={m} exceeds the kernel's cap of {MAX_RANK}")
    xt = x.mT if x.mT.is_contiguous() else x.mT.contiguous()
    _check_cuda_args(
        [
            ("x (transposed)", xt, (P, d)),
            ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)),
            ("Ci", Ci, batch + (m, m)),
            ("mu", mu, batch + (d,)),
        ],
        x.device,
    )
    maha = torch.empty(batch + (P,), dtype=x.dtype, device=x.device)
    if B == 0 or P == 0:
        return maha
    plan = _launch_plan_shared(B, d, m, P, _num_sms(x.device.index))
    _launch("whiten_sumsq", load_library().pf_whiten_sumsq_shared,
            (xt, a_half, X, Ci, mu, maha), plan, x.device, B, d, m, P, shared=True)
    return maha

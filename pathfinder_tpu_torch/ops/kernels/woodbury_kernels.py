"""Woodbury sample+logq (B1) and whiten+sumsq (B2): CUDA kernels and their
plain torch versions.

They replace the JAX package's Pallas TPU kernels ``_sample_kernel`` and
``_whiten_kernel`` (``pathfinder_tpu/ops/pallas/woodbury_kernels.py`` at
commit ``c548d16^``). Three CUDA sources carry them, with the notes on what
bounds each and how it is laid out:

* ``pathfinder_tpu_torch/csrc/woodbury_kernels.cu``, the fast kernel:
  float32 and rank ``m <= MAX_RANK`` (32), the main path's case;
* ``pathfinder_tpu_torch/csrc/woodbury_general.cu``, the general kernel:
  float16, bfloat16, float32 and float64 at any rank, accumulating in
  float64 for float64 and in float32 otherwise, as the TPU kernels did
  (``promote_types(dtype, float32)``);
* ``pathfinder_tpu_torch/csrc/woodbury_shared.cu``, the shared-x kernel:
  B2 over one block ``x (d, P)`` shared by every factor (the mixture
  denominator), at every dtype and rank, its products on the tensor cores.

Per factor the route is chosen from the dtype and the rank before the
launch (:func:`uses_fast_kernel`); B2 over a shared ``x`` always takes the
shared-x kernel. Nothing is caught and retried on another route.

Each wrapper takes tensors on the CPU through the plain version, and
tensors on a CUDA device through a kernel; on a CUDA tensor it launches
the kernel or raises, and never falls back. The libraries are built from
the package's ``csrc/``, loaded and launched by ``ops/kernels/_build.py``;
the binders here give each entry point its argument types. How a launch
is cut is decided here, by :func:`_launch_plan` for the fast kernel,
:func:`_general_rows_plan` for the general one (``factor_kernel``) and
:func:`_shared_plan` for the shared-x one, and checked by each kernel
against its own layout.

Shapes (batch ``B`` of independent factors, dimension ``d``, rank ``m``,
``N`` draws): ``u``/``x`` ``(B, d, N)``, ``a_half``/``mu`` ``(B, d)``,
``X`` ``(B, d, m)``, ``C``/``Ci`` ``(B, m, m)``, ``logdet`` ``(B,)``. The rank
may be 0 (a diagonal factor). B2 also takes one block ``x (d, P)`` shared by
all ``B`` factors and returns ``(B, P)``: one launch over (factor group,
column tile), with no copy of ``x`` per factor.

B1 also runs split over the rows (the mesh's ``dim`` axis, each device
holding a block of ``d_r`` rows), as two launches of the same per-factor
kernels in two more modes: :func:`sample_and_logq_partial` reads the
block's ``u`` and ``X`` rows and writes the partial ``t = X_rᵀ u_r (B, m,
N)`` and ``‖u_r‖² (B, N)``, in the accumulation dtype; after the caller
has summed those over the blocks, :func:`sample_and_logq_resume` forms
``s = C t`` and writes the block's rows of ``x`` and ``logq`` from the
summed ``‖u‖²`` and the full ``d``. B2 with a block of columns per factor
splits the same way, in its own arithmetic: :func:`whiten_sumsq_partial`
whitens the block's rows, ``v_r = (x_r − μ_r)/a½_r``, and writes ``t =
X_rᵀ v_r``; after the sum over the blocks, :func:`whiten_sumsq_resume`
forms ``w_r = v_r + X_r (Ci t)`` and writes the block's ``‖w_r‖²`` per
column, in the accumulation dtype, for the caller to sum over the blocks.
B2 over an ``x (d_r, P)`` shared by the factors splits the same way on the
shared-x kernel, in two more parts of it: the partial writes ``t (B, m, P)``
for every (factor, column) pair, the resume the block's ``‖w_r‖² (B, P)``.
Each launch's plan is the unsplit plan at ``d_r`` rows.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import re
from pathlib import Path

import torch

from pathfinder_tpu_torch.ops.kernels import _build
from pathfinder_tpu_torch.utils import tracing

__all__ = [
    "sample_and_logq",
    "sample_and_logq_torch",
    "sample_and_logq_partial",
    "sample_and_logq_partial_torch",
    "sample_and_logq_resume",
    "sample_and_logq_resume_torch",
    "whiten_sumsq",
    "whiten_sumsq_torch",
    "whiten_sumsq_partial",
    "whiten_sumsq_partial_torch",
    "whiten_sumsq_resume",
    "whiten_sumsq_resume_torch",
    "launch_counts",
    "launch_counts_by_shape",
    "reset_launch_counts",
    "load_library",
    "load_general_library",
    "load_shared_library",
    "kernel_resources",
    "general_kernel_resources",
    "shared_kernel_resources",
    "uses_fast_kernel",
]

_LOG_2PI = math.log(2.0 * math.pi)
_PKG_DIR = Path(__file__).resolve().parents[2]
_SOURCE = _PKG_DIR / "csrc" / "woodbury_kernels.cu"
_GENERAL_SOURCE = _PKG_DIR / "csrc" / "woodbury_general.cu"
_SHARED_SOURCE = _PKG_DIR / "csrc" / "woodbury_shared.cu"
MAX_RANK = 32  # the fast kernel's rank cap; the general kernel takes any rank

# Hopper limits the launch plan works within (H100 SXM)
NUM_SMS = 132
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use
MAX_CLUSTER = 8  # the portable cluster size
_CHUNK = 40  # columns the kernel handles per round (csrc: kChunk)
_MIN_ROWS = 64  # rows below which a factor is not split further
# shared memory of a CTA that leaves room for a second one on its SM (228 KB
# an SM, 1 KB of it reserved per CTA)
_SMEM_PAIR = 233_472 // 2 - 1024

# the general source's factor_kernel (B1, B2 per factor) and the shared-x
# kernel: threads a CTA (csrc: kThreads, both)
_G_THREADS = 256
# factor_kernel: the most columns of a round and the ranks of a pass-1
# register tile (csrc/woodbury_general.cu: kRound, kRK)
_R_ROUND = 40
_R_RK = 4
_R_SPLIT_M = 64  # above this rank a cluster splits s = M t by rows (csrc: kSplitM)
_WARPS = _G_THREADS // 32
# the shared-x kernel (csrc/woodbury_shared.cu): columns of an MMA tile
# (kColTile) and rank tiles of 8 a warp sums at once in pass 1 (kRankTiles)
_S_COL_TILE = 16
_S_RANK_TILES = 4
# the general and shared-x kernels' dtype codes (csrc: kF32 ...)
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.bfloat16: 3}

# launches of each kernel since the last reset, in all and per shape
# ``(B, m, N, shared)`` (plain-version calls on CPU tensors do not count):
# the always-on family ``launch.<kernel>`` of the tracing counters
# (``utils/tracing.py``), updated from every thread that launches (one per
# mesh entry); ``*_general`` are the general kernel's,
# ``whiten_sumsq_shared*`` the shared-x kernel's, ``*_partial`` and
# ``*_resume`` B1's and B2's two row-split modes
_KERNELS = (
    "sample_and_logq", "whiten_sumsq", "sample_and_logq_general", "whiten_sumsq_general",
    "whiten_sumsq_shared", "sample_and_logq_partial", "sample_and_logq_resume",
    "sample_and_logq_partial_general", "sample_and_logq_resume_general",
    "whiten_sumsq_partial", "whiten_sumsq_resume", "whiten_sumsq_partial_general",
    "whiten_sumsq_resume_general", "whiten_sumsq_shared_partial", "whiten_sumsq_shared_resume")


def launch_counts() -> dict:
    totals = tracing.counts(tracing.LAUNCH)
    return {name: totals.get(tracing.LAUNCH + name, 0) for name in _KERNELS}


def launch_counts_by_shape() -> dict:
    """``{kernel: {(B, m, N, shared): launches}}`` since the last reset;
    ``shared`` marks B2 launches over a shared ``x`` of ``N`` columns."""
    by_shape = tracing.counts_by_key(tracing.LAUNCH)
    return {name: by_shape.get(tracing.LAUNCH + name, {}) for name in _KERNELS}


def reset_launch_counts() -> None:
    tracing.reset(tracing.LAUNCH)


# -- plain versions -----------------------------------------------------------


def _upcast(*ts):
    """16-bit inputs in float32, as the kernels accumulate them; float32 and
    float64 as they are."""
    return [t.float() if torch.finfo(t.dtype).bits < 32 else t for t in ts]


def sample_and_logq_torch(u, a_half, X, C, mu, logdet):
    """``x = a½ ∘ (u + X (C (Xᵀ u))) + μ`` and
    ``logq = −(d·log2π + logdet + ‖u‖²)/2`` per column. 16-bit inputs are
    computed in float32 and the outputs rounded to their dtype once."""
    dtype, d = u.dtype, u.shape[-2]
    u, a_half, X, C, mu, logdet = _upcast(u, a_half, X, C, mu, logdet)
    core = u + X @ (C @ (X.mT @ u))
    x = a_half[..., None] * core + mu[..., None]
    usq = torch.sum(u * u, dim=-2)
    logq = -0.5 * (d * _LOG_2PI + logdet[..., None] + usq)
    return x.to(dtype), logq.to(dtype)


def _acc_dtype(dtype):
    """The dtype the kernels accumulate ``dtype`` in: float64 for float64,
    float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def sample_and_logq_partial_torch(u, X):
    """B1's partial on a block of rows: ``(t = Xᵀ u (..., m, N), ‖u‖²
    (..., N))`` in the accumulation dtype."""
    u, X = _upcast(u, X)
    return X.mT @ u, torch.sum(u * u, dim=-2)


def sample_and_logq_resume_torch(u, a_half, X, C, mu, logdet, t, usq, d):
    """B1's resume on a block of rows from the summed ``t`` and ``‖u‖²``:
    ``x = a½ ∘ (u + X (C t)) + μ`` on the block and
    ``logq = −(d·log2π + logdet + ‖u‖²)/2`` with the full ``d``."""
    dtype = u.dtype
    u, a_half, X, C, mu, logdet = _upcast(u, a_half, X, C, mu, logdet)
    x = a_half[..., None] * (u + X @ (C @ t)) + mu[..., None]
    logq = -0.5 * (d * _LOG_2PI + logdet[..., None] + usq)
    return x.to(dtype), logq.to(dtype)


def whiten_sumsq_torch(x, a_half, X, Ci, mu):
    """``‖v + X (Ci (Xᵀ v))‖²`` per column, ``v = (x − μ)/a½``; ``x`` is
    ``(..., d, N)``, or ``(d, P)`` shared by all factors. 16-bit inputs are
    computed in float32 and the result rounded to their dtype once."""
    dtype = x.dtype
    x, a_half, X, Ci, mu = _upcast(x, a_half, X, Ci, mu)
    v = (x - mu[..., None]) / a_half[..., None]
    w = v + X @ (Ci @ (X.mT @ v))
    return torch.sum(w * w, dim=-2).to(dtype)


def whiten_sumsq_partial_torch(x, a_half, X, mu):
    """B2's partial on a block of rows: ``t = Xᵀ v (..., m, N)``, ``v = (x −
    μ)/a½``, in the accumulation dtype; a 2-D ``x (d_r, P)`` is shared by all
    factors."""
    x, a_half, X, mu = _upcast(x, a_half, X, mu)
    return X.mT @ ((x - mu[..., None]) / a_half[..., None])


def whiten_sumsq_resume_torch(x, a_half, X, Ci, mu, t):
    """B2's resume on a block of rows from the summed ``t``: the block's
    ``‖v + X (Ci t)‖² (..., N)``, in the accumulation dtype."""
    x, a_half, X, Ci, mu = _upcast(x, a_half, X, Ci, mu)
    w = (x - mu[..., None]) / a_half[..., None] + X @ (Ci @ t)
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


def _smem_bytes(tile: int, m: int, N: int, threads: int) -> int:
    """Dynamic shared memory of one CTA; mirrors ``Layout`` in the source."""
    mr = _rank_tile(m)
    warps = threads // 32
    parts = warps // (mr // 4)
    nc = min(N, _CHUNK)
    slab = tile * N + 4
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


def _r16(n: int) -> int:
    return (n + 15) & ~15


def _rows_col_tile(N: int) -> int:
    """A thread's column tile in ``factor_kernel``: 5 where N is a multiple
    of 5 (N = 5 and 10 run exactly), else 4."""
    return 5 if N % 5 == 0 else 4


def _rows_slots(m: int, nc: int, nt: int) -> int:
    """Pass 1's slots: the (rank tile, column tile) pairs of a round rounded
    up to a power of two, at most one a thread (csrc: ``pair_slots``)."""
    pairs, slots = -(-m // _R_RK) * -(-nc // nt), 1
    while slots < pairs and slots < _G_THREADS:
        slots *= 2
    return slots


def _rows_parts(m: int, nc: int, nt: int) -> int:
    """Pass 1's partial sums a value: one a warp where a warp holds whole row
    parts of every slot, else one a row part (csrc: ``row_parts``)."""
    slots = _rows_slots(m, nc, nt)
    return _WARPS if slots <= 32 else _G_THREADS // slots


def _rows_s_rows(m: int, cs: int) -> int:
    """Rows of M (and of s) one CTA of a cluster of ``cs`` forms (csrc: ``s_rows``)."""
    return -(-m // cs) if cs > 1 and m > _R_SPLIT_M else m


def _rows_layout(esz: int, asz: int, tile: int, m: int, N: int, nc: int, nt: int, whole: int,
                 mres: int, cs: int, ws: bool) -> int:
    """Bytes of ``factor_kernel``'s dynamic shared memory; mirrors ``RLayout``
    in ``csrc/woodbury_general.cu``. ``esz``/``asz``: bytes of the storage
    and the accumulation type; ``whole``: the slab holds all ``N`` columns
    of u (or x), else a block of a round's ``nc``; ``mres``: the CTA's rows
    of M are staged too; ``cs``: the cluster; ``ws``: the sums live in the
    workspace."""
    al, mr, ncp = 16 // esz, _R_RK * -(-m // _R_RK), nt * -(-nc // nt)
    ks, parts, keep = _rows_s_rows(m, cs), _rows_parts(m, nc, nt), 0 if ws else 1
    split = ks < m
    arrays = (
        16,  # the mbarrier
        esz * (whole * (tile * N + al) + (1 - whole) * tile * nc),  # u or x
        esz * (tile * m + al), esz * (tile + al), esz * (tile + al),  # X, a½, μ
        esz * mres * (ks * m + al),  # this CTA's rows of M
        asz * keep * mr * ncp,  # this CTA's Xᵀv
        asz * keep * (parts > 1) * parts * mr * ncp,  # its row parts'
        asz * keep * (cs > 1) * mr * ncp,  # the cluster's
        asz * keep * mr * ncp,  # s = M Xᵀv
        asz * keep * split * ks * ncp,  # this CTA's rows of s
        asz * _WARPS * ncp, asz * ncp,  # pass-3 sums a warp, the CTA's column sums
    )
    return sum(_r16(a) for a in arrays)


def _rows_workspace(m: int, nc: int, nt: int, cs: int) -> int:
    """Values of the accumulation type one CTA's slice of ``factor_kernel``'s
    workspace holds (csrc: ``ws_values``)."""
    mr, ncp, ks = _R_RK * -(-m // _R_RK), nt * -(-nc // nt), _rows_s_rows(m, cs)
    parts = _rows_parts(m, nc, nt)
    return mr * ncp * (2 + (parts > 1) * parts + (cs > 1)) + (ks < m) * _round4(ks * ncp)


RowsPlan = collections.namedtuple("RowsPlan", "cluster threads tile nc colblk whole mres smem ws")


def _general_rows_plan(B: int, d: int, m: int, N: int, dtype, num_sms: int = NUM_SMS,
                       smem_limit: int = SMEM_LIMIT, cluster: int = None) -> RowsPlan:
    """The plan of ``factor_kernel`` (B1, and B2 with a block of columns per
    factor) over ``B`` factors of ``d`` rows, rank ``m``, ``N`` columns each.

    The cluster splits each factor's rows over 1, 2, 4 or 8 CTAs: the fewest
    that give every SM a CTA, never below ``_MIN_ROWS`` rows a CTA (or
    ``cluster`` where given). Columns go in rounds of ``nc`` (at most
    ``_R_ROUND``); with too few CTAs for the card, the columns are cut into
    blocks of whole column tiles (``colblk``), one a cluster, as many as fill
    the card, and a block is one round. Then the first that fits, growing the
    cluster as far as 8 before the next:

    1. ``whole``: all the CTA's rows of X, a½, μ and of u (or x), every
       column, and its rows of M, staged once by bulk copy, in room for two
       CTAs an SM, else in the CTA's whole limit; a launch of many waves
       (``B · cluster >= 2 · num_sms``) takes one CTA alone over two where
       that keeps one CTA a factor, or a cluster of 2 over 8 (measured,
       ``tools/woodbury_general_bench.py --clusters``);
    2. the rows of X, a½, μ and M staged once, u (or x) in blocks of a
       round's columns;
    3. the rows in tiles, staged for pass 1 and again for pass 3; where not
       even one row fits beside the sums, the round narrows to one column
       tile, then M is read from global memory (``mres = 0``), and then the
       sums go to a global workspace (``ws``), with a cluster of one.

    Raises where one row of X does not fit in shared memory.
    """
    if min(B, d, N) < 1 or m < 0 or dtype not in _DTYPE_CODES:
        raise ValueError(f"no launch plan for B={B}, d={d}, m={m}, N={N}, {dtype}")
    esz = torch.finfo(dtype).bits // 8
    asz = 8 if dtype == torch.float64 else 4
    nt = _rows_col_tile(N)
    nc = min(N, _R_ROUND)
    if cluster is None:
        fill = 1
        while fill < MAX_CLUSTER and B * fill < num_sms and -(-d // (2 * fill)) >= _MIN_ROWS:
            fill *= 2
        sizes = [c for c in (1, 2, 4, 8) if c >= fill]
    elif cluster in (1, 2, 4, 8):
        sizes = [cluster]
    else:
        raise ValueError(f"a cluster of {cluster} CTAs")
    colblk = N
    if B * sizes[0] < num_sms and N > nt:
        per = -(-N // -(-num_sms // (B * sizes[0])))  # columns a block, for enough blocks
        colblk = nc = min(nc, nt * -(-per // nt))

    mres = 1

    def need(tile, whole, cs, ws=False):
        return _rows_layout(esz, asz, tile, m, N, nc, nt, whole, mres, cs, ws)

    def plan(cs, tile, whole, ws=False):
        return RowsPlan(cs, _G_THREADS, tile, nc, colblk, whole, mres, need(tile, whole, cs, ws), ws)

    if colblk == N:
        fits = [[cs for cs in sizes if need(-(-d // cs), 1, cs) <= limit]
                for limit in (min(_SMEM_PAIR, smem_limit), smem_limit)]
        pair, alone = (f[0] if f else None for f in fits)
        # a launch of many waves keeps one CTA a factor where its slab fits
        # alone, and a cluster of 2 alone rather than 8 in pairs: the cluster's
        # barriers cost more there than the overlap of two CTAs an SM gains
        if B * sizes[0] >= 2 * num_sms and alone is not None and (
                alone == sizes[0] or alone <= 2 and pair in (None, MAX_CLUSTER)):
            pair = alone
        cs = pair or alone
        if cs is not None:
            return plan(cs, -(-d // cs), 1)
    for cs in sizes:
        if need(-(-d // cs), 0, cs) <= smem_limit:
            return plan(cs, -(-d // cs), 0)
    cs = sizes[-1]
    for nc, mres, ws in ((nc, 1, False), (min(nc, nt), 1, False), (min(nc, nt), 0, False),
                         (min(nc, nt), 0, True)):
        if ws:  # the sums of a cluster of one: no CTA reads another's workspace
            if cluster not in (None, 1):
                raise ValueError(f"rank m={m} needs the workspace, and with it a cluster of one")
            cs = 1
        if need(1, 0, cs, ws) <= smem_limit:
            break
    else:
        raise ValueError(f"one row of X at rank m={m} does not fit in shared memory")
    rows = -(-d // cs)
    lo, hi = 1, rows  # the most rows that fit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if need(mid, 0, cs, ws) <= smem_limit else (lo, mid - 1)
    return plan(cs, -(-rows // -(-rows // lo)), 0, ws)  # equal tiles


def _shared_x_stride(asz: int, kw: int) -> int:
    """Row stride (values of the accumulation type) of a staged window of
    ``kw`` ranks of X (csrc: ``x_stride``)."""
    return kw + 4 if asz == 8 else (kw + 8 if kw % 16 == 0 else kw)


def _shared_run_bytes(n: int) -> int:
    """Bytes of a staged run of ``n`` bytes at any offset (csrc: ``run_bytes``)."""
    return _r16(n) + 16


def _shared_ci_staged(esz: int, F: int, m: int) -> int:
    """Whether the group's Ci is staged in shared memory for pass 2 (csrc:
    ``ci_staged``)."""
    return int(m > 0 and F * _shared_run_bytes(m * m * esz) <= 32768)


def _shared_kstep_split(W: int, m: int) -> int:
    """Warps that split a pair's k-steps in pass 1 (csrc: ``kstep_split``)."""
    return _WARPS // W if m > 0 and -(-m // 8) <= _S_RANK_TILES else 1


def _shared_layout(esz: int, asz: int, lo: int, W: int, F: int, R: int, m: int, kw: int,
                   ws: bool) -> int:
    """Bytes of the shared-x kernel's dynamic shared memory; mirrors
    ``SLayout`` in ``csrc/woodbury_shared.cu``. ``esz``/``asz``: bytes of the
    storage and the accumulation type; ``lo``: X keeps a TF32 lo part
    (accumulation in float32); ``W`` (factor, column tile) pairs of ``F``
    factors, ``R`` rows a chunk, ``kw`` ranks a window; ``ws``: t and s live
    in the workspace."""
    nc, mp, keep = _S_COL_TILE * W // F, 8 * -(-m // 8), int(m > 0)
    inner, one = keep * (1 - int(ws)), int(kw >= mp)
    conv = keep * (1 - one)
    run = _shared_run_bytes
    xrun = one * run(R * m * esz) + (1 - one) * R * run(kw * esz)
    ldx = _shared_x_stride(asz, kw)
    arrays = (  # two stages of each but t, s and the column sums
        32,  # four mbarriers
        2 * nc * (run(R * esz) + (16 if esz == 8 else 0)),  # x
        2 * 2 * F * run(R * esz),  # μ and a½
        keep * 2 * F * xrun,  # X's rows
        conv * 2 * F * R * ldx * asz,  # a window of X in the accumulation type
        conv * lo * 2 * F * R * ldx * asz,  # its TF32 lo parts
        2 * F * R * asz, 2 * F * R * asz,  # μ, 1/a½
        inner * _shared_kstep_split(W, m) * _S_COL_TILE * W * (mp + 1) * asz,  # Xᵀv (partials)
        inner * _S_COL_TILE * W * (mp + 4) * asz,  # Ci Xᵀv
        _WARPS * _S_COL_TILE * asz,  # pass-3 column sums a warp
        _shared_ci_staged(esz, F, m) * F * run(m * m * esz),  # the group's Ci
    )
    return sum(_r16(a) for a in arrays)


def _shared_workspace(W: int, m: int) -> int:
    """Values of the accumulation type one CTA's workspace slice holds (csrc:
    ``ws_values``)."""
    return _S_COL_TILE * W * (2 * 8 * -(-m // 8) + 5)


SharedPlan = collections.namedtuple("SharedPlan", "W F NC R kw ws smem")


@functools.lru_cache(maxsize=None)
def _shared_shape(m: int, dtype, smem_limit: int = SMEM_LIMIT) -> tuple:
    """``(W, R, kw, ws, limit)`` of the shared-x kernel at rank ``m`` in
    ``dtype``: what sets the order of its sums, and so depends on nothing
    else, and the shared memory its factor groups must keep to.

    ``W`` (factor, column tile) pairs a CTA and ``R`` rows a chunk (128 at
    rank 0, else 64 or 32): the first of (8, 64), (4, 64), (2, 64), (1, 64),
    (8, 32), (4, 32), (2, 32), (1, 32) whose layout, for some factor group,
    fits beside a second CTA on the SM, else the first that fits alone, with
    every rank of X staged at once (``kw`` the whole padded rank). Where
    none fits, one pair in chunks of 64 rows with X's ranks in windows of
    ``kw``, the widest that fit with t and s in shared memory, else with
    them in the workspace (``ws``)."""
    esz = torch.finfo(dtype).bits // 8
    asz = 8 if dtype == torch.float64 else 4
    lo = int(dtype != torch.float64)
    mp = 8 * -(-m // 8)

    def least(W, R, kw, ws):
        return min(_shared_layout(esz, asz, lo, W, 1 << f, R, m, kw, ws)
                   for f in range(W.bit_length()))

    shapes = [(8, 128)] if m == 0 else [(W, R) for R in (64, 32) for W in (8, 4, 2, 1)]
    for limit in (min(_SMEM_PAIR, smem_limit), smem_limit):
        for W, R in shapes:
            if least(W, R, mp, False) <= limit:
                return W, R, mp, False, limit
    for ws in (False, True):
        for kw in range(mp - 8, 7, -8):
            if least(1, 64, kw, ws) <= smem_limit:
                return 1, 64, kw, ws, smem_limit
    raise ValueError(f"one row of X at rank m={m} does not fit in shared memory")


def _shared_plan(B: int, d: int, m: int, P: int, dtype, smem_limit: int = SMEM_LIMIT) -> SharedPlan:
    """The plan of the shared-x kernel for ``B`` factors of ``d`` rows and
    rank ``m`` over an ``x`` of ``P`` columns in ``dtype``: the shape of
    :func:`_shared_shape`, and, of the factor groups ``F`` (of ``W`` pairs,
    so a column tile of ``NC = 16·W/F``) whose layout keeps to its limit,
    the one that moves the fewest bytes from L2, the group's rows of X, μ
    and a½ against the tile's columns of x, the factors and columns past B
    and P counted as moved."""
    if min(B, d, P) < 1 or m < 0 or dtype not in _DTYPE_CODES:
        raise ValueError(f"no launch plan for B={B}, d={d}, m={m}, P={P}, {dtype}")
    W, R, kw, ws, limit = _shared_shape(m, dtype, smem_limit)
    esz = torch.finfo(dtype).bits // 8
    asz = 8 if dtype == torch.float64 else 4
    kw = kw if m else 0

    def smem(F):
        return _shared_layout(esz, asz, int(dtype != torch.float64), W, F, R, m, kw, ws)

    def moved(F):
        nc = _S_COL_TILE * W // F
        return -(-B // F) * -(-P // nc) * (nc + F * (m + 2))

    F = min((1 << f for f in range(W.bit_length()) if smem(1 << f) <= limit), key=moved)
    return SharedPlan(W, F, _S_COL_TILE * W // F, R, kw, ws, smem(F))


def uses_fast_kernel(dtype, m: int) -> bool:
    """Whether B1, and B2 with a block of columns per factor, take the fast
    kernel on the card (float32 at rank ``m <= MAX_RANK``) or the general one
    (every other dtype or rank). B2 over a shared ``x`` takes the shared-x
    kernel whatever the dtype and rank."""
    return dtype == torch.float32 and m <= MAX_RANK


# -- bind and load ------------------------------------------------------------


def _bind_fast(fast) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fast.pf_sample_logq.argtypes = [p] * 8 + [i] * 8 + [p]
    fast.pf_sample_logq.restype = i
    fast.pf_sample_partial.argtypes = [p] * 4 + [i] * 8 + [p]
    fast.pf_sample_partial.restype = i
    fast.pf_sample_resume.argtypes = [p] * 10 + [i] * 9 + [p]
    fast.pf_sample_resume.restype = i
    fast.pf_whiten_sumsq.argtypes = [p] * 6 + [i] * 8 + [p]
    fast.pf_whiten_sumsq.restype = i
    fast.pf_whiten_partial.argtypes = [p] * 5 + [i] * 8 + [p]
    fast.pf_whiten_partial.restype = i
    fast.pf_whiten_resume.argtypes = [p] * 7 + [i] * 8 + [p]
    fast.pf_whiten_resume.restype = i
    fast.pf_max_rank.argtypes = []
    fast.pf_max_rank.restype = i
    if fast.pf_max_rank() != MAX_RANK:
        raise RuntimeError("kernel library and wrapper disagree on MAX_RANK")


def _bind_general(general) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    general.pfg_sample_logq.argtypes = [i] + [p] * 8 + [i] * 12 + [p, p]
    general.pfg_sample_logq.restype = i
    general.pfg_whiten_sumsq.argtypes = [i] + [p] * 6 + [i] * 12 + [p, p]
    general.pfg_whiten_sumsq.restype = i
    general.pfg_sample_partial.argtypes = [i] + [p] * 4 + [i] * 13 + [p, p]
    general.pfg_sample_partial.restype = i
    general.pfg_sample_resume.argtypes = [i] + [p] * 10 + [i] * 13 + [p, p]
    general.pfg_sample_resume.restype = i
    general.pfg_whiten_partial.argtypes = [i] + [p] * 5 + [i] * 13 + [p, p]
    general.pfg_whiten_partial.restype = i
    general.pfg_whiten_resume.argtypes = [i] + [p] * 7 + [i] * 13 + [p, p]
    general.pfg_whiten_resume.restype = i
    general.pfg_round.argtypes = []
    general.pfg_round.restype = i
    if general.pfg_round() != _R_ROUND:
        raise RuntimeError("general kernel library and wrapper disagree on the column rounds")


def _bind_shared(shared) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, pointers in (("pfs_whiten_sumsq", 6), ("pfs_whiten_sumsq_partial", 5),
                           ("pfs_whiten_sumsq_resume", 7)):
        getattr(shared, name).argtypes = [i] + [p] * pointers + [i] * 11 + [p, p]
        getattr(shared, name).restype = i
    for name in ("pfs_col_tile", "pfs_rank_tiles"):
        getattr(shared, name).argtypes = []
        getattr(shared, name).restype = i
    if (shared.pfs_col_tile(), shared.pfs_rank_tiles()) != (_S_COL_TILE, _S_RANK_TILES):
        raise RuntimeError("shared-x kernel library and wrapper disagree on the tiles")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build every kernel library of the package (one ``nvcc`` a source,
    started together) and load the three Woodbury kernels'; returns the
    fast kernel's."""
    load_general_library()
    load_shared_library()
    return _build.load(_SOURCE, _bind_fast)


@functools.cache
def load_general_library() -> ctypes.CDLL:
    """Build (with the package's other sources) and load the general
    kernel's library; returns it."""
    return _build.load(_GENERAL_SOURCE, _bind_general)


@functools.cache
def load_shared_library() -> ctypes.CDLL:
    """Build (with the package's other sources) and load the shared-x
    kernel's library; returns it."""
    return _build.load(_SHARED_SOURCE, _bind_shared)


def kernel_resources() -> dict:
    """Registers and spills of each fast-kernel instantiation as ``ptxas
    -v`` reported them at build time: ``{(name, MR, NT): {"registers": r,
    "spill_stores": bytes, "spill_loads": bytes}}``, ``name`` the mode's
    (B1, B2, B1's partial and resume, B2's)."""
    load_library()
    names = ("sample_and_logq", "whiten_sumsq", "sample_and_logq_partial", "sample_and_logq_resume",
             "whiten_sumsq_partial", "whiten_sumsq_resume")
    return _ptxas_resources(
        _build.log(_SOURCE), r"woodbury_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
        lambda mr, nt, mode: (names[int(mode)], int(mr), int(nt)))


# the storage types of the general kernel as the compiler mangles them
_MANGLED_DTYPES = {"f": "float32", "d": "float64", "6__half": "float16",
                   "13__nv_bfloat16": "bfloat16"}


_MANGLED = "(f|d|6__half|13__nv_bfloat16)"


def general_kernel_resources() -> dict:
    """The same for the general source: ``{(name, dtype, NT): {...}}`` with
    ``name`` ``sample_and_logq_general``, ``whiten_sumsq_general`` or one of
    their row-split modes (``factor_kernel``, NT its column tile) and ``dtype`` the storage dtype's
    name, ``float32 (float64 sums)`` for the instantiation float32 takes at
    m >= d."""
    load_general_library()
    names = ("sample_and_logq_general", "whiten_sumsq_general", "sample_and_logq_partial_general",
             "sample_and_logq_resume_general", "whiten_sumsq_partial_general",
             "whiten_sumsq_resume_general")

    def key(t, mode, nt, sums):
        wide = " (float64 sums)" if sums == "d" and t != "d" else ""
        return names[int(mode)], _MANGLED_DTYPES[t] + wide, int(nt)

    return _ptxas_resources(_build.log(_GENERAL_SOURCE),
                            rf"factor_kernelI{_MANGLED}Li(\d)ELi(\d)E(f|d)", key)


# the shared-x kernel's modes (csrc/woodbury_shared.cu: kRank0, kOne, kWin)
# and parts (kWhole, kPartial, kResume), the latter by their launch names
_SHARED_MODES = ("rank 0", "one window", "windows")
_SHARED_PARTS = ("whiten_sumsq_shared", "whiten_sumsq_shared_partial",
                 "whiten_sumsq_shared_resume")


def shared_kernel_resources() -> dict:
    """The same for the shared-x source: ``{(name, dtype, mode): {...}}``,
    one instantiation a part (``name``: the whole B2 or a row-split part),
    storage dtype and mode (``_SHARED_MODES``)."""
    load_shared_library()
    return _ptxas_resources(
        _build.log(_SHARED_SOURCE), rf"shared_kernelI{_MANGLED}Li(\d)ELi(\d)EE",
        lambda t, mode, part: (_SHARED_PARTS[int(part)], _MANGLED_DTYPES[t],
                               _SHARED_MODES[int(mode)]))


def _ptxas_resources(log: str, pattern: str, key_of) -> dict:
    out, key = {}, None
    for line in log.splitlines():
        found = re.search(pattern, line)
        if "Compiling entry function" in line:  # another function's lines belong to no key
            key = key_of(*found.groups()) if found else None
            if key is not None:
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
    """Each tensor on ``device``, of the first one's dtype (one the kernels
    take), of its shape and contiguous."""
    dtype = names_shapes[0][1].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernels take {tuple(_DTYPE_CODES)}, got {dtype}")
    for name, t, shape in names_shapes:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype} as the first argument")
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
    return batch, math.prod(batch), d, m, N


def _pointers(tensors):
    """Addresses of ``tensors``. A tensor without elements (``X`` and the
    core at m = 0) may have no address of its own; the kernels never read
    it and get a valid one."""
    return [t.data_ptr() or tensors[1].data_ptr() for t in tensors]


def _launch(name, entry, tensors, plan, device, B, d, m, N, extra=()):
    """Launch the fast kernel's ``entry`` with ``plan`` (:func:`_build.launch`);
    ``extra`` ints follow ``N``."""
    _build.launch(name, entry, *_pointers(tensors), B, d, m, N, *extra, *plan, device=device,
                  key=(B, m, N, False))


def _workspace(plan_ws, ctas, words, dtype, device):
    """The global workspace a plan asks for (``ctas`` slices of ``words``
    values of the accumulation type), else None."""
    if not plan_ws:
        return None
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.empty(ctas * words, dtype=acc, device=device)


def _launch_general(name, entry, tensors, device, B, d, m, N, plan=None, extra=()):
    """Launch the general source's ``entry`` (:func:`_build.launch`) as
    ``name + "_general"``; ``plan`` defaults to :func:`_general_rows_plan`,
    ``extra`` ints follow ``N``. The workspace, where the plan asks for one,
    is allocated here."""
    dtype = tensors[0].dtype
    plan = plan or _general_rows_plan(B, d, m, N, dtype, _num_sms(device.index))
    ctas = B * plan.cluster * min(-(-N // plan.colblk), 65535)
    work = _workspace(plan.ws, ctas, _rows_workspace(m, plan.nc, _rows_col_tile(N), plan.cluster),
                      dtype, device)
    _build.launch(name + "_general", entry, _DTYPE_CODES[dtype], *_pointers(tensors), B, d, m, N,
                  *extra, *tuple(plan)[:8], None if work is None else work.data_ptr(),
                  device=device, key=(B, m, N, False))


def _shared_ctas(plan: SharedPlan, B: int, P: int, num_sms: int) -> int:
    """The grid of the shared-x kernel's persistent loop: every (factor
    group, column tile) item a CTA, or, with a workspace, two CTAs an SM."""
    items = -(-B // plan.F) * -(-P // plan.NC)
    return min(items, 2 * num_sms) if plan.ws else items


def _launch_shared(entry, tensors, device, B, d, m, P, plan=None, name="whiten_sumsq_shared"):
    """Launch the shared-x kernel's ``entry`` (the whole B2 or a row-split
    part; :func:`_build.launch`) as ``name``; ``plan`` defaults to
    :func:`_shared_plan`."""
    dtype = tensors[0].dtype
    plan = plan or _shared_plan(B, d, m, P, dtype)
    ctas = _shared_ctas(plan, B, P, _num_sms(device.index))
    work = _workspace(plan.ws, ctas, _shared_workspace(plan.W, m), dtype, device)
    _build.launch(name, entry, _DTYPE_CODES[dtype], *_pointers(tensors), B, d, m, P, plan.W,
                  plan.F, plan.R, plan.kw, int(plan.ws), plan.smem, ctas,
                  None if work is None else work.data_ptr(), device=device, key=(B, m, P, True))


def sample_and_logq(u, a_half, X, C, mu, logdet):
    """B1: fused ``(x, logq)`` from standard-normal draws ``u (..., d, N)``."""
    if u.device.type == "cpu":
        return sample_and_logq_torch(u, a_half, X, C, mu, logdet)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _sample_and_logq_cuda(u, a_half, X, C, mu, logdet)


def _sample_and_logq_cuda(u, a_half, X, C, mu, logdet, general=None, plan=None):
    """B1 on the card: the fast kernel where :func:`uses_fast_kernel`, else
    the general one (``general=True`` takes the general kernel whatever the
    case; ``plan`` overrides its plan)."""
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
    tensors = (u, a_half, X, C, mu, logdet, x, logq)
    if general is None:
        general = not uses_fast_kernel(u.dtype, m)
    if general:
        _launch_general("sample_and_logq", load_general_library().pfg_sample_logq, tensors,
                        u.device, B, d, m, N, plan=plan)
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(u.device.index))
        _launch("sample_and_logq", load_library().pf_sample_logq, tensors, plan, u.device,
                B, d, m, N)
    return x, logq


def sample_and_logq_partial(u, X, d):
    """B1's partial on a block of rows ``u (..., d_r, N)``, ``X (..., d_r,
    m)``: ``(t (..., m, N), ‖u‖² (..., N))`` in the accumulation dtype.
    ``d`` is the full dimension: on the card it chooses the general
    kernel's instantiation, as the resume's ``d`` does."""
    if u.device.type == "cpu":
        return sample_and_logq_partial_torch(u, X)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _sample_and_logq_partial_cuda(u, X, d)


def _sample_and_logq_partial_cuda(u, X, d_full, general=None, plan=None):
    """B1's partial on the card, routed as :func:`_sample_and_logq_cuda`."""
    batch, B, d, m, N = _flat_shapes(u, X)
    _check_cuda_args([("u", u, batch + (d, N)), ("X", X, batch + (d, m))], u.device)
    acc = _acc_dtype(u.dtype)
    t = torch.empty(batch + (m, N), dtype=acc, device=u.device)
    usq = torch.empty(batch + (N,), dtype=acc, device=u.device)
    if B == 0 or N == 0:
        return t, usq
    tensors = (u, X, t, usq)
    if general is None:
        general = not uses_fast_kernel(u.dtype, m)
    if general:
        _launch_general("sample_and_logq_partial", load_general_library().pfg_sample_partial,
                        tensors, u.device, B, d, m, N, plan=plan, extra=(d_full,))
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(u.device.index))
        _launch("sample_and_logq_partial", load_library().pf_sample_partial, tensors, plan,
                u.device, B, d, m, N)
    return t, usq


def sample_and_logq_resume(u, a_half, X, C, mu, logdet, t, usq, d):
    """B1's resume on a block of rows from the summed ``t (..., m, N)`` and
    ``‖u‖² (..., N)`` (accumulation dtype) and the full dimension ``d``:
    ``(x (..., d_r, N), logq (..., N))``."""
    if u.device.type == "cpu":
        return sample_and_logq_resume_torch(u, a_half, X, C, mu, logdet, t, usq, d)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    return _sample_and_logq_resume_cuda(u, a_half, X, C, mu, logdet, t, usq, d)


def _sample_and_logq_resume_cuda(u, a_half, X, C, mu, logdet, t, usq, d_full, general=None,
                                 plan=None):
    """B1's resume on the card, routed as :func:`_sample_and_logq_cuda`."""
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
    _check_cuda_args([("t", t, batch + (m, N)), ("usq", usq, batch + (N,))], u.device)
    if t.dtype != _acc_dtype(u.dtype):
        raise TypeError(f"t and usq are {t.dtype}, expected {_acc_dtype(u.dtype)}")
    x = torch.empty_like(u)
    logq = torch.empty(batch + (N,), dtype=u.dtype, device=u.device)
    if B == 0 or N == 0:
        return x, logq
    tensors = (u, a_half, X, C, mu, logdet, t, usq, x, logq)
    if general is None:
        general = not uses_fast_kernel(u.dtype, m)
    if general:
        _launch_general("sample_and_logq_resume", load_general_library().pfg_sample_resume,
                        tensors, u.device, B, d, m, N, plan=plan, extra=(d_full,))
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(u.device.index))
        _launch("sample_and_logq_resume", load_library().pf_sample_resume, tensors, plan,
                u.device, B, d, m, N, extra=(d_full,))
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
    return _whiten_sumsq_cuda(x, a_half, X, Ci, mu)


def _whiten_sumsq_cuda(x, a_half, X, Ci, mu, general=None, plan=None):
    """B2 on the card, routed as :func:`_sample_and_logq_cuda` per factor;
    over a shared ``x`` on the shared-x kernel (``general`` is not read)."""
    if x.ndim == 2 and X.ndim > 2:
        return _whiten_sumsq_shared(x, a_half, X, Ci, mu, plan)
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
    tensors = (x, a_half, X, Ci, mu, maha)
    if general is None:
        general = not uses_fast_kernel(x.dtype, m)
    if general:
        _launch_general("whiten_sumsq", load_general_library().pfg_whiten_sumsq, tensors,
                        x.device, B, d, m, N, plan=plan)
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(x.device.index))
        _launch("whiten_sumsq", load_library().pf_whiten_sumsq, tensors, plan, x.device,
                B, d, m, N)
    return maha


def whiten_sumsq_partial(x, a_half, X, mu, d):
    """B2's partial on a block of rows ``x (..., d_r, N)``, ``X (..., d_r,
    m)``: ``t = Xᵀ v (..., m, N)`` in the accumulation dtype, ``v = (x −
    μ)/a½``. ``d`` is the full dimension: on the card it chooses the general
    kernel's instantiation, as the resume's ``d`` does."""
    if x.device.type == "cpu":
        return whiten_sumsq_partial_torch(x, a_half, X, mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _whiten_sumsq_partial_cuda(x, a_half, X, mu, d)


def _whiten_sumsq_partial_cuda(x, a_half, X, mu, d_full, general=None, plan=None):
    """B2's partial on the card, routed as :func:`_sample_and_logq_cuda`;
    over a shared ``x`` on the shared-x kernel. At rank 0 there is no ``t``
    to form, and nothing is launched."""
    if x.ndim == 2 and X.ndim > 2:
        return _whiten_sumsq_shared_partial(x, a_half, X, mu, plan)
    batch, B, d, m, N = _flat_shapes(x, X)
    _check_cuda_args([("x", x, batch + (d, N)), ("a_half", a_half, batch + (d,)),
                      ("X", X, batch + (d, m)), ("mu", mu, batch + (d,))], x.device)
    t = torch.empty(batch + (m, N), dtype=_acc_dtype(x.dtype), device=x.device)
    if B == 0 or N == 0 or m == 0:
        return t
    tensors = (x, a_half, X, mu, t)
    if general is None:
        general = not uses_fast_kernel(x.dtype, m)
    if general:
        _launch_general("whiten_sumsq_partial", load_general_library().pfg_whiten_partial,
                        tensors, x.device, B, d, m, N, plan=plan, extra=(d_full,))
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(x.device.index))
        _launch("whiten_sumsq_partial", load_library().pf_whiten_partial, tensors, plan,
                x.device, B, d, m, N)
    return t


def whiten_sumsq_resume(x, a_half, X, Ci, mu, t, d):
    """B2's resume on a block of rows from the summed ``t (..., m, N)``
    (accumulation dtype): the block's ``‖w‖² (..., N)``, ``w = v + X (Ci
    t)``, in the accumulation dtype, to be summed over the blocks. ``d`` is
    the full dimension."""
    if x.device.type == "cpu":
        return whiten_sumsq_resume_torch(x, a_half, X, Ci, mu, t)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _whiten_sumsq_resume_cuda(x, a_half, X, Ci, mu, t, d)


def _whiten_sumsq_resume_cuda(x, a_half, X, Ci, mu, t, d_full, general=None, plan=None):
    """B2's resume on the card, routed as :func:`_sample_and_logq_cuda`;
    over a shared ``x`` on the shared-x kernel."""
    if x.ndim == 2 and X.ndim > 2:
        return _whiten_sumsq_shared_resume(x, a_half, X, Ci, mu, t, plan)
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
    acc = _acc_dtype(x.dtype)
    _check_cuda_args([("t", t, batch + (m, N))], x.device)
    if t.dtype != acc:
        raise TypeError(f"t is {t.dtype}, expected {acc}")
    sumsq = torch.empty(batch + (N,), dtype=acc, device=x.device)
    if B == 0 or N == 0:
        return sumsq
    tensors = (x, a_half, X, Ci, mu, t, sumsq)
    if general is None:
        general = not uses_fast_kernel(x.dtype, m)
    if general:
        _launch_general("whiten_sumsq_resume", load_general_library().pfg_whiten_resume,
                        tensors, x.device, B, d, m, N, plan=plan, extra=(d_full,))
    else:
        plan = _launch_plan(B, d, m, N, _num_sms(x.device.index))
        _launch("whiten_sumsq_resume", load_library().pf_whiten_resume, tensors, plan,
                x.device, B, d, m, N)
    return sumsq


def _shared_shapes(x, a_half, X, mu, Ci=None):
    """``(batch, B, d, m, P, xt)`` of B2 over ``x (d, P)`` shared by the
    factors ``X (..., d, m)``, the arguments checked. The kernel reads ``x``
    in the ``(P, d)`` layout, a column's rows side by side: an ``x`` that is
    the transpose of a contiguous ``(P, d)`` block (pooled draws) goes in as
    it is, any other is transposed once."""
    batch = tuple(X.shape[:-2])
    d, m = X.shape[-2:]
    P = x.shape[1]
    if d == 0:
        raise ValueError("the kernels need d >= 1")
    xt = x.mT if x.mT.is_contiguous() else x.mT.contiguous()
    args = [("x (transposed)", xt, (P, d)), ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)), ("mu", mu, batch + (d,))]
    if Ci is not None:
        args.append(("Ci", Ci, batch + (m, m)))
    _check_cuda_args(args, x.device)
    return batch, math.prod(batch), d, m, P, xt


def _whiten_sumsq_shared(x, a_half, X, Ci, mu, plan=None):
    """B2 with ``x (d, P)`` shared by the factors ``X (..., d, m)``, on the
    shared-x kernel at every dtype and rank (``plan`` overrides its plan)."""
    batch, B, d, m, P, xt = _shared_shapes(x, a_half, X, mu, Ci)
    maha = torch.empty(batch + (P,), dtype=x.dtype, device=x.device)
    if B == 0 or P == 0:
        return maha
    _launch_shared(load_shared_library().pfs_whiten_sumsq, (xt, a_half, X, Ci, mu, maha), x.device,
                   B, d, m, P, plan)
    return maha


def _whiten_sumsq_shared_partial(x, a_half, X, mu, plan=None):
    """B2's partial over ``x (d_r, P)`` shared by the factors' blocks of rows
    ``X (..., d_r, m)``: ``t (..., m, P)`` in the accumulation dtype, the
    transpose of the ``(..., P, m)`` block the kernel writes. At rank 0
    nothing is launched."""
    batch, B, d, m, P, xt = _shared_shapes(x, a_half, X, mu)
    t = torch.empty(batch + (P, m), dtype=_acc_dtype(x.dtype), device=x.device)
    if B == 0 or P == 0 or m == 0:
        return t.mT
    _launch_shared(load_shared_library().pfs_whiten_sumsq_partial, (xt, a_half, X, mu, t), x.device,
                   B, d, m, P, plan, name="whiten_sumsq_shared_partial")
    return t.mT


def _whiten_sumsq_shared_resume(x, a_half, X, Ci, mu, t, plan=None):
    """B2's resume over a shared ``x (d_r, P)`` from the summed ``t (..., m,
    P)`` (accumulation dtype; read in the ``(..., P, m)`` layout, transposed
    once where it is not the transpose of a contiguous block): the block's
    ``‖w‖² (..., P)`` in the accumulation dtype."""
    batch, B, d, m, P, xt = _shared_shapes(x, a_half, X, mu, Ci)
    acc = _acc_dtype(x.dtype)
    tt = t.mT if t.mT.is_contiguous() else t.mT.contiguous()
    _check_cuda_args([("t (transposed)", tt, batch + (P, m))], x.device)
    if t.dtype != acc:
        raise TypeError(f"t is {t.dtype}, expected {acc}")
    sums = torch.empty(batch + (P,), dtype=acc, device=x.device)
    if B == 0 or P == 0:
        return sums
    _launch_shared(load_shared_library().pfs_whiten_sumsq_resume, (xt, a_half, X, Ci, mu, tt, sums),
                   x.device, B, d, m, P, plan, name="whiten_sumsq_shared_resume")
    return sums

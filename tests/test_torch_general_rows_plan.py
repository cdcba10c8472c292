"""The launch plan of the general kernel's per-factor modes (``factor_kernel``
in ``pathfinder_tpu_torch/csrc/woodbury_general.cu``: B1, and B2 with a
block of columns per factor), on the CPU: how a factor's rows are split over
a cluster and walked in tiles, how its columns go in rounds and blocks, the
shared memory at every dtype and rank, the workspace, and the Python mirror
of the source's layout and constants. The kernel itself runs only on the
card (``chip_smoke.py``, ``tools/woodbury_general_bench.py``)."""

import re

import pytest
import torch

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk

torch.set_num_threads(1)

DTYPES = (torch.float64, torch.float32, torch.bfloat16, torch.float16)
RANKS = (0, 1, 12, 40, 100, 258, 1000)
# (B, d, N): the general phase's shapes (ELBO chunk, odd-aligned, GLM width;
# PSIS), the float64 winners, config 2's, and a few edges
SHAPES = ((800, 1000, 5), (8, 999, 5), (128, 25, 5), (100, 1000, 10), (8, 999, 10),
          (100, 25, 10), (100, 1000, 5), (16, 100, 100), (1, 100, 2000), (3, 7, 3),
          (1, 1, 1), (65536, 1000, 5))


def _bytes(dtype):
    return torch.finfo(dtype).bits // 8, 8 if dtype == torch.float64 else 4


def _cta_rows(d, cs, rank):
    """Rows ``[r0, r1)`` of CTA ``rank`` of a cluster of ``cs`` (the kernel's split)."""
    per = -(-d // cs)
    r0 = min(d, rank * per)
    return r0, min(d, r0 + per)


def _check_plan(plan, B, d, m, N, dtype, smem_limit=wk.SMEM_LIMIT):
    esz, asz = _bytes(dtype)
    nt = wk._rows_col_tile(N)
    assert plan.cluster in (1, 2, 4, 8) and plan.threads == wk._G_THREADS
    assert 1 <= plan.nc <= min(N, wk._R_ROUND) and plan.nc <= plan.colblk <= N
    assert plan.whole in (0, 1) and (not plan.whole or plan.colblk == N)
    assert plan.mres in (0, 1) and (plan.mres or not plan.whole)
    assert plan.smem == wk._rows_layout(esz, asz, plan.tile, m, N, plan.nc, nt, plan.whole,
                                        plan.mres, plan.cluster, plan.ws) <= smem_limit
    # every row of the factor exactly once across the cluster, each CTA's
    # rows in equal tiles of at most `tile` rows
    seen = []
    for rank in range(plan.cluster):
        r0, r1 = _cta_rows(d, plan.cluster, rank)
        tiles = max(1, -(-(r1 - r0) // plan.tile))
        starts = [r0 + t * plan.tile for t in range(tiles)]
        for s in starts:
            seen.extend(range(s, min(r1, s + plan.tile)))
        if plan.whole:
            assert tiles == 1 and plan.tile == -(-d // plan.cluster)
    assert seen == list(range(d))
    # every column exactly once: blocks of colblk, rounds of nc within them
    cols = []
    for blk in range(-(-N // plan.colblk)):
        cend = min(N, (blk + 1) * plan.colblk)
        for c0 in range(blk * plan.colblk, cend, plan.nc):
            cols.extend(range(c0, min(cend, c0 + plan.nc)))
    assert cols == list(range(N))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m", RANKS)
def test_rows_plan_covers_every_row_and_keeps_to_the_card(dtype, m):
    for B, d, N in SHAPES:
        plan = wk._general_rows_plan(B, d, m, N, dtype)
        _check_plan(plan, B, d, m, N, dtype)
        esz, asz = _bytes(dtype)
        nt = wk._rows_col_tile(N)
        # M leaves shared memory, and then the sums do, only where one row
        # would not fit beside them
        if not plan.mres:
            assert wk._rows_layout(esz, asz, 1, m, N, plan.nc, nt, 0, 1, plan.cluster, False) > \
                wk.SMEM_LIMIT
        if plan.ws:
            assert wk._rows_layout(esz, asz, 1, m, N, plan.nc, nt, 0, 0, plan.cluster, False) > \
                wk.SMEM_LIMIT


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_cluster_size_splits_the_rows(cluster, dtype):
    for m in (0, 12, 258):
        for B, d, N in ((800, 1000, 5), (100, 1000, 10), (8, 999, 5), (4, 25, 10), (2, 3, 5)):
            plan = wk._general_rows_plan(B, d, m, N, dtype, cluster=cluster)
            assert plan.cluster == cluster
            _check_plan(plan, B, d, m, N, dtype)
    with pytest.raises(ValueError):
        wk._general_rows_plan(8, 1000, 12, 5, dtype, cluster=3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_cluster_fills_the_card(dtype):
    """B = 100 at d = 1000 splits each factor so that the card has at least
    one CTA an SM, and more where that leaves room for two CTAs an SM; B =
    800 (many waves) takes one CTA a factor where its slab fits, and else
    a cluster of 2 alone over 8 in pairs."""
    for m in (0, 12, 40, 100, 258):
        for N in (5, 10):
            plan = wk._general_rows_plan(100, 1000, m, N, dtype)
            assert 100 * plan.cluster >= wk.NUM_SMS
    plan = wk._general_rows_plan(800, 1000, 0, 5, dtype)
    assert plan.cluster == 1 and plan.whole == 1 and plan.smem <= wk._SMEM_PAIR
    assert wk._general_rows_plan(800, 1000, 12, 5, torch.float32).cluster == 1
    plan = wk._general_rows_plan(800, 1000, 12, 5, torch.float64)  # 152 KB: alone
    assert plan.cluster == 1 and wk._SMEM_PAIR < plan.smem <= wk.SMEM_LIMIT
    assert wk._general_rows_plan(800, 1000, 40, 5, torch.float64).cluster == 2
    assert wk._general_rows_plan(100, 1000, 12, 10, torch.float64).cluster == 2  # few waves: pairs
    # a factor below twice the row floor is not split for the sake of filling
    assert wk._general_rows_plan(16, 100, 40, 5, dtype).cluster == 1


@pytest.mark.parametrize("N", [5, 10])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_n5_and_n10_run_as_exact_column_counts(N, dtype):
    """The ELBO draws (N = 5) and the PSIS draws (N = 10) run as 5 and 10
    columns: one round, tiles of 5, no padded column in the sums or the slab."""
    esz, asz = _bytes(dtype)
    for m in (0, 12, 40, 258):
        plan = wk._general_rows_plan(100, 1000, m, N, dtype)
        assert plan.nc == plan.colblk == N
        assert 5 * -(-plan.nc // 5) == N  # the sums' width: no padding
        if plan.whole:  # the slab holds the rows' N columns and no more
            wider = wk._rows_layout(esz, asz, plan.tile, m, N + 1, plan.nc, 5, 1, 1, plan.cluster,
                                    False)
            assert wider - plan.smem <= wk._r16(esz * plan.tile) + 16


def test_few_factors_cut_their_columns_into_blocks():
    """Config 2: too few factors for the card: the columns are cut into
    blocks of whole column tiles, one round each, about one CTA an SM (the
    width a block rounded up to whole tiles); u is staged a block at a time."""
    for B, N, width, blocks in ((16, 100, 15, 7), (1, 2000, 20, 100), (1, 1900, 15, 127),
                                (8, 125, 10, 13), (50, 7, 4, 2)):
        plan = wk._general_rows_plan(B, 100, 40, N, torch.float32)
        assert (plan.nc, plan.colblk, plan.whole) == (width, width, 0)
        assert width % wk._rows_col_tile(N) == 0 and -(-N // plan.colblk) == blocks
    # with enough factors for the card, all columns stay with one cluster,
    # walked in rounds of 40 over the resident slab
    plan = wk._general_rows_plan(800, 25, 12, 125, torch.float64)
    assert (plan.nc, plan.colblk, plan.whole) == (40, 125, 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rows_too_large_for_one_cta_are_tiled(dtype):
    """Where not even a cluster of 8 holds a CTA's rows of X, the rows are
    walked in equal tiles (X read twice)."""
    plan = wk._general_rows_plan(800, 1000, 258, 5, dtype)
    if dtype == torch.float64:  # 125 rows × 258 × 8 B = 258 KB a CTA: 3 tiles of 42
        assert (plan.cluster, plan.whole, plan.tile) == (8, 0, 42)
    else:
        assert (plan.cluster, plan.whole, plan.tile) == (8, 1, 125)
    plan = wk._general_rows_plan(4, 20000, 100, 5, dtype)
    assert plan.cluster == 8 and plan.tile < 2500 and 2500 % plan.tile <= plan.tile
    _check_plan(plan, 4, 20000, 100, 5, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_rank_that_cannot_fit_raises(dtype):
    with pytest.raises(ValueError, match="does not fit"):
        wk._general_rows_plan(4, 10, 120000, 5, dtype)
    for args in ((0, 10, 4, 5), (1, 0, 4, 5), (1, 10, -1, 5), (1, 10, 4, 0)):
        with pytest.raises(ValueError):
            wk._general_rows_plan(*args, dtype)


def test_a_small_limit_narrows_the_round_then_uses_the_workspace():
    plan = wk._general_rows_plan(4, 999, 1000, 5, torch.float32, smem_limit=16384)
    assert plan.ws and plan.whole == 0 and plan.smem <= 16384 and plan.tile >= 1
    assert plan.cluster == 1  # no CTA reads another's workspace
    with pytest.raises(ValueError, match="cluster of one"):
        wk._general_rows_plan(4, 999, 1000, 5, torch.float32, smem_limit=16384, cluster=2)
    _check_plan(plan, 4, 999, 1000, 5, torch.float32, smem_limit=16384)
    # N = 40 at rank 300: the round narrows to one column tile before the workspace
    plan = wk._general_rows_plan(4, 999, 300, 40, torch.float32, smem_limit=49152)
    assert plan.nc == 5 and not plan.ws
    # tl, tg, s (1000 × 5 each) and this CTA's 125 rows of s (625 values,
    # rounded up to 4), in a cluster of 8
    assert wk._rows_workspace(1000, 5, 5, 8) == 3 * 5000 + 628
    # with row parts: m = 4, one column tile: a partial set a warp, 8 of
    # 4 × 5 sums, beside tl and s
    assert wk._rows_workspace(4, 5, 5, 1) == 4 * 5 * (2 + 8)
    # 65 rank tiles × 2 column tiles: 256 slots, one row part (tl itself)
    assert wk._rows_workspace(258, 10, 5, 1) == 260 * 10 * 2


def _source_rows_layout(esz, asz, tile, m, N, nc, nt, whole, mres, cs, ws):
    """Evaluate ``RLayout`` of the general source for one plan."""
    src = wk._GENERAL_SOURCE.read_text()
    body = re.search(r"struct RLayout \{(.*?)\n\};", src, re.S).group(1)
    terms = re.findall(r"o \+= r16\((.*?)\);", body)
    assert len(terms) == 13
    ks = wk._rows_s_rows(m, cs)
    env = dict(esz=esz, asz=asz, tile=tile, m=m, N=N, nc=nc, whole=whole, mres=mres, cs=cs,
               al=16 // esz, split=int(ks < m),
               mr=4 * -(-m // 4), ncp=nt * -(-nc // nt), ks=ks,
               parts=wk._rows_parts(m, nc, nt), keep=1 - int(ws), kWarps=wk._WARPS)
    return sum(wk._r16(eval(t, {}, env)) for t in terms)


@pytest.mark.parametrize("m", [0, 1, 4, 12, 40, 65, 258])
def test_rows_layout_mirrors_the_cuda_source(m):
    for esz, asz in ((8, 8), (4, 4), (2, 4)):
        for tile in (1, 25, 500):
            for N, nc, whole in ((5, 5, 1), (10, 10, 0), (100, 40, 0), (3, 3, 1)):
                for cs, mres in ((1, 1), (8, 1), (8, 0)):
                    for ws in (False, True):
                        nt = wk._rows_col_tile(N)
                        args = (esz, asz, tile, m, N, nc, nt, whole, mres, cs, ws)
                        assert wk._rows_layout(*args) == _source_rows_layout(*args)


def test_rows_constants_and_helpers_mirror_the_cuda_source():
    src = wk._GENERAL_SOURCE.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] == wk._G_THREADS and consts["kRound"] == wk._R_ROUND
    assert consts["kRK"] == wk._R_RK and consts["kMaxCluster"] == wk.MAX_CLUSTER
    assert consts["kMaxSmem"] == wk.SMEM_LIMIT
    assert "constexpr int kWarps = kThreads / 32;" in src and wk._WARPS == 256 // 32
    # the helpers the layout and the workspace are made of
    assert "const int pairs = rank_pad(m) / kRK * ((nc + nt - 1) / nt);" in src
    assert "while (l < pairs && l < kThreads) l *= 2;" in src
    assert "return l <= 32 ? kWarps : kThreads / l;" in src
    assert ("return mr * ncp * (2 + (parts > 1) * parts + (cs > 1)) + "
            "split * ((ks * ncp + 3) & ~3);") in src
    assert "return cs > 1 && m > kSplitM ? (m + cs - 1) / cs : m;" in src
    assert consts["kSplitM"] == wk._R_SPLIT_M
    for m, cs, ks in ((12, 1, 12), (12, 8, 12), (64, 2, 64), (65, 2, 33), (258, 8, 33)):
        assert wk._rows_s_rows(m, cs) == ks
    assert "return N % 5 == 0 ? 5 : 4;" in src
    for N, nt in ((5, 5), (10, 5), (100, 5), (2000, 5), (3, 4), (7, 4), (1, 4)):
        assert wk._rows_col_tile(N) == nt
    for m, nc, nt, slots, parts in ((0, 5, 5, 1, 8), (4, 5, 5, 1, 8), (12, 5, 5, 4, 8),
                                    (12, 10, 5, 8, 8), (40, 5, 5, 16, 8), (100, 5, 5, 32, 8),
                                    (128, 5, 5, 32, 8), (40, 40, 5, 128, 2),
                                    (258, 5, 5, 128, 2), (258, 10, 5, 256, 1),
                                    (1000, 5, 5, 256, 1)):
        assert (wk._rows_slots(m, nc, nt), wk._rows_parts(m, nc, nt)) == (slots, parts)
    # the launch's argument order: the plan's fields as the entry points take them
    assert re.search(r"int pfg_sample_logq\(.*?int cluster, int threads, int tile, int nc, "
                     r"int colblk, int whole,\s+int mres, int smem, void\* ws", src, re.S)
    assert wk.RowsPlan._fields[:8] == ("cluster", "threads", "tile", "nc", "colblk", "whole",
                                       "mres", "smem")


class _FakeStream:
    cuda_stream = 0


def test_the_wrapper_passes_the_rows_plan_to_the_entry_point(monkeypatch):
    """``_launch_general`` hands ``factor_kernel``'s entry point the dtype
    code, the pointers, the shape, the plan's fields in the source's order,
    the workspace (where the plan asks for one) and the stream, and counts
    the launch; ``_launch_shared`` hands the shared-x kernel's entry point
    its plan and grid the same way."""
    import contextlib

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _FakeStream())
    monkeypatch.setattr(wk, "_num_sms", lambda index: wk.NUM_SMS)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    B, d, m, N = 3, 50, 12, 10
    t = [torch.zeros(B, d, N, dtype=torch.float64), torch.ones(B, d, dtype=torch.float64)]
    tensors = t + [torch.zeros(B, d, m, dtype=torch.float64), torch.zeros(B, m, m, dtype=torch.float64),
                   torch.zeros(B, d, dtype=torch.float64), torch.zeros(B, dtype=torch.float64),
                   torch.zeros(B, d, N, dtype=torch.float64), torch.zeros(B, N, dtype=torch.float64)]
    wk.reset_launch_counts()
    wk._launch_general("sample_and_logq", entry, tensors, torch.device("cpu"), B, d, m, N)
    plan = wk._general_rows_plan(B, d, m, N, torch.float64)
    args = calls[-1]
    assert args[0] == wk._DTYPE_CODES[torch.float64] and len(args) == 1 + 8 + 4 + 8 + 2
    assert args[9:13] == (B, d, m, N) and args[13:21] == tuple(plan)[:8]
    assert args[21] is None and args[22] == 0
    # a plan with the workspace: a pointer to it
    ws_plan = wk._general_rows_plan(B, d, 1000, N, torch.float64, smem_limit=16384)
    assert ws_plan.ws
    tensors[2], tensors[3] = torch.zeros(B, d, 1000, dtype=torch.float64), torch.zeros(
        B, 1000, 1000, dtype=torch.float64)
    wk._launch_general("sample_and_logq", entry, tensors, torch.device("cpu"), B, d, 1000, N,
                       plan=ws_plan)
    assert isinstance(calls[-1][21], int) and calls[-1][13:21] == tuple(ws_plan)[:8]
    # B2 over a shared x: the shared-x kernel's plan and its grid
    tensors[2], tensors[3] = torch.zeros(B, d, m, dtype=torch.float64), torch.zeros(
        B, m, m, dtype=torch.float64)
    wk._launch_shared(entry, tensors[:5] + [tensors[7]], torch.device("cpu"), B, d, m, N)
    plan = wk._shared_plan(B, d, m, N, torch.float64)
    args = calls[-1]
    assert args[0] == wk._DTYPE_CODES[torch.float64] and len(args) == 1 + 6 + 4 + 6 + 1 + 2
    assert args[7:11] == (B, d, m, N) and args[11:17] == (plan.W, plan.F, plan.R, plan.kw,
                                                         int(plan.ws), plan.smem)
    assert args[17] == wk._shared_ctas(plan, B, N, wk.NUM_SMS) and args[18] is None
    assert wk.launch_counts()["sample_and_logq_general"] == 2
    assert wk.launch_counts()["whiten_sumsq_general"] == 0
    assert wk.launch_counts_by_shape()["whiten_sumsq_shared"] == {(B, m, N, True): 1}
    wk.reset_launch_counts()

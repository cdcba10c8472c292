"""The launch plan of kernels B1 and B2 (sample+logq, whiten+sumsq).

The kernels run only on the card, but how a launch is cut into clusters,
threads and row tiles is decided in Python (``_launch_plan``) and checked
by the kernel against its own shared-memory layout, so it is held here: on
a grid of shapes every plan covers each row once, keeps to Hopper's limits
and tiles the rows exactly where a CTA's rows do not fit; the plan over
(factor, column tile) of B2 with a shared x covers each column once as
well. The Python mirror of the layout is held against the CUDA source
itself.
"""

import math
import re

import pytest

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk

DS = (1, 7, 999, 1000, 4096, 10000)
NS = (1, 3, 5, 10, 33)


def _covered_once(d, cluster):
    rows = [wk._cta_rows(d, cluster, r) for r in range(cluster)]
    assert rows[0][0] == 0 and rows[-1][1] == d
    for (a0, a1), (b0, b1) in zip(rows, rows[1:]):
        assert a0 <= a1 == b0 <= b1
    return max(r1 - r0 for r0, r1 in rows)


@pytest.mark.parametrize("B", [1, 100, 800])
@pytest.mark.parametrize("m", [1, 7, 12, 32])
def test_plan_covers_rows_and_keeps_to_hopper_limits(B, m):
    mr = wk._rank_tile(m)
    for d in DS:
        for N in NS:
            cluster, threads, smem, tile = wk._launch_plan(B, d, m, N)
            assert cluster in (1, 2, 4, 8)
            assert threads <= 256 and threads % (32 * (mr // 4)) == 0
            assert smem <= wk.SMEM_LIMIT
            assert smem == wk._smem_bytes(tile, m, N, threads)
            rows = _covered_once(d, cluster)
            assert rows == -(-d // cluster)
            fits = wk._smem_bytes(rows, m, N, threads) <= wk.SMEM_LIMIT
            # tiled exactly when a CTA's rows do not fit, and only then at
            # the largest cluster
            assert (tile == rows) == fits
            if not fits:
                assert cluster == wk.MAX_CLUSTER
                assert 1 <= tile < rows
                assert wk._smem_bytes(tile, m, N, threads) <= wk.SMEM_LIMIT


def test_plan_fills_the_card_at_the_main_path_shapes():
    # an ELBO chunk of 800 factors needs no cluster; the 100-factor launches
    # split each factor in two so that all 132 SMs get a CTA
    assert wk._launch_plan(800, 1000, 12, 5)[0] == 1
    assert wk._launch_plan(100, 1000, 12, 5)[0] == 2
    assert wk._launch_plan(100, 1000, 12, 10)[0] == 2
    for B, N in ((800, 5), (100, 5), (100, 10)):
        cluster, _, _, tile = wk._launch_plan(B, 1000, 12, N)
        assert tile == -(-1000 // cluster)  # one resident tile: each byte read once


@pytest.mark.parametrize("B", [1, 3, 100])
@pytest.mark.parametrize("m", [0, 7, 12, 32])
def test_shared_x_plan_covers_rows_and_columns_once(B, m):
    for d in DS + (20000, 30000):
        for P in (1, 3, 50, 77, 1000):
            cluster, threads, smem, tile, width = wk._launch_plan_shared(B, d, m, P)
            assert cluster in (1, 2, 4, 8) and threads == wk._threads(m)
            assert smem <= wk.SMEM_LIMIT
            assert smem == wk._smem_bytes(tile, m, width, threads, True)
            # column tiles [c·width, min(P, (c+1)·width)) cover 0..P once
            assert 1 <= width <= P
            ntiles = -(-P // width)
            assert (ntiles - 1) * width < P <= ntiles * width <= 65535 * width
            # a tile is a multiple of the kernel's 5-column step, or all of x
            assert width % 5 == 0 or width == P
            rows = _covered_once(d, cluster)
            fits = wk._smem_bytes(rows, m, min(5, P), threads, True) <= wk.SMEM_LIMIT
            assert (tile == rows) == fits
            if not fits:
                assert cluster == wk.MAX_CLUSTER and 1 <= tile < rows
                assert width == min(5, P)
                # row tiles [t·tile, ...) cover a CTA's rows
                assert -(-rows // tile) * tile >= rows


def test_shared_x_plan_at_the_mixture_shape():
    """The headline mixture grid: a factor's 1000 rows and a 10-column tile
    of x take less than half an SM's shared memory, so two CTAs share an SM
    and one loads while the other computes (a 40-column tile would fit, but
    alone); no row is staged twice. A wide factor splits over the cluster
    before its tile narrows."""
    assert wk._launch_plan_shared(100, 1000, 12, 1000) == (1, 192, 99696, 1000, 10)
    assert 2 * (99696 + 1024) <= 233472 < 2 * (wk._smem_bytes(1000, 12, 20, 192, True) + 1024)
    assert wk._launch_plan_shared(100, 1000, 0, 1000) == (1, 256, 92704, 1000, 20)
    assert wk._launch_plan_shared(100, 1000, 32, 1000)[3:] == (1000, 20)  # fits only alone
    cluster, _, _, tile, width = wk._launch_plan_shared(4, 20000, 12, 64)
    assert (cluster, tile, width) == (8, 2500, 5)
    # few factors and few columns: the cluster grows to fill the card
    assert wk._launch_plan_shared(3, 999, 7, 77)[0] == 8
    for args in ((0, 10, 4, 5), (1, 0, 4, 5), (1, 10, 33, 5), (1, 10, 4, 0)):
        with pytest.raises(ValueError):
            wk._launch_plan_shared(*args)


def test_plan_rejects_what_the_kernel_cannot_take():
    for args in ((0, 10, 4, 5), (1, 0, 4, 5), (1, 10, 33, 5), (1, 10, 4, 0)):
        with pytest.raises(ValueError):
            wk._launch_plan(*args)
    with pytest.raises(ValueError, match="do not fit"):
        wk._launch_plan(1, 10, 4, 100_000)


def _source_layout_bytes(tile, m, N, threads, shared=False):
    """Evaluate the ``Layout`` of the CUDA source for one plan."""
    src = wk._SOURCE.read_text()
    body = re.search(r"struct Layout \{(.*?)\n\};", src, re.S).group(1)
    start = int(re.search(r"int o = (\d+);", body).group(1))
    terms = re.findall(r"o \+= round4\((.*?)\);", body)
    assert len(terms) == 11
    mr = wk._rank_tile(m)
    env = dict(tile=tile, m=m, N=N, mr=mr, warps=threads // 32, cm=int(shared),
               parts=threads // 32 // (mr // 4), nc=min(N, wk._CHUNK), round4=wk._round4)
    return 4 * (start + sum(wk._round4(eval(t, {}, env)) for t in terms))


@pytest.mark.parametrize("m", [0, 1, 7, 12, 20, 32])
def test_python_layout_mirrors_the_cuda_source(m):
    threads = wk._threads(m)
    for tile in (1, 42, 500, 1250):
        for N in NS:
            assert wk._smem_bytes(tile, m, N, threads) == _source_layout_bytes(tile, m, N, threads)
            assert wk._smem_bytes(tile, m, N, threads, True) == _source_layout_bytes(
                tile, m, N, threads, shared=True)


def test_source_constants_agree_with_the_wrapper():
    src = wk._SOURCE.read_text()
    assert int(re.search(r"kMaxRank = (\d+);", src).group(1)) == wk.MAX_RANK
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == wk._CHUNK
    assert int(re.search(r"kMaxCluster = (\d+);", src).group(1)) == wk.MAX_CLUSTER
    assert int(re.search(r"kMaxSmem = (\d+);", src).group(1)) == wk.SMEM_LIMIT
    # cta_threads(mr) = 8·mr·row_parts(mr) with row_parts = max(1, 32 / mr)
    for m in range(0, 33):
        mr = wk._rank_tile(m)
        assert wk._threads(m) == 8 * mr * max(1, 32 // mr)
        assert math.gcd(wk._threads(m), 32) == 32


# the constrained models' shapes: d below the rank m = 12, below a warp's 32
# lanes and below the row split's floor of 64, and N = ndraws / nruns = 125
SMALL = [(8, 25, 12, 125), (8, 7, 12, 125), (8, 2, 12, 125), (100, 25, 12, 10), (8, 8, 12, 125),
         (1, 1, 12, 125), (4, 7, 0, 125), (8, 25, 12, 126)]


@pytest.mark.parametrize("B,d,m,N", SMALL)
def test_plan_at_the_small_model_shapes(B, d, m, N):
    """A factor with fewer rows than ``_MIN_ROWS`` is never split (no CTA
    without rows), its rows are one resident tile, and N = 125 columns are
    walked in rounds of ``_CHUNK``: 40, 40, 40 and 5, with exact 5-column
    tiles since 125 is a multiple of 5."""
    cluster, threads, smem, tile = wk._launch_plan(B, d, m, N)
    assert (cluster, tile) == (1, d) and threads == wk._threads(m)
    assert smem == wk._smem_bytes(d, m, N, threads) == _source_layout_bytes(d, m, N, threads)
    assert smem <= wk._SMEM_PAIR  # two CTAs an SM
    rounds = [min(wk._CHUNK, N - c0) for c0 in range(0, N, wk._CHUNK)]
    assert sum(rounds) == N and max(rounds) <= wk._CHUNK
    if N == 125:
        assert rounds == [40, 40, 40, 5]
    # the slab of all N columns grows with tile · N and nothing else does
    assert smem - wk._smem_bytes(d, m, 5, threads) >= 4 * (d * (N - 5) - 3) - 4 * 2000


@pytest.mark.parametrize("B,d,m,P", [(8, 25, 12, 1000), (8, 7, 12, 1000), (8, 2, 12, 1000),
                                     (8, 25, 0, 1000), (100, 25, 12, 1000), (1, 3, 12, 7)])
def test_shared_x_plan_at_the_small_model_shapes(B, d, m, P):
    """The mixture denominator of a small model: no cluster, the widest
    column tile, every column's run of d floats in its own round4(d) + 4
    floats (an unaligned run of 7 or 25 floats has at most 3 + 3 edge floats,
    which may be all of it)."""
    cluster, threads, smem, tile, width = wk._launch_plan_shared(B, d, m, P)
    assert (cluster, tile, width) == (1, d, min(40, P))
    assert smem == _source_layout_bytes(d, m, width, threads, shared=True)
    assert smem <= wk._SMEM_PAIR
    for pad in range(4):  # a column that starts pad floats past 16 bytes fits its slot
        assert pad + d <= wk._round4(d) + 4
        head = min((4 - pad) & 3, d)
        body = (d - head) & ~3
        assert head <= 3 and d - head - body <= 3 and head + body <= d

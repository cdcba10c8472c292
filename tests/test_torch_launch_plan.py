"""The launch plans of kernels B1 and B2 (sample+logq, whiten+sumsq).

The kernels run only on the card, but how a launch is cut into clusters,
threads and row tiles is decided in Python (``_launch_plan``) and checked
by the kernel against its own shared-memory layout, so it is held here: on
a grid of shapes every plan covers each row once, keeps to Hopper's limits
and tiles the rows exactly where a CTA's rows do not fit. The plan of B2
over a shared x (``_shared_plan``, the shared-x kernel) covers every
factor, column and row once, keeps to the card, and takes the shape that
sets its sums' order from the rank and dtype alone. The Python mirrors of
the layouts are held against the CUDA sources themselves.
"""

import math
import re

import pytest
import torch

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


SHARED_DTYPES = (torch.float64, torch.float32, torch.bfloat16, torch.float16)
SHARED_RANKS = (0, 1, 7, 12, 32, 40, 100, 258)


@pytest.mark.parametrize("dtype", SHARED_DTYPES, ids=str)
@pytest.mark.parametrize("m", SHARED_RANKS)
def test_shared_x_plan_covers_rows_and_columns_once(dtype, m):
    """On a grid of d, P and B: the factor groups cover 0..B and the column
    tiles 0..P once each, the chunks of R rows cover d and the rank windows
    the padded rank; the pairs a CTA fill its 8 warps' pair slots (F·NC =
    16·W), the layout keeps to the card, and what sets the order of the sums
    (W, R, kw, ws) is the same for every d, P and B."""
    shapes = set()
    for d in (2, 7, 25, 999, 1000, 20000, 30000):
        for P in (7, 77, 1000, 5120):
            for B in (1, 3, 100):
                plan = wk._shared_plan(B, d, m, P, dtype)
                shapes.add((plan.W, plan.R, plan.kw, plan.ws))
                assert plan.W in (1, 2, 4, 8) and plan.F in (1, 2, 4, 8) and plan.F <= plan.W
                assert plan.F * plan.NC == 16 * plan.W and plan.NC % 16 == 0
                groups, tiles = -(-B // plan.F), -(-P // plan.NC)
                assert (groups - 1) * plan.F < B <= groups * plan.F
                assert (tiles - 1) * plan.NC < P <= tiles * plan.NC
                chunks = -(-d // plan.R)
                assert (chunks - 1) * plan.R < d <= chunks * plan.R
                assert plan.R == (128 if m == 0 else plan.R) and plan.R in (32, 64, 128)
                mp = 8 * -(-m // 8)
                if m == 0:
                    assert plan.kw == 0 and not plan.ws
                else:
                    assert 8 <= plan.kw <= mp and plan.kw % 8 == 0
                    windows = -(-mp // plan.kw)
                    assert (windows - 1) * plan.kw < mp <= windows * plan.kw
                assert 0 < plan.smem <= wk.SMEM_LIMIT
                assert plan.smem == wk._shared_layout(
                    torch.finfo(dtype).bits // 8, 8 if dtype == torch.float64 else 4,
                    int(dtype != torch.float64), plan.W, plan.F, plan.R, m, plan.kw, plan.ws)
                ctas = wk._shared_ctas(plan, B, P, wk.NUM_SMS)
                assert 1 <= ctas <= groups * tiles
    assert len(shapes) == 1, shapes


def test_shared_x_plan_at_the_mixture_shape():
    """The headline mixture grid (100 factors of d = 1000 at rank 12 against
    1000 pooled draws): 8 pairs a CTA of 4 factors and 32 columns, in chunks
    of 64 rows, beside a second CTA on the SM; rank 0 takes 8 factors of 16
    columns in chunks of 128 rows; the serving-scale launch keeps the
    headline's shape, on a grid of 40960 CTAs (no 65535 limit: the grid is
    one-dimensional)."""
    plan = wk._shared_plan(100, 1000, 12, 1000, torch.float32)
    assert plan[:6] == (8, 4, 32, 64, 16, False) and plan.smem <= wk._SMEM_PAIR
    assert wk._shared_ctas(plan, 100, 1000, wk.NUM_SMS) == 25 * 32
    zero = wk._shared_plan(100, 1000, 0, 1000, torch.float32)
    assert zero[:6] == (8, 8, 16, 128, 0, False)
    serve = wk._shared_plan(1024, 1000, 12, 5120, torch.float32)
    assert serve[:6] == plan[:6] and wk._shared_ctas(serve, 1024, 5120, wk.NUM_SMS) == 40960
    for args in ((0, 10, 4, 5), (1, 0, 4, 5), (1, 10, -1, 5), (1, 10, 4, 0)):
        with pytest.raises(ValueError):
            wk._shared_plan(*args, torch.float32)
    with pytest.raises(ValueError):
        wk._shared_plan(2, 10, 4, 5, torch.int32)


def test_plan_rejects_what_the_kernel_cannot_take():
    for args in ((0, 10, 4, 5), (1, 0, 4, 5), (1, 10, 33, 5), (1, 10, 4, 0)):
        with pytest.raises(ValueError):
            wk._launch_plan(*args)
    with pytest.raises(ValueError, match="do not fit"):
        wk._launch_plan(1, 10, 4, 100_000)


def _source_layout_bytes(tile, m, N, threads):
    """Evaluate the ``Layout`` of the CUDA source for one plan."""
    src = wk._SOURCE.read_text()
    body = re.search(r"struct Layout \{(.*?)\n\};", src, re.S).group(1)
    start = int(re.search(r"int o = (\d+);", body).group(1))
    terms = re.findall(r"o \+= round4\((.*?)\);", body)
    assert len(terms) == 11
    mr = wk._rank_tile(m)
    env = dict(tile=tile, m=m, N=N, mr=mr, warps=threads // 32,
               parts=threads // 32 // (mr // 4), nc=min(N, wk._CHUNK), round4=wk._round4)
    return 4 * (start + sum(wk._round4(eval(t, {}, env)) for t in terms))


@pytest.mark.parametrize("m", [0, 1, 7, 12, 20, 32])
def test_python_layout_mirrors_the_cuda_source(m):
    threads = wk._threads(m)
    for tile in (1, 42, 500, 1250):
        for N in NS:
            assert wk._smem_bytes(tile, m, N, threads) == _source_layout_bytes(tile, m, N, threads)


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
    """The mixture denominator of a small model takes the headline's shape
    for its rank (what sets the sums' order does not follow d), one chunk of
    rows, and room for a second CTA on the SM; a column's run of d values,
    copied as the 16-byte blocks that hold it at any offset, fits its slot
    in the chunk of R rows."""
    plan = wk._shared_plan(B, d, m, P, torch.float32)
    assert plan[:4] == wk._shared_plan(100, 1000, m, 1000, torch.float32)[:4]
    assert -(-d // plan.R) == 1 and plan.smem <= wk._SMEM_PAIR
    for pad in range(4):  # a run starting pad floats past 16 bytes
        blocks = -(-(4 * pad + 4 * d) // 16)
        assert 16 * blocks <= wk._shared_run_bytes(4 * plan.R)

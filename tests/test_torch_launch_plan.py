"""The launch plan of kernels B1 and B2 (sample+logq, whiten+sumsq).

The kernels run only on the card, but how a launch is cut into clusters,
threads and row tiles is decided in Python (``_launch_plan``) and checked
by the kernel against its own shared-memory layout, so it is held here: on
a grid of shapes every plan covers each row once, keeps to Hopper's limits
and tiles the rows exactly where a CTA's rows do not fit. The Python
mirror of the layout is held against the CUDA source itself.
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
               parts=threads // 32 // (mr // 4), nc=min(N, wk._CHUNK))
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

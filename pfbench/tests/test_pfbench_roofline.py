"""The frozen roofline arithmetic counts what ``chip_smoke.bound_us``
counts at the cells' shapes, and runs the operations at the card's highest
dense rate at the storage precision."""

import pytest

import chip_smoke
from pfharness import roofline

# (function, B, d, m, N): the cells' launches (K=100 and K=8192, d=1000, m=12)
SHAPES = [("b1", 800, 1000, 12, 5), ("b1", 100, 1000, 12, 5), ("b1", 100, 1000, 12, 10),
          ("b2", 100, 1000, 12, 10), ("b1", 65536, 1000, 12, 5), ("b1", 8192, 1000, 12, 5),
          ("b2", 8192, 1000, 12, 5), ("b1", 256, 25, 12, 5), ("b2", 32, 25, 12, 32),
          ("b1", 2000, 1000, 12, 5), ("b2", 250, 1000, 12, 10)]


@pytest.mark.parametrize("fn,B,d,m,N", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_counts_reproduce_chip_smoke(fn, B, d, m, N, itemsize):
    name = "sample_and_logq" if fn == "b1" else "whiten_sumsq"
    values, ops = roofline.work(fn, B, d, m, N)
    t_bytes = itemsize * values / chip_smoke.HBM_BYTES_PER_S
    rate = chip_smoke.F64_FLOPS_PER_S if itemsize == 8 else chip_smoke.F32_FLOPS_PER_S
    assert chip_smoke.bound_us(name, B, d, m, N, itemsize=itemsize)[0] == pytest.approx(
        1e6 * max(t_bytes, ops / rate), rel=1e-12)
    t, kind = roofline.least_seconds(fn, B, d, m, N, itemsize=itemsize)
    assert t == pytest.approx(max(t_bytes, ops / roofline.OPS_PER_S[itemsize]), rel=1e-12)
    assert kind in ("bytes", "operations")


def test_shared_x_is_read_once():
    a, ops = roofline.work("b2_shared", 100, 1000, 12, 1000, shared=True)
    b = roofline.work("b2", 100, 1000, 12, 1000)[0]
    assert b - a == 99 * 1000 * 1000
    want = max(4 * a / chip_smoke.HBM_BYTES_PER_S, ops / chip_smoke.F32_FLOPS_PER_S)
    assert chip_smoke.bound_us("whiten_sumsq", 100, 1000, 12, 1000, shared=True)[0] == \
        pytest.approx(1e6 * want, rel=1e-12)


def test_peaks_are_the_data_sheets():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.OPS_PER_S[4] == 494.7e12 and roofline.OPS_PER_S[8] == 67e12

"""The least time of a Woodbury kernel's work on one NVIDIA H100 SXM, from
its launch shape, whatever implements it.

The bytes are a frozen copy of ``chip_smoke.bound_us``'s count: each input
read once and each output written once. The operations are counted from the
shapes as there, and run at the card's highest dense rate at the storage
precision (NVIDIA's data sheet, 700 W): TF32 tensor cores for float32, FP64
tensor cores for float64, the 16-bit tensor cores for 16-bit values, so that
no implementation can read over 100%.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {8: 67e12, 4: 494.7e12, 2: 989.4e12}  # by bytes a value


def work(function: str, B: int, d: int, m: int, N: int, shared: bool = False):
    """``(values read + written, operations)`` of one launch. ``function``:
    ``"b1"`` (sample and logq of ``N`` draws per factor) or ``"b2"`` /
    ``"b2_shared"`` (whiten and sum the squares of ``N`` columns per factor,
    or of an ``x`` of ``N`` columns shared by all ``B`` factors)."""
    sample = function == "b1"
    x_values = d * N if shared else B * d * N
    reads = x_values + B * (d * m + 2 * d + m * m) + (B if sample else 0)
    writes = B * N + (B * d * N if sample else 0)
    ops = B * N * (4 * d * m + 2 * m * m + 6 * d)
    return reads + writes, ops


def least_seconds(function: str, B: int, d: int, m: int, N: int, shared: bool = False,
                  itemsize: int = 4):
    """``(seconds, "bytes" or "operations")``: the longer of the two bounds."""
    values, ops = work(function, B, d, m, N, shared)
    t_bytes = itemsize * values / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S[itemsize]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

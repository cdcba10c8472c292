"""The arithmetic of the shared-x kernel (``csrc/woodbury_shared.cu``), emulated
in plain torch on float32 bits, against the float64 plain version.

The kernel computes B2 over a shared x on the tensor cores with 3xTF32: each
operand split as ``hi = tf32(a)`` (round to nearest, ties away from zero, as
``cvt.rna`` does) and ``lo = a − hi`` (which the tensor cores read as TF32,
its low 13 bits dropped), the products summed as ``lo·hi + hi·lo + hi·hi``.
The tensor cores sum an MMA's eight products and its accumulator exactly
and round the result toward zero to float32: this emulation takes that as
their rounding. Pass 1 (``t = Xᵀ v``, 125 k-steps at d = 1000) starts each
k-step's three products from zero and adds them to the sums in float32,
rounding to nearest; pass 3 (``X s``, a few k-steps over the ranks) chains
them. This shows on the CPU that the split and that order hold the float32
sum tolerance (rtol = atol = 1e-4) at a small mixture shape and where draws
lie 30 sd out along a factor's widest direction, and that one TF32 product,
or pass 1 chained over all its k-steps, does not hold it there.
"""

import numpy as np
import pytest
import torch

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat

torch.set_num_threads(1)

SUM_TOL = 1e-4  # rtol = atol on the Mahalanobis sums, as chip_smoke.py holds the kernel


def _tf32(a: torch.Tensor, rna: bool = True) -> torch.Tensor:
    """float32 ``a`` with its low 13 mantissa bits dropped: rounded to
    nearest with ties away from zero (``cvt.rna.tf32.f32``: add half of the
    dropped range to the magnitude's bits, then clear them), or truncated."""
    bits = a.contiguous().view(torch.int32)
    if rna:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _rz(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` rounded toward zero to float32."""
    f = v.to(torch.float32)
    over = f.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _mma3(c, a, b, single=False):
    """One k-step's products a (n, 8) · b (8, p) into c (float32), as the
    kernel issues them: three MMAs lo·hi, hi·lo, hi·hi (one, hi·hi of
    tf32-rounded operands, with ``single``), each summing exactly and
    rounding toward zero."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if single:
        return _rz(c.double() + a_hi.double() @ b_hi.double())
    a_lo, b_lo = _tf32(a - a_hi, rna=False), _tf32(b - b_hi, rna=False)
    for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
        c = _rz(c.double() + x.double() @ y.double())
    return c


def _emulated(x, a_half, X, Ci, mu, *, single=False, chained=False):
    """The kernel's B2 over a shared x ``(d, P)`` for factor 0, in float32."""
    d, P = x.shape
    m = X.shape[-1]
    mp = 8 * -(-m // 8)
    x, a, X, Ci, mu = x, a_half[0], X[0], Ci[0], mu[0]
    ra = 1 / a
    # pass 1: A = x − μ (columns × rows), B = X's rows scaled by 1/a½
    A = (x - mu[:, None]).T
    Bs = torch.zeros(d + 7 & ~7, mp, dtype=torch.float32)
    Bs[:d, :m] = X * ra[:, None]
    A = torch.cat([A, torch.zeros(P, Bs.shape[0] - d)], dim=1)
    t = torch.zeros(P, mp, dtype=torch.float32)
    for k0 in range(0, Bs.shape[0], 8):
        a_k, b_k = A[:, k0:k0 + 8], Bs[k0:k0 + 8]
        if chained:
            t = _mma3(t, a_k, b_k, single)
        else:
            t = t + _mma3(torch.zeros_like(t), a_k, b_k, single)
    # pass 2: s = Ci t in float32, Ci's columns in order
    s = torch.zeros(P, mp, dtype=torch.float32)
    for l in range(m):
        s[:, :m] = torch.addcmul(s[:, :m], t[:, l:l + 1], Ci[:, l][None, :])
    # pass 3: (X s)ᵀ over the rank k-steps, chained; w = (x − μ)·(1/a½) + X s
    Xp = torch.zeros(d, mp, dtype=torch.float32)
    Xp[:, :m] = X
    xs = torch.zeros(P, d, dtype=torch.float32)
    for k0 in range(0, mp, 8):
        xs = _mma3(xs, s[:, k0:k0 + 8], Xp[:, k0:k0 + 8].T, single)
    w = torch.addcmul(xs, (x - mu[:, None]).T, ra[None, :])
    return (w * w).sum(dim=1)


def _random_factors(rng, B, d, m):
    """Random Woodbury parts in float32 as chip_smoke.py draws them."""
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (t(rng.uniform(0.5, 1.5, (B, d))), t(rng.standard_normal((B, d, m)) / np.sqrt(d)),
            t(0.1 * rng.standard_normal((B, m, m))), t(rng.standard_normal((B, d))))


def _far_out(d=1000, m=12, P=48):
    """A real Woodbury factor (the port's ``WoodburyPDMat``) with one
    direction 100 of its other sds wide, and P draws 30 of that direction's
    sds out along it, in float32."""
    g = torch.Generator().manual_seed(30)
    f64 = dict(dtype=torch.float64)
    A = 0.5 + torch.rand((1, d), generator=g, **f64)
    Bm = torch.randn((1, d, m), generator=g, **f64) / d**0.5
    wide = torch.ones((1, m), **f64)
    wide[:, 0] = 1e4
    F = WoodburyPDMat.from_parts(A, Bm, torch.diag_embed(wide)).factor
    mu = torch.randn((1, d), generator=g, **f64)
    u = Bm[0, :, 0] / Bm[0, :, 0].norm()
    proj = Bm[0].mT @ u
    sd = torch.sqrt((A[0] * u * u).sum() + (proj * wide[0] * proj).sum())
    noise = A[0].sqrt()[:, None] * torch.randn((d, P), generator=g, **f64)
    x = mu[0, :, None] + 30.0 * sd * u[:, None] + noise
    return tuple(t.float() for t in (x, F.a_half, F.X, F.Ci, mu))


def _case(name):
    if name == "far-out":
        return _far_out()
    rng = np.random.default_rng(7)
    a_half, X, Ci, mu = _random_factors(rng, 1, 200, 12)
    x = torch.tensor(rng.standard_normal((200, 32)), dtype=torch.float32)
    return x, a_half, X, Ci, mu


def _excess(got, args):
    """How far ``got`` lies past rtol = atol = SUM_TOL from the float64
    plain version (negative: inside)."""
    want = wk.whiten_sumsq_torch(*(a.double() for a in args))[0]
    return float(((got.double() - want).abs() - SUM_TOL * (1 + want.abs())).max())


@pytest.mark.parametrize("name", ["mixture", "far-out"])
def test_three_tf32_products_hold_the_sum_tolerance(name):
    args = _case(name)
    assert _excess(_emulated(*args), args) < 0


def test_one_tf32_product_breaks_the_tolerance_far_out():
    args = _case("far-out")
    assert _excess(_emulated(*args, single=True), args) > 0


def test_pass_one_chained_over_all_its_k_steps_breaks_the_tolerance_far_out():
    """The tensor cores' rounding toward zero, compounded over the 125
    k-steps of one accumulator, moves the far-out case past the tolerance;
    a fresh accumulator a k-step (the kernel's order) keeps it inside."""
    args = _case("far-out")
    assert _excess(_emulated(*args, chained=True), args) > 0
    assert _excess(_emulated(*args), args) < 0


def test_tf32_rounding_is_to_nearest_with_ties_away_from_zero():
    ulp = 2.0**-10  # of a TF32 value in [1, 2)
    a = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2**-23, -(1 + ulp / 2), 1 + 3 * ulp / 2, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32(a), want)
    assert torch.equal(_tf32(a, rna=False), torch.tensor([1.0, 1.0, -1.0, 1 + ulp, 3.0]))

"""The arithmetic the reference runs in: float64 for the reference itself,
and for the control the nearest precision below the one a configuration
states: float32 (TF32 off) below float64, TF32 below float32.

TF32 keeps 10 of float32's 23 mantissa bits in the inputs of a product and
accumulates in float32. ``Prec("tf32")`` rounds both operands of every
product to it (round to nearest, as ``cvt.rna.tf32.f32`` does) and
multiplies in float32, so that it gives the same numbers on the CPU and on
the card. Every inner product of the reference goes through :meth:`Prec.mm`
or :meth:`Prec.dot`.
"""

from __future__ import annotations

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa; the gradient
    passes through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach()


class Prec:
    """``"f64"``: float64 throughout. ``"f32"``: float32 throughout.
    ``"tf32"``: float32 storage, products of TF32-rounded operands."""

    BELOW = {"float64": "f32", "float32": "tf32"}  # the control's, by the stated dtype

    def __init__(self, name: str):
        if name not in ("f64", "f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "f64" else torch.float32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Inner product over the last axis, batched over the others."""
        return self.mm(a[..., None, :], b[..., :, None])[..., 0, 0]

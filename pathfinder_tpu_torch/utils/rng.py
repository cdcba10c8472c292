"""Counter-based random streams (Philox4x32-10 + Box-Muller) in plain torch.

The JAX package derives every key by ``fold_in(key, path_id, round, ...)``,
so a path's draws never depend on how paths are batched. This module keeps
that contract with a stateless generator: every number is a pure function of
the tuple ``(seed, path, round, purpose, candidate)`` and its position in the
stream. It cannot reproduce threefry's bits; parity tests inject the JAX
package's noise instead.

Philox4x32-10 (Salmon et al., SC'11) is written with int64 tensor ops only.
The 32×32→64 multiply is split into 16-bit halves so no intermediate leaves
the int64 range, which keeps the results identical on every device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

__all__ = ["Stream", "INIT", "ELBO", "EXTRA", "RESAMPLE", "RESAMPLE_FRESH"]

# purposes: the fourth element of the stream tuple
INIT = 1  # initial points
ELBO = 2  # per-candidate ELBO draws (replayed for the winner)
EXTRA = 3  # a path's draws beyond the ELBO ones, and a failed path's draws
RESAMPLE = 4  # importance resampling of the pooled draws
RESAMPLE_FRESH = 5  # fresh per-component draws in resample()

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF

IntLike = Union[int, torch.Tensor]


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit words of ``a * m`` for uint32 values held in int64."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    mid = al * mh + ah * ml  # < 2^33
    lo_full = al * ml + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = (ah * mh + (mid >> 16) + (lo_full >> 32)) & _MASK32
    return hi, lo_full & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Ten Philox rounds on uint32 counter words held in int64 tensors."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _as_long(v: IntLike, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class Stream:
    """One random stream per element of the broadcast batch of
    ``(path, round, candidate)``; ``seed`` and ``purpose`` are shared.

    ``uniform(n)`` / ``normal(n)`` return ``(*batch, n)``: element ``e`` of a
    stream is the same number whatever ``n`` and whatever the batch holds.
    """

    seed: int
    path: IntLike
    round: IntLike
    purpose: int
    candidate: IntLike = 0

    def _words(self, nblocks: int, device) -> torch.Tensor:
        path = _as_long(self.path, device)
        rnd = _as_long(self.round, device)
        cand = _as_long(self.candidate, device)
        batch = torch.broadcast_shapes(path.shape, rnd.shape, cand.shape)
        shape = batch + (nblocks,)
        c0 = torch.arange(nblocks, dtype=torch.int64, device=device).expand(shape)
        c1 = (cand & _MASK32)[..., None].expand(shape)
        c2 = (((rnd << 8) | self.purpose) & _MASK32)[..., None].expand(shape)
        c3 = (path & _MASK32)[..., None].expand(shape)
        seed = int(self.seed) & 0xFFFFFFFFFFFFFFFF
        words = philox4x32(c0, c1, c2, c3, seed & _MASK32, seed >> 32)
        return torch.stack(words, dim=-1).reshape(batch + (4 * nblocks,))

    def uniform(self, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """``(*batch, n)`` uniforms in the open interval (0, 1)."""
        words = self._words(-(-n // 4), device)[..., :n]
        u = (words.to(torch.float64) + 0.5) * 2.0**-32
        return u.to(dtype)

    def normal(self, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """``(*batch, n)`` standard normals by Box-Muller on word pairs."""
        npairs = -(-n // 2)
        words = self._words(-(-npairs // 2), device)[..., : 2 * npairs]
        u = (words.to(torch.float64) + 0.5) * 2.0**-32
        u1, u2 = u[..., 0::2], u[..., 1::2]
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u2
        z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
        return z.reshape(z.shape[:-2] + (2 * npairs,))[..., :n].to(dtype)

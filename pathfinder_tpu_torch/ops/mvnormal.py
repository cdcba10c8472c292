"""Multivariate normals with Woodbury covariance, and uniform mixtures
(counterpart of ``pathfinder_tpu/ops/mvnormal.py``), batched over leading dims.

Sampling goes through kernel B1 and the log density through kernel B2
(``ops/kernels/woodbury_kernels.py``): the kernel on a CUDA tensor, the plain
torch version on a CPU tensor. A covariance with a dense ``A`` takes the
plain torch route of ``ops/woodbury.py`` on every device, in a row group
too; the kernels are written for a diagonal ``A``. Draws are ``(..., n, N)``
column blocks, as in the JAX package. Every sampler takes a
:class:`~pathfinder_tpu_torch.utils.rng.Stream` for its noise, or the noise
itself as ``u=`` (tests inject the JAX package's draws this way).

Under a row group (``utils/rows.py``, the mesh's ``dim`` axis) a normal
holds a member's rows: ``dim`` is still the full dimension, a stream gives
the member its rows of the unsplit noise, and B1 runs split: its partial
``(Xᵀu, ‖u‖²)`` on the member's rows, summed over the members, then its
resume on them. The log density of a per-factor ``x`` runs B2 split the same
way: its partial ``Xᵀv`` on the member's rows, summed, then its resume,
whose ``‖w‖²`` on the member's rows is summed too; a 2-D ``x`` shared by
batched normals (the mixture denominator) on the shared-x kernel's two
split parts. A mixture's draws take each member's rows of each draw's
unsplit noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pathfinder_tpu_torch.utils.misc import tree_map
from pathfinder_tpu_torch.ops.kernels.woodbury_kernels import (
    sample_and_logq,
    sample_and_logq_partial,
    sample_and_logq_resume,
    whiten_sumsq,
    whiten_sumsq_partial,
    whiten_sumsq_resume,
)
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.utils import rows
from pathfinder_tpu_torch.utils.rng import Stream

__all__ = ["MvNormal", "UniformMixture", "fit_mvnormal"]

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MvNormal:
    """N(μ, Σ) with ``Σ`` a :class:`WoodburyPDMat`; ``mean (..., n)``."""

    mean: torch.Tensor
    cov: WoodburyPDMat

    @property
    def dim(self) -> int:
        return rows.full_dim(self.mean.shape[-1])

    @property
    def dtype(self):
        return self.mean.dtype

    def _noise(self, stream: Optional[Stream], ndraws, u):
        if u is not None:
            return u.to(self.dtype).contiguous()
        n = self.mean.shape[-1]  # a row group's member draws its rows of the (dim, ndraws) block
        z = stream.normal(n * ndraws, self.dtype, self.mean.device, start=rows.row_offset() * ndraws)
        return z.reshape(z.shape[:-1] + (n, ndraws))

    def _kernel_args(self):
        F = self.cov.factor
        return F.a_half.contiguous(), F.X.contiguous(), self.mean.contiguous()

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log density of the columns of ``x (..., n, N)``: ``(..., N)``. A
        2-D ``x (n, P)`` beside batched normals is shared by all of them
        and is not copied per normal: ``(..., P)``."""
        F = self.cov.factor
        batch = F.X.shape[:-2]
        if not F.diag_A:
            maha = self.cov.invquad(x - self.mean[..., None])
            return -0.5 * (self.dim * _LOG_2PI + F.log_det[..., None] + maha)
        a_half, X, mean = self._kernel_args()
        shared = x.ndim == 2 and bool(batch)
        if not shared:
            x = x.expand(batch + x.shape[-2:]).contiguous()
        if rows.in_group():
            if shared:  # in the shared-x kernel's (P, d_r) layout once, for both launches
                x = x.mT.contiguous().mT
            t = rows.sum_rows(whiten_sumsq_partial(x, a_half, X, mean, self.dim))
            maha = rows.sum_rows(whiten_sumsq_resume(x, a_half, X, F.Ci.contiguous(), mean, t,
                                                     self.dim)).to(self.dtype)
        else:
            maha = whiten_sumsq(x, a_half, X, F.Ci.contiguous(), mean)
        return -0.5 * (self.dim * _LOG_2PI + F.log_det[..., None] + maha)

    def rand_and_logpdf(
        self, stream: Optional[Stream] = None, ndraws: Optional[int] = None,
        *, u: Optional[torch.Tensor] = None,
    ):
        """``(x (..., n, ndraws), logq (..., ndraws))`` with ``x = L u + μ``
        and logq from the already-drawn ``‖u‖²``: no second solve."""
        F = self.cov.factor
        u = self._noise(stream, ndraws, u)
        if not F.diag_A:
            x = self.cov.unwhiten(u) + self.mean[..., None]
            usq = rows.sum_rows(torch.sum(u * u, dim=-2))
            return x, -0.5 * (self.dim * _LOG_2PI + F.log_det[..., None] + usq)
        a_half, X, mean = self._kernel_args()
        if rows.in_group():
            t, usq = rows.sum_rows(*sample_and_logq_partial(u, X, self.dim))
            return sample_and_logq_resume(u, a_half, X, F.C.contiguous(), mean,
                                          F.log_det.contiguous(), t, usq, self.dim)
        return sample_and_logq(
            u, a_half, X, F.C.contiguous(), mean, F.log_det.contiguous()
        )

    def sample(
        self, stream: Optional[Stream] = None, ndraws: Optional[int] = None,
        *, u: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``(..., n, ndraws)`` draws ``x = L u + μ``."""
        return self.rand_and_logpdf(stream, ndraws, u=u)[0]

    def entropy(self) -> torch.Tensor:
        return 0.5 * (self.dim * (_LOG_2PI + 1.0) + self.cov.logdet())


def fit_mvnormal(theta, grad_logp, cov: WoodburyPDMat) -> MvNormal:
    """One normal per trajectory point: μ = θ + Σ ∇logp(θ), Σ = H."""
    mu = theta + cov.mul(grad_logp[..., None])[..., 0]
    return MvNormal(mu, cov)


@dataclasses.dataclass(frozen=True)
class UniformMixture:
    """Uniformly weighted mixture of ``K`` normals stored stacked:
    ``components`` is an :class:`MvNormal` with a leading ``K`` axis."""

    components: MvNormal

    @property
    def ncomponents(self) -> int:
        return self.components.mean.shape[0]

    @property
    def dim(self) -> int:
        return rows.full_dim(self.components.mean.shape[1])

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Mixture log density of the columns of ``x (n, N)``:
        ``logsumexp_k logpdf_k(x) − log K``."""
        per_comp = self.components.logpdf(x)  # (K, N)
        return torch.logsumexp(per_comp, dim=0) - math.log(self.ncomponents)

    def component(self, k) -> MvNormal:
        """Component ``k``, or the stacked components ``k`` of an index
        tensor."""
        return tree_map(lambda t: t[k], self.components)

    def sample(self, stream: Stream, ndraws: int):
        """``(draws (n, ndraws), component_ids (ndraws,))`` from the mixture:
        a uniform component per draw, then one draw from it. The ids come
        from ``stream`` and the noise from its candidate 1: draw ``j`` takes
        elements ``[j·n, (j+1)·n)``. In a row group each member draws the
        whole ``(ndraws, n)`` noise and keeps its rows of each draw (one
        stream call; a call for each draw's rows would cost a Philox launch
        sequence each)."""
        dev = self.components.mean.device
        K = self.ncomponents
        ks = (stream.uniform(ndraws, torch.float64, dev) * K).long().clamp_(max=K - 1)
        noise = dataclasses.replace(stream, candidate=1)
        n_r, off = self.components.mean.shape[1], rows.row_offset()
        u = noise.normal(ndraws * self.dim, self.components.dtype, dev).reshape(ndraws, self.dim)
        draws = self.component(ks).sample(u=u[:, off:off + n_r, None])
        return draws[..., 0].mT, ks

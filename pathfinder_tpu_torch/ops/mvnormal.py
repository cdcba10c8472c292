"""Multivariate normals with Woodbury covariance, and uniform mixtures
(counterpart of ``pathfinder_tpu/ops/mvnormal.py``), batched over leading dims.

Sampling goes through kernel B1 and the log density through kernel B2
(``ops/kernels/woodbury_kernels.py``): the kernel on a CUDA tensor, the plain
torch version on a CPU tensor. Draws are ``(..., n, N)`` column blocks, as in
the JAX package. Every sampler takes a :class:`~pathfinder_tpu_torch.utils.
rng.Stream` for its noise, or the noise itself as ``u=`` (tests inject the
JAX package's draws this way).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pathfinder_tpu_torch.ops.kernels.woodbury_kernels import (
    sample_and_logq,
    whiten_sumsq,
)
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
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
        return self.mean.shape[-1]

    @property
    def dtype(self):
        return self.mean.dtype

    def _noise(self, stream: Optional[Stream], ndraws, u):
        if u is not None:
            return u.to(self.dtype).contiguous()
        z = stream.normal(self.dim * ndraws, self.dtype, self.mean.device)
        return z.reshape(z.shape[:-1] + (self.dim, ndraws))

    def _kernel_args(self):
        F = self.cov.factor
        return F.a_half.contiguous(), F.X.contiguous(), self.mean.contiguous()

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log density of the columns of ``x (..., n, N)``: ``(..., N)``."""
        F = self.cov.factor
        a_half, X, mean = self._kernel_args()
        shape = F.X.shape[:-2] + x.shape[-2:]
        maha = whiten_sumsq(
            x.expand(shape).contiguous(), a_half, X, F.Ci.contiguous(), mean
        )
        return -0.5 * (self.dim * _LOG_2PI + F.log_det[..., None] + maha)

    def rand_and_logpdf(
        self, stream: Optional[Stream] = None, ndraws: Optional[int] = None,
        *, u: Optional[torch.Tensor] = None,
    ):
        """``(x (..., n, ndraws), logq (..., ndraws))`` with ``x = L u + μ``
        and logq from the already-drawn ``‖u‖²``: no second solve."""
        F = self.cov.factor
        a_half, X, mean = self._kernel_args()
        return sample_and_logq(
            self._noise(stream, ndraws, u), a_half, X, F.C.contiguous(), mean,
            F.log_det.contiguous(),
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
        return self.components.mean.shape[1]

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Mixture log density of the columns of ``x (n, N)``:
        ``logsumexp_k logpdf_k(x) − log K``."""
        per_comp = self.components.logpdf(x)  # (K, N)
        return torch.logsumexp(per_comp, dim=0) - math.log(self.ncomponents)

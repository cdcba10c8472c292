"""Low-rank-plus-diagonal ("Woodbury") PD matrices, batched over leading dims.

Counterpart of ``pathfinder_tpu/ops/woodbury.py``, restricted to what the
main path uses: diagonal ``A`` and ``method="chol"`` (the L-BFGS H₀ is always
diagonal). The factorization is the same QR-free square root

    W = A + B D Bᵀ = L Lᵀ,   L = A½ (I + X C Xᵀ),   X = A^{-1/2} B,

with the small ``m×m`` cores ``C`` (for ``L``) and ``Ci`` (for ``L⁻¹``) from
a ridge-regularized Cholesky of the Gram matrix ``XᵀX``.

Shapes: ``A (..., n)``, ``B (..., n, m)``, ``D (..., m, m)``; vectors are
passed as column blocks ``x (..., n, N)``.

``torch.linalg.cholesky`` raises on a non-PD matrix where JAX returns NaNs,
and downstream logic (``is_finite_pd``, the success predicate, the NaN-
skipping ELBO argmax) depends on the NaNs. So every Cholesky here is
``cholesky_ex`` with NaN written where ``info != 0``, which also avoids a
host sync on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["WoodburyFactor", "WoodburyPDMat", "pdfactorize", "cholesky_or_nan"]


def cholesky_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all-NaN for matrices that are not PD."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _solve_lower(L, B):
    """``L⁻¹ B`` for lower-triangular ``L``."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def _solve_lower_t(L, B):
    """``L⁻ᵀ B`` for lower-triangular ``L`` (``trans=1`` in SciPy terms)."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


@dataclasses.dataclass(frozen=True)
class WoodburyFactor:
    """Square-root factor ``W = L Lᵀ`` with ``L = A½ (I + X C Xᵀ)``."""

    a_half: torch.Tensor  # (..., n) sqrt(diag A)
    X: torch.Tensor  # (..., n, m) A^{-1/2} B, masked columns zeroed
    C: torch.Tensor  # (..., m, m) core of L
    Ci: torch.Tensor  # (..., m, m) core of L⁻¹
    log_det: torch.Tensor  # (...) log det W

    def _core(self, M, x):
        # x + X (M (Xᵀ x))
        return x + self.X @ (M @ (self.X.mT @ x))

    def L_mul(self, x):
        """``L x``."""
        return self.a_half[..., None] * self._core(self.C, x)

    def Lt_mul(self, x):
        """``Lᵀ x``."""
        return self._core(self.C.mT, self.a_half[..., None] * x)

    def L_solve(self, x):
        """``L⁻¹ x``."""
        return self._core(self.Ci, x / self.a_half[..., None])

    def Lt_solve(self, x):
        """``L⁻ᵀ x``."""
        return self._core(self.Ci.mT, x) / self.a_half[..., None]

    def mul(self, x):
        """``W x = L (Lᵀ x)``."""
        return self.L_mul(self.Lt_mul(x))

    def solve(self, x):
        """``W⁻¹ x = L⁻ᵀ (L⁻¹ x)``."""
        return self.Lt_solve(self.L_solve(x))


def _apply_mask(B, D, col_mask):
    """Zero the masked columns of ``B`` and rows/columns of ``D``."""
    if col_mask is None:
        return B, D
    cm = col_mask.to(B.dtype)
    return B * cm[..., None, :], D * cm[..., :, None] * cm[..., None, :]


def _check_diag_parts(A, B, D):
    if B.ndim < 2 or D.shape[-2:] != (B.shape[-1],) * 2:
        raise ValueError(
            f"B must be (..., n, m) and D (..., m, m); got B {tuple(B.shape)}, "
            f"D {tuple(D.shape)}"
        )
    if A.shape != B.shape[:-1]:
        if A.shape == B.shape[:-2] + (B.shape[-2],) * 2:
            raise NotImplementedError(
                "dense A is not ported yet; pass diag(A) with shape (..., n)"
            )
        raise ValueError(
            f"A must be (..., n) matching B {tuple(B.shape)}; got {tuple(A.shape)}"
        )


def pdfactorize(
    A: torch.Tensor,
    B: torch.Tensor,
    D: torch.Tensor,
    col_mask: Optional[torch.Tensor] = None,
    method: str = "chol",
) -> WoodburyFactor:
    """Factorize ``W = diag(A) + B D Bᵀ`` by the ridge-regularized Cholesky
    of the Gram matrix (the JAX package's ``method="chol"``).

    ``col_mask (..., m)`` marks active columns of ``B``; masked columns are
    treated as absent. Rank-deficient directions (masked columns, m > n,
    duplicated history) lie in the null space of ``X``, so the ridge's effect
    on the represented ``W`` is O(δ).
    """
    if method != "chol":
        raise NotImplementedError(f"method={method!r} is not ported yet")
    _check_diag_parts(A, B, D)
    dtype = torch.promote_types(torch.promote_types(A.dtype, B.dtype), D.dtype)
    A, B, D = A.to(dtype), B.to(dtype), D.to(dtype)
    m = B.shape[-1]
    B, D = _apply_mask(B, D, col_mask)

    a_half = torch.sqrt(A)
    X = B / a_half[..., None]
    log_det_A = torch.sum(torch.log(A), dim=-1)
    if m == 0:
        core0 = torch.zeros(B.shape[:-2] + (0, 0), dtype=dtype, device=B.device)
        return WoodburyFactor(a_half, X, core0, core0, log_det_A)

    eps = torch.finfo(dtype).eps
    eye = torch.eye(m, dtype=dtype, device=B.device)
    G = X.mT @ X
    # the ridge scale comes from the DATA Gram, measured before the
    # masked-column identity is injected (see the JAX package's note: an
    # absolute floor drives I + KᵀDK indefinite near convergence)
    scale = torch.diagonal(G, dim1=-2, dim2=-1).amax(dim=-1)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None, None]
    if col_mask is not None:
        G = G + eye * (1.0 - col_mask.to(dtype))[..., None, :] * scale

    ridge = (32 * m * eps) * scale
    K = cholesky_or_nan(G + ridge * eye)  # G̃ = K Kᵀ
    M = eye + K.mT @ D @ K
    V = cholesky_or_nan(M)  # M = V Vᵀ
    V_inv = _solve_lower(V, eye.expand_as(V))

    def core(T):  # K⁻ᵀ T K⁻¹
        P = _solve_lower_t(K, T)
        return _solve_lower_t(K, P.mT).mT.contiguous()

    C = core(V - eye)
    Ci = core(V_inv - eye)
    log_det = log_det_A + 2.0 * torch.sum(
        torch.log(torch.diagonal(V, dim1=-2, dim2=-1)), dim=-1
    )
    return WoodburyFactor(a_half, X, C, Ci, log_det)


@dataclasses.dataclass(frozen=True)
class WoodburyPDMat:
    """Lazy ``n×n`` PD matrix ``W = diag(A) + B D Bᵀ``, batched."""

    A: torch.Tensor  # (..., n)
    B: torch.Tensor  # (..., n, m)
    D: torch.Tensor  # (..., m, m)
    factor: WoodburyFactor

    @staticmethod
    def from_parts(A, B, D, col_mask=None, method="chol") -> "WoodburyPDMat":
        dtype = torch.promote_types(torch.promote_types(A.dtype, B.dtype), D.dtype)
        A, B, D = A.to(dtype), B.to(dtype), D.to(dtype)
        F = pdfactorize(A, B, D, col_mask=col_mask, method=method)
        B, D = _apply_mask(B, D, col_mask)
        return WoodburyPDMat(A, B, D, F)

    @property
    def dtype(self):
        return self.B.dtype

    def mul(self, x) -> torch.Tensor:
        """``W x`` for ``x (..., n, N)``."""
        return x * self.A[..., None] + self.B @ (self.D @ (self.B.mT @ x))

    def logdet(self) -> torch.Tensor:
        return self.factor.log_det

    def invquad(self, x) -> torch.Tensor:
        """``xᵀ W⁻¹ x`` per column: ``(..., n, N) -> (..., N)``."""
        v = self.factor.L_solve(x)
        return torch.sum(v * v, dim=-2)

    def unwhiten(self, x) -> torch.Tensor:
        """``L x``."""
        return self.factor.L_mul(x)

    def is_finite_pd(self) -> torch.Tensor:
        """True where the factorization succeeded (W numerically PD)."""
        F = self.factor
        return (
            torch.isfinite(F.C).all(dim=(-2, -1))
            & torch.isfinite(F.Ci).all(dim=(-2, -1))
            & torch.isfinite(F.log_det)
        )

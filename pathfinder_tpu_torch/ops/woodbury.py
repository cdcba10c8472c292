"""Low-rank-plus-PD ("Woodbury") matrices, batched over leading dims.

Counterpart of ``pathfinder_tpu/ops/woodbury.py``. The factorization is the
same QR-free square root

    W = A + B D Bᵀ = L Lᵀ,   L = A½ (I + X C Xᵀ),   X = A^{-1/2} B,

with the small ``m×m`` cores ``C`` (for ``L``) and ``Ci`` (for ``L⁻¹``) from
a ridge-regularized Cholesky of the Gram matrix ``XᵀX`` (``method="chol"``)
or from its rank-revealing eigendecomposition (``method="eigh"``).

Shapes: ``A (..., n)`` diagonal (the L-BFGS H₀, the hot path) or
``(..., n, n)`` dense PD; ``B (..., n, m)``, ``D (..., m, m)``, with ``m = 0``
for a matrix with no low-rank part; vectors are passed as column blocks
``x (..., n, N)``. For a dense ``A``, ``a_half`` is its lower Cholesky factor
and ``A½ x`` means ``Kₐ x``; such factors run in plain torch and never reach
the CUDA kernels.

``torch.linalg.cholesky`` raises on a non-PD matrix where JAX returns NaNs,
and downstream logic (``is_finite_pd``, the success predicate, the NaN-
skipping ELBO argmax) depends on the NaNs. So every Cholesky here is
``cholesky_ex`` with NaN written where ``info != 0``, which also avoids a
host sync on the card.

torch has no Cholesky or triangular solve in bfloat16 on any device; the
JAX package's XLA has them. A bfloat16 factor therefore runs those two in
float32 and rounds each result to bfloat16 once. float16 has neither in
torch nor in the JAX package's CPU LAPACK, and raises ``NotImplementedError``
in both.

Under a row group (``utils/rows.py``: the core's rows split over the mesh's
``dim`` axis) the tensors hold a member's rows of ``n``, and every
reduction over ``n`` (the Gram ``XᵀX``, ``log det A``, ``Xᵀx`` and the
column sums) is summed over the members; ``dim`` is the full ``n``, and
``to_dense`` and ``entry`` take the full matrix's columns and indices. A
dense ``A`` comes as the member's rows ``(..., n_r, n)``: its Cholesky
``Kₐ`` and ``X = Kₐ⁻¹B`` are formed once, whole, on the group's first device
(``rows.run_on_lead``), and each member keeps its rows of both. ``Kₐ x`` is
the member's rows of ``Kₐ`` times the gathered ``x``, ``Kₐᵀ x`` a sum over the
members of ``Kₐ_rᵀ x_r``, and the triangular solves run on the first device
over the gathered ``Kₐ`` and operand (the unsharded solve's own arithmetic,
one exchange a solve), where GSPMD partitions them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pathfinder_tpu_torch.utils.rows import (
    full_dim,
    gather_rows,
    in_group,
    row_offset,
    run_on_lead,
    sum_rows,
)

__all__ = [
    "WoodburyFactor",
    "WoodburyPDMat",
    "pdfactorize",
    "pdunfactorize",
    "cholesky_or_nan",
    "solve_triangular",
]


def _linalg_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype torch's Cholesky and triangular solves run in for
    ``dtype``: float32 for bfloat16 (see the module docstring)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def cholesky_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, all-NaN for matrices that are not PD."""
    L, info = torch.linalg.cholesky_ex(M.to(_linalg_dtype(M.dtype)))
    return torch.where((info != 0)[..., None, None], torch.nan, L).to(M.dtype)


def solve_triangular(L: torch.Tensor, B: torch.Tensor, *, upper: bool) -> torch.Tensor:
    """``L⁻¹ B`` for triangular ``L``, in the dtype of :func:`_linalg_dtype`."""
    work = _linalg_dtype(B.dtype)
    return torch.linalg.solve_triangular(L.to(work), B.to(work), upper=upper).to(B.dtype)


def _solve_lower(L, B):
    """``L⁻¹ B`` for lower-triangular ``L``."""
    return solve_triangular(L, B, upper=False)


def _solve_lower_t(L, B):
    """``L⁻ᵀ B`` for lower-triangular ``L`` (``trans=1`` in SciPy terms)."""
    return solve_triangular(L.mT, B, upper=True)


def _gathered(x):
    """The full rows of a row-split column block ``x (..., n_r, N)``: ``(...,
    n, N)`` on every member (``x`` itself outside a group)."""
    return gather_rows(x.mT).mT if in_group() else x


def _own_rows(x, n_r: int):
    """The member's rows ``(..., n_r, N)`` of a block ``x (..., n, N)`` of
    every row."""
    off = row_offset()
    return x[..., off:off + n_r, :]


def _own_block(M):
    """The member's diagonal block ``(..., n_r, n_r)`` of its rows ``M (...,
    n_r, n)`` of an ``n×n`` matrix (all of ``M`` outside a group)."""
    off = row_offset()
    return M[..., off:off + M.shape[-2]]


def _eye_rows(n_r: int, dtype, device):
    """The member's rows ``(n_r, n)`` of the ``n×n`` identity."""
    if not in_group():
        return torch.eye(n_r, dtype=dtype, device=device)
    eye = torch.zeros(n_r, full_dim(n_r), dtype=dtype, device=device)
    _own_block(eye).fill_diagonal_(1.0)
    return eye


def _on_lead(fn, *ts, nout: int = 1):
    """``fn`` of the whole matrices whose rows the row-split ``ts (..., n_r,
    k)`` are, run once on the group's first device; the member's rows of each
    of its ``nout`` outputs ``(..., n, k)``. Outside a group: ``fn(*ts)``.
    ``rows.run_on_lead`` gathers and splits the last axis, so the rows travel
    transposed."""
    if not in_group():
        return fn(*ts)

    def whole(*tts):
        out = fn(*(t.mT for t in tts))
        return out.mT if nout == 1 else tuple(o.mT for o in out)

    out = run_on_lead(whole, *(t.mT for t in ts), split=True if nout == 1 else (True,) * nout)
    return out.mT.contiguous() if nout == 1 else tuple(o.mT.contiguous() for o in out)


def _dense_factor(A, B):
    """``(Kₐ, X)``: the lower Cholesky factor of a dense ``A`` and ``X =
    Kₐ⁻¹B``."""
    a_half = cholesky_or_nan(A)  # lower, A = Kₐ Kₐᵀ
    return a_half, (_solve_lower(a_half, B) if B.shape[-1] else torch.zeros_like(B))


def _dense_inverse(a_half, X):
    """``(A⁻¹, A⁻¹B)`` of a dense ``A = Kₐ Kₐᵀ`` with ``X = Kₐ⁻¹B``."""
    eye = torch.eye(a_half.shape[-1], dtype=a_half.dtype, device=a_half.device)
    ah_inv = _solve_lower(a_half, eye.expand_as(a_half))
    return ah_inv.mT @ ah_inv, ah_inv.mT @ X


@dataclasses.dataclass(frozen=True)
class WoodburyFactor:
    """Square-root factor ``W = L Lᵀ`` with ``L = A½ (I + X C Xᵀ)``."""

    # (..., n) sqrt(diag A), or (..., n, n) lower Cholesky of A (in a group, a member's rows)
    a_half: torch.Tensor
    X: torch.Tensor  # (..., n, m) A^{-1/2} B, masked columns zeroed
    C: torch.Tensor  # (..., m, m) core of L
    Ci: torch.Tensor  # (..., m, m) core of L⁻¹
    log_det: torch.Tensor  # (...) log det W

    @property
    def diag_A(self) -> bool:
        return self.a_half.ndim == self.X.ndim - 1

    # -- A^{±1/2} applications ------------------------------------------------
    def _ah_mul(self, x):
        return self.a_half[..., None] * x if self.diag_A else self.a_half @ _gathered(x)

    def _ah_t_mul(self, x):
        if self.diag_A:
            return self.a_half[..., None] * x
        if not in_group():
            return self.a_half.mT @ x
        return _own_rows(sum_rows(self.a_half.mT @ x), x.shape[-2])  # Σ_j K_jᵀ x_j

    def _ah_solve(self, x):
        return x / self.a_half[..., None] if self.diag_A else _on_lead(_solve_lower, self.a_half, x)

    def _ah_t_solve(self, x):
        return x / self.a_half[..., None] if self.diag_A else _on_lead(_solve_lower_t, self.a_half, x)

    def _core(self, M, x):
        # x + X (M (Xᵀ x))
        return x + self.X @ (M @ sum_rows(self.X.mT @ x))

    # -- factor applications --------------------------------------------------
    def L_mul(self, x):
        """``L x``."""
        return self._ah_mul(self._core(self.C, x))

    def Lt_mul(self, x):
        """``Lᵀ x``."""
        return self._core(self.C.mT, self._ah_t_mul(x))

    def L_solve(self, x):
        """``L⁻¹ x``."""
        return self._core(self.Ci, self._ah_solve(x))

    def Lt_solve(self, x):
        """``L⁻ᵀ x``."""
        return self._ah_t_solve(self._core(self.Ci.mT, x))

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


def _is_diag(A, B) -> bool:
    """Whether ``A`` is a diagonal ``(..., n)`` beside ``B (..., n, m)``;
    raises unless it is that or a dense ``(..., n, n)`` (in a row group the
    member's rows ``(..., n_r, n)``)."""
    n = B.shape[-2]
    if A.shape == B.shape[:-1]:
        return True
    if A.shape == B.shape[:-2] + (n, full_dim(n)):
        return False
    raise ValueError(
        f"A must be (..., n) or (..., n, n) matching B {tuple(B.shape)}; "
        f"got {tuple(A.shape)}"
    )


def _diag_of(M):
    return torch.diagonal(M, dim1=-2, dim2=-1)


def pdfactorize(
    A: torch.Tensor,
    B: torch.Tensor,
    D: torch.Tensor,
    col_mask: Optional[torch.Tensor] = None,
    method: str = "chol",
) -> WoodburyFactor:
    """Factorize ``W = A + B D Bᵀ``; ``A`` is a diagonal ``(..., n)`` or a
    dense PD ``(..., n, n)``.

    ``col_mask (..., m)`` marks active columns of ``B``; masked columns are
    treated as absent.

    ``method``:

    * ``"chol"`` (default): ridge-regularized Cholesky of the Gram matrix.
      Rank-deficient directions (masked columns, m > n, duplicated history)
      lie in the null space of ``X``, so the ridge's effect on the
      represented ``W`` is O(δ).
    * ``"eigh"``: rank-revealing symmetric eigendecomposition with exact
      projection of null directions.
    """
    if method not in ("chol", "eigh"):
        raise ValueError(f"unknown factorization method {method!r}")
    if B.ndim < 2 or D.shape[-2:] != (B.shape[-1],) * 2:
        raise ValueError(
            f"B must be (..., n, m) and D (..., m, m); got B {tuple(B.shape)}, "
            f"D {tuple(D.shape)}"
        )
    diag = _is_diag(A, B)
    dtype = torch.promote_types(torch.promote_types(A.dtype, B.dtype), D.dtype)
    A, B, D = A.to(dtype), B.to(dtype), D.to(dtype)
    m = B.shape[-1]
    B, D = _apply_mask(B, D, col_mask)

    if diag:
        a_half = torch.sqrt(A)
        X = B / a_half[..., None]
        log_det_A = torch.sum(torch.log(A), dim=-1)
    else:  # in a group, whole on the first device; each member keeps its rows
        a_half, X = _on_lead(_dense_factor, A, B, nout=2)
        log_det_A = 2.0 * torch.sum(torch.log(_diag_of(_own_block(a_half))), dim=-1)
    if m == 0:
        core0 = torch.zeros(B.shape[:-2] + (0, 0), dtype=dtype, device=B.device)
        return WoodburyFactor(a_half, X, core0, core0, sum_rows(log_det_A))

    eps = torch.finfo(dtype).eps
    eye = torch.eye(m, dtype=dtype, device=B.device)
    G, log_det_A = sum_rows(X.mT @ X, log_det_A)
    # the ridge scale comes from the DATA Gram, measured before the
    # masked-column identity is injected (see the JAX package's note: an
    # absolute floor drives I + KᵀDK indefinite near convergence)
    scale = _diag_of(G).amax(dim=-1)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))[..., None, None]
    if col_mask is not None:
        G = G + eye * (1.0 - col_mask.to(dtype))[..., None, :] * scale

    if method == "chol":
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
    else:
        lam, E = torch.linalg.eigh(G)  # ascending eigenvalues
        tol = scale[..., 0] * (32 * m * eps)
        active = (lam > tol).to(dtype)
        s = torch.sqrt(torch.where(active > 0, lam, torch.ones_like(lam)))  # Λ̃^{1/2}
        outer = active[..., :, None] * active[..., None, :]
        ss = s[..., :, None] * s[..., None, :]
        M = eye + (E.mT @ D @ E) * outer * ss
        V = cholesky_or_nan(M)
        V_inv = _solve_lower(V, eye.expand_as(V))
        C = (E @ ((V - eye) / ss) @ E.mT).contiguous()
        Ci = (E @ ((V_inv - eye) / ss) @ E.mT).contiguous()
    log_det = log_det_A + 2.0 * torch.sum(torch.log(_diag_of(V)), dim=-1)
    return WoodburyFactor(a_half, X, C, Ci, log_det)


def pdunfactorize(F: WoodburyFactor):
    """``(A, B, D)`` that give the same ``W`` as the factor."""
    if F.diag_A:
        A = F.a_half**2
        B = F.a_half[..., None] * F.X
    else:
        A = _on_lead(lambda L: L @ L.mT, F.a_half)
        B = F._ah_mul(F.X)
    G = sum_rows(F.X.mT @ F.X)
    D = F.C + F.C.mT + F.C @ G @ F.C.mT
    return A, B, D


def _rows_at(*pairs):
    """Row ``i`` (an index of the full matrix) of each row-split ``T (...,
    n_r, k)`` of ``pairs`` ``(T, i)``: ``T[..., i, :]``. In a group the member
    that holds row ``i`` gives it and the others zeros, summed in one exchange,
    so every member has it."""
    if not in_group():
        return tuple(T[..., i, :] for T, i in pairs)
    off = row_offset()
    parts = []
    for T, i in pairs:
        n_r = T.shape[-2]
        i = i + full_dim(n_r) if i < 0 else i
        parts.append(T[..., i - off, :] if off <= i < off + n_r else torch.zeros_like(T[..., 0, :]))
    out = sum_rows(*parts)
    return out if isinstance(out, tuple) else (out,)


def _block_diag(D1, D2):
    """``blockdiag(D1, D2)`` over shared leading dims."""
    m1, m2 = D1.shape[-1], D2.shape[-1]
    batch = torch.broadcast_shapes(D1.shape[:-2], D2.shape[:-2])
    out = torch.zeros(batch + (m1 + m2, m1 + m2), dtype=D1.dtype, device=D1.device)
    out[..., :m1, :m1] = D1
    out[..., m1:, m1:] = D2
    return out


@dataclasses.dataclass(frozen=True)
class WoodburyPDMat:
    """Lazy ``n×n`` PD matrix ``W = A + B D Bᵀ``, batched."""

    A: torch.Tensor  # (..., n) diagonal or (..., n, n) dense
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
    def diag_A(self) -> bool:
        return self.A.ndim == self.B.ndim - 1

    @property
    def dim(self) -> int:
        return full_dim(self.B.shape[-2])

    @property
    def dtype(self):
        return self.B.dtype

    def _dense_A(self):
        """``A`` as ``(..., n, n)``; in a group the member's rows ``(..., n_r,
        n)``."""
        if not self.diag_A:
            return self.A
        if not in_group():
            return torch.diag_embed(self.A)
        out = self.A.new_zeros(self.A.shape + (self.dim,))
        _diag_of(_own_block(out)).copy_(self.A)
        return out

    def _A_mul(self, x):
        return x * self.A[..., None] if self.diag_A else self.A @ _gathered(x)

    def to_dense(self) -> torch.Tensor:
        """``A + B D Bᵀ`` as ``(..., n, n)``; in a group the member's rows
        ``(..., n_r, n)``."""
        return self._dense_A() + self.B @ self.D @ _gathered(self.B).mT

    def diag(self) -> torch.Tensor:
        """Diagonal of ``W``: ``(..., n)``."""
        a = self.A if self.diag_A else _diag_of(_own_block(self.A))
        return a + torch.sum((self.B @ self.D) * self.B, dim=-1)

    def entry(self, i, j) -> torch.Tensor:
        """Element ``W[i, j]`` of every matrix of the batch, without
        densifying; in a group ``i`` and ``j`` index the full matrix, and every
        member returns the same value."""
        A = self.A[..., None] if self.diag_A else self.A
        Ai, Bi, Bj = _rows_at((A, i), (self.B, i), (self.B, j))
        if self.diag_A:
            a = Ai[..., 0] if i == j else torch.zeros_like(Ai[..., 0])
        else:
            a = Ai[..., j]
        return a + torch.sum(Bi * (self.D @ Bj[..., None])[..., 0], dim=-1)

    # -- linear algebra -------------------------------------------------------
    def mul(self, x) -> torch.Tensor:
        """``W x`` for ``x (..., n, N)``."""
        return self._A_mul(x) + self.B @ (self.D @ sum_rows(self.B.mT @ x))

    def solve(self, x) -> torch.Tensor:
        """``W⁻¹ x``."""
        return self.factor.solve(x)

    def logdet(self) -> torch.Tensor:
        return self.factor.log_det

    def inv(self, method: str = "chol") -> "WoodburyPDMat":
        """``W⁻¹``, still in Woodbury form:
        ``A⁻¹ + (A⁻¹B) D' (A⁻¹B)ᵀ`` with ``D' = Ci + Ciᵀ + Ciᵀ G Ci``.
        ``method`` is the factorization of the result."""
        F = self.factor
        G = sum_rows(F.X.mT @ F.X)
        D_inv = F.Ci + F.Ci.mT + F.Ci.mT @ G @ F.Ci
        if F.diag_A:
            A_inv = 1.0 / self.A
            B_inv = F.X / F.a_half[..., None]
        else:
            A_inv, B_inv = _on_lead(_dense_inverse, F.a_half, F.X, nout=2)
        return WoodburyPDMat.from_parts(A_inv, B_inv, D_inv, method=method)

    def quad(self, x) -> torch.Tensor:
        """``xᵀ W x`` per column: ``(..., n, N) -> (..., N)``."""
        xAx, Bx = sum_rows(torch.sum(x * self._A_mul(x), dim=-2), self.B.mT @ x)
        return xAx + torch.sum(Bx * (self.D @ Bx), dim=-2)

    def invquad(self, x) -> torch.Tensor:
        """``xᵀ W⁻¹ x`` per column: ``(..., n, N) -> (..., N)``."""
        v = self.factor.L_solve(x)
        return sum_rows(torch.sum(v * v, dim=-2))

    def whiten(self, x) -> torch.Tensor:
        """``L⁻¹ x``."""
        return self.factor.L_solve(x)

    def unwhiten(self, x) -> torch.Tensor:
        """``L x``."""
        return self.factor.L_mul(x)

    def inv_unwhiten(self, x) -> torch.Tensor:
        """``L⁻ᵀ x``."""
        return self.factor.Lt_solve(x)

    def add_scaled_identity(self, c, method: str = "chol") -> "WoodburyPDMat":
        """``W + c·I`` in Woodbury form; ``c`` must keep ``A + c·I`` PD."""
        if self.diag_A:
            A = self.A + c
        else:
            A = self.A + c * _eye_rows(self.A.shape[-2], self.dtype, self.B.device)
        return WoodburyPDMat.from_parts(A, self.B, self.D, method=method)

    def add(self, other: "WoodburyPDMat", method: str = "chol") -> "WoodburyPDMat":
        """``W₁ + W₂`` in lazy form: the ``A`` parts add (dense if either
        is) and the low-rank parts concatenate."""
        if not isinstance(other, WoodburyPDMat):
            return NotImplemented
        if self.diag_A == other.diag_A:
            A = self.A + other.A
        else:
            A = self._dense_A() + other._dense_A()
        dtype = torch.promote_types(self.dtype, other.dtype)
        B = torch.cat([self.B.to(dtype), other.B.to(dtype)], dim=-1)
        D = _block_diag(self.D.to(dtype), other.D.to(dtype))
        return WoodburyPDMat.from_parts(A, B, D, method=method)

    __add__ = add

    def scale(self, c, method: str = "chol"):
        """``c·W``: a positive scalar keeps the Woodbury form; a non-positive
        one gives the dense ``c * to_dense()``, which is no longer PD."""
        c = float(c)
        if c <= 0:
            return c * self.to_dense()
        return WoodburyPDMat.from_parts(self.A * c, self.B, self.D * c, method=method)

    def __mul__(self, c):
        return self.scale(c)

    __rmul__ = __mul__

    def is_finite_pd(self) -> torch.Tensor:
        """True where the factorization succeeded (W numerically PD)."""
        F = self.factor
        return (
            torch.isfinite(F.C).all(dim=(-2, -1))
            & torch.isfinite(F.Ci).all(dim=(-2, -1))
            & torch.isfinite(F.log_det)
        )

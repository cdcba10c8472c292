"""Pathfinder's arithmetic, written plainly from the papers, batched over
paths: the target's value and gradient, the L-BFGS direction by the
two-loop recursion (Nocedal 1980) with the diagonal H₀ of Gilbert &
Lemaréchal (1989, eq. 4.9), the inverse-Hessian fit in the compact form of
Byrd, Nocedal & Schnabel (1994, Thm 2.2) that Pathfinder fits (Zhang et al.
2022, Alg. 1), and the log density of a normal whose covariance is a
diagonal plus a low-rank part, from its square-root factors.

A fit is ``(mu, alpha, X, M)``: ``Σ = A½ (I + X M Xᵀ) A½`` with ``A =
diag(alpha)``; its log det and its inverse come from the fit itself
(Sylvester and Woodbury, :func:`fit_logdet`, :func:`fit_maha`). A returned
normal holds the factor ``L = A½ (I + X C Xᵀ)``, whose draws and whose
``L Lᵀ`` the reference works out too (:func:`factor_draws`,
:func:`factor_cov_mul`). Everything runs in the arithmetic of a
:class:`Prec`.
"""

from __future__ import annotations

import math

import torch

from reference.precision import Prec

LOG_2PI = math.log(2.0 * math.pi)


def value_and_grad(logp, data: dict, x: torch.Tensor, prec: Prec, block: int = 4096):
    """``(logp (n,), ∇logp (n, d))`` at the rows of ``x (n, d)``, in
    ``prec``, by autograd, in blocks of rows."""
    lps, gs = [], []
    for lo in range(0, x.shape[0], block):
        with torch.enable_grad():
            xb = x[lo:lo + block].to(prec.dtype).detach().requires_grad_(True)
            lp = logp(xb, data, mm=prec.mm)
            (g,) = torch.autograd.grad(lp.sum(), xb)
        lps.append(lp.detach())
        gs.append(g)
    return torch.cat(lps), torch.cat(gs)


def two_loop(g, alpha, S, Y, mask, prec: Prec):
    """``H g`` for the BFGS matrix ``H`` built from ``H₀ = diag(alpha)``
    through the pairs ``(S, Y) (K, J, d)``, oldest first, where ``mask (K,
    J)`` holds (a masked pair changes nothing)."""
    J = S.shape[1]
    sy = prec.dot(S, Y)
    rho = torch.where(mask, 1.0 / torch.where(mask, sy, torch.ones_like(sy)), torch.zeros_like(sy))
    q = g
    a = [None] * J
    for j in reversed(range(J)):
        a[j] = rho[:, j] * prec.dot(S[:, j], q)
        q = q - a[j][:, None] * Y[:, j]
    r = alpha * q
    for j in range(J):
        b = rho[:, j] * prec.dot(Y[:, j], r)
        r = r + S[:, j] * (a[j] - b)[:, None]
    return r


def gilbert_alpha(alpha, s, y, prec: Prec):
    """The diagonal H₀ after the pair ``(s, y)``: Gilbert & Lemaréchal eq. 4.9."""
    a = prec.dot(y * alpha, y)[:, None]
    b = prec.dot(y, s)[:, None]
    c = prec.dot(s / alpha, s)[:, None]
    return b / (a / alpha + y * y - (a / c) * (s / alpha) ** 2)


def compact_fit(alpha, S, Y, mask, prec: Prec):
    """``(X, M)`` of ``H = A + B M Bᵀ`` with ``B = [S | A Y]`` (Byrd et al.
    1994, Thm 2.2, inverse form): ``R = triu(S Yᵀ)``, ``E = diag(R)``,
    ``M = [[R⁻ᵀ(E + Yᵀ A Y)R⁻¹, −R⁻ᵀ], [−R⁻¹, 0]]``; and ``X = A^{-1/2} B``.
    Masked pairs have zero columns in ``B`` and zero rows and columns in
    ``M``."""
    K, J, d = S.shape
    maskf = mask.to(S.dtype)
    S = S * maskf[..., None]
    Y = Y * maskf[..., None]
    eye = torch.eye(J, dtype=S.dtype, device=S.device)
    both = maskf[:, :, None] * maskf[:, None, :]
    R = torch.triu(prec.mm(S, Y.mT)) * both + eye * (1.0 - maskf)[:, None, :]
    E = torch.diagonal(R, dim1=-2, dim2=-1) * maskf
    YAY = prec.mm(Y * alpha[:, None, :], Y.mT)
    Rinv = torch.linalg.solve_triangular(R, eye.expand(K, J, J), upper=True)
    M11 = prec.mm(prec.mm(Rinv.mT, torch.diag_embed(E) + YAY), Rinv)
    M = torch.cat([torch.cat([M11, -Rinv.mT], -1),
                   torch.cat([-Rinv, torch.zeros_like(Rinv)], -1)], -2)
    m2 = torch.cat([maskf, maskf], -1)
    M = M * m2[:, :, None] * m2[:, None, :]
    B = torch.cat([S, Y * alpha[:, None, :]], 1).mT  # (K, d, 2J)
    return B / alpha.sqrt()[..., None], M


def cov_mul(alpha, X, M, v, prec: Prec):
    """``Σ v`` for ``v (K, d)``."""
    ah = alpha.sqrt()
    w = ah * v
    t = prec.mm(X.mT, w[..., None])
    return ah * (w + prec.mm(X, prec.mm(M, t))[..., 0])


def fit_logdet(alpha, X, M, prec: Prec):
    """``log det Σ = Σ log alpha + log det(I + M XᵀX)`` (Sylvester), ``(K,)``."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return torch.log(alpha).sum(-1) + torch.linalg.slogdet(eye + prec.mm(M, prec.mm(X.mT, X)))[1]


def fit_maha(mu, alpha, X, M, x, prec: Prec):
    """``(x − μ)ᵀ Σ⁻¹ (x − μ)`` for the rows of ``x (K, N, d)``: with ``v =
    A^{-1/2}(x − μ)``, ``(I + X M Xᵀ)⁻¹ = I − X M (I + XᵀX M)⁻¹ Xᵀ``."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    G = prec.mm(X.mT, X)
    # W = M (I + G M)⁻¹, from (I + G M)ᵀ Wᵀ = Mᵀ
    W = torch.linalg.solve((eye + prec.mm(G, M)).mT, M.mT).mT
    v = (x.to(mu.dtype) - mu[:, None, :]) / alpha.sqrt()[:, None, :]
    t = prec.mm(X.mT, v.mT)  # (K, 2J, N)
    return (v * v).sum(-1) - (t * prec.mm(W, t)).sum(-2)


def factor_draws(mean, a_half, X, C, u, prec: Prec):
    """``x = μ + L u`` for the columns of ``u (K, d, N)`` with ``L = A½ (I +
    X C Xᵀ)``."""
    a_half, X, C, u = a_half.to(prec.dtype), X.to(prec.dtype), C.to(prec.dtype), u.to(prec.dtype)
    t = prec.mm(C, prec.mm(X.mT, u))
    return mean.to(prec.dtype)[..., None] + a_half[..., None] * (u + prec.mm(X, t))


def factor_cov_mul(a_half, X, C, v):
    """``L Lᵀ v`` for ``v (K, d)`` with ``L = A½ (I + X C Xᵀ)``, in float64."""
    a_half, X, C, v = a_half.double(), X.double(), C.double(), v.double()
    w = a_half * v
    y = w + (X @ (C.mT @ (X.mT @ w[..., None])))[..., 0]  # Lᵀ v
    return a_half * (y + (X @ (C @ (X.mT @ y[..., None])))[..., 0])


def trajectory_pass(xs, g_ref, nvalid, fit_point, history_length, epsilon_curvature, prec: Prec):
    """Follow each path's L-BFGS run from its own iterates ``xs (K, L+1,
    d)``, with the reference's gradients ``g_ref`` (of logp) there.

    At each iterate ``i`` the direction is the two-loop ``−H g`` over the at
    most ``J`` most recent curvature-accepted pairs of the steps before it
    (``sᵀy > ε yᵀy``, minimizer view ``y = −Δ∇logp``), or ``−A g`` where that
    is no descent direction. Returns ``(dirs (K, L, d), fits)``: the
    direction at each iterate, and ``(mu, alpha, X, M)`` at point ``fit_point
    (K,)``."""
    K, L1, d = xs.shape
    J = history_length
    dt, dev = prec.dtype, xs.device
    xs, g_ref = xs.to(dt), g_ref.to(dt)
    alpha = torch.ones(K, d, dtype=dt, device=dev)
    S = torch.zeros(K, J, d, dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    mask = torch.zeros(K, J, dtype=torch.bool, device=dev)
    dirs = torch.zeros(K, L1 - 1, d, dtype=dt, device=dev)
    snap = [torch.zeros_like(alpha), torch.zeros_like(S), torch.zeros_like(Y),
            torch.zeros_like(mask)]
    for i in range(L1):
        at = fit_point == i
        if bool(at.any()):
            for buf, now in zip(snap, (alpha, S, Y, mask)):
                buf[at] = now[at]
        if i == L1 - 1:
            break
        live = i + 1 < nvalid
        if not bool(live.any()):
            continue
        gmin = -g_ref[:, i]
        p = -two_loop(gmin, alpha, S, Y, mask, prec)
        bad = ~(prec.dot(gmin, p) < 0)
        dirs[:, i] = torch.where(bad[:, None], -alpha * gmin, p)
        s = xs[:, i + 1] - xs[:, i]
        y = -(g_ref[:, i + 1] - g_ref[:, i])
        curv, yy = prec.dot(y, s), prec.dot(y, y)
        acc = live & (curv > epsilon_curvature * yy)
        if J > 0:
            S = torch.where(acc[:, None, None], torch.cat([S[:, 1:], s[:, None]], 1), S)
            Y = torch.where(acc[:, None, None], torch.cat([Y[:, 1:], y[:, None]], 1), Y)
            mask = torch.where(acc[:, None], torch.cat([mask[:, 1:], acc[:, None]], 1), mask)
        alpha = torch.where(acc[:, None], gilbert_alpha(alpha, s, y, prec), alpha)
    alpha_p, S_p, Y_p, mask_p = snap
    X, M = compact_fit(alpha_p, S_p, Y_p, mask_p, prec)
    idx = fit_point.clamp(0, L1 - 1)
    x_p = xs[torch.arange(K, device=dev), idx]
    g_p = g_ref[torch.arange(K, device=dev), idx]
    mu = x_p + cov_mul(alpha_p, X, M, g_p, prec)
    return dirs, (mu, alpha_p, X, M)

"""L-BFGS with a trajectory trace, and inverse-Hessian reconstruction, batched
over lanes (counterpart of ``pathfinder_tpu/ops/lbfgs.py``).

The JAX package runs one path's ``lax.while_loop`` under ``vmap``; here the
K paths are a leading axis and the loop is a masked Python loop: the body runs
for all lanes and a lane whose own condition is false keeps its whole state,
which is what JAX's batched ``while_loop`` does. The trace buffers keep the
fixed ``(K, maxiters+1, d)`` shape with a per-lane valid count.

The trace stores the log-density view (``logp`` and ``∇logp``); the optimizer
minimizes ``f = −logp``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops.linesearch import (
    hager_zhang_line_search,
    initial_step_size,
    resolve_c1,
)
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat

__all__ = [
    "OptimizationTrace",
    "LbfgsHistoryAux",
    "gilbert_init",
    "scale_aware_gtol",
    "should_abort_nonfinite",
    "minimize_lbfgs_trace",
    "lbfgs_inverse_hessian",
    "lbfgs_history_aux",
    "lbfgs_fits_at",
]


def should_abort_nonfinite(logp_value, grad_logp, fail_on_nonfinite=True):
    """Abort iff ``fail_on_nonfinite`` and (``isnan(logp)`` or
    ``logp == +Inf`` or any gradient entry non-finite); ``logp == −Inf`` does
    not abort."""
    bad = (
        torch.isnan(logp_value)
        | (logp_value == torch.inf)
        | (~torch.isfinite(grad_logp)).any(dim=-1)
    )
    return bad & fail_on_nonfinite


def gilbert_init(alpha, s, y):
    """Diagonal H₀ refresh, Gilbert & Lemaréchal (1989) eq. 4.9, per lane."""
    a = torch.sum(y * alpha * y, dim=-1, keepdim=True)
    b = torch.sum(y * s, dim=-1, keepdim=True)
    c = torch.sum(s / alpha * s, dim=-1, keepdim=True)
    return b / (a / alpha + y * y - (a / c) * (s / alpha) ** 2)


def scale_aware_gtol(gtol_user, g0, dtype):
    """The user's ``gtol`` floored at 25 eps times ``min(1, |g0|∞)``."""
    floor = 25 * torch.finfo(dtype).eps
    g0_scale = g0.abs().amax(dim=-1)
    g0_scale = torch.where(
        torch.isfinite(g0_scale) & (g0_scale > 0), g0_scale,
        torch.ones_like(g0_scale),
    )
    return torch.clamp(floor * torch.clamp(g0_scale, max=1.0), min=gtol_user)


@dataclasses.dataclass(frozen=True)
class OptimizationTrace:
    """Fixed-shape trace, batched over lanes. Index 0 is the initial point;
    entries at index ≥ ``num_valid`` are padding."""

    xs: torch.Tensor  # (K, maxiters+1, d) iterates
    log_densities: torch.Tensor  # (K, maxiters+1) logp values
    gradients: torch.Tensor  # (K, maxiters+1, d) ∇logp
    num_valid: torch.Tensor  # (K,) number of valid points (≥ 1)
    num_bfgs_updates_rejected: torch.Tensor  # (K,)
    num_fn_evals: torch.Tensor  # (K,) value_and_grad evaluations
    num_ls_exhausted: torch.Tensor  # (K,) steps kept by the fallback

    @property
    def point_mask(self) -> torch.Tensor:
        n = self.xs.shape[-2]
        pos = torch.arange(n, device=self.xs.device)
        return pos < self.num_valid[..., None]


def _compact_pieces(S_masked, Y_masked, alpha, mask):
    """``R = triu(S Yᵀ)`` over active rows (identity on inactive ones),
    ``E = diag(R)`` on active rows and ``YaY = Y diag(α) Yᵀ``; shared by the
    search direction and the reconstructed fits so both mask alike."""
    J = S_masked.shape[-2]
    eyeJ = torch.eye(J, dtype=alpha.dtype, device=alpha.device)
    mm = mask[..., :, None] * mask[..., None, :]
    R = torch.triu(S_masked @ Y_masked.mT) * mm + eyeJ * (1.0 - mask)[..., None, :]
    E = torch.diagonal(R, dim1=-2, dim2=-1) * mask
    YaY = Y_masked @ (alpha[..., None, :] * Y_masked).mT
    return R, E, YaY, eyeJ


def _two_loop_direction(g, alpha, S, Y, pos, hlen):
    """``−H g`` over the masked circular history by the compact
    representation (Byrd et al. 1994, Thm 2.2). ``g``, ``alpha`` (K, d);
    ``S``, ``Y`` (K, J, d); ``pos``, ``hlen`` (K,)."""
    K, J, _ = S.shape
    if J == 0:
        return -(alpha * g)
    dtype = g.dtype
    ar = torch.arange(J, device=g.device)
    order = (pos[:, None] - (J - 1) + ar) % J  # chronological view
    mask = (ar >= (J - hlen[:, None])).to(dtype)
    S_ord = torch.gather(S, 1, order[..., None].expand_as(S)) * mask[..., None]
    Y_ord = torch.gather(Y, 1, order[..., None].expand_as(Y)) * mask[..., None]

    R, E, YaY, _ = _compact_pieces(S_ord, Y_ord, alpha, mask)

    u1 = (Y_ord @ (alpha * g)[..., None])[..., 0]  # B₁ᵀ g
    u2 = (S_ord @ g[..., None])[..., 0]  # B₂ᵀ g
    w = torch.linalg.solve_triangular(R, u2[..., None], upper=True)  # R⁻¹ u2
    inner = -u1[..., None] + E[..., None] * w + YaY @ w
    d2 = torch.linalg.solve_triangular(R.mT, inner, upper=False)  # R⁻ᵀ(...)
    Hg = alpha * g - alpha * (Y_ord.mT @ w)[..., 0] + (S_ord.mT @ d2)[..., 0]
    return -Hg


def minimize_lbfgs_trace(
    value_and_grad: Callable,
    x0: torch.Tensor,
    maxiters: int = 1000,
    history_length: int = 6,
    gtol: float = 1e-8,
    ftol: float = 10.0,
    epsilon_curvature: float = 1e-12,
    max_ls_evals: int = 12,
    c1: Optional[float] = None,
    c2: float = 0.9,
    fail_on_nonfinite: bool = True,
) -> OptimizationTrace:
    """Maximize ``logp`` from each row of ``x0 (K, d)`` with L-BFGS and
    Hager-Zhang, recording every trajectory.

    ``value_and_grad(x (K, d)) -> (logp (K,), ∇logp (K, d))``. Stopping,
    abort and history rules are those of the JAX package: gradient-norm
    ``gtol`` floored at the problem's scale, the ``ftol`` relative-progress
    stall (in ulps), the record-then-abort rule for non-finite points, and
    the curvature-guarded history update.
    """
    K, d = x0.shape
    dtype = x0.dtype
    dev = x0.device
    J = history_length
    ftol_rel = float(ftol) * float(torch.finfo(dtype).eps) if ftol > 0 else 0.0
    c1 = resolve_c1(c1, "hager_zhang")
    lanes = torch.arange(K, device=dev)

    def neg_vg(x):
        lp, glp = value_and_grad(x)
        return (-lp).to(dtype), (-glp).to(dtype)

    f0, g0 = neg_vg(x0)
    gtol_eff = scale_aware_gtol(float(gtol), g0, dtype)
    init_abort = should_abort_nonfinite(-f0, -g0, fail_on_nonfinite)

    xs = torch.zeros((K, maxiters + 1, d), dtype=dtype, device=dev)
    fs = torch.zeros((K, maxiters + 1), dtype=dtype, device=dev)
    gs = torch.zeros((K, maxiters + 1, d), dtype=dtype, device=dev)
    xs[:, 0], fs[:, 0], gs[:, 0] = x0, -f0, -g0

    izero = torch.zeros(K, dtype=torch.int64, device=dev)
    st = dict(
        it=izero, x=x0, f=f0, g=g0,
        alpha=torch.ones((K, d), dtype=dtype, device=dev),
        S=torch.zeros((K, J, d), dtype=dtype, device=dev),
        Y=torch.zeros((K, J, d), dtype=dtype, device=dev),
        pos=izero, hlen=izero, nrej=izero, nev=izero + 1, nexh=izero,
        done=init_abort,
    )

    while True:
        run = (~st["done"]) & (st["it"] < maxiters)
        if not bool(run.any()):
            break
        x, f, g, alpha = st["x"], st["f"], st["g"], st["alpha"]
        direction = _two_loop_direction(g, alpha, st["S"], st["Y"], st["pos"], st["hlen"])
        dphi0 = torch.sum(g * direction, dim=-1)
        # safeguard: scaled steepest descent if not a descent direction
        bad_dir = ~(dphi0 < 0)
        direction = torch.where(bad_dir[:, None], -alpha * g, direction)

        a0_first = initial_step_size(x, f, g)
        alpha0 = torch.where(st["it"] == 0, a0_first, torch.ones_like(f))

        ls = hager_zhang_line_search(
            neg_vg, x, f, g, direction, alpha0,
            c1=c1, c2=c2, max_evals=max_ls_evals, active=run,
        )
        nev = st["nev"] + ls.num_evals

        x_new = x + ls.step_size[:, None] * direction
        f_new, g_new = ls.f, ls.g
        progress = ls.ok
        abort = should_abort_nonfinite(-f_new, -g_new, fail_on_nonfinite)
        nexh = st["nexh"] + (progress & ls.exhausted).long()

        # curvature-guarded history update
        svec = x_new - x
        yvec = g_new - g
        curv = torch.sum(yvec * svec, dim=-1)
        accept = progress & (curv > epsilon_curvature * torch.sum(yvec * yvec, dim=-1))

        if J > 0:
            write = (st["pos"] + 1) % J
            S, Y = st["S"].clone(), st["Y"].clone()
            S[lanes, write] = torch.where(accept[:, None], svec, S[lanes, write])
            Y[lanes, write] = torch.where(accept[:, None], yvec, Y[lanes, write])
            pos = torch.where(accept, write, st["pos"])
        else:
            S, Y, pos = st["S"], st["Y"], st["pos"]
        hlen = torch.where(accept, torch.clamp(st["hlen"] + 1, max=J), st["hlen"])
        alpha_new = torch.where(accept[:, None], gilbert_init(alpha, svec, yvec), alpha)
        nrej = st["nrej"] + (progress & ~accept).long()

        it_new = torch.where(progress, st["it"] + 1, st["it"])
        # trace rows are written in place: only running lanes that made
        # progress write, and each writes its own next row
        wr = run & progress
        xs[lanes, it_new] = torch.where(wr[:, None], x_new, xs[lanes, it_new])
        fs[lanes, it_new] = torch.where(wr, -f_new, fs[lanes, it_new])
        gs[lanes, it_new] = torch.where(wr[:, None], -g_new, gs[lanes, it_new])

        converged = g_new.abs().amax(dim=-1) <= gtol_eff
        if ftol_rel > 0:
            stalled = progress & ((f - f_new) <= ftol_rel * (f_new.abs() + ftol_rel))
        else:
            stalled = torch.zeros_like(progress)
        done = (~progress) | converged | stalled | (progress & abort)

        new = dict(
            it=it_new,
            x=torch.where(progress[:, None], x_new, x),
            f=torch.where(progress, f_new, f),
            g=torch.where(progress[:, None], g_new, g),
            alpha=alpha_new, S=S, Y=Y, pos=pos, hlen=hlen, nrej=nrej,
            nev=nev, nexh=nexh, done=done,
        )
        for k, v in new.items():
            m = run.reshape((K,) + (1,) * (v.ndim - 1))
            st[k] = torch.where(m, v, st[k])

    return OptimizationTrace(
        xs=xs,
        log_densities=fs,
        gradients=gs,
        num_valid=st["it"] + 1,
        num_bfgs_updates_rejected=st["nrej"],
        num_fn_evals=st["nev"],
        num_ls_exhausted=st["nexh"],
    )


def lbfgs_inverse_hessian(alpha, S, Y, row_mask) -> WoodburyPDMat:
    """Inverse-Hessian estimate from one history window per batch element
    (Byrd et al. 1994, Thm 2.2): ``W = diag(α) + B D Bᵀ`` with
    ``B = [αY | S]`` and

        R = triu(S Yᵀ),  E = I∘R,
        D = [[0, −R⁻¹], [−R⁻ᵀ, R⁻ᵀ(E + Y diag(α) Yᵀ) R⁻¹]].

    ``alpha (..., d)``; ``S``, ``Y`` ``(..., J, d)`` chronological (oldest
    first); ``row_mask (..., J)`` marks the rows present. Masked rows
    contribute nothing (unit diagonal in R, zeroed rows/columns of D, and the
    Woodbury column mask).
    """
    J = S.shape[-2]
    dtype = alpha.dtype
    if J == 0:
        B = torch.zeros(alpha.shape + (0,), dtype=dtype, device=alpha.device)
        D = torch.zeros(alpha.shape[:-1] + (0, 0), dtype=dtype, device=alpha.device)
        return WoodburyPDMat.from_parts(alpha, B, D)
    mask = row_mask.to(dtype)
    S = S * mask[..., None]
    Y = Y * mask[..., None]
    B = torch.cat([(alpha[..., None, :] * Y).mT, S.mT], dim=-1)  # (..., d, 2J)
    R, E, YaY, eyeJ = _compact_pieces(S, Y, alpha, mask)
    nRinv = torch.linalg.solve_triangular(R, -eyeJ.expand_as(R), upper=True)
    inner = torch.diag_embed(E) + YaY
    D22 = nRinv.mT @ inner @ nRinv
    Dtop = torch.cat([torch.zeros_like(nRinv), nRinv], dim=-1)
    Dbot = torch.cat([nRinv.mT, D22], dim=-1)
    D = torch.cat([Dtop, Dbot], dim=-2)
    return WoodburyPDMat.from_parts(alpha, B, D, col_mask=torch.cat([mask, mask], -1))


@dataclasses.dataclass(frozen=True)
class LbfgsHistoryAux:
    """Per-trajectory quantities from which the inverse Hessian at any point
    is rebuilt by a gather. Batched over lanes."""

    s_steps: torch.Tensor  # (K, L, d)
    y_steps: torch.Tensor  # (K, L, d) minimizer-view y
    accept: torch.Tensor  # (K, L) curvature-accepted flags
    alphas: torch.Tensor  # (K, L+1, d) diag H₀ per point
    acc_list: torch.Tensor  # (K, L+1) step index of the r-th accepted step
    c_points: torch.Tensor  # (K, L+1) number accepted among steps < point
    point_mask: torch.Tensor  # (K, L+1)
    num_rejected: torch.Tensor  # (K,)


def _accept_index(accept):
    """``(acc_list, c_points)``: the r-th accepted step's index (entries past
    the number accepted are never read), and the number of accepted steps
    strictly before each trajectory point."""
    K, L = accept.shape
    c = torch.cumsum(accept.long(), dim=-1)
    c_points = torch.cat([torch.zeros_like(c[:, :1]), c], dim=-1)  # (K, L+1)
    # a stable sort of "not accepted" lists the accepted steps first, in order
    acc_list = torch.argsort((~accept).long(), dim=-1, stable=True)
    acc_list = torch.cat([acc_list, torch.zeros_like(acc_list[:, :1])], dim=-1)
    return acc_list, c_points


def _windows_at(acc_list, c_points, points, history_length):
    """History-window step indices and mask at ``points (K, P)``:
    ``(idx (K, P, J), mask (K, P, J))``."""
    J = history_length
    L = acc_list.shape[-1] - 1
    ranks = (
        torch.gather(c_points, 1, points)[..., None]
        - J + torch.arange(J, device=points.device)
    )
    mask = ranks >= 0
    flat = torch.clamp(ranks, 0, L).reshape(ranks.shape[0], -1)
    idx = torch.gather(acc_list, 1, flat).reshape(ranks.shape)
    return torch.where(mask, idx, 0), mask


def lbfgs_history_aux(
    trace: OptimizationTrace, epsilon_curvature: float = 1e-12
) -> LbfgsHistoryAux:
    """Step differences, curvature acceptance and the diag-H₀ recursion."""
    xs, grads = trace.xs, trace.gradients
    s_steps = xs[:, 1:] - xs[:, :-1]
    y_steps = grads[:, :-1] - grads[:, 1:]  # ∇logp_l − ∇logp_{l+1}
    point_mask = trace.point_mask
    step_valid = point_mask[:, 1:]
    curv = torch.sum(y_steps * s_steps, dim=-1)
    accept = step_valid & (curv > epsilon_curvature * torch.sum(y_steps**2, dim=-1))
    num_rejected = torch.sum(step_valid & ~accept, dim=-1)

    alpha = torch.ones_like(xs[:, 0])
    alphas = [alpha]
    for l in range(s_steps.shape[1]):
        new = gilbert_init(alpha, s_steps[:, l], y_steps[:, l])
        alpha = torch.where(accept[:, l, None], new, alpha)
        alphas.append(alpha)
    acc_list, c_points = _accept_index(accept)
    return LbfgsHistoryAux(
        s_steps=s_steps,
        y_steps=y_steps,
        accept=accept,
        alphas=torch.stack(alphas, dim=1),
        acc_list=acc_list,
        c_points=c_points,
        point_mask=point_mask,
        num_rejected=num_rejected,
    )


def _gather_rows(t, idx):
    """``t (K, L, d)`` rows at ``idx (K, ...)``: ``(K, ..., d)``."""
    K, d = t.shape[0], t.shape[-1]
    flat = idx.reshape(K, -1)
    out = torch.gather(t, 1, flat[..., None].expand(K, flat.shape[1], d))
    return out.reshape(idx.shape + (d,))


def lbfgs_fits_at(aux: LbfgsHistoryAux, points: torch.Tensor, history_length: int):
    """Inverse-Hessian factors at trajectory ``points (K, P)``: a
    :class:`WoodburyPDMat` batched ``(K, P)``."""
    idx, mask = _windows_at(aux.acc_list, aux.c_points, points, history_length)
    S_w = _gather_rows(aux.s_steps, idx)  # (K, P, J, d)
    Y_w = _gather_rows(aux.y_steps, idx)
    return lbfgs_inverse_hessian(_gather_rows(aux.alphas, points), S_w, Y_w, mask)

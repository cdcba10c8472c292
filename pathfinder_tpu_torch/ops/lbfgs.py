"""L-BFGS with a trajectory trace, and inverse-Hessian reconstruction, batched
over lanes (counterpart of ``pathfinder_tpu/ops/lbfgs.py``).

The JAX package runs one path's ``lax.while_loop`` under ``vmap``; here the
K paths are a leading axis and the loop is the masked loop of
``ops/trajectory.py``: the body runs for all lanes and a lane whose own
condition is false keeps its whole state, which is what JAX's batched
``while_loop`` does. The trace buffers keep the fixed ``(K, maxiters+1, d)``
shape with a per-lane valid count.

The trace stores the log-density view (``logp`` and ``∇logp``); the optimizer
minimizes ``f = −logp``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.ops import linesearch as ls_ops
from pathfinder_tpu_torch.ops.kernels import linesearch_kernels
from pathfinder_tpu_torch.ops.linesearch import initial_step_size
from pathfinder_tpu_torch.ops.trajectory import (
    OptimizationTrace,
    minimize_trace,
    report,
    scale_aware_gtol,
    should_abort_nonfinite,
    start_trace,
)
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat, solve_triangular
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.rows import in_group, sum_rows

__all__ = [
    "OptimizationTrace",
    "LbfgsHistoryAux",
    "gilbert_init",
    "scale_aware_gtol",
    "should_abort_nonfinite",
    "lbfgs_carry",
    "minimize_lbfgs_trace",
    "lbfgs_inverse_hessian",
    "lbfgs_history_aux",
    "lbfgs_fits_at",
    "lbfgs_inverse_hessians",
    "history_windows",
]


def gilbert_init(alpha, s, y):
    """Diagonal H₀ refresh, Gilbert & Lemaréchal (1989) eq. 4.9, per lane."""
    a, b, c = sum_rows(
        torch.sum(y * alpha * y, dim=-1, keepdim=True),
        torch.sum(y * s, dim=-1, keepdim=True),
        torch.sum(s / alpha * s, dim=-1, keepdim=True),
    )
    return b / (a / alpha + y * y - (a / c) * (s / alpha) ** 2)


def _compact_pieces(S_masked, Y_masked, alpha, mask):
    """``R = triu(S Yᵀ)`` over active rows (identity on inactive ones),
    ``E = diag(R)`` on active rows and ``YaY = Y diag(α) Yᵀ``; shared by the
    search direction and the reconstructed fits so both mask alike."""
    J = S_masked.shape[-2]
    eyeJ = torch.eye(J, dtype=alpha.dtype, device=alpha.device)
    mm = mask[..., :, None] * mask[..., None, :]
    SY, YaY = sum_rows(S_masked @ Y_masked.mT, Y_masked @ (alpha[..., None, :] * Y_masked).mT)
    R = torch.triu(SY) * mm + eyeJ * (1.0 - mask)[..., None, :]
    E = torch.diagonal(R, dim1=-2, dim2=-1) * mask
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

    u1, u2 = sum_rows(
        (Y_ord @ (alpha * g)[..., None])[..., 0],  # B₁ᵀ g
        (S_ord @ g[..., None])[..., 0],  # B₂ᵀ g
    )
    w = solve_triangular(R, u2[..., None], upper=True)  # R⁻¹ u2
    inner = -u1[..., None] + E[..., None] * w + YaY @ w
    d2 = solve_triangular(R.mT, inner, upper=False)  # R⁻ᵀ(...)
    Hg = alpha * g - alpha * (Y_ord.mT @ w)[..., 0] + (S_ord.mT @ d2)[..., 0]
    return -Hg


def _lbfgs_direction(st, gs):
    """L-BFGS's ``direction_fn`` of ``ops/trajectory.minimize_trace``: the
    two-loop direction, the descent safeguard, and the first iteration's
    step guess."""
    g, alpha = st["g"], st["alpha"]
    direction = _two_loop_direction(g, alpha, st["S"], st["Y"], st["pos"], st["hlen"])
    # safeguard: scaled steepest descent if not a descent direction
    bad_dir = ~(sum_rows(torch.sum(g * direction, dim=-1)) < 0)
    direction = torch.where(bad_dir[:, None], -alpha * g, direction)
    alpha0 = torch.where(
        st["it"] == 0, initial_step_size(st["x"], st["f"], g), torch.ones_like(st["f"])
    )
    return direction, alpha0, None


def _lbfgs_update(st, mid, direction, ls, x_new, *, history_length, epsilon_curvature):
    """L-BFGS's ``update_fn``: the curvature-guarded history update."""
    J = history_length
    progress, alpha = ls.ok, st["alpha"]
    svec = x_new - st["x"]
    yvec = ls.g - st["g"]
    curv, yy = sum_rows(torch.sum(yvec * svec, dim=-1), torch.sum(yvec * yvec, dim=-1))
    accept = progress & (curv > epsilon_curvature * yy)
    if J > 0:
        lanes = torch.arange(x_new.shape[0], device=x_new.device)
        write = (st["pos"] + 1) % J
        S, Y = st["S"].clone(), st["Y"].clone()
        S[lanes, write] = torch.where(accept[:, None], svec, S[lanes, write])
        Y[lanes, write] = torch.where(accept[:, None], yvec, Y[lanes, write])
        pos = torch.where(accept, write, st["pos"])
    else:
        S, Y, pos = st["S"], st["Y"], st["pos"]
    return dict(
        alpha=torch.where(accept[:, None], gilbert_init(alpha, svec, yvec), alpha),
        S=S, Y=Y, pos=pos,
        hlen=torch.where(accept, torch.clamp(st["hlen"] + 1, max=J), st["hlen"]),
        nrej=st["nrej"] + (progress & ~accept).long(),
    )


def lbfgs_carry(x0: torch.Tensor, history_length: int) -> dict:
    """L-BFGS's initial carry: ``alpha`` (diag H₀), the circular history
    ``S``, ``Y`` ``(K, J, d)`` and its ``pos``, ``hlen`` and ``nrej``."""
    K, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    J = history_length
    izero = torch.zeros(K, dtype=torch.int64, device=dev)
    return dict(
        alpha=torch.ones((K, d), dtype=dtype, device=dev),
        S=torch.zeros((K, J, d), dtype=dtype, device=dev),
        Y=torch.zeros((K, J, d), dtype=dtype, device=dev),
        pos=izero, hlen=izero, nrej=izero,
    )


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
    line_search: str = "hager_zhang",
    progress_every: int = 0,
) -> OptimizationTrace:
    """Maximize ``logp`` from each row of ``x0 (K, d)`` with L-BFGS and the
    named line search (Hager-Zhang by default), recording every trajectory.

    ``value_and_grad(x (K, d)) -> (logp (K,), ∇logp (K, d))``. Stopping,
    abort and history rules are those of the JAX package: gradient-norm
    ``gtol`` floored at the problem's scale, the ``ftol`` relative-progress
    stall (in ulps), the record-then-abort rule for non-finite points, and
    the curvature-guarded history update. The masked loop over the K lanes
    is ``ops/trajectory.py``'s, shared with the other optimizers, which also
    prints the progress lines of ``progress_every > 0``.

    With the Hager-Zhang search on float32 or float64 tensors on a CUDA
    device, outside a row group, each iteration's own work is one launch of
    a CUDA kernel (``ops/kernels/linesearch_kernels.Iterations``, where
    ``iterates`` says so) beside the search's one launch an evaluation; the
    plain loop above runs everywhere else. The two agree to rounding in the
    sums over ``d``.
    """
    J = history_length
    settings = dict(maxiters=maxiters, gtol=gtol, ftol=ftol, fail_on_nonfinite=fail_on_nonfinite)
    if (line_search == "hager_zhang" and not in_group()
            and linesearch_kernels.iterates(x0.device, x0.dtype, J) and x0.shape[0] > 0):
        return _minimize_by_launches(
            value_and_grad, x0, history_length=J, epsilon_curvature=epsilon_curvature,
            max_ls_evals=max_ls_evals, c1=ls_ops.resolve_c1(c1, line_search), c2=c2,
            progress_every=progress_every, **settings)
    update_fn = functools.partial(_lbfgs_update, history_length=J,
                                  epsilon_curvature=epsilon_curvature)
    return minimize_trace(
        value_and_grad, x0, lbfgs_carry(x0, J), _lbfgs_direction, update_fn,
        max_ls_evals=max_ls_evals, c1=c1, c2=c2, line_search=line_search,
        progress_every=progress_every, name="L-BFGS", **settings,
    )


def _minimize_by_launches(value_and_grad, x0, *, maxiters, gtol, ftol, fail_on_nonfinite,
                          history_length, epsilon_curvature, max_ls_evals, c1, c2,
                          progress_every) -> OptimizationTrace:
    """:func:`minimize_lbfgs_trace` with the Hager-Zhang search, an
    iteration's own work one launch of the iteration kernel and each
    evaluation's state update one of the search's kernel: the host reads one
    flag an iteration (any lane runs on, which is also the search's first
    check) and one an evaluation."""
    neg_vg, f0, g0, gtol_eff, init_abort, ftol_rel, trace = start_trace(
        value_and_grad, x0, maxiters=maxiters, gtol=gtol, ftol=ftol,
        fail_on_nonfinite=fail_on_nonfinite)
    batch = linesearch_kernels.Iterations(
        x0, f0, g0, init_abort, gtol_eff, trace, history_length=history_length,
        maxiters=maxiters, ftol_rel=ftol_rel, epsilon_curvature=epsilon_curvature,
        fail_on_nonfinite=fail_on_nonfinite, epsilon=ls_ops.HZ_EPSILON, psi0=ls_ops.PSI0)
    s = batch.search
    k = ls_ops._HZConst(batch.f0, batch.dphi0, batch.eps_k, c1, c2, ls_ops.HZ_GAMMA,
                        ls_ops.HZ_THETA, ls_ops.HZ_EXPAND, max_ls_evals)
    x_c, more = batch.launch(start=True)
    while tracing.read(more, "ops/lbfgs.py"):
        if max_ls_evals > 0:
            ls_ops.hz_evaluations(neg_vg, s, k, batch.x, batch.p, x_c, linesearch_kernels.step)
        if progress_every > 0:
            it_before = batch.it.clone()
        x_c, more = batch.launch()
        if progress_every > 0:
            it_new = batch.it
            report(it_new, trace[1][torch.arange(it_new.shape[0], device=it_new.device), it_new],
                   it_new != it_before, every=progress_every, maxiters=maxiters, name="L-BFGS")
    xs, fs, gs = trace
    return OptimizationTrace(
        xs=xs,
        log_densities=fs,
        gradients=gs,
        num_valid=batch.it + 1,
        num_bfgs_updates_rejected=batch.nrej,
        num_fn_evals=batch.nev,
        num_ls_exhausted=batch.nexh,
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
    nRinv = solve_triangular(R, -eyeJ.expand_as(R), upper=True)
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


def history_windows(accept: torch.Tensor, history_length: int):
    """The history window of every trajectory point: for ``accept (K, L)``
    flags of steps ``1..L``, the step indices (into the ``(K, L, d)`` step
    arrays) of the at most ``J`` most recent accepted steps before each point
    ``0..L``, oldest first, and their mask: ``(idx (K, L+1, J), mask (K, L+1,
    J))``."""
    K, L = accept.shape
    acc_list, c_points = _accept_index(accept)
    points = torch.arange(L + 1, device=accept.device).expand(K, L + 1)
    return _windows_at(acc_list, c_points, points, history_length)


def lbfgs_history_aux(
    trace: OptimizationTrace, epsilon_curvature: float = 1e-12
) -> LbfgsHistoryAux:
    """Step differences, curvature acceptance and the diag-H₀ recursion."""
    xs, grads = trace.xs, trace.gradients
    s_steps = xs[:, 1:] - xs[:, :-1]
    y_steps = grads[:, :-1] - grads[:, 1:]  # ∇logp_l − ∇logp_{l+1}
    point_mask = trace.point_mask
    step_valid = point_mask[:, 1:]
    curv, yy = sum_rows(torch.sum(y_steps * s_steps, dim=-1), torch.sum(y_steps**2, dim=-1))
    accept = step_valid & (curv > epsilon_curvature * yy)
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


def lbfgs_inverse_hessians(
    trace: OptimizationTrace, history_length: int = 6, epsilon_curvature: float = 1e-12
):
    """The inverse-Hessian estimate at every trajectory point, rebuilt from
    the trace: ``(fits, point_mask, num_rejected)`` with ``fits`` a
    :class:`WoodburyPDMat` batched ``(K, L+1)`` over paths and points."""
    aux = lbfgs_history_aux(trace, epsilon_curvature)
    K, n = aux.point_mask.shape
    points = torch.arange(n, device=aux.point_mask.device).expand(K, n)
    return lbfgs_fits_at(aux, points, history_length), aux.point_mask, aux.num_rejected

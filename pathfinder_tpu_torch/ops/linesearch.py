"""Hager-Zhang line search, batched over lanes (counterpart of the JAX
package's ``hager_zhang_line_search`` in ``pathfinder_tpu/ops/linesearch.py``).

The JAX search is a one-evaluation-per-iteration ``lax.while_loop`` state
machine run under ``vmap``. Here the lanes are a leading axis: each iteration
evaluates the objective once for the batch, and a lane that has finished (or
was never active) keeps its whole state, exactly as JAX's batched
``while_loop`` freezes the carry of a lane whose own condition is false. So
every lane, including its evaluation count, follows the path it would follow
alone.

Shapes: ``x``, ``g0``, ``direction`` ``(K, d)``; ``f0``, ``alpha0``,
``active`` ``(K,)``. ``value_and_grad`` is the minimization objective over a
``(K, d)`` batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = [
    "LineSearchResult",
    "hager_zhang_line_search",
    "initial_step_size",
    "resolve_c1",
]

# Hager-Zhang stage machine
_HZ_BRACKET = 0  # expansion phase (HZ "bracket")
_HZ_U3 = 1  # inner bisection of update rule U3
_HZ_SECANT1 = 2  # first secant of secant²
_HZ_SECANT2 = 3  # second secant of secant²
_HZ_BISECT_G = 4  # γ-safeguard bisection
_HZ_DONE = 5


@dataclasses.dataclass(frozen=True)
class LineSearchResult:
    step_size: torch.Tensor  # (K,) accepted step (0 means no progress)
    f: torch.Tensor  # (K,) objective at the accepted point
    g: torch.Tensor  # (K, d) gradient at the accepted point
    num_evals: torch.Tensor  # (K,) value_and_grad evaluations used
    ok: torch.Tensor  # (K,) made finite progress with sufficient decrease
    exhausted: torch.Tensor  # (K,) budget ran out; fallback point used


def resolve_c1(c1, line_search: str) -> float:
    """Per-search sufficient-decrease default: Hager-Zhang's δ = 0.1, and the
    Armijo constant 1e-4 for the strong-Wolfe family."""
    if c1 is not None:
        return c1
    return 0.1 if line_search == "hager_zhang" else 1e-4


def initial_step_size(x0, f0, g0, psi0=0.01):
    """First-iteration step guess (HZ's ``InitialHagerZhang`` I0 rule)."""
    xinf = x0.abs().amax(dim=-1)
    ginf = g0.abs().amax(dim=-1)
    gnormsq = torch.sum(g0 * g0, dim=-1)
    a_x = psi0 * xinf / torch.clamp(ginf, min=1e-32)
    a_f = psi0 * f0.abs() / torch.clamp(gnormsq, min=1e-32)
    one = torch.ones_like(f0)
    a = torch.where(xinf > 0, a_x, torch.where(f0.abs() > 0, a_f, one))
    return torch.where(torch.isfinite(a) & (a > 0), a, one)


def _secant(a, dphi_a, b, dphi_b):
    """Secant step for φ': root of the linear interpolant of φ' on [a, b]."""
    denom = dphi_b - dphi_a
    c = (a * dphi_b - b * dphi_a) / denom
    ok = torch.isfinite(c) & (denom.abs() > 1e-32)
    return torch.where(ok, c, 0.5 * (a + b))


def _where(mask, new: dict, old: dict) -> dict:
    """Per-lane select over a dict of (K,) or (K, d) tensors."""
    out = {}
    for k, v in new.items():
        m = mask if v.ndim == 1 else mask[:, None]
        out[k] = torch.where(m, v, old[k])
    return out


def hager_zhang_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    alpha0: torch.Tensor,
    c1: float = 0.1,
    c2: float = 0.9,
    max_evals: int = 12,
    expand: float = 5.0,
    epsilon: float = 1e-6,
    gamma: float = 0.66,
    theta: float = 0.5,
    active: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """Hager-Zhang line search (Hager & Zhang 2005, CG_DESCENT).

    Accepts ``a`` satisfying the weak Wolfe conditions
    ``φ(a) ≤ φ(0) + δ·a·φ'(0)`` and ``φ'(a) ≥ σ·φ'(0)``, or the approximate
    Wolfe conditions ``(2δ−1)·φ'(0) ≥ φ'(a) ≥ σ·φ'(0)`` when
    ``φ(a) ≤ φ(0) + ε·|φ(0)|``, with δ=``c1``, σ=``c2``. Interval
    management, the U3 bisection, secant² steps, the γ rule and the
    backtracking on non-finite trial values are those of the JAX package.
    Lanes with ``active`` False do no work and report zero evaluations.
    """
    dtype = x.dtype
    K = x.shape[0]
    p = direction
    dphi0 = torch.sum(g0 * p, dim=-1)
    zero = torch.zeros_like(f0)
    eps_k = epsilon * f0.abs()
    delta, sigma = c1, c2
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=x.device)

    s = dict(
        stage=torch.where(active, _HZ_BRACKET, _HZ_DONE).to(torch.int64),
        nev=torch.zeros(K, dtype=torch.int64, device=x.device),
        c=alpha0.to(dtype).expand(K).clone(),
        a=zero, phi_a=f0, dphi_a=dphi0, g_a=g0,
        b=zero, phi_b=f0, dphi_b=dphi0,
        a0=zero, b0=zero, phi_a0=f0, dphi_a0=dphi0, phi_b0=f0, dphi_b0=dphi0,
        a_acc=zero, phi_acc=f0, g_acc=g0,
        accepted=torch.zeros(K, dtype=torch.bool, device=x.device),
    )

    while True:
        running = (s["stage"] != _HZ_DONE) & (s["nev"] < max_evals)
        if not bool(running.any()):
            break
        c = s["c"]
        phi_c, g_c = value_and_grad(x + c[:, None] * p)
        phi_c, g_c = phi_c.to(dtype), g_c.to(dtype)
        dphi_c = torch.sum(g_c * p, dim=-1)
        nev = s["nev"] + 1
        bad = ~(torch.isfinite(phi_c) & torch.isfinite(dphi_c))

        wolfe = (phi_c <= f0 + delta * c * dphi0) & (dphi_c >= sigma * dphi0)
        approx = (
            (phi_c <= f0 + eps_k)
            & (dphi_c >= sigma * dphi0)
            & (dphi_c <= (2.0 * delta - 1.0) * dphi0)
        )
        accept = (~bad) & (c > 0) & (wolfe | approx)

        upd_b = (~bad) & (dphi_c >= 0)
        upd_a = (~bad) & (~upd_b) & (phi_c <= f0 + eps_k)
        upd_u3 = (~bad) & (~upd_b) & (~upd_a)

        stage = s["stage"]
        in_bracket = stage == _HZ_BRACKET
        in_u3 = stage == _HZ_U3
        in_sec1 = stage == _HZ_SECANT1
        in_sec2 = (stage == _HZ_SECANT2) | (stage == _HZ_BISECT_G)

        new_a = torch.where(upd_a, c, s["a"])
        new_phi_a = torch.where(upd_a, phi_c, s["phi_a"])
        new_dphi_a = torch.where(upd_a, dphi_c, s["dphi_a"])
        new_g_a = torch.where(upd_a[:, None], g_c, s["g_a"])
        move_b = upd_b | upd_u3
        new_b = torch.where(move_b, c, s["b"])
        new_phi_b = torch.where(move_b, phi_c, s["phi_b"])
        new_dphi_b = torch.where(move_b, dphi_c, s["dphi_b"])

        width_new = (new_b - new_a).abs()
        gamma_ok = width_new <= gamma * (s["b0"] - s["a0"]).abs()

        stage_next = torch.where(
            bad,
            stage,
            torch.where(
                in_bracket,
                torch.where(upd_b, _HZ_SECANT1, torch.where(upd_a, _HZ_BRACKET, _HZ_U3)),
                torch.where(
                    in_u3,
                    torch.where(upd_b, _HZ_SECANT1, _HZ_U3),
                    torch.where(
                        upd_u3,
                        _HZ_U3,
                        torch.where(
                            in_sec1,
                            _HZ_SECANT2,
                            torch.where(gamma_ok, _HZ_SECANT1, _HZ_BISECT_G),
                        ),
                    ),
                ),
            ),
        )
        stage_next = torch.where(accept, _HZ_DONE, stage_next)

        mid = new_a + theta * (new_b - new_a)
        sec = _secant(new_a, new_dphi_a, new_b, new_dphi_b)
        sec2 = torch.where(
            upd_b,
            _secant(s["b0"], s["dphi_b0"], new_b, new_dphi_b),
            _secant(s["a0"], s["dphi_a0"], new_a, new_dphi_a),
        )
        lo, hi = torch.minimum(new_a, new_b), torch.maximum(new_a, new_b)
        sec_safe = torch.where((sec > lo) & (sec < hi), sec, mid)
        sec2_safe = torch.where((sec2 > lo) & (sec2 < hi), sec2, mid)
        c_next = torch.where(
            bad,
            s["a"] + 0.3 * (c - s["a"]),  # backtrack toward the low endpoint
            torch.where(
                stage_next == _HZ_BRACKET,
                c * expand,
                torch.where(
                    stage_next == _HZ_U3,
                    mid,
                    torch.where(
                        stage_next == _HZ_SECANT2,
                        sec2_safe,
                        torch.where(stage_next == _HZ_BISECT_G, mid, sec_safe),
                    ),
                ),
            ),
        )

        # snapshot the interval at entry to a secant² cycle, and refresh it
        # when a full cycle restarts
        snap = ((stage_next == _HZ_SECANT1) & ~in_sec1) | (
            in_sec2 & (stage_next == _HZ_SECANT1)
        )
        new = dict(
            stage=stage_next,
            nev=nev,
            c=c_next,
            a=new_a, phi_a=new_phi_a, dphi_a=new_dphi_a, g_a=new_g_a,
            b=new_b, phi_b=new_phi_b, dphi_b=new_dphi_b,
            a0=torch.where(snap, new_a, s["a0"]),
            b0=torch.where(snap, new_b, s["b0"]),
            phi_a0=torch.where(snap, new_phi_a, s["phi_a0"]),
            dphi_a0=torch.where(snap, new_dphi_a, s["dphi_a0"]),
            phi_b0=torch.where(snap, new_phi_b, s["phi_b0"]),
            dphi_b0=torch.where(snap, new_dphi_b, s["dphi_b0"]),
            a_acc=torch.where(accept, c, s["a_acc"]),
            phi_acc=torch.where(accept, phi_c, s["phi_acc"]),
            g_acc=torch.where(accept[:, None], g_c, s["g_acc"]),
            accepted=s["accepted"] | accept,
        )
        s = _where(running, new, s)

    # exhausted budget: fall back to the low endpoint, which by invariant
    # satisfies φ(a) ≤ φ0 + εk with φ'(a) < 0; require strict decrease
    fallback_ok = (s["a"] > 0) & torch.isfinite(s["phi_a"]) & (s["phi_a"] < f0)
    acc = s["accepted"]
    a = torch.where(acc, s["a_acc"], torch.where(fallback_ok, s["a"], zero))
    f = torch.where(acc, s["phi_acc"], torch.where(fallback_ok, s["phi_a"], f0))
    g = torch.where(
        acc[:, None], s["g_acc"], torch.where(fallback_ok[:, None], s["g_a"], g0)
    )
    return LineSearchResult(
        step_size=a, f=f, g=g, num_evals=s["nev"], ok=acc | fallback_ok,
        exhausted=fallback_ok & ~acc,
    )

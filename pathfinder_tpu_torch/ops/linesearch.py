"""Line searches, batched over lanes: Hager-Zhang, Moré-Thuente, strong-Wolfe
bracket and zoom, and Armijo backtracking (counterparts of the four searches
of ``pathfinder_tpu/ops/linesearch.py``).

A JAX search is a one-evaluation-per-iteration ``lax.while_loop`` state
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
from typing import Callable, NamedTuple, Optional

import torch

from pathfinder_tpu_torch.ops.kernels import linesearch_kernels
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.rows import max_rows, sum_rows

__all__ = [
    "LineSearchResult",
    "hager_zhang_line_search",
    "hz_evaluations",
    "backtracking_line_search",
    "more_thuente_line_search",
    "wolfe_line_search",
    "initial_step_size",
    "resolve_c1",
    "resolve_line_search",
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


def resolve_line_search(name: str) -> Callable:
    """The search function of a name, shared by the trajectory optimizers."""
    table = {
        "hager_zhang": hager_zhang_line_search,
        "more_thuente": more_thuente_line_search,
        "wolfe": wolfe_line_search,
        "backtracking": backtracking_line_search,
    }
    if name not in table:
        raise ValueError(f"unknown line_search {name!r}")
    return table[name]


def resolve_c1(c1, line_search: str) -> float:
    """Per-search sufficient-decrease default: Hager-Zhang's δ = 0.1, and the
    Armijo constant 1e-4 for the strong-Wolfe family."""
    if c1 is not None:
        return c1
    return 0.1 if line_search == "hager_zhang" else 1e-4


# Hager-Zhang's settings that the trajectory optimizers leave at their defaults
HZ_EXPAND = 5.0
HZ_EPSILON = 1e-6
HZ_GAMMA = 0.66
HZ_THETA = 0.5
PSI0 = 0.01  # initial_step_size's default


def initial_step_size(x0, f0, g0, psi0=PSI0):
    """First-iteration step guess (HZ's ``InitialHagerZhang`` I0 rule)."""
    xinf, ginf = max_rows(x0.abs().amax(dim=-1), g0.abs().amax(dim=-1))
    gnormsq = sum_rows(torch.sum(g0 * g0, dim=-1))
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


class _HZConst(NamedTuple):
    """A Hager-Zhang search's constants: φ(0), φ'(0) and ε|φ(0)| of each
    lane, and its settings."""

    f0: torch.Tensor
    dphi0: torch.Tensor
    eps_k: torch.Tensor
    delta: float
    sigma: float
    gamma: float
    theta: float
    expand: float
    max_evals: int


def _hz_running(s: dict, max_evals: int) -> torch.Tensor:
    """The lanes that evaluate next: not done, and within the budget."""
    return (s["stage"] != _HZ_DONE) & (s["nev"] < max_evals)


def _hz_step_torch(s: dict, phi_c, g_c, dphi_c, x, p, k: _HZConst) -> tuple:
    """One Hager-Zhang evaluation's state update in plain torch: from the
    state ``s`` and the values ``φ(c)``, ``∇f(x + c p)`` and ``φ'(c)`` at
    its trial steps, ``(the new state, the next trial point x + c p of
    every lane, whether any lane runs on)``. A lane that did not run keeps
    its state. The kernel ``ops/kernels/linesearch_kernels.step`` gives the
    same bits on the card."""
    running = _hz_running(s, k.max_evals)
    f0, dphi0, eps_k = k.f0, k.dphi0, k.eps_k
    delta, sigma = k.delta, k.sigma
    c = s["c"]
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
    gamma_ok = width_new <= k.gamma * (s["b0"] - s["a0"]).abs()

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

    mid = new_a + k.theta * (new_b - new_a)
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
            c * k.expand,
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
    return s, x + s["c"][:, None] * p, _hz_running(s, k.max_evals).any()


def _hz_start(x, f0, g0, p, alpha0, active, c1, c2, max_evals, expand, epsilon, gamma,
              theta) -> tuple:
    """A Hager-Zhang search's initial state (the plain version's dict) and
    its constants."""
    K = x.shape[0]
    dphi0 = sum_rows(torch.sum(g0 * p, dim=-1))
    zero = torch.zeros_like(f0)
    eps_k = epsilon * f0.abs()
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=x.device)
    s = dict(
        stage=torch.where(active, _HZ_BRACKET, _HZ_DONE).to(torch.int64),
        nev=torch.zeros(K, dtype=torch.int64, device=x.device),
        c=alpha0.to(x.dtype).expand(K).clone(),
        a=zero, phi_a=f0, dphi_a=dphi0, g_a=g0,
        b=zero, phi_b=f0, dphi_b=dphi0,
        a0=zero, b0=zero, phi_a0=f0, dphi_a0=dphi0, phi_b0=f0, dphi_b0=dphi0,
        a_acc=zero, phi_acc=f0, g_acc=g0,
        accepted=torch.zeros(K, dtype=torch.bool, device=x.device),
    )
    return s, _HZConst(f0, dphi0, eps_k, c1, c2, gamma, theta, expand, max_evals)


def _hz_result(s: dict, k: _HZConst, g0) -> LineSearchResult:
    """The accepted point; where the budget ran out, the low endpoint,
    which by invariant satisfies φ(a) ≤ φ0 + εk with φ'(a) < 0, if it
    decreased φ strictly; else no step."""
    f0 = k.f0
    fallback_ok = (s["a"] > 0) & torch.isfinite(s["phi_a"]) & (s["phi_a"] < f0)
    acc = s["accepted"]
    a = torch.where(acc, s["a_acc"], torch.where(fallback_ok, s["a"], torch.zeros_like(f0)))
    f = torch.where(acc, s["phi_acc"], torch.where(fallback_ok, s["phi_a"], f0))
    g = torch.where(
        acc[:, None], s["g_acc"], torch.where(fallback_ok[:, None], s["g_a"], g0)
    )
    return LineSearchResult(
        step_size=a, f=f, g=g, num_evals=s["nev"], ok=acc | fallback_ok,
        exhausted=fallback_ok & ~acc,
    )


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
    expand: float = HZ_EXPAND,
    epsilon: float = HZ_EPSILON,
    gamma: float = HZ_GAMMA,
    theta: float = HZ_THETA,
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

    Each evaluation's state update is one launch of a CUDA kernel where
    ``x`` is a float32 or float64 tensor on a CUDA device
    (``ops/kernels/linesearch_kernels.py``), and the plain version
    :func:`_hz_step_torch` elsewhere; the two give the same bits.
    """
    p = direction
    s, k = _hz_start(x, f0, g0, p, alpha0, active, c1, c2, max_evals, expand, epsilon, gamma,
                     theta)
    more = _hz_running(s, max_evals).any()
    x_c = x + s["c"][:, None] * p
    if linesearch_kernels.takes(x.device, x.dtype):
        s, step = linesearch_kernels.pack(s, k), linesearch_kernels.step
    else:
        step = _hz_step_torch
    if tracing.read(more, "ops/linesearch.py"):
        s = hz_evaluations(value_and_grad, s, k, x, p, x_c, step)
    return _hz_result(s, k, g0)


def hz_evaluations(value_and_grad: Callable, s: dict, k: _HZConst, x, p, x_c, step: Callable):
    """A Hager-Zhang search's evaluations from the state ``s`` and its first
    trial point ``x_c``, the caller having found that a lane runs: each
    evaluates the batch at the trial points, updates the state by ``step``
    and reads whether any lane runs on. Returns the final state."""
    while True:
        phi_c, g_c = value_and_grad(x_c)
        phi_c, g_c = phi_c.to(x.dtype), g_c.to(x.dtype)
        dphi_c = sum_rows(torch.sum(g_c * p, dim=-1))
        s, x_c, more = step(s, phi_c, g_c, dphi_c, x, p, k)
        if not tracing.read(more, "ops/linesearch.py"):
            return s


def backtracking_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    alpha0: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,  # unused; the searches share one signature
    max_evals: int = 12,
    shrink: float = 0.5,
    active: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """Armijo backtracking: halve the step until sufficient decrease holds
    at a finite value. Cheaper per step than a Wolfe search, but accepted
    steps may violate the curvature condition, so more L-BFGS updates are
    rejected by the positive-definiteness guard. Lanes with ``active`` False
    do no work and report zero evaluations."""
    dtype = x.dtype
    K = x.shape[0]
    p = direction
    dphi0 = sum_rows(torch.sum(g0 * p, dim=-1))
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=x.device)
    s = dict(
        a=alpha0.to(dtype).expand(K).clone(), f=f0, g=g0,
        nev=torch.zeros(K, dtype=torch.int64, device=x.device),
        ok=torch.zeros(K, dtype=torch.bool, device=x.device),
    )
    while True:
        running = active & ~s["ok"] & (s["nev"] < max_evals)
        if not tracing.read(running.any(), "ops/linesearch.py"):
            break
        a = s["a"]
        fa, ga = value_and_grad(x + a[:, None] * p)
        fa, ga = fa.to(dtype), ga.to(dtype)
        ok = torch.isfinite(fa) & (fa <= f0 + c1 * a * dphi0)
        new = dict(a=torch.where(ok, a, a * shrink), f=fa, g=ga, nev=s["nev"] + 1, ok=ok)
        s = _where(running, new, s)
    ok = s["ok"]
    return LineSearchResult(
        step_size=torch.where(ok, s["a"], torch.zeros_like(f0)),
        f=torch.where(ok, s["f"], f0),
        g=torch.where(ok[:, None], s["g"], g0),
        num_evals=s["nev"], ok=ok, exhausted=torch.zeros_like(ok),
    )


def _nz(v, tiny=1e-32):
    """``v`` with exact zeros replaced, to guard a denominator."""
    return torch.where(v.abs() > 0, v, torch.full_like(v, tiny))


def _mt_cubic_quad(stx, fx, dx, stp, fp, dp):
    """Shared pieces of the MINPACK ``dcstep`` interpolants between ``stx``
    and ``stp``: ``(θ, γ)`` of the cubic, its discriminant clamped to ≥ 0
    (case 3's cubic may have no minimizer). A trial that landed exactly on
    ``stx`` must not poison the interpolants: the safeguarded caller then
    just bisects."""
    theta = 3.0 * (fx - fp) / _nz(stp - stx) + dx + dp
    s = torch.clamp(torch.maximum(torch.maximum(theta.abs(), dx.abs()), dp.abs()), min=1e-32)
    disc = (theta / s) ** 2 - (dx / s) * (dp / s)
    gamma = s * torch.sqrt(torch.clamp(disc, min=0.0))
    return theta, gamma


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stmin, stmax):
    """MINPACK-2 ``dcstep`` (Moré & Thuente 1994 §4): from the best point
    ``stx``, the other endpoint ``sty`` and a new trial ``stp`` with values
    and derivatives of the (possibly modified) objective, the next trial by
    safeguarded cubic and quadratic interpolation, and the updated interval.
    All four cases are computed and selected per lane. Returns ``(stx, fx,
    dx, sty, fy, dy, stp_next, brackt, moved_x)``; ``moved_x`` says that the
    best point moved to ``stp`` (the caller then saves its gradient)."""
    sgnd = dp * torch.sign(dx)

    # case 1: higher function value, so the minimum is bracketed
    theta1, gamma1 = _mt_cubic_quad(stx, fx, dx, stp, fp, dp)
    gamma1 = torch.where(stp < stx, -gamma1, gamma1)
    p1 = (gamma1 - dx) + theta1
    q1 = ((gamma1 - dx) + gamma1) + dp
    stpc1 = stx + (p1 / _nz(q1)) * (stp - stx)
    denq1 = (fx - fp) / _nz(stp - stx) + dx
    stpq1 = stx + (dx / _nz(denq1)) / 2.0 * (stp - stx)
    case1_step = torch.where(
        (stpc1 - stx).abs() < (stpq1 - stx).abs(), stpc1, stpc1 + (stpq1 - stpc1) / 2.0
    )

    # case 2: lower value, derivatives of opposite sign: bracketed
    theta2, gamma2 = _mt_cubic_quad(stp, fp, dp, stx, fx, dx)
    gamma2 = torch.where(stp > stx, -gamma2, gamma2)
    p2 = (gamma2 - dp) + theta2
    q2 = ((gamma2 - dp) + gamma2) + dx
    stpc2 = stp + (p2 / _nz(q2)) * (stx - stp)
    den2 = dp - dx
    stpq2 = stp + (dp / _nz(den2)) * (stx - stp)
    case2_step = torch.where((stpc2 - stp).abs() > (stpq2 - stp).abs(), stpc2, stpq2)

    # case 3: lower value, same sign, |dp| < |dx|
    theta3, gamma3 = _mt_cubic_quad(stp, fp, dp, stx, fx, dx)
    gamma3 = torch.where(stp > stx, -gamma3, gamma3)
    p3 = (gamma3 - dp) + theta3
    q3 = (gamma3 + (dx - dp)) + gamma3
    r3 = p3 / _nz(q3)
    stpc3 = torch.where(
        (r3 < 0.0) & (gamma3 != 0.0),
        stp + r3 * (stx - stp),
        torch.where(stp > stx, stmax, stmin),
    )
    stpq3 = stp + (dp / _nz(den2)) * (stx - stp)
    c3_brackt = torch.where((stpc3 - stp).abs() < (stpq3 - stp).abs(), stpc3, stpq3)
    c3_brackt = torch.where(
        stp > stx,
        torch.minimum(stp + 0.66 * (sty - stp), c3_brackt),
        torch.maximum(stp + 0.66 * (sty - stp), c3_brackt),
    )
    c3_free = torch.clamp(
        torch.where((stpc3 - stp).abs() > (stpq3 - stp).abs(), stpc3, stpq3), stmin, stmax
    )
    case3_step = torch.where(brackt, c3_brackt, c3_free)

    # case 4: lower value, same sign, |dp| ≥ |dx|
    theta4, gamma4 = _mt_cubic_quad(sty, fy, dy, stp, fp, dp)
    gamma4 = torch.where(stp > sty, -gamma4, gamma4)
    p4 = (gamma4 - dp) + theta4
    q4 = ((gamma4 - dp) + gamma4) + dy
    stpc4 = stp + (p4 / _nz(q4)) * (sty - stp)
    case4_step = torch.where(brackt, stpc4, torch.where(stp > stx, stmax, stmin))

    is1 = fp > fx
    is2 = (~is1) & (sgnd < 0.0)
    is3 = (~is1) & (~is2) & (dp.abs() < dx.abs())
    stpf = torch.where(
        is1, case1_step, torch.where(is2, case2_step, torch.where(is3, case3_step, case4_step))
    )
    brackt_new = brackt | is1 | is2

    # the interval update (dcstep's epilogue)
    sty_n = torch.where(is1, stp, torch.where(is2, stx, sty))
    fy_n = torch.where(is1, fp, torch.where(is2, fx, fy))
    dy_n = torch.where(is1, dp, torch.where(is2, dx, dy))
    moved_x = ~is1
    stx_n = torch.where(moved_x, stp, stx)
    fx_n = torch.where(moved_x, fp, fx)
    dx_n = torch.where(moved_x, dp, dx)
    stp_next = torch.clamp(stpf, stmin, stmax)
    return stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, stp_next, brackt_new, moved_x


def _finish(s, best, f0, g0, fallback_ok) -> LineSearchResult:
    """The accepted point, else the best sufficient-decrease point ``best``
    (keys of ``a``, ``phi``, ``g`` in ``s``) where ``fallback_ok``, else no
    step."""
    acc = s["accepted"]
    a_key, phi_key, g_key = best
    return LineSearchResult(
        step_size=torch.where(
            acc, s["a_acc"], torch.where(fallback_ok, s[a_key], torch.zeros_like(f0))
        ),
        f=torch.where(acc, s["phi_acc"], torch.where(fallback_ok, s[phi_key], f0)),
        g=torch.where(
            acc[:, None], s["g_acc"], torch.where(fallback_ok[:, None], s[g_key], g0)
        ),
        num_evals=s["nev"], ok=acc | fallback_ok, exhausted=fallback_ok & ~acc,
    )


def more_thuente_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    alpha0: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 12,
    alpha_min: float = 1e-16,
    alpha_max: float = 65536.0,
    xtrapl: float = 1.1,
    xtrapu: float = 4.0,
    active: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """Moré-Thuente line search (Moré & Thuente 1994; MINPACK-2
    ``dcsrch``/``dcstep``).

    Finds ``a`` with the strong Wolfe conditions ``φ(a) ≤ φ(0) + c1·a·φ'(0)``
    and ``|φ'(a)| ≤ c2·|φ'(0)|`` by the two-stage scheme: stage 1 applies
    the interval updates to the modified function ψ(a) = φ(a) − φ(0) −
    c1·a·φ'(0) until a point with ψ(a) ≤ 0 and φ'(a) ≥ min(c1, c2)·φ'(0)
    appears, then switches to φ itself; trial steps come from ``dcstep``
    with the 0.66-width bisection fallback. Non-finite trial values
    backtrack toward the best point. Lanes with ``active`` False do no work
    and report zero evaluations.
    """
    dtype = x.dtype
    K = x.shape[0]
    p = direction
    dphi0 = sum_rows(torch.sum(g0 * p, dim=-1))
    zero = torch.zeros_like(f0)
    gtest = c1 * dphi0  # slope of the sufficient-decrease line
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=x.device)
    false = torch.zeros(K, dtype=torch.bool, device=x.device)
    width0 = torch.full_like(f0, alpha_max - alpha_min)
    s = dict(
        nev=torch.zeros(K, dtype=torch.int64, device=x.device),
        stp=torch.clamp(alpha0.to(dtype).expand(K).clone(), alpha_min, alpha_max),
        brackt=false, stage1=~false,
        stx=zero, fx=f0, dx=dphi0, g_x=g0,  # the best point so far
        sty=zero, fy=f0, dy=dphi0,  # the other endpoint
        width=width0, width1=2.0 * width0,
        a_acc=zero, phi_acc=f0, g_acc=g0, accepted=false,
    )

    while True:
        running = (
            active & ~s["accepted"] & (s["nev"] < max_evals)
            & (~s["brackt"] | ((s["sty"] - s["stx"]).abs() > 1e-12 * s["stx"].abs()))
        )
        if not tracing.read(running.any(), "ops/linesearch.py"):
            break
        stp = s["stp"]
        fp, g_p = value_and_grad(x + stp[:, None] * p)
        fp, g_p = fp.to(dtype), g_p.to(dtype)
        dp = sum_rows(torch.sum(g_p * p, dim=-1))
        bad = ~(torch.isfinite(fp) & torch.isfinite(dp))

        suff = fp <= f0 + stp * gtest
        curv = dp.abs() <= c2 * dphi0.abs()
        accept = (~bad) & suff & curv & (stp > 0)
        # stage switch: ψ(stp) ≤ 0 and φ'(stp) ≥ min(c1, c2)·φ'(0)
        stage1 = s["stage1"] & ~(suff & (dp >= min(c1, c2) * dphi0))

        # bounds of the interval of uncertainty for the next trial
        stmin = torch.where(
            s["brackt"], torch.minimum(s["stx"], s["sty"]), stp + xtrapl * (stp - s["stx"])
        )
        stmax = torch.where(
            s["brackt"], torch.maximum(s["stx"], s["sty"]), stp + xtrapu * (stp - s["stx"])
        )

        # the modified function ψ in stage 1 while ψ(stp) > 0 and φ(stp) ≤ φ(stx)
        use_mod = stage1 & (fp <= s["fx"]) & (~suff)
        shift = torch.where(use_mod, gtest, zero)
        stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, stp_n, brackt_n, moved_x = _dcstep(
            s["stx"], s["fx"] - s["stx"] * shift, s["dx"] - shift,
            s["sty"], s["fy"] - s["sty"] * shift, s["dy"] - shift,
            stp, fp - stp * shift, dp - shift, s["brackt"], stmin, stmax,
        )
        # undo the ψ shift on the stored values
        fx_n, fy_n = fx_n + stx_n * shift, fy_n + sty_n * shift
        dx_n, dy_n = dx_n + shift, dy_n + shift

        # the 0.66 bisection safeguard on bracketed intervals
        wid = (sty_n - stx_n).abs()
        force_bisect = brackt_n & (wid >= 0.66 * s["width1"])
        stp_n = torch.where(force_bisect, stx_n + 0.5 * (sty_n - stx_n), stp_n)
        stp_n = torch.clamp(stp_n, alpha_min, alpha_max)

        good = dict(
            stp=stp_n, brackt=brackt_n, stage1=stage1,
            stx=stx_n, fx=fx_n, dx=dx_n,
            g_x=torch.where(moved_x[:, None], g_p, s["g_x"]),
            sty=sty_n, fy=fy_n, dy=dy_n,
            width=torch.where(brackt_n, wid, s["width"]),
            width1=torch.where(brackt_n, s["width"], s["width1"]),
        )
        # a non-finite trial is discarded: backtrack toward the best point
        kept = dict({k: s[k] for k in good}, stp=s["stx"] + 0.3 * (stp - s["stx"]))
        new = dict(
            _where(~bad, good, kept),
            nev=s["nev"] + 1,
            a_acc=torch.where(accept, stp, s["a_acc"]),
            phi_acc=torch.where(accept, fp, s["phi_acc"]),
            g_acc=torch.where(accept[:, None], g_p, s["g_acc"]),
            accepted=s["accepted"] | accept,
        )
        s = _where(running, new, s)

    # exhausted budget: fall back to the best sufficient-decrease point (stx)
    fallback_ok = (
        (s["stx"] > 0) & torch.isfinite(s["fx"]) & (s["fx"] < f0)
        & (s["fx"] <= f0 + s["stx"] * gtest)
    )
    return _finish(s, ("stx", "fx", "g_x"), f0, g0, fallback_ok)


# stages of the bracket-and-zoom search
_BRACKET = 0
_ZOOM = 1
_DONE = 2


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant on [a, b] (N&W eq. 3.59), the
    midpoint where it does not exist."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    under = d1 * d1 - dfa * dfb
    d2 = torch.sqrt(torch.clamp(under, min=0.0)) * torch.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    cand = b - (b - a) * (dfb + d2 - d1) / denom
    ok = (under >= 0) & torch.isfinite(cand) & (denom.abs() > 1e-32)
    return torch.where(ok, cand, 0.5 * (a + b))


def wolfe_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    alpha0: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_evals: int = 12,
    expand: float = 2.0,
    active: Optional[torch.Tensor] = None,
) -> LineSearchResult:
    """Strong-Wolfe bracket and zoom (Nocedal & Wright, Alg. 3.5 and 3.6)
    with cubic interpolation: ``a`` with ``f(x + a p) ≤ f0 + c1·a·p·g0`` and
    ``|p·g(x + a p)| ≤ −c2·p·g0`` within ``max_evals`` evaluations.
    Non-finite trial values backtrack toward the last finite point, so the
    search is safe on densities with bounded support. Lanes with ``active``
    False do no work and report zero evaluations.
    """
    dtype = x.dtype
    K = x.shape[0]
    p = direction
    dphi0 = sum_rows(torch.sum(g0 * p, dim=-1))
    zero = torch.zeros_like(f0)
    eps = torch.finfo(dtype).eps
    if active is None:
        active = torch.ones(K, dtype=torch.bool, device=x.device)
    izero = torch.zeros(K, dtype=torch.int64, device=x.device)
    s = dict(
        stage=torch.where(active, _BRACKET, _DONE).to(torch.int64),
        it=izero, nev=izero,
        a_prev=zero, phi_prev=f0, dphi_prev=dphi0,
        a_cur=alpha0.to(dtype).expand(K).clone(),
        a_lo=zero, phi_lo=f0, dphi_lo=dphi0, g_lo=g0,  # lo keeps sufficient decrease
        a_hi=zero, phi_hi=f0, dphi_hi=dphi0,
        a_acc=zero, phi_acc=f0, g_acc=g0,
        accepted=torch.zeros(K, dtype=torch.bool, device=x.device),
    )

    while True:
        # once the zoom interval has shrunk to a few ulps the clipped cubic
        # would evaluate the same point again and again
        collapsed = (s["stage"] == _ZOOM) & (
            (s["a_hi"] - s["a_lo"]).abs()
            <= 4 * eps * torch.maximum(s["a_lo"].abs(), s["a_hi"].abs())
        )
        running = (s["stage"] != _DONE) & (s["nev"] < max_evals) & ~collapsed
        if not tracing.read(running.any(), "ops/linesearch.py"):
            break
        b = s["stage"] == _BRACKET
        # bracket evaluates a_cur; zoom the safeguarded cubic minimizer of [lo, hi]
        width = (s["a_hi"] - s["a_lo"]).abs()
        a_cub = _cubic_min(
            s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"], s["phi_hi"], s["dphi_hi"]
        )
        lo_b = torch.minimum(s["a_lo"], s["a_hi"]) + 0.1 * width
        hi_b = torch.maximum(s["a_lo"], s["a_hi"]) - 0.1 * width
        a = torch.where(b, s["a_cur"], torch.clamp(a_cub, lo_b, hi_b))

        phi_a, g_a = value_and_grad(x + a[:, None] * p)
        phi_a, g_a = phi_a.to(dtype), g_a.to(dtype)
        dphi_a = sum_rows(torch.sum(g_a * p, dim=-1))
        bad = ~(torch.isfinite(phi_a) & torch.isfinite(dphi_a))
        suff = phi_a <= f0 + c1 * a * dphi0
        curv = dphi_a.abs() <= -c2 * dphi0

        # bracket classification (N&W 3.5)
        br_zoom_hi = (~bad) & ((~suff) | ((s["it"] > 0) & (phi_a >= s["phi_prev"])))
        br_accept = (~bad) & ~br_zoom_hi & curv
        br_zoom_lo = (~bad) & ~br_zoom_hi & ~br_accept & (dphi_a >= 0)
        br_expand = (~bad) & ~br_zoom_hi & ~br_accept & ~br_zoom_lo
        # zoom classification (N&W 3.6)
        zm_shrink = bad | (~suff) | (phi_a >= s["phi_lo"])
        zm_accept = (~zm_shrink) & curv
        zm_move_lo = (~zm_shrink) & ~zm_accept
        flip = zm_move_lo & (dphi_a * (s["a_hi"] - s["a_lo"]) >= 0)
        accept = torch.where(b, br_accept, zm_accept)

        # lo: bracket keeps it in step with a_prev (expand and zoom_lo set it
        # to the evaluated point); zoom moves it on zm_move_lo
        set_lo = torch.where(b, br_expand | br_zoom_lo, zm_move_lo)
        from_prev = b & br_zoom_hi

        def lo(new, prev, old):
            return torch.where(set_lo, new, torch.where(from_prev, prev, old))

        # hi: a non-finite zoom trial still moves a_hi to the trial point but
        # is recorded as φ = +inf, dφ = 0, an "infinitely high" endpoint: the
        # cubic then degrades to bisection toward the support's boundary
        set_hi = torch.where(b, br_zoom_hi, zm_shrink)
        hi_prev = b & br_zoom_lo

        def hi(new, prev, lo_old, old):
            return torch.where(
                set_hi, new, torch.where(hi_prev, prev, torch.where(flip, lo_old, old))
            )

        upd_prev = b & br_expand
        to_zoom = b & (br_zoom_hi | br_zoom_lo)
        new = dict(
            stage=torch.where(accept, _DONE, torch.where(to_zoom, _ZOOM, s["stage"])),
            it=s["it"] + 1,
            nev=s["nev"] + 1,
            a_prev=torch.where(upd_prev, a, s["a_prev"]),
            phi_prev=torch.where(upd_prev, phi_a, s["phi_prev"]),
            dphi_prev=torch.where(upd_prev, dphi_a, s["dphi_prev"]),
            # next bracket trial: backtrack on a bad value, expand otherwise
            a_cur=torch.where(
                b & bad, s["a_prev"] + 0.3 * (a - s["a_prev"]),
                torch.where(upd_prev, a * expand, s["a_cur"]),
            ),
            a_lo=lo(a, s["a_prev"], s["a_lo"]),
            phi_lo=lo(phi_a, s["phi_prev"], s["phi_lo"]),
            dphi_lo=lo(dphi_a, s["dphi_prev"], s["dphi_lo"]),
            g_lo=torch.where(set_lo[:, None], g_a, s["g_lo"]),
            a_hi=hi(a, s["a_prev"], s["a_lo"], s["a_hi"]),
            phi_hi=hi(
                torch.where(bad, torch.full_like(phi_a, torch.inf), phi_a),
                s["phi_prev"], s["phi_lo"], s["phi_hi"],
            ),
            dphi_hi=hi(torch.where(bad, zero, dphi_a), s["dphi_prev"], s["dphi_lo"], s["dphi_hi"]),
            a_acc=torch.where(accept, a, s["a_acc"]),
            phi_acc=torch.where(accept, phi_a, s["phi_acc"]),
            g_acc=torch.where(accept[:, None], g_a, s["g_acc"]),
            accepted=s["accepted"] | accept,
        )
        s = _where(running, new, s)

    # exhausted budget: fall back to the best sufficient-decrease point (a_lo)
    fallback_ok = (s["a_lo"] > 0) & torch.isfinite(s["phi_lo"]) & (s["phi_lo"] < f0)
    return _finish(s, ("a_lo", "phi_lo", "g_lo"), f0, g0, fallback_ok)

"""What the reference works out again from a call's inputs and the
program's own iterates, and the gap of each program output from it.

``outputs`` is a dict of the program's outputs, taken from its result
(``pfharness.window.extract``): ``path_id``, ``num_tries``, ``success``
(K,); ``xs``, ``lps``, ``gs`` (K, L+1, ·) and ``nvalid`` (K,);
``fit_iteration`` (K,), ``elbo_values`` (K, L); each path's fit, ``mean``
(K, d), its square-root factors ``a_half``, ``X``, ``C`` (of ``L``) and its
``logdet`` (K,); the pooled draws ``pool`` (K, N, d); the PSIS
``log_weights`` (K·N,) and ``khat``; the resampled ``draws`` (d, n) and
their component ``ids`` (n,); the call's ``seed``, ``denominator`` and
``optimizer``. ``inputs`` holds what the benchmark made and handed to the
program: ``init`` (K, d), the target ``logp(x, data, mm)`` and its
``data``. ``settings``: ``history_length``, ``ndraws_elbo``,
``epsilon_curvature``.

The reference follows the program's iterates, the one state that only the
program can give: at each iterate it works out the L-BFGS direction from
the history of those iterates, and at each path's winner the fit ``(μ,
alpha, X, M)``. Everything after that is its own: the fit's covariance, its
log det and its inverse (:mod:`reference.pathfinder`), the log densities of
the winner's ELBO draws and of the pooled draws under that fit, PSIS
(:mod:`reference.psis`), and the picks of the resampling from the
program's seed (:mod:`reference.rng`). A returned normal's factor is judged
by its ``L Lᵀ`` against the fit's covariance (``cov_gap``), and by the
draws it gives from the noise of the call's seed (``draw_gap``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import pathfinder as pf
from reference import rng
from reference.precision import Prec
from reference.psis import psis

BLOCK = 32  # paths a block: what the reference holds at once
# a step is judged by its direction where float32's rounding of the iterate
# is small beside it: ‖s‖∞ ≥ 2⁻¹⁰ ‖x‖∞, so that rounding is ≤ 2⁻¹⁴ of the step
BIG_STEP = 2.0**-10
# Hager-Zhang accepts a step only where φ(a) ≤ φ(0) + ε|φ(0)| (its weakest
# test: the approximate Wolfe conditions' ε, the program's default)
HZ_EPSILON = 1e-6
# the program compares φ(a) and φ(0) in float32: each rounded by at most
# 2⁻²⁴ of itself, allowed here four times over
FLOAT32_COMPARE = 2.0**-22
PROBE_SEED = 20240531  # the probe vectors of the covariance check


@dataclasses.dataclass
class Derived:
    """The reference's own values, in one precision."""

    lps: torch.Tensor  # (K, L+1) at the program's iterates
    gs: torch.Tensor
    dirs: torch.Tensor  # (K, L, d) the L-BFGS direction at each iterate
    fit_mean: torch.Tensor  # (K, d) the fit at each path's winner
    cov_probe: torch.Tensor  # (K, d) the fit's covariance times each path's probe vector
    logdet: torch.Tensor  # (K,) the fit's log det
    redrawn: torch.Tensor  # (K, d, N) each path's draws from its noise (paths not redrawn: NaN)
    elbo: torch.Tensor  # (K,) of the winner's ELBO draws under the fit
    log_weights: np.ndarray  # PSIS of the pooled draws' ratios under the fits
    khat: float
    picks: torch.Tensor  # (n,) the resampling's picks into the pool, under those weights


def redrawn_paths(outputs: dict) -> torch.Tensor:
    """The paths whose draws the reference works out again from their noise:
    those that succeeded at their first try, whose pooled draws are their
    winner's ELBO draws and then their extra draws."""
    return outputs["success"].bool() & (outputs["num_tries"].to(outputs["success"].device) == 1)


def noise(outputs: dict, lo: int, hi: int, ne: int, N: int, d: int, dtype) -> torch.Tensor:
    """The noise ``u (k, d, N)`` that the program drew for paths ``lo:hi``:
    its winner's ELBO stream (candidate ``fit_iteration − 1``), then its extra
    stream, in the program's dtype."""
    dev = outputs["pool"].device
    path = outputs["path_id"][lo:hi].to(dev)
    cand = (outputs["fit_iteration"][lo:hi] - 1).to(dev)
    seed = outputs["seed"]
    u = rng.Stream(seed, path, 0, rng.ELBO, cand).normal(d * ne, torch.float64, dev)
    u = u.to(dtype).reshape(-1, d, ne)
    if N > ne:
        extra = rng.Stream(seed, path, 0, rng.EXTRA).normal(d * (N - ne), torch.float64, dev)
        u = torch.cat([u, extra.to(dtype).reshape(-1, d, N - ne)], -1)
    return u[..., :N]


def probe_vectors(K: int, d: int, device) -> torch.Tensor:
    """``(K, d)`` fixed standard normal vectors, one a path."""
    g = torch.Generator().manual_seed(PROBE_SEED)
    return torch.randn(K, d, generator=g, dtype=torch.float64).to(device)


def resample_picks(seed: int, log_weights: np.ndarray, n: int) -> torch.Tensor:
    """The ``n`` picks into the pool that inverse-CDF resampling gives under
    ``log_weights`` with the uniforms of the call's resampling stream."""
    u = rng.Stream(seed, 0, 0, rng.RESAMPLE).uniform(n, torch.float64)
    w = np.exp(log_weights - np.max(log_weights))
    cdf = torch.as_tensor(np.cumsum(w))
    idx = torch.searchsorted(cdf, u * cdf[-1], right=True)
    return idx.clamp(0, cdf.shape[0] - 1)


def derive(outputs: dict, inputs: dict, settings: dict, prec: Prec,
           own_draws: bool = False) -> Derived:
    """The reference's values, in ``prec``. The pooled draws whose ratios it
    takes are the program's, or (``own_draws``) its own redrawn ones in the
    paths it redraws."""
    if outputs["denominator"] != "component" or outputs["optimizer"] != "lbfgs":
        raise NotImplementedError(
            f"the reference judges L-BFGS with the component denominator, not "
            f"{outputs['optimizer']!r} with {outputs['denominator']!r}")
    if outputs["xs"] is None:
        raise NotImplementedError("the reference judges only calls that keep their trajectory")
    logp, data = inputs["logp"], inputs["data"]
    K, N, d = outputs["pool"].shape
    ne = settings["ndraws_elbo"]
    names = ("lps", "gs", "dirs", "mean", "probe", "logdet", "redrawn", "elbo", "ratios")
    parts = {k: [] for k in names}
    redo = redrawn_paths(outputs)
    probes = probe_vectors(K, d, outputs["pool"].device)
    for lo in range(0, K, BLOCK):
        hi = min(lo + BLOCK, K)
        xs = outputs["xs"][lo:hi]
        k, L1, _ = xs.shape
        lp, g = pf.value_and_grad(logp, data, xs.reshape(k * L1, d), prec)
        lp, g = lp.reshape(k, L1), g.reshape(k, L1, d)
        dirs, (mu, alpha, X, M) = pf.trajectory_pass(
            xs, g, outputs["nvalid"][lo:hi], outputs["fit_iteration"][lo:hi],
            settings["history_length"], settings["epsilon_curvature"], prec)
        logdet = pf.fit_logdet(alpha, X, M, prec)
        # B1 worked out again from the noise: the draws of each returned factor
        u = noise(outputs, lo, hi, ne, N, d, outputs["pool"].dtype)
        x = pf.factor_draws(*[outputs[n][lo:hi] for n in ("mean", "a_half", "X", "C")], u, prec)
        redo_b = redo[lo:hi]
        pool = outputs["pool"][lo:hi].to(prec.dtype)
        if own_draws:
            pool = torch.where(redo_b[:, None, None], x.mT, pool)
        lq = -0.5 * (d * pf.LOG_2PI + logdet[:, None] + pf.fit_maha(mu, alpha, X, M, pool, prec))
        lpp = pf.value_and_grad(logp, data, pool.reshape(k * N, d), prec)[0].reshape(k, N)
        # the winner's ELBO draws are the first ndraws_elbo of the pool
        x_e = x[..., :ne].mT
        lq_e = -0.5 * (d * pf.LOG_2PI + logdet[:, None] + pf.fit_maha(mu, alpha, X, M, x_e, prec))
        lp_e = pf.value_and_grad(logp, data, x_e.reshape(k * ne, d), prec)[0].reshape(k, ne)
        for name, value in (("lps", lp), ("gs", g), ("dirs", dirs), ("mean", mu),
                            ("probe", pf.cov_mul(alpha, X, M, probes[lo:hi].to(prec.dtype), prec)),
                            ("logdet", logdet), ("elbo", (lp_e - lq_e).mean(-1)),
                            ("ratios", (lpp - lq).reshape(-1)),
                            ("redrawn", torch.where(redo_b[:, None, None], x,
                                                    torch.full_like(x, math.nan)))):
            parts[name].append(value)
    cat = {k: torch.cat(v) for k, v in parts.items()}
    log_weights, khat = psis(cat["ratios"].double().cpu().numpy())
    picks = resample_picks(outputs["seed"], log_weights, outputs["ids"].shape[0])
    return Derived(cat["lps"], cat["gs"], cat["dirs"], cat["mean"], cat["probe"], cat["logdet"],
                   cat["redrawn"], cat["elbo"], log_weights, khat, picks)


def _rel(a, b):
    """``|a − b| / (1 + |b|)`` elementwise, in float64."""
    a, b = a.double(), b.double()
    return (a - b).abs() / (1.0 + b.abs())


def _max(t) -> float:
    if t is None or t.numel() == 0:
        return 0.0
    t = torch.where(torch.isnan(t), torch.full_like(t, math.inf), t)
    return float(t.max())


def winner_elbo(outputs: dict) -> torch.Tensor:
    """The program's ELBO of each path's winner: ``elbo_values`` at
    ``fit_iteration − 1``."""
    idx = (outputs["fit_iteration"] - 1).clamp(min=0).long()
    return outputs["elbo_values"].gather(1, idx[:, None].to(outputs["elbo_values"].device))[:, 0]


def program_steps(outputs: dict) -> torch.Tensor:
    """The steps the program took: ``x_{i+1} − x_i`` (K, L, d), in float64."""
    xs = outputs["xs"].double()
    return xs[:, 1:] - xs[:, :-1]


def _valid_steps(outputs: dict) -> torch.Tensor:
    L = outputs["xs"].shape[1] - 1
    dev = outputs["xs"].device
    return torch.arange(L, device=dev) + 1 < outputs["nvalid"].to(dev)[:, None]


def step_gaps(steps, dirs, xs, nvalid):
    """``(step_gap, step_gap_median, zero_steps)``. A step's gap, over the
    valid big steps (``‖s‖∞ ≥ BIG_STEP ‖x_{i+1}‖∞`` of the program's
    iterates): ``‖s − a p‖∞ / ‖a p‖∞`` with ``a = sᵀp / pᵀp`` the length
    that fits best, 1 where ``a ≤ 0``. ``step_gap``: the largest over every
    path; ``step_gap_median``: the median over the paths of each path's
    largest, steady where a rare step's direction is ill-conditioned (the
    diagonal H₀'s denominator cancelling). ``zero_steps``: valid steps that
    did not move."""
    K, L, d = steps.shape
    p = dirs.double()
    valid = torch.arange(L, device=steps.device) + 1 < nvalid.to(steps.device)[:, None]
    x_next = xs.double()[:, 1:]
    prog = x_next - xs.double()[:, :-1]
    big = valid & (prog.abs().amax(-1) >= BIG_STEP * x_next.abs().amax(-1))
    a = (steps * p).sum(-1) / (p * p).sum(-1)
    fit = a[..., None] * p
    gap = (steps - fit).abs().amax(-1) / fit.abs().amax(-1)
    gap = torch.where((a > 0) & torch.isfinite(gap), gap, torch.ones_like(gap))
    zero = valid & (prog == 0).all(-1)
    per_path = torch.where(big, gap, torch.zeros_like(gap)).amax(-1)
    return _max(gap[big]), float(per_path.median()), float(zero.sum())


def ascent_steps(outputs: dict, lps: torch.Tensor) -> float:
    """The valid steps whose end the line search could not have accepted:
    ``−logp`` at the new iterate above its value at the old one by more
    than Hager-Zhang's ``ε|φ(0)|`` and float32's rounding of the two, with
    ``logp`` the reference's at the program's iterates."""
    f = -lps.double()
    f0, f1 = f[:, :-1], f[:, 1:]
    allowed = HZ_EPSILON * f0.abs() + FLOAT32_COMPARE * (f0.abs() + f1.abs())
    return float((_valid_steps(outputs) & ~(f1 <= f0 + allowed)).sum())


def resample_gap(outputs: dict, picks: torch.Tensor, block: int = 1000) -> float:
    """The share of resampled draws that are not, bit for bit, the pooled
    draw the reference picks from the same uniforms under its own weights,
    or whose component is not that draw's."""
    draws, ids, pool = outputs["draws"].mT, outputs["ids"].long(), outputs["pool"]
    N = pool.shape[1]
    bad = 0
    for lo in range(0, draws.shape[0], block):
        p = picks[lo:lo + block].to(pool.device)
        want = pool[p // N, p % N]
        got = draws[lo:lo + block].to(pool.device)
        bad += int(((want != got).any(-1) | (ids[lo:lo + block].to(pool.device) != p // N)).sum())
    return bad / max(1, draws.shape[0])


def readings(outputs: dict, inputs: dict, settings: dict, ref: Derived = None) -> dict:
    """The gap of each program output from the float64 reference: ``{name:
    float}``."""
    ref = ref or derive(outputs, inputs, settings, Prec("f64"))
    K, N, d = outputs["pool"].shape
    dev = outputs["pool"].device
    ok = outputs["success"].to(dev)
    r = {}
    r["lanes_gap"] = float((outputs["path_id"].to(dev) != torch.arange(K, device=dev)).sum())
    r["duplicate_paths"] = float(K - torch.unique(outputs["mean"], dim=0).shape[0])
    vals = outputs["elbo_values"].double()
    best = torch.where(torch.isnan(vals), -math.inf, vals).argmax(-1)
    r["winner_gap"] = float(((best != outputs["fit_iteration"].to(best.device) - 1) & ok).sum())
    first = outputs["num_tries"].to(dev) == 1
    x0 = outputs["xs"][:, 0].double() - inputs["init"].double()
    r["x0_gap"] = _max(x0.abs().amax(-1)[first])
    valid = torch.arange(outputs["xs"].shape[1], device=dev) < outputs["nvalid"].to(dev)[:, None]
    lp_gap = _rel(outputs["lps"], ref.lps)
    g_gap = ((outputs["gs"].double() - ref.gs.double()).abs().amax(-1)
             / (1.0 + ref.gs.double().abs().amax(-1)))
    r["vg_gap"] = _max(torch.maximum(lp_gap, g_gap)[valid])
    steps = outputs.get("steps")
    r["step_gap"], r["step_gap_median"], r["zero_steps"] = step_gaps(
        program_steps(outputs) if steps is None else steps.double(), ref.dirs,
        outputs["xs"], outputs["nvalid"])
    r["ascent_steps"] = ascent_steps(outputs, ref.lps)
    m_gap = ((outputs["mean"].double() - ref.fit_mean.double()).abs().amax(-1)
             / (1.0 + ref.fit_mean.double().abs().amax(-1)))
    r["fit_mean_gap"] = _max(m_gap[ok])
    probe = outputs.get("cov_probe")
    if probe is None:
        probe = pf.factor_cov_mul(outputs["a_half"], outputs["X"], outputs["C"],
                                  probe_vectors(K, d, dev))
    want = ref.cov_probe.double()
    r["cov_gap"] = _max(((probe.double() - want).abs().amax(-1) / want.abs().amax(-1))[ok])
    r["logdet_gap"] = _max((outputs["logdet"].double() - ref.logdet.double()).abs()[ok])
    redo = redrawn_paths(outputs)
    x_ref = ref.redrawn.double()[redo]  # (k, d, N)
    x_out = outputs["pool"].mT.double()[redo]
    dev_scale = (x_ref - outputs["mean"].double()[redo][..., None]).abs().amax(-2)
    r["draw_gap"] = _max(((x_out - x_ref).abs().amax(-2) / dev_scale))
    r["elbo_gap"] = _max(_rel(winner_elbo(outputs), ref.elbo)[redo])
    kp, kr = float(outputs["khat"]), ref.khat
    r["khat_gap"] = abs(kp - kr) if kp == kp and kr == kr else (0.0 if kp != kp and kr != kr else math.inf)
    wp = np.exp(outputs["log_weights"].double().cpu().numpy())
    r["weights_tv"] = float(np.abs(wp - np.exp(ref.log_weights)).sum())
    r["resample_gap"] = resample_gap(outputs, ref.picks)
    return r


def control_outputs(outputs: dict, inputs: dict, settings: dict, below: Prec) -> dict:
    """The control: the reference computed in ``below``, the precision
    next below the configuration's, put in the program's place. At each of
    the program's iterates it takes the step the low reference's direction
    gives (at the length that fits the program's step best); every output
    the program derives from its iterates is the low reference's: the log density and gradient there, the fit's mean, its
    covariance (against the probe vectors) and log det, the draws from each
    returned factor with the program's noise, the winner's ELBO, the PSIS
    weights of those draws and the resampling's picks under them. The
    iterates stay the program's, as the same prompts and tokens do for a
    served model."""
    low = derive(outputs, inputs, settings, below, own_draws=True)
    out = dict(outputs)
    out["lps"], out["gs"], out["mean"] = low.lps, low.gs, low.fit_mean
    out["cov_probe"], out["logdet"] = low.cov_probe, low.logdet
    s, p = program_steps(outputs), low.dirs.double()
    a = (s * p).sum(-1) / (p * p).sum(-1)
    out["steps"] = torch.nan_to_num(a)[..., None] * p
    redo = redrawn_paths(outputs)
    pool = outputs["pool"].clone()
    pool[redo] = low.redrawn[redo].mT.to(pool.dtype)
    N = pool.shape[1]
    picks = low.picks.to(pool.device)
    out["pool"], out["draws"], out["ids"] = pool, pool[picks // N, picks % N].mT, picks // N
    vals = outputs["elbo_values"].clone()
    idx = (outputs["fit_iteration"] - 1).clamp(min=0).long().to(vals.device)
    vals[torch.arange(vals.shape[0], device=vals.device), idx] = low.elbo.to(vals)
    out["elbo_values"] = vals
    out["log_weights"] = torch.as_tensor(low.log_weights)
    out["khat"] = low.khat
    return out

"""Pareto-smoothed importance sampling (counterpart of
``pathfinder_tpu/ops/psis.py``; Vehtari et al., JMLR 25(72), 2024).

Tail length ``M = ceil(min(S/5, 3·√(S/r_eff)))``; a generalized Pareto fit
to the ``M`` largest ratios by the Zhang & Stephens (2009) quantile-grid
posterior mean with the paper's weak prior on k̂; the tail replaced by the
fitted expected order statistics, truncated at the raw maximum. NaN ratios
count as −∞ (zero weight) and +∞ ratios are capped at the largest finite
one, as in the JAX package. The sort is stable, as JAX's is: ties matter.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["PSISResult", "psis", "gpdfit", "tail_length", "pareto_k_verdict"]


def pareto_k_verdict(k: float) -> str:
    """Verdict with the reference thresholds; NaN is ``"not computed"``."""
    k = float(k)
    if k != k:
        return "not computed"
    if k > 1:
        return "very bad"
    if k > 0.7:
        return "bad"
    if k > 0.5:
        return "ok"
    return "good"


@dataclasses.dataclass(frozen=True)
class PSISResult:
    log_weights: torch.Tensor  # (S,) smoothed, normalized: logsumexp == 0
    weights: torch.Tensor  # (S,) sum == 1
    pareto_shape: torch.Tensor  # () k̂
    tail_length: int
    reff: float

    @property
    def ess(self) -> torch.Tensor:
        """Importance-sampling effective sample size ``1/Σ wᵢ²``."""
        return 1.0 / torch.sum(self.weights**2)

    @property
    def diagnosis(self) -> str:
        return pareto_k_verdict(self.pareto_shape)


def tail_length(reff: float, S: int) -> int:
    return int(math.ceil(min(S / 5.0, 3.0 * math.sqrt(S / reff))))


def gpdfit(x: torch.Tensor, prior_bs: float = 3.0, prior_k: float = 10.0):
    """Generalized-Pareto ``(k, sigma)`` fit to sorted-ascending exceedances."""
    n = x.shape[0]
    dtype = x.dtype
    m = 30 + int(math.floor(math.sqrt(n)))
    j = torch.arange(1, m + 1, dtype=dtype, device=x.device)
    xq = x[int(n / 4.0 + 0.5) - 1]  # first-quartile order statistic
    # a tied cutoff makes xq exactly 0; anchor the grid at the smallest
    # positive exceedance instead
    pos_min = torch.where(x > 0, x, torch.inf).amin()
    one = torch.ones((), dtype=dtype, device=x.device)
    xq = torch.where(xq > 0, xq, torch.where(torch.isfinite(pos_min), pos_min, one))
    xmax = x[-1]
    bs = 1.0 / xmax + (1.0 - torch.sqrt(m / (j - 0.5))) / (prior_bs * xq)
    ks = torch.mean(torch.log1p(-bs[:, None] * x[None, :]), dim=1)  # (m,)
    L = n * (torch.log(-bs / ks) - ks - 1.0)
    w = 1.0 / torch.sum(torch.exp(L[None, :] - L[:, None]), dim=1)
    b_post = torch.sum(bs * w)
    k_post = torch.mean(torch.log1p(-b_post * x))
    sigma = -k_post / b_post
    k_reg = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return k_reg, sigma


def _gpd_quantile(p, k, sigma):
    """Inverse CDF of GPD(σ, k) at probabilities ``p`` (location 0)."""
    small = k.abs() < 1e-12
    safe_k = torch.where(small, torch.ones_like(k), k)
    q_k = sigma * torch.expm1(-safe_k * torch.log1p(-p)) / safe_k
    q_0 = -sigma * torch.log1p(-p)
    return torch.where(small, q_0, q_k)


def psis(log_ratios: torch.Tensor, reff: float = 1.0) -> PSISResult:
    """Smooth importance log-ratios ``(S,)``: normalized weights and k̂.
    With fewer than 5 tail draws the ratios are only normalized and k̂ is
    NaN."""
    S = log_ratios.shape[0]
    dtype = log_ratios.dtype
    M = tail_length(reff, S)
    nan = torch.full((), torch.nan, dtype=dtype, device=log_ratios.device)

    lw = torch.where(torch.isnan(log_ratios), -torch.inf, log_ratios)
    finite_max = torch.where(torch.isfinite(lw), lw, -torch.inf).amax()
    has_finite = torch.isfinite(finite_max)
    lw = torch.minimum(lw, finite_max)
    x = torch.where(has_finite, lw - finite_max, torch.zeros_like(lw))

    if M < 5:
        log_weights = x - torch.logsumexp(x, dim=0)
        return PSISResult(log_weights, torch.exp(log_weights), nan, M, reff)

    order = torch.argsort(x, stable=True)
    x_sorted = x[order]
    cutoff_log = x_sorted[S - M - 1]
    cut_w = torch.exp(cutoff_log)
    tail_log = x_sorted[S - M:]
    exceed = torch.exp(tail_log) - cut_w  # ascending, ≥ 0

    k, sigma = gpdfit(exceed)

    p = (torch.arange(1, M + 1, dtype=dtype, device=x.device) - 0.5) / M
    smoothed_tail = torch.log(_gpd_quantile(p, k, sigma) + cut_w)
    smoothed_tail = torch.clamp(smoothed_tail, max=0.0)  # truncate at the max

    fit_ok = (
        torch.isfinite(k)
        & torch.isfinite(sigma)
        & (sigma > 0)
        & torch.isfinite(smoothed_tail).all()
    )
    new_tail = torch.where(fit_ok, smoothed_tail, tail_log)
    x_smoothed = x.clone()
    x_smoothed[order[S - M:]] = new_tail

    log_weights = x_smoothed - torch.logsumexp(x_smoothed, dim=0)
    return PSISResult(
        log_weights=log_weights,
        weights=torch.exp(log_weights),
        pareto_shape=torch.where(fit_ok, k, nan),
        tail_length=M,
        reff=reff,
    )

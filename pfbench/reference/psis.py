"""Pareto-smoothed importance sampling in NumPy float64 (Vehtari, Simpson,
Gelman, Yao & Gabry, JMLR 25(72), 2024), as Pathfinder applies it to the
pooled draws.

Tail length ``M = ceil(min(S/5, 3·√(S/r_eff)))``; a generalized Pareto fit
to the ``M`` largest exceedances over the next largest ratio, by the
posterior mean over Zhang & Stephens' (2009) quantile grid with their weak
prior, and ``k̂`` pulled toward 0.5 by ten pseudo-observations; the tail
replaced by the fitted distribution's expected order statistics, truncated
at the largest raw ratio. NaN ratios weigh nothing and +∞ is capped at the
largest finite ratio. Fewer than 5 tail draws: the ratios are only
normalized and ``k̂`` is NaN.
"""

from __future__ import annotations

import math

import numpy as np


def _logsumexp(x):
    m = np.max(x)
    return m + math.log(np.sum(np.exp(x - m)))


def gpdfit(x: np.ndarray, prior_bs: float = 3.0, prior_k: float = 10.0):
    """``(k, sigma)`` of a generalized Pareto fit to sorted exceedances."""
    n = x.shape[0]
    m = 30 + int(math.floor(math.sqrt(n)))
    j = np.arange(1, m + 1, dtype=np.float64)
    xq = x[int(n / 4.0 + 0.5) - 1]
    if not xq > 0:
        pos = x[x > 0]
        xq = pos.min() if pos.size else 1.0
    bs = 1.0 / x[-1] + (1.0 - np.sqrt(m / (j - 0.5))) / (prior_bs * xq)
    ks = np.mean(np.log1p(-bs[:, None] * x[None, :]), axis=1)
    L = n * (np.log(-bs / ks) - ks - 1.0)
    w = 1.0 / np.sum(np.exp(L[None, :] - L[:, None]), axis=1)
    b_post = np.sum(bs * w)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    return (n * k_post + prior_k * 0.5) / (n + prior_k), sigma


def psis(log_ratios: np.ndarray, reff: float = 1.0):
    """``(log_weights (S,), k̂)``: smoothed, normalized log weights."""
    lr = np.asarray(log_ratios, dtype=np.float64)
    S = lr.shape[0]
    M = int(math.ceil(min(S / 5.0, 3.0 * math.sqrt(S / reff))))
    lw = np.where(np.isnan(lr), -np.inf, lr)
    finite = lw[np.isfinite(lw)]
    x = np.minimum(lw, finite.max()) - finite.max() if finite.size else np.zeros(S)
    if M < 5:
        return x - _logsumexp(x), float("nan")
    order = np.argsort(x, kind="stable")
    cut_w = math.exp(x[order[S - M - 1]])
    tail = x[order[S - M:]]
    p = (np.arange(1, M + 1) - 0.5) / M
    # tied exceedances (zeros) give a non-finite fit, and the tail is kept as it is
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        k, sigma = gpdfit(np.exp(tail) - cut_w)
        if abs(k) < 1e-12:
            q = -sigma * np.log1p(-p)
        else:
            q = sigma * np.expm1(-k * np.log1p(-p)) / k
        smoothed = np.minimum(np.log(q + cut_w), 0.0)
    ok = np.isfinite(k) and np.isfinite(sigma) and sigma > 0 and np.all(np.isfinite(smoothed))
    out = x.copy()
    if ok:
        out[order[S - M:]] = smoothed
    return out - _logsumexp(out), (float(k) if ok else float("nan"))

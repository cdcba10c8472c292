"""Target densities (counterpart of ``pathfinder_tpu/models/zoo.py``).

Each target is built from the same ``np.random.default_rng(seed)`` stream as
its JAX twin, so both packages see identical data.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pathfinder_tpu_torch.integrations.transforms import (
    Exp,
    Identity,
    Ordered,
    Stacked,
    TransformedLogDensity,
)
from pathfinder_tpu_torch.models.protocol import LogDensity

__all__ = [
    "StandardNormal",
    "CorrelatedGaussian",
    "NealsFunnel",
    "Banana",
    "LogisticRegression",
    "german_credit_synthetic",
    "PoissonRegression",
    "poisson_synthetic",
    "StudentTRegression",
    "student_t_synthetic",
    "OrderedLogisticRegression",
    "ordered_logistic_synthetic",
    "NegativeBinomialRegression",
    "negative_binomial_synthetic",
    "HierarchicalGaussian",
    "hierarchical_gaussian_truth",
]

_LOG_2PI = math.log(2.0 * math.pi)


def StandardNormal(dim: int) -> LogDensity:
    """N(0, I_dim)."""

    def logp(x):
        return -0.5 * (torch.sum(x * x, dim=-1) + dim * _LOG_2PI)

    return LogDensity(logp=logp, dim=dim)


def _made_under_transform(t) -> bool:
    """Whether ``t`` was made inside a ``torch.func`` transform (``vmap``,
    ``hessian``): such a tensor belongs to that call and must not outlive
    it. Where torch does not say, assume it was."""
    check = getattr(getattr(torch._C, "_functorch", None), "is_functorch_wrapped_tensor", None)
    return check is None or check(t)


def _per_dtype_and_device(array):
    """``like -> tensor``: ``array`` as a tensor of ``like``'s dtype on its
    device, one copy kept per (dtype, device) beside the target. A copy made
    while ``torch.func`` traces the target is used once and not kept. Threads
    that run the target on several devices at once (a mesh) each get their
    device's copy; two that make the same copy at once keep the first."""
    copies = {}

    def get(like):
        key = (like.dtype, like.device)
        if key in copies:
            return copies[key]
        copy = torch.as_tensor(array, dtype=like.dtype, device=like.device)
        if _made_under_transform(copy):
            return copy
        return copies.setdefault(key, copy)

    return get


def CorrelatedGaussian(dim: int, rho: float = 0.8, seed: int = 0) -> LogDensity:
    """N(μ, Σ) with a random rotation of an AR(1)-style spectrum: a dense
    covariance. The target carries its ``mean`` and ``cov`` as numpy
    arrays."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(dim)
    lam = rho ** np.arange(dim) + 0.05
    Q = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
    cov = Q @ np.diag(lam) @ Q.T
    prec = np.linalg.inv(cov)
    _, ld = np.linalg.slogdet(cov)
    const = -0.5 * (dim * _LOG_2PI + ld)
    mu_t, prec_t = _per_dtype_and_device(mu), _per_dtype_and_device(prec)

    def logp(x):
        dx = x - mu_t(x)
        return const - 0.5 * torch.sum(dx * (dx @ prec_t(x)), dim=-1)

    out = LogDensity(logp=logp, dim=dim)
    out.__dict__["mean"] = mu
    out.__dict__["cov"] = cov
    return out


def NealsFunnel(dim: int = 101, scale: float = 3.0) -> LogDensity:
    """Neal's funnel: v ~ N(0, scale²), xᵢ | v ~ N(0, exp(v)) for the other
    dim − 1 coordinates."""

    def logp(z):
        v, x = z[..., 0], z[..., 1:]
        lp_v = -0.5 * (v / scale) ** 2 - 0.5 * _LOG_2PI - math.log(scale)
        lp_x = -0.5 * torch.sum(x * x, dim=-1) * torch.exp(-v) - 0.5 * (dim - 1) * (
            _LOG_2PI + v
        )
        return lp_v + lp_x

    return LogDensity(logp=logp, dim=dim)


def Banana(b: float = 0.03, sigma: float = 10.0) -> LogDensity:
    """The 2-D banana density."""

    def logp(x):
        x1, x2 = x[..., 0], x[..., 1]
        return -0.5 * (x1 / sigma) ** 2 - 0.5 * (x2 + b * x1 * x1 - sigma * sigma * b) ** 2

    return LogDensity(logp=logp, dim=2)


def _regression_data(X, y):
    """``like -> (X (n, d), y (n,))`` in ``like``'s dtype on its device."""
    X_like = _per_dtype_and_device(np.asarray(X))
    y_like = _per_dtype_and_device(np.asarray(y, dtype=np.float64))
    return lambda like: (X_like(like), y_like(like))


def LogisticRegression(X, y, prior_scale: float = 10.0) -> LogDensity:
    """Bayesian logistic regression posterior over the coefficients
    (d ≈ 25 at German-credit scale)."""
    data = _regression_data(X, y)
    d = np.shape(X)[1]

    def logp(beta):
        Xt, yt = data(beta)
        logits = beta @ Xt.mT  # (K, n)
        # log(1 + e^t) = −logσ(−t), stable on both sides
        loglik = torch.sum(yt * logits + F.logsigmoid(-logits), dim=-1)
        logprior = -0.5 * torch.sum((beta / prior_scale) ** 2, dim=-1)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def PoissonRegression(X, y, prior_scale: float = 5.0) -> LogDensity:
    """Bayesian Poisson (log-link) regression posterior over the
    coefficients, up to the data-only ``log(y!)`` constant."""
    data = _regression_data(X, y)
    d = np.shape(X)[1]

    def logp(beta):
        Xt, yt = data(beta)
        eta = beta @ Xt.mT
        loglik = torch.sum(yt * eta - torch.exp(eta), dim=-1)
        logprior = -0.5 * torch.sum((beta / prior_scale) ** 2, dim=-1)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def poisson_synthetic(n: int = 500, d: int = 8, seed: int = 0):
    """Synthetic Poisson-regression data (bounded rates for stable tests)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    lam = np.exp(np.clip(X @ beta_true, -4.0, 4.0))
    y = rng.poisson(lam).astype(np.float64)
    return X, y, beta_true


def StudentTRegression(X, y, df: float = 4.0, sigma: float = 1.0,
                       prior_scale: float = 5.0) -> LogDensity:
    """Robust (Student-t likelihood) linear regression over the
    coefficients: heavy-tailed residuals make the posterior non-Gaussian."""
    data = _regression_data(X, y)
    d = np.shape(X)[1]
    const = float(df)

    def logp(beta):
        Xt, yt = data(beta)
        z = (yt - beta @ Xt.mT) / sigma
        loglik = -0.5 * (const + 1.0) * torch.sum(torch.log1p(z * z / const), dim=-1)
        logprior = -0.5 * torch.sum((beta / prior_scale) ** 2, dim=-1)
        return loglik + logprior

    return LogDensity(logp=logp, dim=d)


def student_t_synthetic(n: int = 400, d: int = 8, df: float = 4.0, seed: int = 0):
    """Synthetic robust-regression data with t-distributed noise (and
    therefore outliers)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    y = X @ beta_true + rng.standard_t(df, size=n)
    return X, y, beta_true


def OrderedLogisticRegression(X, y, n_cats: int, prior_scale: float = 5.0):
    """Ordinal (cumulative-logit) regression: ``P(y ≤ k | x) = σ(c_k − xβ)``
    with strictly increasing cutpoints ``c``.

    Returns a :class:`~pathfinder_tpu_torch.integrations.transforms.
    TransformedLogDensity` over the constrained parameters
    ``[c (n_cats−1, ordered), β (d)]``: ``Ordered`` stacked with ``Identity``.
    Category log-probabilities use the stable ``log(σ(b) − σ(a)) = logσ(b) +
    logσ(−a) + log1p(−e^{a−b})`` (exact at both edge categories through
    cutpoints padded with ±200, the exponent clamped so that even a cutpoint
    that crosses the pad gives a finite penalty, never NaN).
    """
    X_like = _per_dtype_and_device(np.asarray(X))
    d = np.shape(X)[1]
    K = int(n_cats)
    big = 200.0
    # each observation's lower and upper cutpoint among the K + 1 padded ones
    # (categories 0..K−1), as masks
    y = np.asarray(y, dtype=np.int64)[:, None]
    lo_like = _per_dtype_and_device(np.arange(K + 1) == y)
    hi_like = _per_dtype_and_device(np.arange(K + 1) == y + 1)

    def pick(mask, c_pad):
        # c_pad's entry under each row of mask: a select and a sum with
        # zeros, exact. Not a gather: its gradient is a scatter-add, whose
        # atomic adds on a CUDA device sum in another order from call to call
        return torch.where(mask, c_pad[..., None, :], 0.0).sum(dim=-1)

    def logp_constrained(theta):
        Xt = X_like(theta)
        flag = theta.new_empty(0, dtype=torch.bool)
        c, beta = theta[..., : K - 1], theta[..., K - 1 :]
        eta = beta @ Xt.mT  # (B, n)
        pad = torch.full_like(theta[..., :1], big)
        c_pad = torch.cat([-pad, c, pad], dim=-1)  # (B, K + 1)
        a = pick(lo_like(flag), c_pad) - eta  # lower cutpoint minus linear predictor
        b = pick(hi_like(flag), c_pad) - eta  # upper
        # a < b by the ordering, except when a cutpoint crosses the ±big pad
        # (|c| > 200: absurd, but a line-search trial can get there); the
        # clamp keeps log1p a huge finite penalty
        diff = torch.clamp(a - b, max=-1e-6)
        loglik = torch.sum(
            F.logsigmoid(b) + F.logsigmoid(-a) + torch.log1p(-torch.exp(diff)), dim=-1
        )
        logprior = -0.5 * torch.sum((theta / prior_scale) ** 2, dim=-1)
        return loglik + logprior

    bij = Stacked(((Ordered(), K - 1), (Identity(), d)))
    return TransformedLogDensity(logp_constrained=logp_constrained, bijector=bij, dim=K - 1 + d)


def NegativeBinomialRegression(X, y, prior_scale: float = 5.0):
    """Negative-binomial (NB2) regression with learned dispersion:
    ``μ = exp(Xβ)``, ``y ~ NB2(μ, φ)`` with ``Var = μ + μ²/φ``; constrained
    parameters ``[β (d), φ (1, positive)]`` through ``Stacked((Identity, d),
    (Exp, 1))``. Prior: N(0, prior_scale²) on β and on log φ.

    Returns a :class:`~pathfinder_tpu_torch.integrations.transforms.
    TransformedLogDensity`.
    """
    data = _regression_data(X, y)
    d = np.shape(X)[1]

    def logp_constrained(theta):
        Xt, yt = data(theta)
        beta, phi = theta[..., :d], theta[..., d:]  # phi (B, 1)
        # the rate is bounded as the generator bounds it: an unbounded exp
        # overflows f32 near 88
        eta = torch.clamp(beta @ Xt.mT, -20.0, 20.0)
        mu = torch.exp(eta)
        loglik = torch.sum(
            torch.lgamma(yt + phi)
            - torch.lgamma(phi)
            - torch.lgamma(yt + 1.0)
            + phi * (torch.log(phi) - torch.log(phi + mu))
            + yt * (eta - torch.log(phi + mu)),
            dim=-1,
        )
        logprior = -0.5 * torch.sum((beta / prior_scale) ** 2, dim=-1)
        logprior = logprior - 0.5 * (torch.log(phi[..., 0]) / prior_scale) ** 2
        return loglik + logprior

    bij = Stacked(((Identity(), d), (Exp(), 1)))
    return TransformedLogDensity(logp_constrained=logp_constrained, bijector=bij, dim=d + 1)


def negative_binomial_synthetic(n: int = 500, d: int = 6, phi: float = 3.0, seed: int = 0):
    """Synthetic NB2 data with overdispersion (a gamma-Poisson mixture)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    X[:, 0] = 1.0
    beta_true = rng.standard_normal(d) * 0.5
    mu = np.exp(np.clip(X @ beta_true, -4.0, 4.0))
    lam = rng.gamma(phi, mu / phi)  # Var(y) = mu + mu^2/phi
    y = rng.poisson(lam).astype(np.float64)
    return X, y, beta_true


def ordered_logistic_synthetic(n: int = 600, d: int = 4, n_cats: int = 4, seed: int = 0):
    """Synthetic ordinal-regression data with well-separated cutpoints (gaps
    ≥ 0.5). No intercept column: cumulative-logit models are invariant under
    ``c → c+δ, β₀ → β₀+δ``, so an intercept would leave a ridge that only
    the prior identifies."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)) / np.sqrt(d)
    beta_true = rng.standard_normal(d) * 0.8
    gaps = rng.uniform(0.5, 1.0, n_cats - 1)
    c_true = np.cumsum(gaps)
    c_true = c_true - c_true.mean()  # centered, strictly increasing
    eta = X @ beta_true
    u = rng.logistic(size=n)
    y = np.sum((eta + u)[:, None] > c_true[None, :], axis=1)
    return X, y, c_true, beta_true


def german_credit_synthetic(n: int = 1000, d: int = 25, seed: int = 0):
    """Synthetic logistic-regression data at German-credit scale (the real
    data set is not shipped)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    X[:, 0] = 1.0  # intercept
    beta_true = rng.standard_normal(d) / np.sqrt(d)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.uniform(size=n) < p).astype(np.float64)
    return X, y, beta_true


def HierarchicalGaussian(dim: int = 1000, seed: int = 0) -> LogDensity:
    """A global log-scale coordinate controlling the variance of ``dim − 1``
    locals (funnel-like but milder), non-centered parameterization."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(dim - 1)
    obs_like = _per_dtype_and_device(obs)

    def logp(z):
        obs_t = obs_like(z)
        log_tau, theta = z[..., 0], z[..., 1:]
        lp_tau = -0.5 * log_tau**2
        lp_theta = -0.5 * torch.sum(theta * theta, dim=-1)
        sigma = torch.exp(0.5 * log_tau)
        lp_obs = -0.5 * torch.sum((obs_t - sigma[..., None] * theta) ** 2, dim=-1)
        return lp_tau + lp_theta + lp_obs

    return LogDensity(logp=logp, dim=dim)


def hierarchical_gaussian_truth(dim: int, seed: int = 0):
    """Exact posterior moments of :func:`HierarchicalGaussian` by 1-D
    quadrature over ``log_tau`` (θ is conditionally Gaussian given it).

    A numpy copy of the JAX package's function: importing that one would pull
    in JAX, which the machine with the card does not have. A test holds the
    two equal. Returns ``(mean (dim,), sd (dim,))`` ordered
    ``[log_tau, theta...]``.
    """
    d = dim
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(d - 1)  # must match HierarchicalGaussian
    S = float(np.sum(obs**2))
    lt = np.linspace(-10.0, 10.0, 40001)
    s2 = np.exp(lt)  # sigma^2
    logw = -0.5 * lt**2 - 0.5 * (
        (d - 1) * np.log(2 * np.pi * (1.0 + s2)) + S / (1.0 + s2)
    )
    logw -= logw.max()
    w = np.exp(logw)
    w /= w.sum()
    sig = np.sqrt(s2)
    mean_lt = float(np.sum(w * lt))
    var_lt = float(np.sum(w * (lt - mean_lt) ** 2))
    A = float(np.sum(w * sig / (1.0 + s2)))  # E[sigma/(1+sigma^2)]
    B = float(np.sum(w / (1.0 + s2)))  # E[1/(1+sigma^2)]
    C = float(np.sum(w * s2 / (1.0 + s2) ** 2))  # E[sigma^2/(1+sigma^2)^2]
    mean_theta = obs * A
    var_theta = B + obs**2 * C - (obs * A) ** 2
    mean = np.concatenate([[mean_lt], mean_theta])
    sd = np.sqrt(np.concatenate([[var_lt], var_theta]))
    return mean, sd

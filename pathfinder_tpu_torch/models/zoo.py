"""Target densities (counterpart of ``pathfinder_tpu/models/zoo.py``).

Each target is built from the same ``np.random.default_rng(seed)`` stream as
its JAX twin, so both packages see identical data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pathfinder_tpu_torch.models.protocol import LogDensity

__all__ = [
    "StandardNormal",
    "CorrelatedGaussian",
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
    while ``torch.func`` traces the target is used once and not kept."""
    copies = {}

    def get(like):
        key = (like.dtype, like.device)
        if key in copies:
            return copies[key]
        copy = torch.as_tensor(array, dtype=like.dtype, device=like.device)
        if not _made_under_transform(copy):
            copies[key] = copy
        return copy

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

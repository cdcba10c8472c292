"""Target densities (counterpart of ``pathfinder_tpu/models/zoo.py``).

Each target is built from the same ``np.random.default_rng(seed)`` stream as
its JAX twin, so both packages see identical data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pathfinder_tpu_torch.models.protocol import LogDensity

__all__ = ["StandardNormal", "HierarchicalGaussian", "hierarchical_gaussian_truth"]

_LOG_2PI = math.log(2.0 * math.pi)


def StandardNormal(dim: int) -> LogDensity:
    """N(0, I_dim)."""

    def logp(x):
        return -0.5 * (torch.sum(x * x, dim=-1) + dim * _LOG_2PI)

    return LogDensity(logp=logp, dim=dim)


def HierarchicalGaussian(dim: int = 1000, seed: int = 0) -> LogDensity:
    """A global log-scale coordinate controlling the variance of ``dim − 1``
    locals (funnel-like but milder), non-centered parameterization."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(dim - 1)
    # the observations live beside the target, one copy per (dtype, device)
    copies = {}

    def logp(z):
        key = (z.dtype, z.device)
        if key not in copies:
            copies[key] = torch.as_tensor(obs, dtype=z.dtype, device=z.device)
        obs_t = copies[key]
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

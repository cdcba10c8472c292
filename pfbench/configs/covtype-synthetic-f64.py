"""Bayesian logistic regression at Covertype's shape (Liu & Wang 2016, SVGD,
sec. 5): the user's model, in plain torch, on synthetic data.

``x = (w ∈ ℝ^p, log α)`` with ``p = 55`` (54 features and an intercept):
``w ~ N(0, α⁻¹ I)``, ``α ~ Gamma(1, rate 0.01)``, ``y_n ~ Bernoulli(σ(z_n))``
with ``z = X w``. The log density, up to a constant, is

    Σ_n [y_n z_n − softplus(z_n)] + (p/2) log α − (α/2)‖w‖² − 0.01 α + log α,

the last term the Jacobian of ``α = exp(log α)``, written as a modeller
writes it: a batch of ``K`` points holds ``K × n`` logits and the
elementwise temporaries of the sum, 3.7 MB a point each at ``n = 464,809``.

The data is made on the card from the run's seed: 10 standardized
continuous columns, a one-hot of 4 wilderness areas, a one-hot of 40 soil
types with skewed, partly rare levels, a column of ones, and labels from a
seeded logistic model at 49% positives (the configuration's ``assumed``).
"""

import math

import torch
import torch.nn.functional as F

CONTINUOUS = 10
WILDERNESS = (0.449, 0.051, 0.436, 0.064)
SOIL = 40
SOIL_SCALE = 5.0  # soil level k has frequency ∝ exp(−k / SOIL_SCALE)
POSITIVES = 0.49
GAMMA_RATE = 0.01


def _one_hot(probs: torch.Tensor, n: int, gen: torch.Generator, dtype) -> torch.Tensor:
    levels = torch.multinomial(probs, n, replacement=True, generator=gen)
    return F.one_hot(levels, probs.shape[0]).to(dtype)


def make_data(cfg: dict, gen: torch.Generator, device) -> dict:
    """``X (n, 55)`` (continuous, wilderness, soil, intercept) and its labels
    ``y (n,)`` in the configuration's dtype on ``device``; ``n`` is
    ``cfg["rows"]``."""
    dtype = getattr(torch, cfg["dtype"])
    n = int(cfg["rows"])
    mix = torch.eye(CONTINUOUS, device=device, dtype=dtype) + 0.5 * torch.randn(
        CONTINUOUS, CONTINUOUS, generator=gen, device=device, dtype=dtype) / math.sqrt(CONTINUOUS)
    cont = torch.randn(n, CONTINUOUS, generator=gen, device=device, dtype=dtype) @ mix
    cont = (cont - cont.mean(0)) / cont.std(0)
    wild = _one_hot(torch.tensor(WILDERNESS, device=device, dtype=dtype), n, gen, dtype)
    order = torch.randperm(SOIL, generator=gen, device=device)
    soil_p = torch.exp(-torch.arange(SOIL, device=device, dtype=dtype) / SOIL_SCALE)[order]
    soil = _one_hot(soil_p / soil_p.sum(), n, gen, dtype)
    X = torch.cat([cont, wild, soil, torch.ones(n, 1, device=device, dtype=dtype)], 1)
    scale = torch.cat([torch.full((CONTINUOUS,), 0.5), torch.ones(len(WILDERNESS) + SOIL)])
    w_true = torch.randn(X.shape[1] - 1, generator=gen, device=device, dtype=dtype) * scale.to(
        device, dtype)
    z = X[:, :-1] @ w_true
    lo, hi = -20.0, 20.0  # the intercept that gives the positives' share, by bisection
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if float(torch.sigmoid(z + mid).mean()) < POSITIVES else (lo, mid)
    p = torch.sigmoid(z + 0.5 * (lo + hi))
    y = (torch.rand(n, generator=gen, device=device, dtype=dtype) < p).to(dtype)
    return {"X": X, "y": y}


def logp(x: torch.Tensor, data: dict, mm=torch.matmul) -> torch.Tensor:
    """``logp (K,)`` of the rows of ``x (K, 56)``; ``mm`` is every matrix
    product."""
    X, y = data["X"].to(x.dtype), data["y"].to(x.dtype)
    w, log_alpha = x[..., :-1], x[..., -1]
    p = w.shape[-1]
    alpha = torch.exp(log_alpha)
    z = mm(w, X.mT)  # (K, n) logits
    loglik = torch.sum(y * z - F.softplus(z), dim=-1)
    return (loglik + 0.5 * p * log_alpha - 0.5 * alpha * torch.sum(w * w, dim=-1)
            - GAMMA_RATE * alpha + log_alpha)

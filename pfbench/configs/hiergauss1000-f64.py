"""The 1000-D hierarchical posterior: the user's model, in plain torch.

``z = (log τ, θ ∈ ℝ^{d−1})``: ``log τ ~ N(0, 1)``, ``θ ~ N(0, I)``,
``obs ~ N(e^{log τ / 2} θ, I)``, non-centred (the JAX bench's ``run_bench``
target, ``bench.py:461-473``). ``obs`` is drawn from the run's seed.
"""

import torch


def make_data(cfg: dict, gen: torch.Generator, device) -> dict:
    """``obs (d − 1,)`` in the configuration's dtype, on ``device``."""
    dtype = getattr(torch, cfg["dtype"])
    return {"obs": torch.randn(cfg["dim"] - 1, generator=gen, device=device, dtype=dtype)}


def logp(z: torch.Tensor, data: dict, mm=torch.matmul) -> torch.Tensor:
    """``logp (K,)`` of the rows of ``z (K, d)``; ``mm`` is every matrix
    product (this target has none)."""
    obs = data["obs"].to(z.dtype)
    log_tau, theta = z[..., 0], z[..., 1:]
    sigma = torch.exp(0.5 * log_tau)
    return (-0.5 * log_tau**2 - 0.5 * torch.sum(theta * theta, dim=-1)
            - 0.5 * torch.sum((obs - sigma[..., None] * theta) ** 2, dim=-1))

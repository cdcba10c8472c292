"""Sampling diagnostics: rank-normalized split-R̂ and bulk and tail effective
sample size (counterpart of ``pathfinder_tpu/utils/diagnostics.py``).

Definitions from Vehtari, Gelman, Simpson, Carpenter, Bürkner (2021),
*Rank-normalization, folding, and localization: An improved R̂*, over
``(num_chains, num_samples, dim)`` sample stacks on any torch device:

* samples are rank-normalized (ranks → normal quantiles by the
  (r − 3/8)/(S + 1/4) rule) before both diagnostics, so heavy tails cannot
  mask mixing failures;
* ``split_rhat`` is the max of the rank-normalized split-R̂ and the folded
  (median-absolute-deviation) split-R̂;
* ``ess_bulk`` is the spectral ESS (FFT autocovariance + Geyer's initial
  monotone sequence) of the rank-normalized samples, with
  ``var⁺ = mean-autocov₀ + var(chain means)``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["split_rhat", "ess_bulk", "ess_tail", "summarize"]


def _as_stack(samples) -> torch.Tensor:
    x = torch.as_tensor(samples)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _split_chains(x):
    """(C, N, d) -> (2C, N//2, d)."""
    C, N, d = x.shape
    half = N // 2
    return x[:, : 2 * half, :].reshape(C * 2, half, d)


def _rank_normalize(x):
    """Rank-normalize each dimension of ``x (C, N, d)`` over all its C·N
    entries: rank r → Φ⁻¹((r − 3/8)/(S + 1/4)).

    Ties get *average* ranks (the convention of Vehtari et al. and ArviZ),
    so the diagnostics are permutation-invariant for discrete or heavily
    tied chains: rank(x) = (#{< x} + #{≤ x} + 1) / 2 by two searchsorted
    passes."""
    C, N, d = x.shape
    S = C * N
    flat = x.reshape(S, d).mT.contiguous()  # (d, S)
    sorted_flat = torch.sort(flat, dim=-1).values
    lo = torch.searchsorted(sorted_flat, flat, right=False)
    hi = torch.searchsorted(sorted_flat, flat, right=True)
    # rank arithmetic in at least f32: a narrower dtype would round the ranks
    rank_dtype = torch.promote_types(x.dtype, torch.float32)
    ranks = 0.5 * (lo + hi + 1).to(rank_dtype)
    z = torch.special.ndtri((ranks - 0.375) / (S + 0.25))
    return z.mT.reshape(C, N, d)


def _basic_split_rhat(x):
    """Split-R̂ of (C, N, d) without any normalization."""
    x = _split_chains(x)
    C, N, d = x.shape
    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, unbiased=True)
    W = chain_vars.mean(dim=0)
    B = N * chain_means.var(dim=0, unbiased=True)
    var_plus = (N - 1) / N * W + B / N
    return torch.sqrt(var_plus / W)


def split_rhat(samples) -> torch.Tensor:
    """Rank-normalized split-R̂, the max of the bulk and folded variants, per
    dimension of a ``(chains, samples, dim)`` stack."""
    x = _as_stack(samples)
    z = _rank_normalize(x)
    med = torch.quantile(x.reshape(-1, x.shape[-1]), 0.5, dim=0)
    zf = _rank_normalize(torch.abs(x - med))
    return torch.maximum(_basic_split_rhat(z), _basic_split_rhat(zf))


def _autocov(x):
    """Autocovariance of each chain by FFT: x (..., N) -> (..., N), biased (1/N)."""
    N = x.shape[-1]
    xc = x - x.mean(dim=-1, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * N, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * N, dim=-1)[..., :N]
    return acov / N


def _ess(xd):
    """Spectral ESS of ``xd (d, C, N)`` chains (already normalized): ``(d,)``."""
    d, C, N = xd.shape
    acov = _autocov(xd)
    chain_var = acov[..., 0] * N / (N - 1)
    W = chain_var.mean(dim=-1)  # (d,)
    mean_acov = acov.mean(dim=1)  # (d, N)
    # var⁺ = (N−1)/N · W + B/N  =  mean_acov[0] + var(chain means)
    var_plus = mean_acov[:, 0] + xd.mean(dim=-1).var(dim=-1, unbiased=True)
    rho = 1.0 - (W[:, None] - mean_acov) / var_plus[:, None]  # (d, N)
    npairs = N // 2
    pair = rho[:, : 2 * npairs].reshape(d, npairs, 2).sum(dim=-1)
    pos = torch.cumprod((pair > 0).to(torch.int64), dim=-1) > 0  # up to the first non-positive pair
    pair_mon = torch.cummin(pair, dim=-1).values  # monotone cap
    tau = -1.0 + 2.0 * torch.sum(torch.where(pos, pair_mon, torch.zeros_like(pair)), dim=-1)
    tau = torch.clamp(tau, min=1.0 / math.log10(float(N * C)))
    return C * N / tau


def ess_bulk(samples) -> torch.Tensor:
    """Bulk ESS (rank-normalized spectral ESS on split chains) per dimension
    of a ``(chains, samples, dim)`` stack."""
    x = _split_chains(_as_stack(samples))
    return _ess(_rank_normalize(x).permute(2, 0, 1))


def _ess_quantile(xd, prob):
    """ESS of the indicator I(x ≤ q_prob) over ``xd (d, C, N)`` split
    chains: the tail-resolution measure of Vehtari et al. (2021) §4.3."""
    d = xd.shape[0]
    q = torch.quantile(xd.reshape(d, -1), prob, dim=-1)
    ind = (xd <= q[:, None, None]).to(xd.dtype)
    # a constant indicator (all or none below q) carries no tail-resolution
    # information: NaN (the ArviZ/posterior convention), not a spuriously
    # maximal ESS for heavily tied or near-constant chains
    flat = ind.reshape(d, -1)
    degenerate = (flat == flat[:, :1]).all(dim=-1)
    return torch.where(degenerate, torch.nan, _ess(ind))


def ess_tail(samples) -> torch.Tensor:
    """Tail ESS: the min of the 5%- and 95%-quantile indicator ESS per
    dimension of a ``(chains, samples, dim)`` stack (Vehtari et al. 2021; the
    ArviZ ``ess_tail`` convention). A low tail ESS beside a fine bulk ESS
    means the chains resolve the center but not the tails. NaN where a
    quantile indicator is constant."""
    xd = _split_chains(_as_stack(samples)).permute(2, 0, 1)
    return torch.minimum(_ess_quantile(xd, 0.05), _ess_quantile(xd, 0.95))


def summarize(samples) -> dict:
    """Mean, sd, ESS and R̂ of a ``(chains, samples, dim)`` stack (or of
    ``(samples, dim)``, taken as one chain)."""
    x = _as_stack(samples)
    if x.ndim == 2:
        x = x[None]
    flat = x.reshape(-1, x.shape[-1])
    return {
        "mean": flat.mean(dim=0),
        "sd": flat.std(dim=0, unbiased=True),
        "ess_bulk": ess_bulk(x),
        "ess_tail": ess_tail(x),
        "rhat": split_rhat(x),
    }

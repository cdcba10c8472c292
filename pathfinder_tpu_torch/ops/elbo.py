"""Monte-Carlo ELBO over trajectory candidates (counterpart of
``pathfinder_tpu/ops/elbo.py``), batched over paths and candidates.

Candidate ``i`` of a path draws its noise from its own stream, so a
candidate's estimate does not depend on the chunk it falls in or on the
other paths in the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.misc import findmax_skipnan

__all__ = [
    "ELBOEstimate",
    "elbo_and_samples",
    "elbo_stats",
    "maximize_elbo",
    "maximize_elbo_chunked",
]


@dataclasses.dataclass(frozen=True)
class ELBOEstimate:
    value: torch.Tensor  # (...) ELBO point estimate
    std_err: torch.Tensor  # (...) Monte-Carlo SE
    draws: torch.Tensor  # (..., d, ndraws)
    log_densities_target: torch.Tensor  # (..., ndraws)
    log_densities_fit: torch.Tensor  # (..., ndraws)
    log_density_ratios: torch.Tensor  # (..., ndraws)


def elbo_and_samples(logp: Callable, dist: MvNormal, u: torch.Tensor) -> ELBOEstimate:
    """ELBO of each (batched) candidate from its noise ``u (..., d, N)``:
    draws and logq from kernel B1, the target's logp on every draw."""
    draws, logq = dist.rand_and_logpdf(u=u)
    d, N = draws.shape[-2:]
    flat = draws.mT.reshape(-1, d)
    logp_x = logp(flat).to(draws.dtype).reshape(logq.shape)
    logr = logp_x - logq
    elbo = logr.mean(dim=-1)
    if N > 1:
        var = torch.sum((logr - elbo[..., None]) ** 2, dim=-1) / (N - 1)
        se = torch.sqrt(var / N)
    else:
        # a single draw has no variance information: SE is unknown
        se = torch.full_like(elbo, torch.nan)
    return ELBOEstimate(elbo, se, draws, logp_x, logq, logr)


def elbo_stats(logp: Callable, dist: MvNormal, u: torch.Tensor):
    """``(value, std_err)`` of :func:`elbo_and_samples`; the draws are not
    kept, since the same noise replays them."""
    est = elbo_and_samples(logp, dist, u)
    return est.value, est.std_err


def maximize_elbo(logp: Callable, dists: MvNormal, u: torch.Tensor, valid_mask: torch.Tensor):
    """The ELBO of every candidate at once and the NaN-skipping argmax over
    the last batch axis: ``dists`` batched ``(..., L)``, their noise
    ``u (..., L, d, N)``, ``valid_mask (..., L)``. Returns ``(best_idx (...),
    estimates, best_value (...))``; the values and standard errors of
    invalid candidates are NaN, as in :func:`maximize_elbo_chunked`."""
    est = elbo_and_samples(logp, dists, u)
    est = dataclasses.replace(
        est,
        value=torch.where(valid_mask, est.value, torch.nan),
        std_err=torch.where(valid_mask, est.std_err, torch.nan),
    )
    best, idx = findmax_skipnan(est.value)
    return idx, est, best


def maximize_elbo_chunked(
    logp: Callable,
    make_chunk_dists: Callable,
    noise: Callable,
    num_candidates: int,
    chunk_size: int,
    valid_mask: torch.Tensor,
    dtype=torch.float32,
):
    """Chunked ELBO maximization over ``K`` paths at once.

    ``make_chunk_dists(idx (K, C)) -> MvNormal`` batched ``(K, C)`` builds
    the candidates of one chunk; ``noise(idx (K, C)) -> u (K, C, d, N)``
    gives their noise. Chunks past every path's last valid candidate are
    skipped; stats of invalid candidates are NaN. Returns ``(best_idx (K,),
    values (K, L), ses (K, L), best_value (K,))``.
    """
    K = valid_mask.shape[0]
    C = chunk_size
    nchunks = -(-num_candidates // C)
    dev = valid_mask.device
    pos = torch.arange(1, num_candidates + 1, device=dev)
    # the cutoff is the last valid index + 1, so scattered masks work too
    n_valid_cand = torch.where(valid_mask, pos, 0).amax()
    with tracing.sync("ops/elbo.py"):
        n_valid_cand = int(n_valid_cand)
    vals = torch.full((K, nchunks * C), torch.nan, dtype=dtype, device=dev)
    ses = torch.full_like(vals, torch.nan)
    for c in range(nchunks):
        if c * C >= n_valid_cand:
            break
        idx = (c * C + torch.arange(C, device=dev)).expand(K, C)
        est = elbo_and_samples(logp, make_chunk_dists(idx), noise(idx))
        vals[:, c * C:(c + 1) * C] = est.value
        ses[:, c * C:(c + 1) * C] = est.std_err
    vals = vals[:, :num_candidates]
    ses = ses[:, :num_candidates]
    # NaN marks invalid candidates in both outputs: a chunk straddling a
    # trajectory's end computes finite garbage from clipped trace points
    vals = torch.where(valid_mask, vals, torch.nan)
    ses = torch.where(valid_mask, ses, torch.nan)
    best, idx = findmax_skipnan(vals)
    return idx, vals, ses, best

"""Weighted resampling of pooled multi-path draws (counterpart of
``pathfinder_tpu/ops/resample.py``).

With replacement: inverse-CDF sampling over the (smoothed) weights. Without
replacement: Gumbel-top-k (Efraimidis–Spirakis). The noise comes from a
:class:`~pathfinder_tpu_torch.utils.rng.Stream`, or is passed in (``u=``
uniforms, ``gumbel=``) so tests can inject the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pathfinder_tpu_torch.ops.psis import PSISResult
from pathfinder_tpu_torch.utils import tracing
from pathfinder_tpu_torch.utils.rng import Stream

__all__ = ["resample_indices", "resample_draws"]


def resample_indices(
    stream: Optional[Stream],
    total: int,
    ndraws: int,
    log_weights: Optional[torch.Tensor] = None,
    replace: bool = True,
    *,
    u: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    device="cpu",
) -> torch.Tensor:
    """``ndraws`` indices into ``0..total-1``; uniform when ``log_weights``
    is None."""
    if log_weights is not None:
        device = log_weights.device
    dtype = torch.float64 if log_weights is None else log_weights.dtype
    if replace:
        if u is None:
            u = stream.uniform(ndraws, dtype, device)
        if log_weights is None:
            return torch.clamp((u * total).long(), max=total - 1)
        w = torch.softmax(log_weights, dim=0)
        # the running sum on the host, in order: on a CUDA device torch.cumsum
        # may add in another order from one call to the next, and a draw whose
        # u lands on a boundary then moves (1 index of 1000 in 1 of 5 K=32768
        # pairs on an H100, PERF.md §7)
        with tracing.sync("ops/resample.py"):
            w, u = w.cpu(), u.cpu()
        cdf = torch.cumsum(w, dim=0)
        idx = torch.searchsorted(cdf, (u * cdf[-1]).to(cdf.dtype), right=True)
        return torch.clamp(idx, 0, total - 1).to(device)
    if ndraws > total:
        raise ValueError(f"cannot draw {ndraws} from {total} without replacement")
    if log_weights is not None:
        # Gumbel-top-k fills slots only from positive-weight entries; refuse
        # rather than return zero-probability indices
        n_support = tracing.read(torch.sum(log_weights > -torch.inf), "ops/resample.py")
        if ndraws > n_support:
            raise ValueError(
                f"cannot draw {ndraws} without replacement: only {n_support} "
                f"of {total} pooled draws have nonzero importance weight "
                "(use replace=True, or fewer draws)"
            )
    if gumbel is None:
        gumbel = -torch.log(-torch.log(stream.uniform(total, dtype, device)))
    keys = gumbel if log_weights is None else log_weights + gumbel
    # a stable descending sort takes ties in index order, as lax.top_k does
    return torch.argsort(keys, descending=True, stable=True)[:ndraws]


@tracing.spanned("resample")
def resample_draws(
    stream: Optional[Stream],
    draws_per_component: torch.Tensor,  # (K, N, d)
    psis_result: Optional[PSISResult],
    ndraws: int,
    replace: bool = True,
    device=None,
    **noise,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool the ``(K, N, d)`` per-component draws (component-major) and
    sample ``ndraws`` of them by PSIS weight, or uniformly when
    ``psis_result`` is None. Returns ``(draws (d, ndraws), component_ids
    (ndraws,))`` on ``device`` (default: where the pool lies); the pool may
    lie elsewhere, in host memory for instance, and only the chosen draws
    move."""
    K, N, d = draws_per_component.shape
    lw = None if psis_result is None else psis_result.log_weights
    idx = resample_indices(
        stream, K * N, ndraws, lw, replace=replace,
        device=draws_per_component.device if device is None else device, **noise,
    )
    at = idx.to(draws_per_component.device)
    draws = draws_per_component[at // N, at % N].to(idx.device).T
    return draws, idx // N

"""Multi-path Pathfinder: batched paths → mixture → PSIS → resampling
(counterpart of ``pathfinder_tpu/multipath.py``, main path only).

All K paths run as one batch on one device. Failed paths are retried in
bounded rounds that re-run only the failed lanes, compacted and padded to a
power of two. Path ``i`` in round ``r`` draws everything from the streams
``(seed, i, r, ...)``, so results do not depend on batch layout.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from pathfinder_tpu_torch.models.protocol import LogDensity, as_log_density
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu_torch.ops.psis import PSISResult, psis
from pathfinder_tpu_torch.ops.resample import resample_draws
from pathfinder_tpu_torch.singlepath import (
    PathfinderConfig,
    SinglePathState,
    pathfinder_core,
    uniform_init_sampler,
    validate_dtype,
)
from pathfinder_tpu_torch.utils import rng
from pathfinder_tpu_torch.utils.misc import resolve_device, tree_map

__all__ = ["multipathfinder", "MultiPathfinderResult", "resample"]

# options of the JAX entry point that this port does not have yet; passing
# one raises NotImplementedError rather than being silently ignored
_NOT_PORTED = (
    "mesh", "max_paths_per_launch", "keep_traces", "offload_launches",
    "transform", "grad", "hess", "progress", "progress_every",
    "auto_optimizers", "auto_khat_early_exit", "auto_laplace",
)


def _log_importance_ratios_fit(components: MvNormal, draws_knd: torch.Tensor):
    """logq of each draw under its own component: ``(K, N)`` (kernel B2)."""
    return components.logpdf(draws_knd.mT)


def _compute_psis_result(
    logp: Callable, components: MvNormal, draws_knd: torch.Tensor
) -> PSISResult:
    """PSIS over the pooled own-component log ratios, component-major."""
    K, N, d = draws_knd.shape
    log_q = _log_importance_ratios_fit(components, draws_knd)
    log_p = logp(draws_knd.reshape(K * N, d)).to(log_q.dtype).reshape(K, N)
    return psis((log_p - log_q).reshape(-1))


@dataclasses.dataclass
class MultiPathfinderResult:
    input: Any
    config: PathfinderConfig
    seed: int
    logp: Callable
    fit_distribution: UniformMixture
    draws: torch.Tensor  # (dim, ndraws)
    draw_component_ids: torch.Tensor  # (ndraws,)
    states: SinglePathState  # batched over paths
    psis_result: Optional[PSISResult]
    num_tries: torch.Tensor  # (K,) tries per path
    draws_per_component: torch.Tensor  # (K, N, d) pooled candidate draws
    target: LogDensity = None
    resample_count: int = 0  # resample() calls that led to this result

    @property
    def nruns(self) -> int:
        return self.states.draws.shape[0]


def multipathfinder(
    fn,
    ndraws: int,
    *,
    seed: int = 0,
    nruns: Optional[int] = None,
    init=None,
    dim: Optional[int] = None,
    ndraws_elbo: int = 5,
    ndraws_per_run: Optional[int] = None,
    importance: bool = True,
    importance_denominator: str = "component",
    history_length: int = 6,
    maxiters: int = 1000,
    ntries: int = 1000,
    init_scale: float = 2.0,
    init_sampler: Optional[Callable] = None,
    gtol: float = 1e-8,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    **config_overrides,
) -> MultiPathfinderResult:
    """Run Pathfinder from ``nruns`` starting points, mix, and importance-
    resample with PSIS over the own-component log ratios.

    ``device`` chooses where every tensor lives. The default, ``"cuda"``,
    runs the two Woodbury kernels on the card and raises when CUDA is not
    available; ``device="cpu"`` runs their plain torch versions.
    ``ndraws_per_run`` defaults to ``max(ndraws_elbo, ceil(ndraws / nruns))``.
    """
    bad = sorted(k for k in config_overrides if k in _NOT_PORTED)
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
    if importance_denominator != "component":
        raise NotImplementedError(
            f"importance_denominator={importance_denominator!r} is not ported yet"
        )
    dev = resolve_device(device)
    target = as_log_density(fn, dim=dim)

    if init is not None:
        init = torch.as_tensor(init, device=dev)
        if not init.is_floating_point():
            init = init.to(torch.get_default_dtype())
        if init.ndim != 2:
            raise ValueError("init must have shape (nruns, dim)")
        if nruns is not None and nruns != init.shape[0]:
            raise ValueError(f"nruns={nruns} conflicts with init's {init.shape[0]} rows")
        nruns, d = init.shape
        if target.dim is not None and target.dim != d:
            raise ValueError(
                f"init rows have length {d} but the target's dimension is {target.dim}"
            )
    else:
        if nruns is None or nruns <= 0:
            raise ValueError("A positive `nruns` must be set or `init` must be provided.")
        d = target.dim
        if d is None:
            raise ValueError("`dim` must be provided when `fn` has no dimension.")
    if target.dim is None:
        target = target.with_dim(d)
    if dtype is None:
        dtype = init.dtype if init is not None else torch.float32
    validate_dtype(dtype)
    sampler = init_sampler or uniform_init_sampler(init_scale)

    if ndraws_per_run is None:
        ndraws_per_run = max(ndraws_elbo, -(-ndraws // max(nruns, 1)))
    if ndraws > ndraws_per_run * nruns:
        warnings.warn(
            "More draws requested than total number of draws across replicas. "
            "Draws will not be unique."
        )
    config = PathfinderConfig(
        maxiters=maxiters,
        history_length=history_length,
        ndraws_elbo=ndraws_elbo,
        ndraws=ndraws_per_run,
        gtol=gtol,
        **config_overrides,
    )

    def run_round(path_ids: torch.Tensor, round_idx: int) -> SinglePathState:
        if init is not None and round_idx == 0:
            x0s = init.to(dtype)
        else:
            stream = rng.Stream(seed, path_ids, round_idx, rng.INIT)
            x0s = sampler(stream, d, dtype, dev)
        return pathfinder_core(target, x0s, config, seed, path_ids, round_idx)

    states = run_round(torch.arange(nruns, device=dev), 0)
    num_tries = np.ones(nruns, dtype=np.int64)
    rounds = 1
    while rounds < ntries:
        failed = ~states.success.cpu().numpy()
        if not failed.any():
            break
        fidx = np.nonzero(failed)[0]
        B = 1 << max(0, int(np.ceil(np.log2(len(fidx)))))
        sel = np.concatenate([fidx, np.full(B - len(fidx), fidx[0])])
        retry = run_round(torch.as_tensor(sel, device=dev), rounds)
        rows = torch.as_tensor(fidx, device=dev)

        def merge(old, new):
            out = old.clone()
            out[rows] = new[: len(fidx)]
            return out

        states = tree_map(merge, states, retry)
        num_tries[failed] += 1
        rounds += 1

    n_failed = int((~states.success).sum())
    if n_failed:
        warnings.warn(
            f"{n_failed} of {nruns} Pathfinder runs failed after {ntries} "
            "tries; their fits may contaminate the mixture."
        )

    components = states.fit_distribution
    draws_knd = states.draws.mT  # (K, N, d)
    psis_result = (
        _compute_psis_result(target.logp, components, draws_knd) if importance else None
    )
    draws, component_ids = resample_draws(
        rng.Stream(seed, 0, 0, rng.RESAMPLE), draws_knd, psis_result, ndraws
    )
    return MultiPathfinderResult(
        input=fn,
        config=config,
        seed=seed,
        logp=target.logp,
        fit_distribution=UniformMixture(components),
        draws=draws,
        draw_component_ids=component_ids,
        states=states,
        psis_result=psis_result,
        num_tries=torch.as_tensor(num_tries),
        draws_per_component=draws_knd,
        target=target,
    )


def resample(
    result: MultiPathfinderResult,
    ndraws: int,
    *,
    replace: bool = True,
    importance: bool = True,
    ndraws_per_run: Optional[int] = None,
) -> MultiPathfinderResult:
    """Re-resample a finished result without re-optimizing. Reuses the stored
    per-path draws and PSIS result unless ``ndraws_per_run`` asks for fresh
    draws from each component. Each call on a result draws from the next
    round of the resampling stream, so chained calls differ."""
    count = result.resample_count + 1
    components = result.fit_distribution.components
    if ndraws_per_run is None:
        draws_knd = result.draws_per_component
        psis_stored = result.psis_result
    else:
        K = components.mean.shape[0]
        paths = torch.arange(K, device=components.mean.device)
        stream = rng.Stream(result.seed, paths, count, rng.RESAMPLE_FRESH)
        draws_knd = components.sample(stream, ndraws_per_run).mT
        psis_stored = None
    if importance:
        psis_used = psis_stored
        if psis_used is None:
            psis_used = _compute_psis_result(result.logp, components, draws_knd)
    else:
        psis_used = None
    draws, component_ids = resample_draws(
        rng.Stream(result.seed, 0, count, rng.RESAMPLE), draws_knd, psis_used,
        ndraws, replace=replace,
    )
    return dataclasses.replace(
        result,
        draws=draws,
        draw_component_ids=component_ids,
        psis_result=psis_used,
        draws_per_component=draws_knd,
        resample_count=count,
    )

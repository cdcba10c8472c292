"""Single-path Pathfinder core, batched over paths, and the single-path
driver (counterpart of ``pathfinder_tpu/singlepath.py``).

Pipeline per path: L-BFGS trajectory → inverse-Hessian fits at every point
→ chunked ELBO with the NaN-skipping argmax → the winner's draws. The K
paths of a batch run as one leading axis. Every random number comes from a
stream keyed by ``(seed, path, round, purpose, candidate)``, so a path's
result does not depend on which batch it runs in.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional, Union

import torch

from pathfinder_tpu_torch.models.protocol import LogDensity, as_log_density
from pathfinder_tpu_torch.ops.elbo import maximize_elbo_chunked
from pathfinder_tpu_torch.ops.lbfgs import (
    OptimizationTrace,
    lbfgs_fits_at,
    lbfgs_history_aux,
    minimize_lbfgs_trace,
)
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, fit_mvnormal
from pathfinder_tpu_torch.utils import rng
from pathfinder_tpu_torch.utils.misc import resolve_device, tree_map

__all__ = [
    "pathfinder",
    "pathfinder_core",
    "PathfinderConfig",
    "PathfinderResult",
    "SinglePathState",
    "uniform_init_sampler",
]


@dataclasses.dataclass(frozen=True)
class PathfinderConfig:
    """Configuration of the core; defaults are the JAX package's."""

    maxiters: int = 1000
    history_length: int = 6
    ndraws_elbo: int = 5
    ndraws: int = 5
    gtol: float = 1e-8
    ftol: float = 10.0  # relative-progress stop in ulps; <= 0 disables
    epsilon_curvature: float = 1e-12
    max_ls_evals: int = 12
    c1: Optional[float] = None  # None: Hager-Zhang's δ = 0.1
    c2: float = 0.9
    fail_on_nonfinite: bool = True
    elbo_chunk: int = 16  # candidates per ELBO chunk (a memory bound)
    optimizer: str = "lbfgs"
    line_search: str = "hager_zhang"

    def __post_init__(self):
        if self.optimizer != "lbfgs":
            raise NotImplementedError(f"optimizer={self.optimizer!r} is not ported yet")
        if self.line_search != "hager_zhang":
            raise NotImplementedError(
                f"line_search={self.line_search!r} is not ported yet"
            )
        if self.maxiters < 1:
            raise ValueError(f"maxiters must be >= 1, got {self.maxiters}")
        if self.elbo_chunk < 1:
            raise ValueError(f"elbo_chunk must be >= 1, got {self.elbo_chunk}")


@dataclasses.dataclass(frozen=True)
class SinglePathState:
    """Everything the core computes for a batch of paths."""

    success: torch.Tensor  # (K,) bool
    path_id: torch.Tensor  # (K,) stream path ids
    round: torch.Tensor  # (K,) stream round of each path's attempt
    trace: OptimizationTrace
    fit_iteration: torch.Tensor  # (K,) 1-based trajectory iteration
    elbo_values: torch.Tensor  # (K, maxiters) per candidate (NaN = invalid)
    elbo_se: torch.Tensor  # (K, maxiters)
    fit_distribution: MvNormal  # batched (K,): the ELBO winners
    num_bfgs_updates_rejected: torch.Tensor  # (K,)
    draws: torch.Tensor  # (K, d, ndraws)
    num_fn_evals: torch.Tensor  # (K,)


def _gather_points(t, points):
    """Rows of ``t (K, L+1, ...)`` at ``points (K, P)``."""
    K, P = points.shape
    idx = points.reshape((K, P) + (1,) * (t.ndim - 2)).expand((K, P) + t.shape[2:])
    return torch.gather(t, 1, idx)


def candidate_dists(trace: OptimizationTrace, aux, history_length: int) -> Callable:
    """``make(cand_idx (K, C)) -> MvNormal (K, C)``: the normal fitted at
    trajectory iteration ``cand_idx + 1`` of each path (candidates are
    iterations 1..L; the initial point is skipped), μ = θ + Σ∇logp(θ)."""
    L = trace.xs.shape[1] - 1

    def make(cand_idx):
        points = torch.clamp(cand_idx + 1, 0, L)
        fits = lbfgs_fits_at(aux, points, history_length)
        return fit_mvnormal(
            _gather_points(trace.xs, points),
            _gather_points(trace.gradients, points),
            fits,
        )

    return make


def pathfinder_core(
    target: LogDensity,
    x0s: torch.Tensor,
    config: PathfinderConfig,
    seed: int,
    path_ids: torch.Tensor,
    round_idx: int,
) -> SinglePathState:
    """One Pathfinder attempt for each row of ``x0s (K, d)``."""
    cfg = config
    K, d = x0s.shape
    dtype = x0s.dtype
    trace = minimize_lbfgs_trace(
        target.value_and_grad,
        x0s,
        maxiters=cfg.maxiters,
        history_length=cfg.history_length,
        gtol=cfg.gtol,
        ftol=cfg.ftol,
        epsilon_curvature=cfg.epsilon_curvature,
        max_ls_evals=cfg.max_ls_evals,
        c1=cfg.c1,
        c2=cfg.c2,
        fail_on_nonfinite=cfg.fail_on_nonfinite,
    )
    aux = lbfgs_history_aux(trace, cfg.epsilon_curvature)
    L = cfg.maxiters
    N = cfg.ndraws_elbo
    make_chunk_dists = candidate_dists(trace, aux, cfg.history_length)

    def elbo_stream(cand_idx):
        return rng.Stream(seed, path_ids[:, None], round_idx, rng.ELBO, cand_idx)

    def noise(cand_idx):
        z = elbo_stream(cand_idx).normal(d * N, dtype, x0s.device)
        return z.reshape(cand_idx.shape + (d, N))

    best_idx, elbo_values, elbo_se, best_elbo = maximize_elbo_chunked(
        target.logp,
        make_chunk_dists,
        noise,
        num_candidates=L,
        chunk_size=min(cfg.elbo_chunk, L),
        valid_mask=aux.point_mask[:, 1:],
        dtype=dtype,
    )
    n_valid = trace.num_valid - 1
    success = (n_valid > 0) & ~torch.isnan(best_elbo) & (best_elbo != -torch.inf)

    # rebuild the winner once and replay its ELBO draws from the same stream
    fit = tree_map(lambda t: t[:, 0], make_chunk_dists(best_idx[:, None]))
    winner_draws = fit.sample(u=noise(best_idx[:, None])[:, 0])
    extra_stream = rng.Stream(seed, path_ids, round_idx, rng.EXTRA)
    if cfg.ndraws <= N:
        reused = winner_draws[..., : cfg.ndraws]
    else:
        extra = fit.sample(extra_stream, cfg.ndraws - N)
        reused = torch.cat([winner_draws, extra], dim=-1)
    fresh = fit.sample(extra_stream, cfg.ndraws)
    draws = torch.where(success[:, None, None], reused, fresh)

    return SinglePathState(
        success=success,
        path_id=path_ids,
        round=torch.full_like(path_ids, round_idx),
        trace=trace,
        fit_iteration=best_idx + 1,
        elbo_values=elbo_values,
        elbo_se=elbo_se,
        fit_distribution=fit,
        num_bfgs_updates_rejected=aux.num_rejected,
        draws=draws,
        num_fn_evals=trace.num_fn_evals,
    )


def uniform_init_sampler(scale: float = 2.0) -> Callable:
    """IID U[−scale, scale] initial points:
    ``sampler(stream, dim, dtype, device) -> (*batch, dim)``."""
    if scale <= 0:
        raise ValueError("scale of uniform sampler must be positive.")

    def sampler(stream: rng.Stream, dim, dtype, device):
        return stream.uniform(dim, dtype, device) * (2 * scale) - scale

    return sampler


@dataclasses.dataclass
class PathfinderResult:
    """Single-path result (counterpart of the JAX package's
    ``PathfinderResult``; the transformed-space fields and the lazy replays
    are not ported yet)."""

    input: Any
    config: PathfinderConfig
    seed: int
    logp: Callable
    fit_distribution: MvNormal
    draws: torch.Tensor  # (dim, ndraws)
    fit_iteration: int
    num_tries: int
    optim_trace: OptimizationTrace
    elbo_values: torch.Tensor  # (maxiters,)
    elbo_se: torch.Tensor  # (maxiters,)
    num_bfgs_updates_rejected: int
    success: bool
    num_fn_evals: int
    state: SinglePathState = None


def validate_dtype(dtype) -> None:
    if not dtype.is_floating_point:
        raise ValueError(f"dtype must be a floating type; got {dtype}")
    if torch.finfo(dtype).bits < 32:
        warnings.warn(
            f"dtype={dtype} optimization state is almost always numerically "
            "unusable for L-BFGS (curvature pairs lose all significance); "
            "use float32."
        )


def pathfinder(
    fn,
    *,
    seed: int = 0,
    dim: Optional[int] = None,
    init=None,
    ndraws_elbo: int = 5,
    ndraws: Optional[int] = None,
    history_length: int = 6,
    maxiters: int = 1000,
    ntries: int = 1000,
    init_scale: float = 2.0,
    init_sampler: Optional[Callable] = None,
    gtol: float = 1e-8,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device] = "cuda",
    **config_overrides,
) -> PathfinderResult:
    """The ELBO-best normal approximation along one L-BFGS trajectory, with
    the host retry loop: try ``t`` (1-based) draws its initial point and all
    its noise from round ``t − 1`` of path 0's streams.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is not available;
    ``device="cpu"`` runs on the CPU."""
    dev = resolve_device(device)
    target = as_log_density(fn, dim=dim)
    if ndraws is None:
        ndraws = ndraws_elbo
    if init is not None:
        init = torch.as_tensor(init, device=dev)
        if not init.is_floating_point():
            init = init.to(torch.get_default_dtype())
        if dtype is not None:
            init = init.to(dtype)
        d = init.shape[0]
        if target.dim is not None and target.dim != d:
            raise ValueError(
                f"init has length {d} but the target's dimension is {target.dim}"
            )
    else:
        d = target.dim
        if d is None:
            raise ValueError("An initial point `init` or dimension `dim` must be provided.")
    if target.dim is None:
        target = target.with_dim(d)
    if dtype is None:
        dtype = init.dtype if init is not None else torch.float32
    validate_dtype(dtype)
    sampler = init_sampler or uniform_init_sampler(init_scale)
    config = PathfinderConfig(
        maxiters=maxiters,
        history_length=history_length,
        ndraws_elbo=ndraws_elbo,
        ndraws=ndraws,
        gtol=gtol,
        **config_overrides,
    )
    path0 = torch.zeros(1, dtype=torch.int64, device=dev)

    def attempt(itry):
        rnd = itry - 1
        if init is not None and itry == 1:
            x0 = init[None]
        else:
            x0 = sampler(rng.Stream(seed, path0, rnd, rng.INIT), d, dtype, dev)
        return pathfinder_core(target, x0, config, seed, path0, rnd)

    itry = 1
    state = attempt(itry)
    while not bool(state.success[0]) and itry < ntries:
        itry += 1
        state = attempt(itry)

    success = bool(state.success[0])
    if not success:
        warnings.warn(
            f"Pathfinder failed after {itry} tries. Increase `ntries`, inspect "
            "the model for numerical instability, or provide a more suitable "
            "`init_sampler`."
        )
    one = tree_map(lambda t: t[0], state)
    nrej = int(one.num_bfgs_updates_rejected)
    if nrej > 0:
        total = int(one.trace.num_valid) - 1
        perc = round(nrej * 100.0 / max(total, 1), 1)
        warnings.warn(
            f"{nrej} ({perc}%) updates to the inverse Hessian estimate were "
            "rejected to keep it positive definite."
        )
    return PathfinderResult(
        input=fn,
        config=config,
        seed=seed,
        logp=target.logp,
        fit_distribution=one.fit_distribution,
        draws=one.draws,
        fit_iteration=int(one.fit_iteration),
        num_tries=itry,
        optim_trace=one.trace,
        elbo_values=one.elbo_values,
        elbo_se=one.elbo_se,
        num_bfgs_updates_rejected=nrej,
        success=success,
        num_fn_evals=int(one.num_fn_evals),
        state=state,
    )

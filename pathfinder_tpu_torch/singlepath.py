"""Single-path Pathfinder core, batched over paths, and the single-path
driver (counterpart of ``pathfinder_tpu/singlepath.py``).

Pipeline per path: optimizer trajectory (L-BFGS by default; any optimizer
with the trace contract of ``ops/optimizers.py``) → inverse-Hessian fits at
every point
→ chunked ELBO with the NaN-skipping argmax → the winner's draws. The K
paths of a batch run as one leading axis. Every random number comes from a
stream keyed by ``(seed, path, round, purpose, candidate)``, so a path's
result does not depend on which batch it runs in.

The core also runs as one member of a row group (``utils/rows.py``: the
mesh's ``dim`` axis, ``parallel/sharding.make_path_executor``): ``x0s``
then holds the member's rows of ``d``, the noise its rows of the unsplit
streams, and every reduction over ``d`` is summed over the members.
"""

from __future__ import annotations

import dataclasses
import sys
import warnings
from typing import Any, Callable, Optional, Union

import torch

from pathfinder_tpu_torch.integrations.transforms import (
    resolve_transform,
    transformed_outputs,
)
from pathfinder_tpu_torch.models.protocol import LogDensity, as_log_density
from pathfinder_tpu_torch.ops.elbo import (
    ELBOEstimate,
    elbo_and_samples,
    maximize_elbo_chunked,
)
from pathfinder_tpu_torch.ops.lbfgs import (
    OptimizationTrace,
    lbfgs_fits_at,
    lbfgs_history_aux,
    lbfgs_inverse_hessians,
)
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, fit_mvnormal
from pathfinder_tpu_torch.ops.optimizers import resolve_optimizer
from pathfinder_tpu_torch.utils import rng, rows, tracing
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
    # trajectory optimizer: a name of ``ops.optimizers.OPTIMIZERS`` or any
    # callable with the minimize_*_trace contract; the fit and ELBO stages
    # read only the trace it returns
    optimizer: Any = "lbfgs"
    line_search: str = "hager_zhang"  # a name ``ops.linesearch.resolve_line_search`` knows
    # > 0: every lane prints a line each time its iteration count reaches a
    # multiple of this (the optimizers' shared loop, ``ops/trajectory.py``)
    progress_every: int = 0

    def __post_init__(self):
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
    launch_lanes: torch.Tensor  # (K,) lanes of the launch that ran each attempt
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


def elbo_noise(seed: int, path_ids, round_idx, cand_idx, d: int, ndraws: int, dtype, device):
    """The ELBO noise of candidates ``cand_idx (K, C)`` of paths ``path_ids
    (K,)``: ``u (K, C, d, ndraws)``, one stream per (path, round, candidate).
    In a row group ``d`` is the member's rows, drawn from its rows of the
    unsplit ``(d, ndraws)`` block."""
    stream = rng.Stream(seed, path_ids[:, None], round_idx, rng.ELBO, cand_idx)
    z = stream.normal(d * ndraws, dtype, device, start=rows.row_offset() * ndraws)
    return z.reshape(cand_idx.shape + (d, ndraws))


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
    minimize = resolve_optimizer(cfg.optimizer, target, dim=rows.full_dim(d))
    # progress_every only where asked for: a user optimizer need not take it
    progress = {"progress_every": cfg.progress_every} if cfg.progress_every > 0 else {}
    with tracing.span("trajectory"):
        trace = minimize(
            tracing.spanned("target")(target.value_and_grad),
            x0s,
            **progress,
            maxiters=cfg.maxiters,
            history_length=cfg.history_length,
            gtol=cfg.gtol,
            ftol=cfg.ftol,
            epsilon_curvature=cfg.epsilon_curvature,
            max_ls_evals=cfg.max_ls_evals,
            c1=cfg.c1,
            c2=cfg.c2,
            fail_on_nonfinite=cfg.fail_on_nonfinite,
            line_search=cfg.line_search,
        )
    with tracing.span("fits"):
        aux = lbfgs_history_aux(trace, cfg.epsilon_curvature)
    L = cfg.maxiters
    N = cfg.ndraws_elbo
    make_chunk_dists = candidate_dists(trace, aux, cfg.history_length)

    def noise(cand_idx):
        return elbo_noise(seed, path_ids, round_idx, cand_idx, d, N, dtype, x0s.device)

    with tracing.span("elbo"):
        best_idx, elbo_values, elbo_se, best_elbo = maximize_elbo_chunked(
            tracing.spanned("target")(target.logp),
            tracing.spanned("fits")(make_chunk_dists),
            noise,
            num_candidates=L,
            chunk_size=min(cfg.elbo_chunk, L),
            valid_mask=aux.point_mask[:, 1:],
            dtype=dtype,
        )
    n_valid = trace.num_valid - 1
    success = (n_valid > 0) & ~torch.isnan(best_elbo) & (best_elbo != -torch.inf)

    with tracing.span("winner_draws"):
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
        launch_lanes=torch.full_like(path_ids, K),
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


_SLIM_TRACE = (
    "the trajectory trace was dropped (multipathfinder ran with "
    "keep_traces=False), so per-point fits cannot be rebuilt; re-run with "
    "keep_traces=True to use fit_distributions / elbo_estimates"
)


@dataclasses.dataclass
class PathfinderResult:
    """Single-path result (counterpart of the JAX package's
    ``PathfinderResult``).

    ``fit_distributions`` (a normal at every trajectory point) and
    ``elbo_estimates`` (every candidate's ELBO with its draws) are rebuilt on
    demand from the trace, the latter from the same ``(seed, path, round,
    ELBO, candidate)`` streams the core drew from, so that its values are the
    stored ``elbo_values``. Both raise where the trace was dropped
    (``multipathfinder(keep_traces=False)``)."""

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
    target: LogDensity = None
    # constrained-space views of a transform-aware run (see
    # ``MultiPathfinderResult``); plain runs repeat the fit and the draws
    fit_distribution_transformed: Any = None
    draws_transformed: Any = None
    transform: Any = None

    def _batched_trace(self, lanes: int = 1) -> OptimizationTrace:
        """The trace repeated on a leading path axis of ``lanes``, as the
        batched ops take it."""
        if self.optim_trace.xs.shape[-2] == 0:
            raise ValueError(_SLIM_TRACE)
        return tree_map(lambda t: t[None].repeat((lanes,) + (1,) * t.ndim), self.optim_trace)

    @property
    def fit_distributions(self) -> MvNormal:
        """The normal fitted at every trajectory point ``0..maxiters``,
        batched over points."""
        tr = self._batched_trace()
        cfg = self.config
        fits, _, _ = lbfgs_inverse_hessians(tr, cfg.history_length, cfg.epsilon_curvature)
        return tree_map(lambda t: t[0], fit_mvnormal(tr.xs, tr.gradients, fits))

    @property
    def elbo_estimates(self) -> ELBOEstimate:
        """Every candidate's ELBO estimate with its draws, replayed chunk by
        chunk as the core ran them; NaN where the stored value is NaN (a
        candidate past the trajectory's end).

        The replay runs at the lane count of the launch that ran the path
        (``state.launch_lanes``, the path's trace repeated), because on a
        CUDA device a kernel's launch plan and a library's algorithm, and so
        the order of their sums, follow the batch: at the core's own batch
        shape the replay gives the core's bits. So each call costs the ELBO
        stage of one whole launch, up to ``max_paths_per_launch`` lanes, and
        replaying every path of a run costs about one launch per path."""
        lanes = int(self.state.launch_lanes.reshape(-1)[0])
        tr = self._batched_trace(lanes)
        cfg = self.config
        L, N = cfg.maxiters, cfg.ndraws_elbo
        C = min(cfg.elbo_chunk, L)
        d = tr.xs.shape[-1]
        dev = tr.xs.device
        make = candidate_dists(tr, lbfgs_history_aux(tr, cfg.epsilon_curvature), cfg.history_length)
        path = self.state.path_id.reshape(-1)[:1].to(dev).expand(lanes)
        rnd = int(self.state.round.reshape(-1)[0])
        chunks = []
        for c in range(-(-L // C)):
            idx = (c * C + torch.arange(C, device=dev)).expand(lanes, C)
            u = elbo_noise(self.seed, path, rnd, idx, d, N, tr.xs.dtype, dev)
            # the first lane is the path; the others only give the batch its shape
            chunks.append(tree_map(lambda t: t[0], elbo_and_samples(self.logp, make(idx), u)))
        est = tree_map(lambda *ts: torch.cat(ts)[:L], *chunks)
        invalid = torch.isnan(self.elbo_values).to(dev)
        return dataclasses.replace(
            est,
            value=torch.where(invalid, torch.nan, est.value),
            std_err=torch.where(invalid, torch.nan, est.std_err),
        )

    def __repr__(self):
        n = int(self.optim_trace.num_valid) - 1
        i = self.fit_iteration - 1
        elbo_s = (
            f"{float(self.elbo_values[i]):.2f} ± {float(self.elbo_se[i]):.2f}"
            if 0 <= i < self.elbo_values.shape[-1] else "n/a"
        )
        return (
            "Single-path Pathfinder result\n"
            f"  tries: {self.num_tries}\n"
            f"  draws: {self.draws.shape[1]}\n"
            f"  fit iteration: {self.fit_iteration} (total: {n})\n"
            f"  fit ELBO: {elbo_s}"
        )


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
    grad: Optional[Callable] = None,
    hess: Optional[Callable] = None,
    transform=None,
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
    core: Optional[Callable] = None,
    progress: bool = False,
    **config_overrides,
) -> PathfinderResult:
    """The ELBO-best normal approximation along one L-BFGS trajectory, with
    the host retry loop: try ``t`` (1-based) draws its initial point and all
    its noise from round ``t − 1`` of path 0's streams.

    ``device`` defaults to ``"cuda"`` and raises when CUDA is not available;
    ``device="cpu"`` runs on the CPU. ``grad`` is the user's own gradient,
    ``x (K, d) -> (K, d)``; ``hess`` the target's Hessian,
    ``x (K, d) -> (K, d, d)``, for what consumes the order-2 capability.

    ``fn`` may be a model with a ``.transformed`` (a ``BayesModel``) or a
    ``TransformedLogDensity``; or pass ``transform=`` a bijector, with ``fn``
    (and ``grad``) then in the constrained space. ``init`` is always in the
    unconstrained space; ``draws_transformed`` and
    ``fit_distribution_transformed`` hold the constrained-space views.
    ``progress=True`` prints ``Optimizing (try N)`` to standard error before
    each try.

    ``core`` replaces :func:`pathfinder_core` for every try, with the port's
    batched contract ``core(target, x0s, config, seed, path_ids, round_idx)
    -> SinglePathState``, here on one lane: ``x0s (1, d)``, ``path_ids``
    ``[0]`` and ``round_idx = t − 1`` for try ``t``. It is the counterpart
    of the JAX package's single-path ``core(key, x0, target, config)``:
    ``x0`` is ``x0s[0]``, and the key ``fold_in(key, t − 1)`` of try ``t``
    is the streams ``(seed, path 0, round t − 1)``. The retry loop reads
    ``state.success[0]`` after each try."""
    dev = resolve_device(device)
    if init is not None:
        init = torch.as_tensor(init, device=dev)
        if dim is None and init.ndim == 1:
            dim = int(init.shape[0])  # "init or dim" holds for transform=<bijector> too
    target_input, tld = resolve_transform(fn, transform, dim=dim, grad=grad)
    if tld is not None and hess is not None:
        raise ValueError(
            "hess= cannot be combined with a transform: the unconstrained "
            "Hessian needs the bijector chain rule; omit hess= (it is then "
            "derived with torch.func from the linked density)."
        )
    # with a transform, grad was consumed (bijector path) or rejected
    target = as_log_density(
        target_input, dim=dim, grad=None if tld is not None else grad, hess=hess
    )
    if ndraws is None:
        ndraws = ndraws_elbo
    if init is not None:
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
    core = core or pathfinder_core

    def attempt(itry):
        if progress:
            print(f"Optimizing (try {itry})", file=sys.stderr)
        rnd = itry - 1
        if init is not None and itry == 1:
            x0 = init[None]
        else:
            x0 = sampler(rng.Stream(seed, path0, rnd, rng.INIT), d, dtype, dev)
        return core(target, x0, config, seed, path0, rnd)

    def succeeded(state) -> bool:
        with tracing.sync("singlepath.py"):
            return bool(state.success[0])

    itry = 1
    state = attempt(itry)
    while not succeeded(state) and itry < ntries:
        itry += 1
        state = attempt(itry)

    success = succeeded(state)
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
    draws_t, fit_t = transformed_outputs(tld, fn, one.draws, one.fit_distribution)
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
        target=target,
        fit_distribution_transformed=fit_t,
        draws_transformed=draws_t,
        transform=tld,
    )

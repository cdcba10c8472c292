"""Multi-path Pathfinder: batched paths → mixture → PSIS → resampling, and
the remedies for a bad Pareto k̂: other optimizers and ``optimizer="auto"``,
the mixture denominator, and the Laplace covariance correction (counterpart
of ``pathfinder_tpu/multipath.py``).

The K paths run as one batch on one device, or split over the ``paths`` axis
of a device mesh (``mesh=``, ``parallel/sharding.py``), and, at serving
scale, as launches of ``max_paths_per_launch`` lanes each, whose outputs may
stream into host memory as each launch completes (``offload_launches``) and
may drop their trajectory arrays (``keep_traces=False``); the defaults come
from the card's total memory. Failed paths are retried in bounded rounds
that re-run only the failed lanes, compacted, padded to a power of two and
then to a multiple of the mesh's width. Path ``i`` in round ``r`` draws
everything from the streams ``(seed, i, r, ...)``, so batch layout, mesh
shape, launch cap and offload change no random number. Offload changes no
bit, and neither does the mesh at a fixed per-device launch width: a mesh of
``n`` blocks with ``max_paths_per_launch=n·c`` gives the bits of no mesh
with ``max_paths_per_launch=c``. The per-device launch width can change the
last bits (on a CUDA device a kernel's launch plan and a library's algorithm
follow the batch), and through them, rarely, a decision that sits on a tie,
such as the step at which a path's ``ftol`` test stops it.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from pathfinder_tpu_torch.integrations.transforms import (
    resolve_transform,
    transformed_outputs,
)
from pathfinder_tpu_torch.models.protocol import (
    LogDensity,
    as_log_density,
    batched_hessian,
)
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu_torch.ops.optimizers import NEWTON_DENSE_DIM_WARN, OPTIMIZERS
from pathfinder_tpu_torch.ops.psis import PSISResult, psis
from pathfinder_tpu_torch.ops.resample import resample_draws
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.parallel.sharding import (
    Mesh,
    check_mesh,
    chunk_launches,
    device_memory_bytes,
    dim_width,
    lane_bytes,
    laplace_block,
    make_path_executor,
    mesh_device_bytes,
    pad_paths,
    paths_devices,
    paths_width,
    plan_launches,
    state_bytes,
)
from pathfinder_tpu_torch.singlepath import (
    PathfinderConfig,
    PathfinderResult,
    SinglePathState,
    uniform_init_sampler,
    validate_dtype,
)
from pathfinder_tpu_torch.utils import rng, tracing
from pathfinder_tpu_torch.utils.misc import indexed_device, resolve_device, tree_map
from pathfinder_tpu_torch.utils.progress import ThrottledProgress

__all__ = ["multipathfinder", "MultiPathfinderResult", "resample", "laplace_resample"]

def _khat_remedy_hint(tried_auto: bool = False, tried_laplace: bool = False) -> str:
    """One line of remedies for a bad or very bad Pareto-k̂ verdict: the
    optimizer competition, the Laplace covariance correction, and, for
    funnel-like geometry where importance sampling is hopeless, sampling."""
    remedies = []
    if not tried_auto:
        remedies.append("optimizer='auto' (k-hat-arbitrated optimizer competition)")
    if not tried_laplace:
        remedies.append(
            "laplace_resample(result, ndraws)"
            + ("" if tried_auto else " or auto_laplace=True")
            + " (curvature-corrected covariances)"
        )
    remedies.append(
        "for funnel-like geometry use warm_start_chains + NUTS instead of "
        "importance sampling"
    )
    return (
        "measured remedies: " + "; ".join(remedies)
        + " — see docs/examples/resampling.md"
    )


def _maybe_warn_bad_khat(
    psis_result: Optional[PSISResult],
    *,
    tried_auto: bool = False,
    tried_laplace: bool = False,
) -> None:
    """Warn with the remedies when the PSIS verdict is bad or very bad
    (k̂ > 0.7)."""
    if psis_result is None:
        return
    with tracing.sync("multipath.py"):
        verdict = psis_result.diagnosis
    if verdict not in ("bad", "very bad"):
        return
    with tracing.sync("multipath.py"):
        k = float(psis_result.pareto_shape)
    warnings.warn(
        f"Pareto k-hat = {k:.2f} ({verdict}): importance weights are "
        "unreliable and resampled draws may misrepresent the target; "
        + _khat_remedy_hint(tried_auto=tried_auto, tried_laplace=tried_laplace)
    )


def _log_importance_ratios_fit(components: MvNormal, draws_knd: torch.Tensor):
    """logq of each draw under its own component: ``(K, N)`` (kernel B2)."""
    return components.logpdf(draws_knd.mT)


def _log_importance_ratios_mixture(components: MvNormal, draws_knd: torch.Tensor):
    """logq of each draw under the full uniform mixture,
    ``logsumexp_k' logq_k'(x) − log K``: ``(K, N)``. The pooled draws are
    distributed as the mixture, so these weights have no more variance than
    the own-component ones (the balance heuristic). It needs every
    component at every pooled draw, K²·N densities: kernel B2 in one launch
    over (component, draw tile), reading the pooled draws where they lie.
    ``draws_knd`` may be a block ``(k, N, d)`` of the pool: each draw's
    logsumexp runs over all K components whatever the block, along the last
    axis of a ``(k·N, K)`` copy, a reduction that runs in the same order for
    every row whatever the number of rows, so blocks give the unblocked
    values."""
    k, N, d = draws_knd.shape
    flat = draws_knd.reshape(k * N, d)
    logq_all = components.logpdf(flat.mT)  # (K components, k·N draws)
    K = components.mean.shape[0]
    return (torch.logsumexp(logq_all.mT.contiguous(), dim=-1) - math.log(K)).reshape(k, N)


def _slim_traces(states: SinglePathState) -> SinglePathState:
    """The states without their trajectory arrays (``keep_traces=False``),
    with the trace's counts kept. The trace is most of a lane's state (xs
    and gradients are 2·(maxiters+1)·d floats, 520 KB at d=1000 and
    maxiters=64, against 130 KB for the rest) and nothing pooled reads it.
    The empty arrays are new tensors, not views, so that the trace's memory
    is freed before the next launch."""
    tr = states.trace
    K, d = tr.xs.shape[0], tr.xs.shape[-1]
    slim = dataclasses.replace(
        tr,
        xs=tr.xs.new_empty((K, 0, d)),
        log_densities=tr.log_densities.new_empty((K, 0)),
        gradients=tr.gradients.new_empty((K, 0, d)),
    )
    return dataclasses.replace(states, trace=slim)


def _blocks(K: int, chunk: Optional[int]):
    """``[lo, hi)`` path blocks of at most ``chunk`` paths (one without)."""
    step = K if chunk is None or chunk >= K else chunk
    return [(lo, min(lo + step, K)) for lo in range(0, K, step)]


def _rows(tree, lo: int, hi: int, device):
    """Rows ``lo:hi`` of every leaf, on ``device``."""
    return tree_map(lambda t: t[lo:hi].to(device), tree)


@tracing.spanned("psis")
def _compute_psis_result(
    logp: Callable, components: MvNormal, draws_knd: torch.Tensor,
    denominator: str = "component", chunk: Optional[int] = None, device=None,
) -> PSISResult:
    """PSIS over the pooled log ratios, component-major. ``denominator``:
    ``"component"``, each draw under its own component (kernel B2), or
    ``"mixture"``, under the full mixture
    (:func:`_log_importance_ratios_mixture`).

    The components and draws may lie in host memory (an offloaded run);
    they are computed on ``device`` (default: where they lie). With
    ``chunk``, the ratios are computed for one block of ``chunk`` paths'
    draws at a time, reading the blocks from where they lie: under their
    own components, or under every component (moved to ``device`` once) for
    the mixture, whose ``(K, chunk·N)`` densities are what the block bounds.
    A ratio depends on its draw alone, so the result is the unchunked one
    (bitwise on the CPU; on a CUDA device the mixture denominator's kernel
    gives the same bits whatever the block, the component one's launch plan
    follows the block's width and can move the last bits, and so can the
    target's log density at another batch size)."""
    K, N, d = draws_knd.shape
    dev = draws_knd.device if device is None else device
    if denominator not in ("component", "mixture"):
        raise ValueError(f"unknown importance_denominator {denominator!r}")
    every = _rows(components, 0, K, dev) if denominator == "mixture" else None
    ratios = []
    for lo, hi in _blocks(K, chunk):
        dk = draws_knd[lo:hi].to(dev)
        if denominator == "component":
            log_q = _log_importance_ratios_fit(_rows(components, lo, hi, dev), dk)
        else:
            log_q = _log_importance_ratios_mixture(every, dk)
        log_p = logp(dk.reshape(-1, d)).to(log_q.dtype).reshape(hi - lo, N)
        ratios.append((log_p - log_q).reshape(-1))
    return psis(torch.cat(ratios))


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
    # resample() and laplace_resample() calls that led to this result: the
    # round of their random streams, so that chained calls differ
    resample_count: int = 0
    # the log-ratio denominator that produced psis_result ("component" or
    # "mixture"), so that resample() reuses or recomputes it correctly
    importance_denominator: str = "component"
    # constrained-space views of a transform-aware run (a model with a
    # ``.transformed``, a TransformedLogDensity, or ``transform=``): the
    # pushforward of the fit, the draws mapped forward (a named chain dict
    # for a BayesModel), and the link itself; plain runs repeat
    # ``fit_distribution`` and ``draws`` and leave ``transform`` None
    fit_distribution_transformed: Any = None
    draws_transformed: Any = None
    transform: Any = None
    # the lanes of the run's launches on one device (the cap over a mesh
    # divided by its width; None: one launch); resample() and
    # laplace_resample() work through the paths in blocks of it
    max_paths_per_launch: Optional[int] = None

    @property
    def nruns(self) -> int:
        return self.states.draws.shape[0]

    def path_result(self, k: int) -> PathfinderResult:
        """Path ``k``'s own :class:`PathfinderResult` on the run's device,
        with its constrained-space views where the run had a transform."""
        st = tree_map(lambda t: t[k].to(self.draws.device), self.states)
        draws_t, fit_t = transformed_outputs(
            self.transform, self.input, st.draws, st.fit_distribution
        )
        return PathfinderResult(
            input=self.input,
            config=self.config,
            seed=self.seed,
            logp=self.logp,
            fit_distribution=st.fit_distribution,
            draws=st.draws,
            fit_iteration=int(st.fit_iteration),
            num_tries=int(self.num_tries[k]),
            optim_trace=st.trace,
            elbo_values=st.elbo_values,
            elbo_se=st.elbo_se,
            num_bfgs_updates_rejected=int(st.num_bfgs_updates_rejected),
            success=bool(st.success),
            num_fn_evals=int(st.num_fn_evals),
            state=st,
            target=self.target,
            fit_distribution_transformed=fit_t,
            draws_transformed=draws_t,
            transform=self.transform,
        )

    @property
    def pathfinder_results(self):
        return [self.path_result(k) for k in range(self.nruns)]

    def __repr__(self):
        out = (
            "Multi-path Pathfinder result\n"
            f"  runs: {self.nruns}\n"
            f"  draws: {self.draws.shape[1]}"
        )
        if self.psis_result is not None:
            k = float(self.psis_result.pareto_shape)
            verdict = self.psis_result.diagnosis
            out += f"\n  Pareto shape diagnostic: {k:.2f} ({verdict})"
            if verdict in ("bad", "very bad"):
                out += (
                    "\n  hint: k-hat > 0.7 — try optimizer='auto', "
                    "laplace_resample, or warm_start_chains "
                    "(docs/examples/resampling.md)"
                )
        return out


@tracing.spanned("call")
def multipathfinder(
    fn,
    ndraws: int,
    *,
    seed: int = 0,
    nruns: Optional[int] = None,
    init=None,
    dim: Optional[int] = None,
    grad: Optional[Callable] = None,
    hess: Optional[Callable] = None,
    transform=None,
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
    mesh: Optional[Mesh] = None,
    max_paths_per_launch: Optional[int] = None,
    keep_traces: bool = True,
    offload_launches: Optional[bool] = None,
    progress: bool = False,
    **config_overrides,
) -> MultiPathfinderResult:
    """Run Pathfinder from ``nruns`` starting points, mix, and importance-
    resample with PSIS.

    Serving scale: ``max_paths_per_launch`` runs the paths as launches of at
    most that many lanes; ``keep_traces=False`` drops each launch's
    trajectory arrays as it completes (per-path ``fit_distributions`` and
    ``elbo_estimates`` then raise); ``offload_launches=True`` streams each
    launch's states into pinned host memory while the next launch runs, so
    that they never accumulate on the card (``result.states`` then holds
    host tensors, read back one block at a time by the PSIS tail,
    ``resample`` and ``laplace_resample``). None of them changes a random
    number; offload changes no bit, the cap may change the last bits
    (see the module docstring). On a CUDA device the defaults follow the
    card's total memory (``parallel.sharding.plan_launches``), so a card
    and a set of options always give the same cap: one launch while its
    estimated peak fits in half of it, else the fewest even launches that
    fit; offload when a chunked run's states would pass a quarter of it.
    Where other work holds memory on the card, pass the cap. On the CPU the
    defaults are one launch and no offload.
    ``progress=True`` prints a throttled line of succeeded paths after each
    round of launches.

    ``device`` chooses where every tensor lives. The default, ``"cuda"``,
    runs the two Woodbury kernels on the card and raises when CUDA is not
    available; ``device="cpu"`` runs their plain torch versions.

    ``mesh`` (``parallel.sharding.paths_mesh``) splits every launch's lanes
    over the mesh's ``paths`` axis, one block a device, each run from a host
    thread of its own, and gathers the states on the mesh's first device,
    where the PSIS tail, ``resample`` and ``laplace_resample`` then run:
    ``device`` must be that device. The paths are padded to a multiple of
    the mesh's width, and ``max_paths_per_launch`` counts lanes over the
    whole mesh (rounded down to a multiple of its width); on a CUDA device
    its default comes from each block's share of its device's memory. A
    mesh with a ``dim`` axis as well (``parallel.sharding.paths_dim_mesh``)
    splits each block's parameter rows over that axis, one host thread a
    row block, summing every reduction over ``d`` in rank order and
    evaluating the target on the block's gathered rows on its first device
    (``parallel/sharding.py``); ``d`` must divide by its width. Every
    optimizer runs there, ``"auto"`` too (each candidate on the same mesh);
    Newton's Hessian and ``eigh`` and a user callable run whole on the
    block's first device. ``laplace_resample`` of such a result runs on its
    gathered states, on the mesh's first device.
    ``ndraws_per_run`` defaults to ``max(ndraws_elbo, ceil(ndraws / nruns))``.
    ``importance_denominator``: ``"component"`` weighs each pooled draw
    against its own component, ``"mixture"`` against the whole mixture.
    ``grad`` is the user's own gradient, ``x (K, d) -> (K, d)``, in place of
    autograd. ``hess`` is the target's Hessian, ``x (K, d) -> (K, d, d)``,
    for the Laplace correction; absent, it is derived with ``torch.func``.

    ``fn`` may be a model with a ``.transformed`` (a ``BayesModel``) or a
    ``TransformedLogDensity``; or pass ``transform=`` a bijector, with ``fn``
    (and ``grad``) then in the constrained space. The run happens in the
    unconstrained space, and ``draws_transformed`` and
    ``fit_distribution_transformed`` hold the constrained-space views.

    ``optimizer="auto"`` runs the full pipeline under each optimizer in
    ``auto_optimizers`` (default ``("lbfgs", "cg")``; names of
    ``ops.optimizers.OPTIMIZERS`` and callables with the trace contract)
    and returns the result with the lower Pareto k̂: which optimizer gives
    better-located components depends on the target, and the ELBO cannot
    tell. A NaN k̂ with near-uniform weights (ESS ≈ N, a perfect fit's
    zero-variance tail) ranks best, any other NaN last. Candidates run in
    order and stop as soon as one reaches k̂ < ``auto_khat_early_exit``
    (default 0.7, the "ok" verdict; ``None`` runs every candidate).
    Requires ``importance=True``. ``auto_laplace=True`` (or ``"diag"`` /
    ``"full"``) also applies :func:`laplace_resample` to the winner when no
    candidate reached the threshold, and keeps the correction only if k̂
    improves.
    """
    check_mesh(mesh)
    # auto-mode candidate runs suppress the bad-k̂ hint: only the winner warns
    suppress_khat_hint = config_overrides.pop("_suppress_khat_hint", False)
    auto = _pop_auto_options(config_overrides, importance)
    if auto is not None:
        shared = dict(
            seed=seed, nruns=nruns, init=init, dim=dim, grad=grad, hess=hess,
            transform=transform, ndraws_elbo=ndraws_elbo, ndraws_per_run=ndraws_per_run,
            importance=importance, importance_denominator=importance_denominator,
            history_length=history_length, maxiters=maxiters, ntries=ntries,
            init_scale=init_scale, init_sampler=init_sampler, gtol=gtol,
            dtype=dtype, device=device, mesh=mesh, max_paths_per_launch=max_paths_per_launch,
            keep_traces=keep_traces, offload_launches=offload_launches, progress=progress,
        )
        winner = _run_auto(fn, ndraws, auto, shared, config_overrides)
        if not suppress_khat_hint:
            _maybe_warn_bad_khat(
                winner.psis_result, tried_auto=True, tried_laplace=bool(auto.laplace)
            )
        return winner
    if importance_denominator not in ("component", "mixture"):
        raise ValueError(f"unknown importance_denominator {importance_denominator!r}")
    dev = resolve_device(device)
    if mesh is not None:
        first = paths_devices(mesh)[0]
        if indexed_device(dev) != first:
            raise ValueError(
                f"device={str(device)!r} is not the mesh's first device, {first}, where the "
                "states are gathered and the PSIS tail runs; pass device="
                f"{str(first)!r}"
            )
        dev = first
    if init is not None:
        init = torch.as_tensor(init, device=dev)
        if dim is None and init.ndim == 2:
            dim = int(init.shape[1])  # "init or dim" holds for transform=<bijector> too
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

    if init is not None:
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

    cap, offload = max_paths_per_launch, offload_launches
    if dev.type == "cuda" and (cap is None or offload is None):
        cap, offload = plan_launches(
            pad_paths(nruns, mesh),
            lane_bytes(d, maxiters, history_length, ndraws_elbo, config.elbo_chunk,
                       ndraws_per_run, dtype, config.optimizer, importance_denominator, nruns,
                       dim_width(mesh)),
            state_bytes(d, maxiters, history_length, ndraws_per_run, dtype, keep_traces),
            device_memory_bytes(dev) if mesh is None else mesh_device_bytes(mesh),
            cap=cap, offload=offload, width=paths_width(mesh),
        )
    # the PSIS tail's blocks: a launch's lanes on one device, the share its
    # memory was planned for (and the blocks of the run without a mesh)
    device_cap = None if cap is None else max(cap // paths_width(mesh), 1)
    # slimmed per launch (and per block, on its device), so that a launch's
    # trace is freed before the next
    executor = make_path_executor(mesh, finish=None if keep_traces else _slim_traces)

    def run_round(path_ids: torch.Tensor, round_idx: int) -> SinglePathState:
        n = path_ids.shape[0]
        if init is not None and round_idx == 0:
            x0s = init.to(dtype)
        else:
            stream = rng.Stream(seed, path_ids, round_idx, rng.INIT)
            x0s = sampler(stream, d, dtype, dev)
        pad = pad_paths(n, mesh) - n
        if pad:  # lanes for the whole mesh, repeating the leading paths
            rep = torch.arange(pad, device=dev) % n
            path_ids, x0s = torch.cat([path_ids, path_ids[rep]]), torch.cat([x0s, x0s[rep]])

        def launch(ids, x):
            return executor(ids, x, target, config, seed, round_idx)

        states = chunk_launches(launch, cap, mesh, bool(offload))(path_ids, x0s)
        return tree_map(lambda t: t[:n], states) if pad else states

    reporter = ThrottledProgress(nruns, name="Multi-path Pathfinder") if progress else None
    states = run_round(torch.arange(nruns, device=dev), 0)
    num_tries = np.ones(nruns, dtype=np.int64)
    rounds = 1
    while rounds < ntries:
        with tracing.sync("multipath.py"):
            failed = ~states.success.cpu().numpy()
        if reporter is not None:
            reporter.update(nruns - int(failed.sum()), extra=f"(round {rounds})")
        if not failed.any():
            break
        fidx = np.nonzero(failed)[0]
        B = 1 << max(0, int(np.ceil(np.log2(len(fidx)))))
        sel = np.concatenate([fidx, np.full(B - len(fidx), fidx[0])])
        retry = run_round(torch.as_tensor(sel, device=dev), rounds)

        def merge(old, new):
            # in place, where the states lie (host memory when offloaded):
            # this run made them and nothing else holds them
            old[torch.as_tensor(fidx, device=old.device)] = new[: len(fidx)].to(old.device)
            return old

        states = tree_map(merge, states, retry)
        num_tries[failed] += 1
        rounds += 1
    n_failed = (~states.success).sum()
    with tracing.sync("multipath.py"):
        n_failed = int(n_failed)
    if reporter is not None:
        reporter.update(nruns - n_failed)
        reporter.close()

    if n_failed:
        warnings.warn(
            f"{n_failed} of {nruns} Pathfinder runs failed after {ntries} "
            "tries; their fits may contaminate the mixture."
        )

    components = states.fit_distribution
    draws_knd = states.draws.mT  # (K, N, d), in host memory when offloaded
    psis_result = (
        _compute_psis_result(
            tracing.spanned("target")(target.logp), components, draws_knd,
            denominator=importance_denominator, chunk=device_cap, device=dev,
        )
        if importance
        else None
    )
    draws, component_ids = resample_draws(
        rng.Stream(seed, 0, 0, rng.RESAMPLE), draws_knd, psis_result, ndraws, device=dev
    )
    if not suppress_khat_hint:
        _maybe_warn_bad_khat(psis_result)
    mixture = UniformMixture(components)
    draws_t, fit_t = transformed_outputs(tld, fn, draws, mixture)
    return MultiPathfinderResult(
        input=fn,
        config=config,
        seed=seed,
        logp=target.logp,
        fit_distribution=mixture,
        draws=draws,
        draw_component_ids=component_ids,
        states=states,
        psis_result=psis_result,
        num_tries=torch.as_tensor(num_tries),
        draws_per_component=draws_knd,
        target=target,
        importance_denominator=importance_denominator,
        fit_distribution_transformed=fit_t,
        draws_transformed=draws_t,
        transform=tld,
        max_paths_per_launch=device_cap,
    )


@dataclasses.dataclass(frozen=True)
class _AutoOptions:
    optimizers: tuple  # candidates, in the order they run
    khat_early_exit: Optional[float]  # None: run every candidate
    laplace: Union[bool, str]  # False, "diag" or "full"


_UNSET = object()


def _pop_auto_options(config_overrides: dict, importance: bool) -> Optional[_AutoOptions]:
    """Take the auto mode's options out of ``config_overrides`` and validate
    them before any run: ``None`` unless ``optimizer="auto"``."""
    auto_set = config_overrides.pop("auto_optimizers", None)
    early_exit = config_overrides.pop("auto_khat_early_exit", _UNSET)
    auto_laplace = config_overrides.pop("auto_laplace", False)
    is_auto = config_overrides.get("optimizer") == "auto"
    if auto_set is not None and not is_auto:
        raise ValueError(
            "auto_optimizers requires optimizer='auto' (it names the "
            "candidates the auto mode runs)"
        )
    if auto_laplace and not is_auto:
        raise ValueError(
            "auto_laplace requires optimizer='auto' (it extends the auto "
            "mode's k̂ arbitration; call laplace_resample directly on a "
            "finished result otherwise)"
        )
    if auto_laplace is True:
        auto_laplace = "diag"
    if auto_laplace not in (False, "diag", "full"):
        raise ValueError(
            f"auto_laplace must be False, True, 'diag', or 'full'; got "
            f"{auto_laplace!r}"
        )
    if early_exit is not _UNSET and not is_auto:
        raise ValueError(
            "auto_khat_early_exit requires optimizer='auto' (it bounds "
            "the auto mode's candidate competition)"
        )
    if early_exit is _UNSET:
        early_exit = 0.7  # the "ok" verdict boundary
    elif early_exit is not None:
        # fail fast: a bad threshold found after the first full candidate
        # run would waste the whole pipeline
        early_exit = float(early_exit)
    if not is_auto:
        return None
    del config_overrides["optimizer"]
    if auto_set is None:
        auto_set = ("lbfgs", "cg")
    elif isinstance(auto_set, str) or callable(auto_set):
        auto_set = (auto_set,)  # a bare string would iterate per character
    else:
        auto_set = tuple(auto_set)
    if not auto_set:
        raise ValueError("auto_optimizers must name at least one optimizer")
    bad = [
        o for o in auto_set
        if not ((isinstance(o, str) and o in OPTIMIZERS) or (callable(o) and not isinstance(o, str)))
    ]
    if bad:
        # a typo found inside the Nth run would waste every earlier one
        raise ValueError(
            f"unknown auto_optimizers entries {bad}; choose from "
            f"{tuple(OPTIMIZERS)} or pass callables with the "
            "minimize_*_trace contract"
        )
    if not importance:
        raise ValueError(
            "optimizer='auto' selects by Pareto-k̂ and therefore "
            "requires importance=True"
        )
    return _AutoOptions(auto_set, early_exit, auto_laplace)


def _khat(r: MultiPathfinderResult) -> float:
    """The k̂ the auto mode ranks by. A NaN k̂ ("not computed") is
    ambiguous: a zero-variance weight tail from a perfect fit (every weight
    ≈ 1/N, ESS ≈ N) is the best outcome and ranks first (−inf; ties break by
    candidate order). But ``psis`` also returns uniform weights when every
    log ratio was non-finite, a broken candidate. So the perfect-fit rank
    needs healthy evidence (all paths succeeded, finite draws); any other
    NaN ranks last."""
    k = float(r.psis_result.pareto_shape)
    if k == k:
        return k
    ess_frac = float(r.psis_result.ess) / r.psis_result.weights.shape[0]
    healthy = bool(r.states.success.all()) and bool(torch.isfinite(r.draws).all())
    return float("-inf") if (ess_frac >= 0.99 and healthy) else float("inf")


def _run_auto(fn, ndraws, auto: _AutoOptions, shared: dict, config_overrides: dict):
    """Run the candidates and let the Pareto k̂ arbitrate (k̂ as a fit-
    quality diagnostic, Yao et al. 2018); then, if asked and no candidate
    is acceptable, try the Laplace correction on the winner."""
    candidates = []
    for opt in auto.optimizers:
        r = multipathfinder(
            fn, ndraws, **shared,
            **{**config_overrides, "optimizer": opt, "_suppress_khat_hint": True},
        )
        candidates.append(r)
        # a candidate at "ok" or better ends the competition: later ones
        # cost a full run each and could at best improve an acceptable fit
        if auto.khat_early_exit is not None and _khat(r) < auto.khat_early_exit:
            break
    winner = min(candidates, key=_khat)  # the first of equals, as they ran
    if auto.laplace:
        # the correction at the winner's own means costs one batch of
        # Hessians, far less than another candidate run; it is kept only if
        # the diagnostic improves, since it can be a slight negative where
        # the fits already match the local curvature
        trigger = auto.khat_early_exit if auto.khat_early_exit is not None else 0.7
        if _khat(winner) >= trigger:
            corrected = laplace_resample(winner, ndraws, method=auto.laplace)
            if _khat(corrected) < _khat(winner):
                winner = corrected
    return winner


def resample(
    result: MultiPathfinderResult,
    ndraws: int,
    *,
    replace: bool = True,
    importance: bool = True,
    importance_denominator: Optional[str] = None,
    ndraws_per_run: Optional[int] = None,
) -> MultiPathfinderResult:
    """Re-resample a finished result without re-optimizing. Reuses the stored
    per-path draws and PSIS result unless ``ndraws_per_run`` asks for fresh
    draws from each component. The stored PSIS result is tagged with the
    denominator that produced it: ``importance_denominator=None`` reuses it
    as it is, and an explicit value recomputes only when it differs from
    the tag. Each call on a result draws from the next round of the
    resampling stream, so chained calls differ. A serving-scale result is
    worked through in blocks of its launch cap, its pool left where it lies
    (in host memory when offloaded)."""
    count = result.resample_count + 1
    components = result.fit_distribution.components
    stored_denom = result.importance_denominator or "component"
    effective_denom = importance_denominator or stored_denom
    dev, cap = result.draws.device, result.max_paths_per_launch
    if ndraws_per_run is None:
        draws_knd = result.draws_per_component
        psis_stored = result.psis_result
        if effective_denom != stored_denom:
            psis_stored = None  # recompute with the requested ratios
    else:
        pool = components.mean.device
        draws_knd = torch.cat([
            _rows(components, lo, hi, dev).sample(
                rng.Stream(result.seed, torch.arange(lo, hi, device=dev), count,
                           rng.RESAMPLE_FRESH),
                ndraws_per_run,
            ).mT.to(pool)
            for lo, hi in _blocks(components.mean.shape[0], cap)
        ])
        psis_stored = None
    if importance:
        psis_used = psis_stored
        if psis_used is None:
            psis_used = _compute_psis_result(
                result.logp, components, draws_knd, denominator=effective_denom,
                chunk=cap, device=dev,
            )
    else:
        psis_used = None
    draws, component_ids = resample_draws(
        rng.Stream(result.seed, 0, count, rng.RESAMPLE), draws_knd, psis_used,
        ndraws, replace=replace, device=dev,
    )
    # a transform-aware result gets its constrained-space draws rebuilt
    draws_t, _ = transformed_outputs(
        result.transform, result.input, draws, result.fit_distribution
    )
    return dataclasses.replace(
        result,
        draws=draws,
        draw_component_ids=component_ids,
        psis_result=psis_used,
        draws_per_component=draws_knd,
        resample_count=count,
        importance_denominator=effective_denom,
        draws_transformed=draws_t,
    )


def _laplace_covariances(negH: torch.Tensor, fit_diag: torch.Tensor, method: str):
    """Corrected covariances from the negative Hessians ``negH (K, d, d)`` at
    the component means: a :class:`WoodburyPDMat` batched over K with an
    empty low-rank part (m = 0). ``fit_diag (K, d)`` is the fitted
    covariances' diagonal, the fallback."""
    K, d, _ = negH.shape
    dtype, dev = negH.dtype, negH.device
    B0 = torch.zeros((K, d, 0), dtype=dtype, device=dev)
    D0 = torch.zeros((K, 0, 0), dtype=dtype, device=dev)
    if method == "diag":
        # Σ = diag(1 / diag(−H)); μ is generally not a stationary point, so
        # diag(−H) can have non-positive (or, for the garbage mean of a
        # failed path, non-finite) coordinates: those fall back, each on its
        # own, to the fitted covariance's diagonal
        hd = torch.diagonal(negH, dim1=-2, dim2=-1)
        usable = (hd > 0) & torch.isfinite(hd)
        var = torch.where(usable, 1.0 / torch.clamp(hd, min=1e-30), fit_diag)
        return WoodburyPDMat.from_parts(var, B0, D0)
    if method == "full":
        # Σ = (−H)⁻¹ with the saddle-free |λ| spectrum: a direction of
        # negative curvature keeps its scale (variance 1/|λ|), where a small
        # positive floor would blow its variance up to 1/floor. A Hessian
        # with non-finite entries has no spectrum: it is taken as zero, and
        # then, like a (near-)zero one, the component falls back whole to
        # the fitted diagonal.
        finite = torch.isfinite(negH).all(dim=(-2, -1), keepdim=True)
        w, V = torch.linalg.eigh(torch.where(finite, negH, torch.zeros_like(negH)))
        aw = w.abs()
        maxaw = aw.amax(dim=1, keepdim=True)
        degenerate = (maxaw <= 0) | ~torch.isfinite(maxaw) | ~finite[:, 0]  # (K, 1)
        floor = 1e-8 * torch.where(degenerate, torch.ones_like(maxaw), maxaw)
        wc = torch.maximum(aw, floor)
        sigma = (V / wc[:, None, :]) @ V.mT  # V diag(1/wc) Vᵀ
        # symmetrize, so that the dense Cholesky sees an exactly symmetric matrix
        sigma = 0.5 * (sigma + sigma.mT)
        sigma = torch.where(degenerate[:, :, None], torch.diag_embed(fit_diag), sigma)
        return WoodburyPDMat.from_parts(sigma, B0, D0)
    raise ValueError(f"unknown laplace_resample method {method!r}; use 'diag' or 'full'")


def laplace_corrected_components_and_draws(
    logp: Callable,
    components: MvNormal,
    stream: rng.Stream,
    ndraws_per_run: int,
    method: str = "diag",
    hess_fn: Optional[Callable] = None,
):
    """The core of the Laplace correction: the Hessians at the component
    means in one batch, the corrected covariances, and ``ndraws_per_run``
    draws from each corrected component (``stream`` is batched over the K
    components). Returns ``(corrected MvNormal, draws_knd (K, N, d))``."""
    if hess_fn is None:
        hess_fn = batched_hessian(logp)
    negH = -hess_fn(components.mean).to(components.dtype)  # (K, d, d)
    corrected = MvNormal(
        components.mean, _laplace_covariances(negH, components.cov.diag(), method)
    )
    return corrected, corrected.sample(stream, ndraws_per_run).mT.contiguous()


def laplace_resample(
    result: MultiPathfinderResult,
    ndraws: int,
    *,
    method: str = "diag",
    ndraws_per_run: Optional[int] = None,
    replace: bool = True,
    importance: bool = True,
    importance_denominator: Optional[str] = None,
    hess: Optional[Callable] = None,
) -> MultiPathfinderResult:
    """Replace each component's covariance with a Laplace covariance at the
    same mean, redraw, re-weight and resample.

    Pathfinder's component covariances are L-BFGS inverse-Hessian estimates
    gathered along the trajectory; at the ELBO-selected means they can be
    far from the target's local curvature. This correction keeps the chosen
    means and swaps in the curvature the target has there:

    * ``method="diag"`` (default): ``Σ = diag(1 / diag(−H(μ)))``, falling
      back per coordinate to the fitted diagonal where ``diag(−H) ≤ 0``.
    * ``method="full"``: ``Σ = (−H(μ))⁻¹`` by the saddle-free ``|λ|``
      eigendecomposition: cross-correlations too, at the cost of one dense
      ``eigh`` and a ``(d, d)`` covariance per component.

    Both evaluate the target's Hessian at every component mean (``hess=`` if
    given, else the result target's own ``hess``, else ``torch.func``'s
    forward-over-reverse Hessian of the stored log density, batched over
    components). For a transform-aware run that is the Hessian of the
    *linked* (unconstrained) density, the space the components live in.

    Returns a new result whose ``fit_distribution`` and per-path
    ``states.fit_distribution`` hold the corrected components, with fresh
    draws from each, a recomputed PSIS diagnostic and ``ndraws`` resampled
    draws. ``elbo_values`` still describe the uncorrected candidate fits.
    Chain with :func:`resample` to re-resample without correcting again. On
    a CUDA device the components are corrected in blocks sized by the
    correction's own memory estimate (``parallel.sharding.laplace_block``),
    and the corrected components and draws stay where the pool lies.

    Not a universal win: where the fitted covariances already match the
    local curvature the correction can be a slight negative. Let the Pareto
    k̂ arbitrate: apply it when the fitted verdict is bad and keep whichever
    result diagnoses better.
    """
    if method not in ("diag", "full"):
        raise ValueError(
            f"unknown laplace_resample method {method!r}; use 'diag' or 'full'"
        )
    count = result.resample_count + 1
    components = result.fit_distribution.components
    K, d = components.mean.shape
    if d > NEWTON_DENSE_DIM_WARN:
        warnings.warn(
            f"laplace_resample at d={d} materializes {K} dense ({d}, {d}) Hessians"
            + (" plus one eigh each" if method == "full" else "")
            + f" — expect high memory above d~{NEWTON_DENSE_DIM_WARN}."
        )
    if hess is None:
        hess = getattr(result.target, "hess", None)
    N = ndraws_per_run if ndraws_per_run is not None else result.draws_per_component.shape[1]
    dev, cap, pool = result.draws.device, result.max_paths_per_launch, components.mean.device
    # blocks from the correction's own estimate (Hessians, factors, draws),
    # not the run's cap, which was sized for the optimizer's lanes
    block = laplace_block(K, d, N, components.dtype, method, dev)
    parts, pool_draws = [], []
    for lo, hi in _blocks(K, block):
        stream = rng.Stream(result.seed, torch.arange(lo, hi, device=dev), count, rng.LAPLACE_DRAWS)
        part, dk = laplace_corrected_components_and_draws(
            result.logp, _rows(components, lo, hi, dev), stream, N, method, hess_fn=hess
        )
        parts.append(tree_map(lambda t: t.to(pool), part))
        pool_draws.append(dk.to(pool))
    corrected = parts[0] if len(parts) == 1 else tree_map(lambda *ts: torch.cat(ts), *parts)
    draws_knd = torch.cat(pool_draws)
    effective_denom = importance_denominator or result.importance_denominator or "component"
    psis_used = (
        _compute_psis_result(result.logp, corrected, draws_knd, denominator=effective_denom,
                             chunk=cap, device=dev)
        if importance
        else None
    )
    draws, component_ids = resample_draws(
        rng.Stream(result.seed, 0, count, rng.LAPLACE_RESAMPLE), draws_knd, psis_used,
        ndraws, replace=replace, device=dev,
    )
    mixture = UniformMixture(corrected)
    draws_t, fit_t = transformed_outputs(result.transform, result.input, draws, mixture)
    return dataclasses.replace(
        result,
        fit_distribution=mixture,
        fit_distribution_transformed=fit_t,
        draws_transformed=draws_t,
        # the per-path views stay consistent: both the corrected components
        # and the draws they produced go in
        states=dataclasses.replace(
            result.states, fit_distribution=corrected, draws=draws_knd.mT
        ),
        draws=draws,
        draw_component_ids=component_ids,
        psis_result=psis_used,
        draws_per_component=draws_knd,
        resample_count=count,
        importance_denominator=effective_denom,
    )

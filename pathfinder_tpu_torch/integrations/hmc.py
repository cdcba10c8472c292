"""HMC warm start: the low-rank Euclidean metric and a sampler (counterpart of
``pathfinder_tpu/integrations/hmc.py``).

The metric's inverse mass matrix is the Pathfinder fit covariance, kept in
its Woodbury form: kinetic energy, its gradient and momentum draws cost
O(d·m) and nothing d×d is formed. The sampler is a self-contained HMC with
dual-averaging step-size adaptation that consumes the metric directly.

Chains are the batch axis: positions, momenta and gradients are ``(C, d)``,
energies and step sizes ``(C,)``. The chains advance in lockstep and every
random number of chain ``c`` at transition ``t`` comes from the stream
``(seed, c, t, purpose)``, so a chain's samples do not depend on the chains
that run beside it. A metric is shared by all chains (a fit covariance) or
carries a leading chain axis (the per-chain adapted diagonal of NUTS).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyFactor, WoodburyPDMat
from pathfinder_tpu_torch.utils import rng
from pathfinder_tpu_torch.utils.misc import resolve_device

__all__ = [
    "WoodburyMetric",
    "StreamNoise",
    "resolve_result_value_and_grad",
    "leapfrog_step",
    "leapfrog",
    "da_init",
    "da_update",
    "HMCResult",
    "hmc",
    "hmc_warm_start",
]


@dataclasses.dataclass(frozen=True)
class WoodburyMetric:
    """Euclidean metric with inverse mass matrix ``M⁻¹ = W`` (the Pathfinder
    fit covariance), every operation in low-rank form through the cached
    factorization. Momenta are rows: ``p (C, d)`` (or one vector ``(d,)``).

    * kinetic energy:  ``K(p) = pᵀ M⁻¹ p / 2 = quad(W, p)/2``
    * its gradient:    ``∇K(p) = W p``
    * momentum draws:  ``p = L⁻ᵀ z``, ``z ~ N(0, I)``, so that
      ``cov(p) = L⁻ᵀL⁻¹ = W⁻¹ = M``
    """

    minv: WoodburyPDMat

    @property
    def dim(self) -> int:
        return self.minv.dim

    @property
    def batched(self) -> bool:
        """Whether the metric has a leading chain axis of its own."""
        return self.minv.B.ndim > 2

    @property
    def device(self) -> torch.device:
        return self.minv.B.device

    def _columns(self, p):
        """``p`` as the column block the Woodbury operations take, and the
        way back for a block of the same shape."""
        if p.ndim == 1:
            return p[:, None], lambda r: r[..., 0]
        if self.batched:  # one column per chain's own matrix
            return p[..., None], lambda r: r[..., 0]
        return p.mT, lambda r: r.mT  # the chains are the columns of one matrix

    def kinetic_energy(self, p: torch.Tensor) -> torch.Tensor:
        cols, _ = self._columns(p)
        q = self.minv.quad(cols)
        return 0.5 * (q[..., 0] if p.ndim == 1 or self.batched else q)

    def grad_kinetic(self, p: torch.Tensor) -> torch.Tensor:
        cols, back = self._columns(p)
        return back(self.minv.mul(cols))

    def sample_momentum(self, z: torch.Tensor) -> torch.Tensor:
        """``L⁻ᵀ z`` for standard-normal ``z (C, d)``."""
        cols, back = self._columns(z)
        return back(self.minv.inv_unwhiten(cols))

    @staticmethod
    def from_fit(fit: MvNormal) -> "WoodburyMetric":
        return WoodburyMetric(fit.cov)

    @staticmethod
    def diag(inv_mass_diag: torch.Tensor, rank: int = 0) -> "WoodburyMetric":
        """The diagonal metric ``M⁻¹ = diag(inv_mass_diag)`` as a degenerate
        Woodbury matrix with ``rank`` zero columns; ``inv_mass_diag`` is
        ``(d,)``, or ``(C, d)`` for one diagonal per chain. The factorization
        is written in closed form (``a_half = sqrt(diag)``, zero cores):
        windowed adaptation builds one at every window end."""
        v = inv_mass_diag
        Z = v.new_zeros(v.shape + (rank,))
        Zm = v.new_zeros(v.shape[:-1] + (rank, rank))
        F = WoodburyFactor(
            a_half=torch.sqrt(v), X=Z, C=Zm, Ci=Zm, log_det=torch.sum(torch.log(v), dim=-1)
        )
        return WoodburyMetric(WoodburyPDMat(v, Z, Zm, F))

    @staticmethod
    def from_result(result, draw_index: int = 0) -> "WoodburyMetric":
        """From a ``PathfinderResult`` (single path: the fit covariance) or a
        ``MultiPathfinderResult`` (mixture fit: the covariance of the
        component that produced draw ``draw_index``, since no single
        Woodbury matrix represents a mixture)."""
        # checked here: a negative index beyond the range would wrap around
        # silently in the component lookup below
        ndraws = result.draws.shape[1]
        if not -ndraws <= draw_index < ndraws:
            raise IndexError(
                f"draw_index {draw_index} out of range for a result with "
                f"{ndraws} draws"
            )
        fd = result.fit_distribution
        if hasattr(fd, "cov"):
            return WoodburyMetric(fd.cov)
        k = int(result.draw_component_ids[draw_index])
        return WoodburyMetric(fd.component(k).cov)

    def to_inverse_mass_matrix(self) -> torch.Tensor:
        """Dense ``M⁻¹ = W`` (the fit covariance): the exchange format every
        HMC implementation accepts. O(d²) memory, for export at moderate
        ``d``; the samplers here use the factor form."""
        return self.minv.to_dense()


def resolve_result_value_and_grad(result) -> Callable:
    """``value_and_grad`` of the density a Pathfinder result's draws live
    in. A transform-aware result (a ``BayesModel`` or ``transform=`` run)
    samples in *unconstrained* space (its draws, metric and stored ``logp``
    all live there), so a warm-started sampler must target the linked
    density, never the raw model input; a plain result keeps the user's own
    gradient."""
    tld = getattr(result, "transform", None)
    if tld is not None:
        return tld.unconstrained.value_and_grad
    target = getattr(result, "target", None)
    if target is not None:  # the entry points' resolved target, user gradient included
        return target.value_and_grad
    return autograd_value_and_grad(result.logp)


def _per_chain(eps):
    """A per-chain scalar ``(C,)`` as a column beside ``(C, d)`` rows."""
    return eps[..., None] if isinstance(eps, torch.Tensor) and eps.ndim else eps


def leapfrog_step(value_and_grad: Callable, metric: WoodburyMetric, x, p, g, eps):
    """One leapfrog step; ``g = ∇logp(x)`` (= −∇U), ``eps`` a scalar or one
    step size per chain. Returns ``(x, p, g, logp)`` at the new point. The
    one integration step shared by :func:`leapfrog`, :func:`hmc` and the
    NUTS tree loop."""
    e = _per_chain(eps)
    p_half = p + 0.5 * e * g
    x_new = x + e * metric.grad_kinetic(p_half)
    logp_new, g_new = value_and_grad(x_new)
    p_new = p_half + 0.5 * e * g_new
    return x_new, p_new, g_new, logp_new


def leapfrog(value_and_grad: Callable, metric: WoodburyMetric, x, p, grad_x, eps, n_steps: int):
    """``n_steps`` leapfrog steps; returns ``(x, p, logp, grad)`` at the end.
    ``value_and_grad(x) -> (logp, ∇logp)``; the potential is U = −logp."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    g, logp = grad_x, None
    for _ in range(n_steps):
        x, p, g, logp = leapfrog_step(value_and_grad, metric, x, p, g, eps)
    return x, p, logp, g


def da_init(init_step_size, dtype, batch=(), device="cpu"):
    """Dual-averaging state ``(mu, log_eps, log_eps_bar, h_acc, t)``, each
    of shape ``batch`` (Hoffman & Gelman 2014, sec. 3.2). ``log_eps_bar``
    starts at ``init_step_size``, so a warm-up of length zero samples at the
    requested step size; the first update (weight ``w = 1^{-κ} = 1``)
    overwrites it entirely."""
    le = torch.full(batch, float(np.log(init_step_size)), dtype=dtype, device=device)
    mu = torch.full(batch, float(np.log(10.0 * init_step_size)), dtype=dtype, device=device)
    zero = torch.zeros(batch, dtype=dtype, device=device)
    return (mu, le, le.clone(), zero, zero.clone())


def da_update(da, astat, target_accept):
    """One dual-averaging step (Hoffman & Gelman 2014, eq. 6): the one copy
    shared by :func:`hmc` and ``nuts``."""
    mu, log_eps, log_eps_bar, h_acc, t_prev = da
    t = t_prev + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    h_acc = (1.0 - 1.0 / (t + t0)) * h_acc + (target_accept - astat) / (t + t0)
    log_eps = mu - torch.sqrt(t) / gamma * h_acc
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return (mu, log_eps, log_eps_bar, h_acc, t)


class StreamNoise:
    """The samplers' random decisions from the port's counter-based streams:
    chain → ``path``, transition → ``round``, tree depth or leaf →
    ``candidate``. Tests pass an object with the same methods that replays
    the JAX package's numbers instead."""

    def __init__(self, seed: int, chain_ids: torch.Tensor, dim: int, dtype, device):
        self.seed, self.chain_ids, self.dim = int(seed), chain_ids, dim
        self.dtype, self.device = dtype, device

    def _stream(self, t, purpose, candidate=0):
        paths = self.chain_ids[:, None] if isinstance(candidate, torch.Tensor) else self.chain_ids
        return rng.Stream(self.seed, paths, t, purpose, candidate)

    def momentum(self, t):
        """Standard normals ``(C, d)`` of transition ``t``."""
        return self._stream(t, rng.MOMENTUM).normal(self.dim, self.dtype, self.device)

    def _uniform(self, t, purpose, candidate=0):
        return self._stream(t, purpose, candidate).uniform(1, self.dtype, self.device)[..., 0]

    def jitter(self, t):
        """The step-size factor of an HMC transition, uniform in (0.8, 1.2)."""
        return 0.8 + 0.4 * self._uniform(t, rng.HMC_JITTER)

    def accept(self, t):
        return self._uniform(t, rng.HMC_ACCEPT)

    def tree(self, t, max_depth):
        """Every decision of the tree of transition ``t``, in one call (a
        Philox call is some hundred small kernels, whatever its size):
        ``(go_right (C, max_depth) bool, merge uniforms (C, max_depth), leaf
        uniforms (C, 2^max_depth − 1))``; the leaves of doubling ``j`` are
        the columns ``2^j − 1 .. 2^(j+1) − 2``. No number depends on
        ``max_depth``."""
        if max_depth > 64:
            raise ValueError(f"max_depth must be <= 64, got {max_depth}")
        leaves = torch.arange(64, 64 + (1 << max_depth) - 1, device=self.device)
        cand = torch.cat([torch.arange(max_depth, device=self.device), leaves])
        u = self._stream(t, rng.NUTS_TREE, cand).uniform(2, self.dtype, self.device)
        return u[:, :max_depth, 0] < 0.5, u[:, :max_depth, 1], u[:, max_depth:, 0]


def sampler_inputs(x0, metric: Optional[WoodburyMetric], device):
    """``(x0 (C, d) tensor, single)`` on the device the sampler runs on: where
    ``x0`` and the metric live when they are tensors, else ``device``
    (``"cuda"`` by default at the entry points, raising without a card).
    ``single`` marks one chain given as a vector ``(d,)``."""
    if isinstance(x0, torch.Tensor):
        dev = x0.device
    else:
        dev = resolve_device(device)
        x0 = torch.as_tensor(np.asarray(x0), device=dev)
    if not x0.is_floating_point():
        x0 = x0.to(torch.get_default_dtype())
    if metric is not None and metric.device != dev:
        raise ValueError(
            f"the metric is on {metric.device} but x0 is on {dev}: move one of them"
        )
    single = x0.ndim == 1
    if single:
        x0 = x0[None]
    if x0.ndim != 2:
        raise ValueError(f"x0 must be (C, d) or (d,); got shape {tuple(x0.shape)}")
    return x0, single


def sampler_noise(noise, seed, chain_ids, x0):
    """The noise source of a run over the chains of ``x0 (C, d)``."""
    if noise is not None:
        return noise
    C, d = x0.shape
    if chain_ids is None:
        chain_ids = torch.arange(C, device=x0.device)
    else:
        chain_ids = torch.as_tensor(chain_ids, dtype=torch.int64, device=x0.device)
        if chain_ids.shape != (C,):
            raise ValueError(f"chain_ids must have shape ({C},); got {tuple(chain_ids.shape)}")
    return StreamNoise(seed, chain_ids, d, x0.dtype, x0.device)


def check_transitions(n: int) -> None:
    if n > rng.MAX_ROUND:
        raise ValueError(
            f"{n} transitions exceed the {rng.MAX_ROUND} rounds a random stream can number"
        )


class HMCResult(NamedTuple):
    samples: torch.Tensor  # (C, num_samples, d)
    accept_prob: torch.Tensor  # (C, num_samples)
    step_size: torch.Tensor  # (C,) adapted step size
    log_densities: torch.Tensor  # (C, num_samples)


@torch.no_grad()
def hmc(
    seed: int,
    value_and_grad: Callable,
    metric: WoodburyMetric,
    x0,
    num_samples: int = 1000,
    num_warmup: int = 300,
    num_leapfrog: int = 16,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    *,
    chain_ids=None,
    noise=None,
    device="cuda",
) -> HMCResult:
    """HMC with dual-averaging warm-up and the low-rank Woodbury metric, one
    chain per row of ``x0 (C, d)`` (a vector ``(d,)`` is one chain and gives
    results without the chain axis). Runs where ``x0`` lives; a numpy ``x0``
    goes to ``device``. ``chain_ids`` (default ``0..C−1``) name the chains'
    random streams."""
    x0, single = sampler_inputs(x0, metric, device)
    check_transitions(num_warmup + num_samples)
    noise = sampler_noise(noise, seed, chain_ids, x0)
    C, d = x0.shape
    dtype = x0.dtype
    x = x0
    logp, g = value_and_grad(x)

    def mh_step(x, logp, g, eps_base, t):
        """One Metropolis-Hastings transition at base step size ``eps_base``,
        jittered ±20% to break resonances on near-Gaussian targets."""
        eps = eps_base * noise.jitter(t)
        p = metric.sample_momentum(noise.momentum(t))
        ke0 = metric.kinetic_energy(p)
        x_new, p_new, logp_new, g_new = leapfrog(
            value_and_grad, metric, x, p, g, eps, num_leapfrog
        )
        ke1 = metric.kinetic_energy(p_new)
        log_accept = (logp_new - ke1) - (logp - ke0)
        log_accept = torch.where(torch.isnan(log_accept), -torch.inf, log_accept)
        accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
        accept = noise.accept(t) < accept_prob
        x = torch.where(accept[:, None], x_new, x)
        logp = torch.where(accept, logp_new, logp)
        g = torch.where(accept[:, None], g_new, g)
        return x, logp, g, accept_prob

    da = da_init(init_step_size, dtype, (C,), x0.device)
    for t in range(num_warmup):
        x, logp, g, accept_prob = mh_step(x, logp, g, torch.exp(da[1]), t)
        da = da_update(da, accept_prob, target_accept)
    eps_final = torch.exp(da[2])  # the averaged step size, frozen for sampling

    xs = x0.new_empty((C, num_samples, d))
    aps = x0.new_empty((C, num_samples))
    lps = x0.new_empty((C, num_samples))
    for i in range(num_samples):
        x, logp, g, accept_prob = mh_step(x, logp, g, eps_final, num_warmup + i)
        xs[:, i], aps[:, i], lps[:, i] = x, accept_prob, logp
    out = HMCResult(samples=xs, accept_prob=aps, step_size=eps_final, log_densities=lps)
    return HMCResult(*(f[0] for f in out)) if single else out


def hmc_warm_start(
    seed: int,
    result,
    *,
    num_samples: int = 1000,
    num_warmup: int = 300,
    num_leapfrog: int = 16,
    draw_index: int = 0,
    **kwargs,
) -> HMCResult:
    """HMC initialized from a Pathfinder result, on the device its tensors
    live on: initial position = a Pathfinder draw, metric = the fit's
    Woodbury covariance."""
    vg = resolve_result_value_and_grad(result)
    metric = WoodburyMetric.from_result(result, draw_index)
    x0 = result.draws[:, draw_index]
    return hmc(
        seed, vg, metric, x0,
        num_samples=num_samples, num_warmup=num_warmup, num_leapfrog=num_leapfrog,
        **kwargs,
    )

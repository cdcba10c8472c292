"""Bayesian model layer: named priors + likelihood, linked to unconstrained
space (counterpart of ``pathfinder_tpu/models/bayes.py``).

A :class:`BayesModel`

* links itself to unconstrained space with the change-of-variables Jacobian,
  through the package's bijectors;
* converts unconstrained draws back to named constrained parameters with
  per-draw ``logprior`` / ``loglikelihood`` / ``logjoint``;
* offers init strategies: from the prior, or from (partly) fixed parameter
  values.

``pathfinder(model)`` and ``multipathfinder(model, n)`` accept a
:class:`BayesModel` directly and return results whose ``draws_transformed``
are constrained-space draws, rebuilt by ``resample``.

Everything is batched over leading axes. A named parameter of a batch of K
rows is ``(K,)`` for a block of size 1 and ``(K, size)`` otherwise, and the
user's ``loglikelihood(params)`` returns ``(K,)``: it must reduce over its
data axes only, never over the batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import numbers
from typing import Callable, Dict, Optional, Tuple

import torch

from pathfinder_tpu_torch.integrations.transforms import (
    Bijector,
    Exp,
    Identity,
    Interval,
    Simplex,
    Stacked,
    TransformedLogDensity,
)
from pathfinder_tpu_torch.utils import rng

__all__ = [
    "Normal",
    "Cauchy",
    "HalfCauchy",
    "Gamma",
    "HalfNormal",
    "LogNormal",
    "Exponential",
    "Uniform",
    "Beta",
    "StudentT",
    "Dirichlet",
    "BayesModel",
]

_LOG_2PI = math.log(2.0 * math.pi)
_GAMMA_TRIES = 16  # rejection rounds of the gamma sampler, drawn up front


def _log(value, like):
    """``log(value)`` for a distribution parameter: a Python scalar, or an
    array-valued parameter brought to ``like``'s dtype and device."""
    if isinstance(value, numbers.Real):
        return math.log(value) if value > 0 else math.nan
    return torch.log(torch.as_tensor(value, dtype=like.dtype, device=like.device))


def _lgamma(value, like):
    if isinstance(value, numbers.Real):
        return math.lgamma(value)
    return torch.lgamma(torch.as_tensor(value, dtype=like.dtype, device=like.device))


def _standard_normal(u):
    """Box-Muller on the last axis of ``u (..., 2)``."""
    return torch.sqrt(-2.0 * torch.log(u[..., 0])) * torch.cos(2.0 * math.pi * u[..., 1])


def _standard_gamma(stream: rng.Stream, shape, concentration, dtype, device):
    """Gamma(concentration, 1) draws of ``shape`` (Marsaglia & Tsang 2000).
    The stream is counter-based, so the rejection loop is drawn up front:
    ``_GAMMA_TRIES`` candidates an element, the first accepted one taken
    (none accepted has probability below 1e-20; the last candidate then
    stands). ``concentration < 1`` uses ``Gamma(a + 1)·U^(1/a)``."""
    n = math.prod(shape)
    u = stream.uniform(n * (3 * _GAMMA_TRIES + 1), torch.float64, device)
    u = u.reshape(u.shape[:-1] + tuple(shape) + (3 * _GAMMA_TRIES + 1,))
    a = torch.as_tensor(concentration, dtype=torch.float64, device=device)
    boost = a < 1.0
    a1 = torch.where(boost, a + 1.0, a)[..., None]
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    tries = u[..., : 3 * _GAMMA_TRIES].reshape(u.shape[:-1] + (_GAMMA_TRIES, 3))
    z = _standard_normal(tries[..., :2])
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (
        torch.log(tries[..., 2])
        < 0.5 * z * z + d - d * v + d * torch.log(torch.where(v > 0, v, torch.ones_like(v)))
    )
    ok[..., -1] = True
    first = torch.argmax(ok.to(torch.int8), dim=-1, keepdim=True)
    g = (d * torch.gather(v, -1, first))[..., 0]
    g = torch.where(boost, g * u[..., -1] ** (1.0 / torch.where(boost, a, torch.ones_like(a))), g)
    return g.to(dtype)


class Distribution:
    """Prior distribution: ``log_prob`` in constrained space, a support
    ``bijector`` (unconstrained → support), and prior sampling for the init
    strategies. ``log_prob`` is elementwise unless ``block`` is set: a block
    distribution takes its whole block on the last axis and returns the
    block's total."""

    bijector: Bijector = Identity()
    block = False

    def log_prob(self, x):
        raise NotImplementedError

    def sample(self, stream: rng.Stream, shape, dtype=torch.float32, device="cpu"):
        """``(*stream batch, *shape)`` draws from ``stream``."""
        raise NotImplementedError


def _normal(stream, shape, dtype, device):
    n = math.prod(shape)
    z = stream.normal(n, dtype, device)
    return z.reshape(z.shape[:-1] + tuple(shape))


def _uniform(stream, shape, dtype, device):
    n = math.prod(shape)
    u = stream.uniform(n, dtype, device)
    return u.reshape(u.shape[:-1] + tuple(shape))


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    bijector: Bijector = Identity()

    def __post_init__(self):
        _check_positive("Normal", scale=self.scale)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG_2PI) - _log(self.scale, x)

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        return self.loc + self.scale * _normal(stream, shape, dtype, device)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    scale: float = 1.0
    bijector: Bijector = Exp()

    def __post_init__(self):
        _check_positive("HalfNormal", scale=self.scale)

    def log_prob(self, x):
        z = x / self.scale
        return 0.5 * math.log(2.0 / math.pi) - _log(self.scale, x) - 0.5 * z * z

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        return self.scale * torch.abs(_normal(stream, shape, dtype, device))


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    bijector: Bijector = Exp()

    def __post_init__(self):
        _check_positive("LogNormal", scale=self.scale)

    def log_prob(self, x):
        # at x = 0 (f32 underflow of Exp.forward during a line search) the
        # naive −z²/2 − log(x) is −inf + inf = NaN; the true limit is −inf,
        # and the double where keeps the gradient free of NaN
        pos = x > 0
        lx = torch.log(torch.where(pos, x, torch.ones_like(x)))
        z = (lx - self.loc) / self.scale
        val = -0.5 * (z * z + _LOG_2PI) - _log(self.scale, x) - lx
        return torch.where(pos, val, -torch.inf)

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        return torch.exp(self.loc + self.scale * _normal(stream, shape, dtype, device))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: float = 1.0
    bijector: Bijector = Exp()

    def __post_init__(self):
        _check_positive("Exponential", rate=self.rate)

    def log_prob(self, x):
        return _log(self.rate, x) - self.rate * x

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        return -torch.log(_uniform(stream, shape, dtype, device)) / self.rate


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: float = 0.0
    high: float = 1.0

    def __post_init__(self):
        if (
            isinstance(self.low, (int, float))
            and isinstance(self.high, (int, float))
            and not self.high > self.low
        ):
            raise ValueError(
                f"Uniform: high must exceed low, got ({self.low}, {self.high})"
            )

    @property
    def bijector(self) -> Bijector:
        return Interval(self.low, self.high)

    def log_prob(self, x):
        if isinstance(self.low, numbers.Real) and isinstance(self.high, numbers.Real):
            return torch.zeros_like(x) - math.log(self.high - self.low)
        width = torch.as_tensor(self.high, dtype=x.dtype, device=x.device) - torch.as_tensor(
            self.low, dtype=x.dtype, device=x.device
        )
        return torch.zeros_like(x) - torch.log(width)

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        return self.low + (self.high - self.low) * _uniform(stream, shape, dtype, device)


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: float = 1.0
    b: float = 1.0

    @property
    def bijector(self) -> Bijector:
        return Interval(0.0, 1.0)

    def __post_init__(self):
        _check_positive("Beta", a=self.a, b=self.b)

    def log_prob(self, x):
        betaln = _lgamma(self.a, x) + _lgamma(self.b, x) - _lgamma(self.a + self.b, x)
        # unit shapes: the term is dropped statically (see _is_static_one)
        out = -betaln + torch.zeros_like(x)
        if not _is_static_one(self.a):
            out = out + torch.xlogy(_like(self.a - 1.0, x), x)
        if not _is_static_one(self.b):
            out = out + torch.special.xlog1py(_like(self.b - 1.0, x), -x)
        return out

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        ga = _standard_gamma(stream, shape, self.a, torch.float64, device)
        gb = _standard_gamma(
            dataclasses.replace(stream, purpose=rng.PRIOR_AUX), shape, self.b, torch.float64, device
        )
        return (ga / (ga + gb)).to(dtype)


def _like(value, x):
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def _is_static_one(value) -> bool:
    """True when ``value`` is a Python or numpy scalar equal to 1. Unit-shape
    xlogy terms are dropped statically: xlogy keeps the VALUE finite at a
    saturated bijector's corner (0·log(0) = 0), but its gradient there is
    0/0 = NaN."""
    return isinstance(value, numbers.Real) and float(value) == 1.0


def _check_positive(dist: str, **params) -> None:
    """Named validation of scalar distribution parameters (array-valued ones
    are accepted and show up as NaN from the logarithm)."""
    for name, value in params.items():
        if isinstance(value, (int, float)) and not value > 0:
            raise ValueError(
                f"{dist}: parameter {name!r} must be positive, got {value}"
            )


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Shape-rate parameterization (Stan's convention)."""

    concentration: float = 1.0
    rate: float = 1.0
    bijector: Bijector = Exp()

    def __post_init__(self):
        _check_positive("Gamma", concentration=self.concentration, rate=self.rate)

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        out = a * _log(b, x) - _lgamma(a, x) - b * x
        # a == 1 (the default): the shape term is dropped statically, as its
        # gradient is NaN where Exp.forward underflows to exactly 0 in f32
        if not _is_static_one(a):
            out = out + torch.xlogy(_like(a - 1.0, x), x)
        return out

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        g = _standard_gamma(stream, shape, self.concentration, torch.float64, device)
        return (g / self.rate).to(dtype)


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    bijector: Bijector = Identity()

    def __post_init__(self):
        _check_positive("Cauchy", scale=self.scale)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -math.log(math.pi) - _log(self.scale, x) - torch.log1p(z * z)

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        u = _uniform(stream, shape, torch.float64, device)
        return (self.loc + self.scale * torch.tan(math.pi * (u - 0.5))).to(dtype)


@dataclasses.dataclass(frozen=True)
class HalfCauchy(Distribution):
    """The weakly informative scale prior of Gelman (2006)."""

    scale: float = 1.0
    bijector: Bijector = Exp()

    def __post_init__(self):
        _check_positive("HalfCauchy", scale=self.scale)

    def log_prob(self, x):
        z = x / self.scale
        return math.log(2.0 / math.pi) - _log(self.scale, x) - torch.log1p(z * z)

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        u = _uniform(stream, shape, torch.float64, device)
        return (self.scale * torch.abs(torch.tan(math.pi * (u - 0.5)))).to(dtype)


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    df: float = 3.0
    loc: float = 0.0
    scale: float = 1.0
    bijector: Bijector = Identity()

    def __post_init__(self):
        _check_positive("StudentT", df=self.df, scale=self.scale)

    def log_prob(self, x):
        nu = self.df
        z = (x - self.loc) / self.scale
        return (
            _lgamma((nu + 1.0) / 2.0, x)
            - _lgamma(nu / 2.0, x)
            - 0.5 * _log(nu * math.pi, x)
            - _log(self.scale, x)
            - (nu + 1.0) / 2.0 * torch.log1p(z * z / nu)
        )

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        # z / sqrt(χ²_ν / ν) with χ²_ν = 2·Gamma(ν/2)
        z = _normal(dataclasses.replace(stream, purpose=rng.PRIOR_AUX), shape, torch.float64, device)
        chi2 = 2.0 * _standard_gamma(stream, shape, self.df / 2.0, torch.float64, device)
        return (self.loc + self.scale * z / torch.sqrt(chi2 / self.df)).to(dtype)


class Dirichlet(Distribution):
    """Dirichlet(α) over the (len(α)−1)-dimensional representation of the
    simplex: the parameter block stores the **first len(α)−1 coordinates**
    (the last is ``1 − Σx``, the :class:`Simplex` bijector's convention).
    Declare it with the matching block size:
    ``{"w": (Dirichlet([a1, ..., aK]), K - 1)}``."""

    block = True

    def __init__(self, alpha):
        self.alpha = tuple(float(a) for a in alpha)
        _check_positive("Dirichlet", **{f"alpha[{i}]": a for i, a in enumerate(self.alpha)})

    def __hash__(self):
        return hash(("Dirichlet", self.alpha))

    def __eq__(self, other):
        return isinstance(other, Dirichlet) and self.alpha == other.alpha

    @property
    def size(self) -> int:
        return len(self.alpha) - 1

    @property
    def bijector(self) -> Bijector:
        return Simplex()

    def log_prob(self, x):
        """``x (..., K−1)``: the first K−1 simplex coordinates; returns the
        block's total ``(...)``."""
        a = self.alpha
        # f32 stick breaking can round sum(x) a hair past 1; a negative
        # x_last would make xlogy NaN (not −inf): clamp to the boundary,
        # where the density's limit is −inf (a > 1) or +inf (a < 1)
        x_last = torch.clamp(1.0 - torch.sum(x, dim=-1, keepdim=True), min=0.0)
        xs = torch.cat([x, x_last], dim=-1)
        log_beta = sum(math.lgamma(ai) for ai in a) - math.lgamma(sum(a))
        # unit-alpha components are dropped statically (value AND gradient
        # stay finite at simplex corners; xlogy alone repairs only the value)
        keep = [i for i, ai in enumerate(a) if ai != 1.0]
        if not keep:
            return torch.zeros_like(xs[..., 0]) - log_beta
        am1 = torch.as_tensor([a[i] - 1.0 for i in keep], dtype=x.dtype, device=x.device)
        return torch.sum(torch.xlogy(am1, xs[..., keep]), dim=-1) - log_beta

    def sample(self, stream, shape, dtype=torch.float32, device="cpu"):
        if tuple(shape) != (self.size,):
            raise ValueError(
                f"Dirichlet block must have size {self.size} "
                f"(= len(alpha) - 1), got shape {tuple(shape)}"
            )
        alpha = torch.as_tensor(self.alpha, dtype=torch.float64, device=device)
        g = _standard_gamma(stream, (len(self.alpha),), alpha, torch.float64, device)
        return (g / g.sum(dim=-1, keepdim=True))[..., : self.size].to(dtype)


def _normalize_priors(priors) -> Tuple[Tuple[str, Distribution, int], ...]:
    out = []
    items = priors.items() if isinstance(priors, dict) else priors
    for item in items:
        if isinstance(priors, dict):
            name, spec = item
        else:
            name, spec = item[0], item[1:] if len(item) > 2 else item[1]
        if isinstance(spec, tuple):
            dist, size = spec
        else:
            dist = spec
            size = getattr(dist, "size", 1)  # block distributions size themselves
        # block distributions (Dirichlet) fix their own block size: another
        # one would silently mis-slice the flat vector
        required = getattr(dist, "size", None)
        if required is not None and int(size) != int(required):
            raise ValueError(
                f"prior {name!r} ({type(dist).__name__}) requires block "
                f"size {required}, got {size}"
            )
        out.append((name, dist, int(size)))
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)
class BayesModel:
    """``priors``: ``{name: dist}`` or ``{name: (dist, size)}`` (ordered);
    ``loglikelihood``: optional callable that takes the dict of named
    constrained parameters (each ``(K,)`` or ``(K, size)``) and returns the
    log likelihood of every row, ``(K,)``."""

    priors: Tuple[Tuple[str, Distribution, int], ...]
    loglikelihood: Optional[Callable] = None

    def __init__(self, priors, loglikelihood=None):
        object.__setattr__(self, "priors", _normalize_priors(priors))
        object.__setattr__(self, "loglikelihood", loglikelihood)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # -- shapes ---------------------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(size for _, _, size in self.priors)

    @property
    def names(self):
        return [name for name, _, _ in self.priors]

    def split(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Flat constrained ``x (..., dim)`` → dict of named parameters
        (``(...)`` for size-1 blocks, ``(..., size)`` otherwise)."""
        out, i = {}, 0
        for name, _, size in self.priors:
            block = x[..., i : i + size]
            out[name] = block[..., 0] if size == 1 else block
            i += size
        return out

    def join(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict of named parameters → flat constrained ``(..., dim)``."""
        parts = []
        for name, _, size in self.priors:
            v = torch.as_tensor(params[name])
            if not v.is_floating_point():
                v = v.to(torch.get_default_dtype())
            parts.append(v[..., None] if size == 1 else v)
        return torch.cat(parts, dim=-1)

    # -- densities (constrained space) ---------------------------------------
    def logprior(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for name, dist, size in self.priors:
            v = params[name]
            if dist.block:
                lp = dist.log_prob(v[..., None] if size == 1 else v)
            else:
                lp = dist.log_prob(v)
                if size > 1:
                    lp = torch.sum(lp, dim=-1)
            total = total + lp
        return total

    def logjoint(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        lp = self.logprior(params)
        if self.loglikelihood is not None:
            lp = lp + self.loglikelihood(params)
        return lp

    def constrained_logp(self, x: torch.Tensor) -> torch.Tensor:
        return self.logjoint(self.split(x))

    # -- linking --------------------------------------------------------------
    @functools.cached_property
    def bijector(self) -> Stacked:
        return Stacked(tuple((dist.bijector, size) for _, dist, size in self.priors))

    @functools.cached_property
    def transformed(self) -> TransformedLogDensity:
        """The unconstrained linked density with the Jacobian correction;
        ``.unconstrained`` is what ``pathfinder`` optimizes (done for you
        when the model itself is passed)."""
        return TransformedLogDensity(
            logp_constrained=self.constrained_logp,
            bijector=self.bijector,
            dim=self.dim,
        )

    # -- init strategies ------------------------------------------------------
    def init_from_prior(self) -> Callable:
        """An ``init_sampler`` that draws the initial point from the prior
        and links it to unconstrained space."""

        def sampler(stream: rng.Stream, dim, dtype=torch.float32, device="cpu"):
            x = self.sample_prior(stream, torch.float64, device)
            return self.bijector.inverse(x).to(dtype)

        return sampler

    def sample_prior(self, stream: rng.Stream, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """One flat constrained draw from the prior for every element of the
        stream's batch: ``(*batch, dim)``. Block ``i`` draws from the stream's
        candidate ``i`` under the purpose ``rng.PRIOR``."""
        parts = []
        for i, (name, dist, size) in enumerate(self.priors):
            sub = dataclasses.replace(stream, purpose=rng.PRIOR, candidate=i)
            parts.append(dist.sample(sub, (size,), dtype, device))
        return torch.cat(parts, dim=-1)

    def init_from_params(
        self, params: Dict[str, torch.Tensor], stream: Optional[rng.Stream] = None,
        dtype=torch.float32, device="cpu",
    ) -> torch.Tensor:
        """Unconstrained initial point ``(dim,)`` from (possibly partial)
        constrained parameter values; parameters not given are drawn from
        their prior."""
        if stream is None:
            stream = rng.Stream(0, 0, 0, rng.PRIOR)
        full = dict(self.split(self.sample_prior(stream, torch.float64, device)))
        for name, val in params.items():
            if name not in full:
                raise KeyError(f"unknown parameter {name!r}")
            full[name] = torch.as_tensor(val, dtype=torch.float64, device=device)
        z = self.bijector.inverse(self.join(full))
        if not bool(torch.isfinite(z).all()):
            # name the offending parameters instead of letting every
            # pathfinder try fail on a silent NaN init
            zf = torch.isfinite(z)
            bad, i = [], 0
            for name, _, size in self.priors:
                if not bool(zf[..., i : i + size].all()):
                    bad.append(name)
                i += size
            raise ValueError(
                f"init_from_params: value(s) for {bad} are outside the "
                "support of their prior (unconstrained init is non-finite)"
            )
        return z.to(dtype)

    # -- draw conversion ------------------------------------------------------
    def constrain_draws(self, draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Unconstrained ``(dim, ndraws)`` → named constrained tensors with a
        leading draws axis."""
        return self.split(self.bijector.forward(draws.mT))

    def pointwise_stats(
        self, draws: torch.Tensor, constrained: Optional[torch.Tensor] = None
    ) -> Dict[str, torch.Tensor]:
        """Per-draw ``logprior`` / ``loglikelihood`` / ``logjoint`` of the
        constrained draws. ``constrained``: the already transformed
        ``(N, dim)`` matrix, to skip a second forward pass."""
        if constrained is None:
            constrained = self.bijector.forward(draws.mT)
        params = self.split(constrained)
        lp = self.logprior(params)
        ll = self.loglikelihood(params) if self.loglikelihood is not None else torch.zeros_like(lp)
        return {"logprior": lp, "loglikelihood": ll, "logjoint": lp + ll}

    def draws_to_chain(self, draws: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Named constrained draws and per-draw stats in one dict, the
        chain-like object used for ``draws_transformed``; the bijector's
        forward pass over the draw matrix runs once."""
        con = self.bijector.forward(draws.mT)
        out = self.split(con)
        out.update(self.pointwise_stats(draws, constrained=con))
        return out

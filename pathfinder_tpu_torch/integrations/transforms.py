"""Constrained ↔ unconstrained transforms with the change-of-variables
Jacobian (counterpart of ``pathfinder_tpu/integrations/transforms.py``).

Pathfinder runs on ``logp_unconstrained(z) = logp(T(z)) + log|det J_T(z)|``
and ``forward_draws`` maps its draws back to the constrained space.

Every bijector acts on the last axis of a batch: ``z (..., d) -> x (..., d)``.
The elementwise ones (:class:`Identity`, :class:`Exp`, :class:`Interval`)
take any shape; the block ones (:class:`Ordered`, :class:`Simplex`) treat the
last axis as one parameter block. ``forward_log_det`` returns a tensor of
``z``'s shape whose sum over the last axis is the log-Jacobian of the row.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from pathfinder_tpu_torch.models.protocol import LogDensity

__all__ = [
    "Bijector",
    "Identity",
    "Exp",
    "Interval",
    "Ordered",
    "Simplex",
    "Stacked",
    "TransformedLogDensity",
    "TransformedDistribution",
    "resolve_transform",
    "transformed_outputs",
]


def resolve_transform(fn, transform, dim=None, grad=None):
    """Resolve the ``(fn, transform)`` inputs of ``pathfinder`` and
    ``multipathfinder`` into ``(target_input, tld)``: what the optimizer
    should maximize, and the :class:`TransformedLogDensity` (``None`` for a
    plain unconstrained run).

    Accepted:

    * ``fn`` is a model object with a ``.transformed``
      (a :class:`TransformedLogDensity`), e.g. a ``BayesModel``;
    * ``fn`` is a :class:`TransformedLogDensity`;
    * ``transform=`` is a :class:`TransformedLogDensity` (``fn`` ignored);
    * ``transform=`` is a bijector: ``fn`` is then the **constrained-space**
      log density and is linked here; ``grad=`` (the constrained-space
      gradient of ``fn``) is chain-ruled through the bijector, so the
      optimizer never differentiates the user's logp.

    With a model or a :class:`TransformedLogDensity` a ``grad`` has no
    meaning (which space is it in?) and is rejected.
    """
    if transform is None:
        if isinstance(fn, TransformedLogDensity):
            _reject_grad(grad, "a TransformedLogDensity input")
            return fn.unconstrained, fn
        t = getattr(fn, "transformed", None)
        if isinstance(t, TransformedLogDensity):
            _reject_grad(grad, "a model input")
            return t.unconstrained, t
        return fn, None
    if isinstance(transform, TransformedLogDensity):
        _reject_grad(grad, "transform=<TransformedLogDensity>")
        return transform.unconstrained, transform
    if not isinstance(transform, Bijector):
        raise TypeError(
            "transform must be a Bijector or TransformedLogDensity, got "
            f"{type(transform)!r}"
        )
    logp_c = getattr(fn, "logp", fn)
    if not callable(logp_c):
        raise TypeError("fn must be a callable log density when transform= is a bijector")
    d = dim if dim is not None else getattr(fn, "dim", None)
    if d is None:
        raise ValueError("dim is required when transform= is a bijector")
    tld = TransformedLogDensity(
        logp_constrained=logp_c, bijector=transform, dim=int(d), grad_constrained=grad
    )
    return tld.unconstrained, tld


def _reject_grad(grad, what):
    if grad is not None:
        raise ValueError(
            f"grad= cannot be combined with {what}: the linked "
            "unconstrained density is built by the transform itself. Pass "
            "grad= only with a plain callable target, or with "
            "transform=<bijector> (where it is the constrained-space "
            "gradient)."
        )


def transformed_outputs(tld, input_obj, draws, fit_distribution):
    """Constrained-space result fields of a transform-aware run: the
    transformed draws (a named chain dict with per-draw stats when the input
    model has ``draws_to_chain`` and its own link drove the run, else the
    forward-mapped ``(dim, ndraws)`` matrix) and the pushforward of the fit
    distribution. Without a transform both come back unchanged."""
    if tld is None:
        return draws, fit_distribution
    # the model's own chain conversion only when the model's own link IS the
    # transform that drove the optimization: with another transform=, the
    # model's bijector would make draws_transformed inconsistent with
    # fit_distribution_transformed
    chainer = getattr(input_obj, "draws_to_chain", None)
    own_tld = getattr(input_obj, "transformed", None)
    if chainer is not None and own_tld == tld:
        draws_t = chainer(draws)
    else:
        draws_t = tld.forward_draws(draws)
    return draws_t, TransformedDistribution(fit_distribution, tld.bijector)


class Bijector:
    """z (unconstrained) ↔ x (constrained) along the last axis."""

    def forward(self, z):  # z -> x
        raise NotImplementedError

    def inverse(self, x):  # x -> z
        raise NotImplementedError

    def forward_log_det(self, z):  # log|dx/dz|, summing to the row's log-Jacobian
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, z):
        return z

    def inverse(self, x):
        return x

    def forward_log_det(self, z):
        return torch.zeros_like(z)


@dataclasses.dataclass(frozen=True)
class Exp(Bijector):
    """Positive support: x = exp(z) (the standard link for scales)."""

    def forward(self, z):
        return torch.exp(z)

    def inverse(self, x):
        return torch.log(x)

    def forward_log_det(self, z):
        return z


@dataclasses.dataclass(frozen=True)
class Interval(Bijector):
    """Bounded support (a, b): x = a + (b−a)·sigmoid(z)."""

    low: float
    high: float

    def __post_init__(self):
        # swapped bounds would make every log-Jacobian log(negative) = NaN
        # with no pointer to the cause
        if (
            isinstance(self.low, (int, float))
            and isinstance(self.high, (int, float))
            and not self.high > self.low
        ):
            raise ValueError(
                f"Interval: high must exceed low, got ({self.low}, {self.high})"
            )

    def forward(self, z):
        return self.low + (self.high - self.low) * torch.sigmoid(z)

    def inverse(self, x):
        u = (x - self.low) / (self.high - self.low)
        return torch.log(u) - torch.log1p(-u)

    def forward_log_det(self, z):
        # log((b−a) σ(z) (1−σ(z)))
        return math.log(self.high - self.low) + F.logsigmoid(z) + F.logsigmoid(-z)


@dataclasses.dataclass(frozen=True)
class Ordered(Bijector):
    """Strictly increasing vectors (Stan's ``ordered`` type): ``x₁ = z₁``,
    ``x_k = x_{k−1} + exp(z_k)``. A block bijector: the last axis is the
    whole block (e.g. ordered cutpoints); ``forward_log_det`` sums to the
    true log-Jacobian ``Σ_{k≥2} z_k``."""

    def forward(self, z):
        return torch.cumsum(torch.cat([z[..., :1], torch.exp(z[..., 1:])], dim=-1), dim=-1)

    def inverse(self, x):
        return torch.cat([x[..., :1], torch.log(torch.diff(x, dim=-1))], dim=-1)

    def forward_log_det(self, z):
        return torch.cat([torch.zeros_like(z[..., :1]), z[..., 1:]], dim=-1)


@dataclasses.dataclass(frozen=True)
class Simplex(Bijector):
    """Stick-breaking simplex transform (Stan reference manual §10.7):
    ``z`` of length m ↔ the **first m coordinates** of an (m+1)-simplex
    (the last coordinate is ``1 − Σx``, stored implicitly, so the block has
    the same length in both spaces). ``w_k = σ(z_k − log(m+1−k))``,
    ``x_k = stick_k · w_k``, ``stick_{k+1} = stick_k(1 − w_k)``."""

    def _offsets(self, like):
        m = like.shape[-1]
        return torch.log(torch.arange(m, 0, -1, dtype=like.dtype, device=like.device))

    def forward(self, z):
        u = z - self._offsets(z)
        stick = torch.ones_like(u[..., 0])
        xs = []
        for k in range(u.shape[-1]):
            xk = stick * torch.sigmoid(u[..., k])
            stick = stick - xk
            xs.append(xk)
        return torch.stack(xs, dim=-1)

    def inverse(self, x):
        stick = 1.0 - torch.cat(
            [torch.zeros_like(x[..., :1]), torch.cumsum(x, dim=-1)[..., :-1]], dim=-1
        )
        w = x / stick
        return torch.log(w) - torch.log1p(-w) + self._offsets(x)

    def forward_log_det(self, z):
        u = z - self._offsets(z)
        stick = torch.ones_like(u[..., 0])
        lds = []
        for k in range(u.shape[-1]):
            uk = u[..., k]
            lds.append(F.logsigmoid(uk) + F.logsigmoid(-uk) + torch.log(stick))
            stick = stick * torch.sigmoid(-uk)
        return torch.stack(lds, dim=-1)


@dataclasses.dataclass(frozen=True)
class Stacked(Bijector):
    """Per-block bijectors along the parameter axis:
    ``blocks = [(bijector, size), ...]`` in order."""

    blocks: Tuple[Tuple[Bijector, int], ...]

    def __post_init__(self):
        object.__setattr__(self, "blocks", tuple(self.blocks))
        for _, size in self.blocks:
            if size < 1:
                raise ValueError(f"Stacked block sizes must be >= 1; got {size}")

    def _split(self, v):
        total = sum(size for _, size in self.blocks)
        if v.shape[-1] != total:
            raise ValueError(
                f"Stacked blocks cover {total} entries but the parameter "
                f"vector has {v.shape[-1]} — block sizes must sum to the "
                "target dimension (a mismatch would silently truncate the "
                "vector and drop Jacobian terms)"
            )
        out, i = [], 0
        for b, size in self.blocks:
            out.append((b, v[..., i : i + size]))
            i += size
        return out

    def forward(self, z):
        return torch.cat([b.forward(part) for b, part in self._split(z)], dim=-1)

    def inverse(self, x):
        return torch.cat([b.inverse(part) for b, part in self._split(x)], dim=-1)

    def forward_log_det(self, z):
        return torch.cat([b.forward_log_det(part) for b, part in self._split(z)], dim=-1)


@dataclasses.dataclass(frozen=True)
class TransformedLogDensity:
    """A constrained-space target wrapped for unconstrained optimization.

    ``logp_constrained`` takes a batch ``x (K, d)`` in the constrained space
    and returns ``(K,)``; ``bijector`` maps unconstrained z → constrained x.
    ``unconstrained`` is the :class:`LogDensity` to hand to ``pathfinder``;
    ``forward_draws`` maps a ``(dim, ndraws)`` unconstrained draw matrix back
    to the constrained space."""

    logp_constrained: Callable
    bijector: Bijector
    dim: int
    # optional constrained-space gradient of logp_constrained, batched
    # (K, d) -> (K, d): when given, the unconstrained value_and_grad
    # chain-rules it through the bijector and never differentiates the
    # user's logp, so targets that autograd cannot trace still work
    grad_constrained: Optional[Callable] = None

    def __hash__(self):
        return hash((self.logp_constrained, self.bijector, self.dim, self.grad_constrained))

    @functools.cached_property
    def unconstrained(self) -> LogDensity:
        b = self.bijector
        lp = self.logp_constrained
        gc = self.grad_constrained

        def logp(z):
            return lp(b.forward(z)) + torch.sum(b.forward_log_det(z), dim=-1)

        vg = None
        if gc is not None:

            def vg(z):
                with torch.enable_grad():
                    zr = z.detach().requires_grad_(True)
                    x = b.forward(zr)
                    ld = torch.sum(b.forward_log_det(zr), dim=-1)
                    xd = x.detach()
                    # Jᵀ·∇logp(x) + ∇ld, in one backward pass
                    (g,) = torch.autograd.grad(torch.sum(x * gc(xd)) + torch.sum(ld), zr)
                return lp(xd) + ld.detach(), g

        return LogDensity(logp=logp, dim=self.dim, value_and_grad=vg)

    def forward_draws(self, draws_zd: torch.Tensor) -> torch.Tensor:
        """Draws ``(dim, ndraws)`` from unconstrained to constrained."""
        return self.bijector.forward(draws_zd.mT).mT

    def inverse_point(self, x: torch.Tensor) -> torch.Tensor:
        return self.bijector.inverse(x)


@dataclasses.dataclass(frozen=True)
class TransformedDistribution:
    """Pushforward of a fit distribution through a bijector.

    ``base`` is an unconstrained-space distribution (an ``MvNormal`` or a
    ``UniformMixture``) with ``sample``/``logpdf`` over ``(dim, N)``
    matrices; samples are mapped forward, densities get the inverse
    change-of-variables correction."""

    base: object
    bijector: Bijector

    def sample(self, stream, ndraws: int):
        out = self.base.sample(stream, ndraws)
        if isinstance(out, tuple):  # mixtures return (draws, component_ids)
            return (self.bijector.forward(out[0].mT).mT,) + out[1:]
        return self.bijector.forward(out.mT).mT

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        """Log density at constrained ``x`` of shape ``(dim,)`` or
        ``(dim, N)``: ``logq(z) − log|det J(z)|`` with ``z = inverse(x)``."""
        single = x.ndim == 1
        xm = x[:, None] if single else x
        z = self.bijector.inverse(xm.mT)  # (N, dim)
        ld = torch.sum(self.bijector.forward_log_det(z), dim=-1)
        out = self.base.logpdf(z.mT.contiguous()) - ld
        # outside the support the inverse is NaN or ±inf and the arithmetic
        # above gives NaN (inf − inf at a boundary); the density there is 0:
        # report -inf, never NaN
        out = torch.where(torch.isnan(out), -torch.inf, out)
        return out[..., 0] if single else out

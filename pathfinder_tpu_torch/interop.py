"""Carry state from the JAX package into the port.

Pathfinder has no weights: a target's data comes from the shared numpy seed,
and what one package hands the other is fitted state. These converters take
the JAX package's objects as numpy arrays (``np.asarray`` on the JAX side)
and return the port's objects. This module imports no JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pathfinder_tpu_torch.integrations import transforms
from pathfinder_tpu_torch.integrations.hmc import WoodburyMetric
from pathfinder_tpu_torch.models import bayes
from pathfinder_tpu_torch.ops.lbfgs import OptimizationTrace
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.singlepath import PathfinderConfig

__all__ = [
    "woodbury_from_numpy",
    "mvnormal_from_numpy",
    "trace_from_numpy",
    "config_from_fields",
    "metric_from_numpy",
    "bijector_from_spec",
    "bayes_model_from_spec",
    "ArrayNoise",
]


def _t(a, dtype, device):
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    dt = dtype or (torch.float64 if a.dtype == np.float64 else torch.float32)
    return torch.as_tensor(a, dtype=dt, device=device)


def woodbury_from_numpy(
    A, B, D, col_mask=None, *, method: str = "chol",
    dtype: Optional[torch.dtype] = None, device="cpu",
) -> WoodburyPDMat:
    """``WoodburyPDMat`` from ``A`` (diagonal ``(..., n)`` or dense
    ``(..., n, n)``), ``B (..., n, m)`` (``m`` may be 0), ``D (..., m, m)``
    and an optional column mask, refactorized in torch by ``method``."""
    cm = None if col_mask is None else torch.as_tensor(np.array(col_mask), device=device)
    return WoodburyPDMat.from_parts(
        _t(A, dtype, device), _t(B, dtype, device), _t(D, dtype, device), col_mask=cm,
        method=method,
    )


def mvnormal_from_numpy(
    mean, A, B, D, col_mask=None, *, dtype: Optional[torch.dtype] = None, device="cpu"
) -> MvNormal:
    """``MvNormal`` with a Woodbury covariance from numpy parts; with a
    leading axis on every part, a batch of components."""
    cov = woodbury_from_numpy(A, B, D, col_mask, dtype=dtype, device=device)
    return MvNormal(_t(mean, dtype, device).to(cov.dtype), cov)


def trace_from_numpy(
    xs, log_densities, gradients, num_valid, num_bfgs_updates_rejected=None,
    num_fn_evals=None, num_ls_exhausted=None, *,
    dtype: Optional[torch.dtype] = None, device="cpu",
) -> OptimizationTrace:
    """``OptimizationTrace`` batched over paths from a JAX trace: ``xs`` and
    ``gradients (K, L+1, d)``, ``log_densities (K, L+1)``, ``num_valid (K,)``
    (a single path's unbatched arrays get a leading axis of 1)."""
    xs = np.asarray(xs)
    batched = xs.ndim == 3

    def arr(a, float_=True):
        a = np.array(a)
        a = a if batched else a[None]
        if float_:
            return _t(a, dtype, device)
        return torch.as_tensor(a.astype(np.int64), device=device)

    K = xs.shape[0] if batched else 1
    zeros = np.zeros(K if batched else (), np.int64)

    def count(a):
        return arr(zeros if a is None else a, float_=False)

    return OptimizationTrace(
        xs=arr(xs),
        log_densities=arr(log_densities),
        gradients=arr(gradients),
        num_valid=count(num_valid),
        num_bfgs_updates_rejected=count(num_bfgs_updates_rejected),
        num_fn_evals=count(num_fn_evals),
        num_ls_exhausted=count(num_ls_exhausted),
    )


def config_from_fields(config) -> PathfinderConfig:
    """The port's ``PathfinderConfig`` from the JAX package's (a named
    tuple), or from a mapping with fields of the same names. The port has
    every field of the JAX package's; a field it does not know must be at
    its off value (false, zero or None)."""
    fields = dict(config) if isinstance(config, dict) else config._asdict()
    known = {f.name for f in dataclasses.fields(PathfinderConfig)}
    extra = sorted(k for k, v in fields.items() if k not in known and v)
    if extra:
        raise NotImplementedError(f"not ported yet: {', '.join(extra)}")
    return PathfinderConfig(**{k: v for k, v in fields.items() if k in known})


def metric_from_numpy(
    A, B, D, *, method: str = "chol", dtype: Optional[torch.dtype] = None, device="cpu"
) -> WoodburyMetric:
    """A ``WoodburyMetric`` from the parts ``minv.A``, ``minv.B``, ``minv.D``
    of the JAX package's metric, refactorized in torch."""
    return WoodburyMetric(woodbury_from_numpy(A, B, D, method=method, dtype=dtype, device=device))


def bijector_from_spec(spec) -> transforms.Bijector:
    """A bijector from its name and parameters: ``("Exp", {})``,
    ``("Interval", {"low": 0.0, "high": 2.0})``, or a stack
    ``("Stacked", [(spec, size), ...])``."""
    name, params = spec
    if name == "Stacked":
        return transforms.Stacked(tuple((bijector_from_spec(b), int(n)) for b, n in params))
    cls = getattr(transforms, name, None)
    if not (isinstance(cls, type) and issubclass(cls, transforms.Bijector)):
        raise ValueError(f"unknown bijector {name!r}")
    return cls(**{k: float(v) for k, v in params.items()})


def bayes_model_from_spec(priors, loglikelihood=None) -> bayes.BayesModel:
    """A ``BayesModel`` from its priors as ``(name, distribution name,
    parameters, size)`` tuples, e.g. ``("sigma", "HalfNormal", {"scale":
    2.0}, 1)``; parameters are scalars or numpy arrays (a Dirichlet's
    ``alpha``). The likelihood is the port's own, batched callable."""
    out = []
    for name, dist_name, params, size in priors:
        cls = getattr(bayes, dist_name, None)
        if not (isinstance(cls, type) and issubclass(cls, bayes.Distribution)):
            raise ValueError(f"unknown distribution {dist_name!r}")
        kw = {
            k: (float(v) if np.ndim(v) == 0 else np.asarray(v, dtype=np.float64))
            for k, v in params.items()
        }
        out.append((name, cls(**kw), int(size)))
    return bayes.BayesModel(out, loglikelihood)


class ArrayNoise:
    """The random decisions of one HMC or NUTS run as arrays, in place of the
    port's streams (the samplers' ``noise=``): the numbers the JAX package
    drew under its own keys, so that both samplers make the same decisions.
    All arrays lead with ``(T transitions, C chains)``, warm-up first:

    * ``momentum (T, C, d)`` standard normals;
    * HMC: ``jitter (T, C)`` step-size factors in (0.8, 1.2), ``accept (T, C)``
      uniforms;
    * NUTS: ``direction (T, C, max_depth)`` booleans (go right),
      ``merge (T, C, max_depth)`` uniforms, ``leaf (T, C, max_depth, L)``
      uniforms for leaf ``n < L`` of the subtree of each doubling.
    """

    def __init__(self, *, momentum, jitter=None, accept=None, direction=None, merge=None,
                 leaf=None, dtype: Optional[torch.dtype] = None, device="cpu"):
        self.momentum_ = _t(momentum, dtype, device)
        f = lambda a: None if a is None else _t(a, self.momentum_.dtype, device)
        self.jitter_, self.accept_, self.merge_, self.leaf_ = f(jitter), f(accept), f(merge), f(leaf)
        self.direction_ = (
            None if direction is None else torch.as_tensor(np.array(direction), device=device).bool()
        )

    def momentum(self, t):
        return self.momentum_[t]

    def jitter(self, t):
        return self.jitter_[t]

    def accept(self, t):
        return self.accept_[t]

    def tree(self, t, max_depth):
        leaves = [self.leaf_[t, :, j, : 1 << j] for j in range(max_depth)]
        return (self.direction_[t, :, :max_depth], self.merge_[t, :, :max_depth],
                torch.cat(leaves, dim=-1))

"""Carry state from the JAX package into the port.

Pathfinder has no weights: a target's data comes from the shared numpy seed,
and what one package hands the other is fitted state. These converters take
the JAX package's objects as numpy arrays (``np.asarray`` on the JAX side)
and return the port's objects. This module imports no JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pathfinder_tpu_torch.ops.lbfgs import OptimizationTrace
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat

__all__ = ["woodbury_from_numpy", "mvnormal_from_numpy", "trace_from_numpy"]


def _t(a, dtype, device):
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    dt = dtype or (torch.float64 if a.dtype == np.float64 else torch.float32)
    return torch.as_tensor(a, dtype=dt, device=device)


def woodbury_from_numpy(
    A, B, D, col_mask=None, *, dtype: Optional[torch.dtype] = None, device="cpu"
) -> WoodburyPDMat:
    """``WoodburyPDMat`` from diagonal ``A (..., n)``, ``B (..., n, m)``,
    ``D (..., m, m)`` and an optional column mask, refactorized in torch."""
    cm = None if col_mask is None else torch.as_tensor(np.array(col_mask), device=device)
    return WoodburyPDMat.from_parts(
        _t(A, dtype, device), _t(B, dtype, device), _t(D, dtype, device), col_mask=cm
    )


def mvnormal_from_numpy(
    mean, A, B, D, col_mask=None, *, dtype: Optional[torch.dtype] = None, device="cpu"
) -> MvNormal:
    """``MvNormal`` with a Woodbury covariance from numpy parts."""
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

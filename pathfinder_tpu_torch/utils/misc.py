"""Small shared utilities (counterpart of ``pathfinder_tpu/utils/misc.py``)."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["findmax_skipnan", "tree_map", "resolve_device"]


def findmax_skipnan(values: torch.Tensor, valid_mask=None):
    """``(max, argmax)`` over the last axis, skipping NaNs.

    The semantics of the JAX package's ``findmax_skipnan``: NaN (and masked)
    entries are skipped; ties resolve to the first index; an all-NaN row gives
    ``(NaN, 0)``; if the best non-NaN value is -Inf, the first non-NaN slot
    is returned (genuine -Inf values are not skipped).
    """
    isnan = torch.isnan(values)
    if valid_mask is not None:
        isnan = isnan | ~valid_mask
    neg_inf = torch.full_like(values, -torch.inf)
    keyed = torch.where(isnan, neg_inf, values)
    # torch.argmax does not promise the first of several maxima, so take the
    # first index that attains the row maximum explicitly
    row_max = keyed.max(dim=-1, keepdim=True).values
    idx = _first_true(keyed == row_max)
    has_valid = ~isnan.all(dim=-1)
    first_valid = _first_true(~isnan)
    at_idx = torch.gather(keyed, -1, idx[..., None])[..., 0]
    idx = torch.where(has_valid & (at_idx == -torch.inf), first_valid, idx)
    value = torch.gather(values, -1, idx[..., None])[..., 0]
    value = torch.where(has_valid, value, torch.full_like(value, torch.nan))
    return value, idx


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when there is none)."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device).expand(mask.shape)
    return torch.where(mask, pos, n).min(dim=-1).values % n


def tree_map(fn, obj, *others):
    """Apply ``fn`` to every tensor leaf of a (nested) dataclass, pairing the
    leaves of ``others`` that have the same structure. Non-tensor fields are
    taken from ``obj`` unchanged."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *others)
    if dataclasses.is_dataclass(obj):
        changes = {
            f.name: tree_map(
                fn, getattr(obj, f.name), *(getattr(o, f.name) for o in others)
            )
            for f in dataclasses.fields(obj)
        }
        return dataclasses.replace(obj, **changes)
    return obj


def resolve_device(device) -> torch.device:
    """The one place a device is chosen. A CUDA request on a machine without
    CUDA raises; nothing moves silently to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} was requested but CUDA is not available"
            )
        # plain f32 matmuls (Gram matrices, fits) in full f32, never TF32;
        # this is PyTorch's default, set here so no caller can change it
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cpu' or 'cuda'")
    return dev

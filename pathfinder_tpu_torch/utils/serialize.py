"""Save and load results as one ``.npz`` file (counterpart of the ``.npz``
path of ``pathfinder_tpu/utils/serialize.py``).

A result is a tree of registered dataclasses over tensors. The file holds a
JSON description of the tree and one array per tensor; a tensor that two
fields share (the pooled components are the per-path fits) is stored once
and shared again after loading. Callables (the log density, the input
object, a transform) are not stored: ``load_result(path, fn=target)`` binds
them again, so that ``resample`` works on the loaded result. Files are the
port's own: a run's random numbers come from its integer ``seed``, where the
JAX package stores a key, so they do not load in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings

import numpy as np
import torch

from pathfinder_tpu_torch.utils.misc import resolve_device

__all__ = ["save_result", "load_result", "TYPE_REGISTRY", "FORMAT_VERSION"]

FORMAT_VERSION = 1

# dtypes numpy has no type for: stored as an exact float32 upcast
_UPCAST = (torch.bfloat16,)


def __getattr__(name):
    # built on first use: the classes live in modules that import this one's
    # package, so a module-level constant would be an import cycle
    if name == "TYPE_REGISTRY":
        return _registry()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@functools.lru_cache(maxsize=1)
def _registry():
    from pathfinder_tpu_torch.multipath import MultiPathfinderResult
    from pathfinder_tpu_torch.ops.elbo import ELBOEstimate
    from pathfinder_tpu_torch.ops.lbfgs import OptimizationTrace
    from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
    from pathfinder_tpu_torch.ops.psis import PSISResult
    from pathfinder_tpu_torch.ops.woodbury import WoodburyFactor, WoodburyPDMat
    from pathfinder_tpu_torch.singlepath import (
        PathfinderConfig,
        PathfinderResult,
        SinglePathState,
    )

    return {
        cls.__name__: cls
        for cls in (
            MultiPathfinderResult, PathfinderResult, PathfinderConfig, SinglePathState,
            OptimizationTrace, ELBOEstimate, MvNormal, UniformMixture, WoodburyFactor,
            WoodburyPDMat, PSISResult,
        )
    }


def _encode(obj, arrays: dict, memo: dict):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"lit": obj}
    if isinstance(obj, torch.Tensor):
        if id(obj) not in memo:
            aid = f"a{len(arrays)}"
            t = obj.detach().cpu()
            node = {"arr": aid}
            if t.dtype in _UPCAST:
                node["dt"] = str(t.dtype).removeprefix("torch.")
                t = t.float()
            arrays[aid] = t.numpy()
            memo[id(obj)] = (node, obj)  # obj kept, so that its id stays its own
        return memo[id(obj)][0]
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in _registry():
        return {
            "type": type(obj).__name__,
            "fields": {
                f.name: _encode(getattr(obj, f.name), arrays, memo)
                for f in dataclasses.fields(obj)
            },
        }
    if isinstance(obj, (list, tuple)):
        return {"seq": [_encode(v, arrays, memo) for v in obj], "tuple": isinstance(obj, tuple)}
    if isinstance(obj, dict) and all(isinstance(k, str) for k in obj):
        # the named chain dict of a model run's draws_transformed
        return {"map": {k: _encode(v, arrays, memo) for k, v in obj.items()}}
    return {"skip": repr(type(obj))}  # callables and other objects


def _decode(meta, arrays, device, rebind: dict, unbound: set, memo: dict):
    if "lit" in meta:
        return meta["lit"]
    if "arr" in meta:
        aid = meta["arr"]
        if aid not in memo:
            t = torch.as_tensor(arrays[aid]).to(device)
            memo[aid] = t.to(getattr(torch, meta["dt"])) if "dt" in meta else t
        return memo[aid]
    if "seq" in meta:
        vals = [_decode(v, arrays, device, rebind, unbound, memo) for v in meta["seq"]]
        return tuple(vals) if meta.get("tuple") else vals
    if "map" in meta:
        return {k: _decode(v, arrays, device, rebind, unbound, memo) for k, v in meta["map"].items()}
    if "skip" in meta:
        return None
    if "type" in meta:
        fields = {
            k: _decode(v, arrays, device, rebind, unbound, memo)
            for k, v in meta["fields"].items()
        }
        for k, v in meta["fields"].items():
            if "skip" in v and k not in rebind:
                unbound.add(f"{meta['type']}.{k}")
        for k, v in rebind.items():
            if k in fields and fields[k] is None:
                fields[k] = v
        return _construct(_registry()[meta["type"]], fields, meta["type"])
    raise ValueError(f"bad meta node: {meta}")


def _construct(cls, fields: dict, type_name: str):
    """Build ``cls`` from the saved fields, tolerating another version's
    schema: fields the class no longer has are dropped and fields it has
    gained take their default (or None), each with a warning that names
    them."""
    current = {f.name: f for f in dataclasses.fields(cls)}
    defaults = {}
    for name, f in current.items():
        if f.default is not dataclasses.MISSING:
            defaults[name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            defaults[name] = f.default_factory()
    dropped = sorted(set(fields) - set(current))
    added = sorted(set(current) - set(fields))
    if dropped:
        warnings.warn(
            f"load_result: saved {type_name} has fields the current class does not: "
            f"{dropped}; dropping them (file written by another version)."
        )
    if any(n not in defaults for n in added):
        warnings.warn(
            f"load_result: saved {type_name} predates fields "
            f"{[n for n in added if n not in defaults]}; filled with None."
        )
    kwargs = {k: v for k, v in fields.items() if k in current}
    kwargs.update({n: defaults.get(n) for n in added})
    return cls(**kwargs)


def save_result(path, result) -> None:
    """Save a registered result or state (see ``TYPE_REGISTRY``) to
    ``<path>.npz``; its tensors are copied to the host wherever they lie."""
    arrays: dict = {}
    root = _encode(result, arrays, {})
    if "type" not in root:
        # an unregistered root would write a file that loads as None
        raise TypeError(
            f"save_result: {type(result).__name__} is not a serializable result type "
            "(register it in TYPE_REGISTRY, or save a PathfinderResult, "
            "MultiPathfinderResult or SinglePathState)"
        )
    meta = json.dumps({"v": FORMAT_VERSION, "root": root}).encode()
    arrays["__meta__"] = np.frombuffer(meta, dtype=np.uint8)
    np.savez(path, **arrays)


def load_result(path, fn=None, device="cuda"):
    """Load a result saved by :func:`save_result`, its tensors on ``device``
    (the card unless the caller asks for the CPU).

    ``fn`` is the original target (a callable, a ``LogDensity``, a model with
    a ``.transformed`` such as a ``BayesModel``, or a
    ``TransformedLogDensity``): ``logp``, ``target`` and ``input`` are bound
    to it again, and for a model its ``transform`` and the pushforward
    ``fit_distribution_transformed``. Without it those fields are None and
    a warning names them."""
    from pathfinder_tpu_torch.integrations.transforms import (
        TransformedDistribution,
        resolve_transform,
    )
    from pathfinder_tpu_torch.models.protocol import as_log_density

    dev = resolve_device(device)
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        rebind = {}
        if fn is not None:
            # a model resolves to its unconstrained linked density: the space
            # the stored draws live in
            target_input, tld = resolve_transform(fn, None)
            target = as_log_density(target_input)
            rebind = {"logp": target.logp, "target": target, "input": fn}
            if tld is not None:
                rebind["transform"] = tld
        unbound: set = set()
        result = _decode(meta["root"], data, dev, rebind, unbound, {})
    if (
        "transform" in rebind
        and getattr(result, "fit_distribution_transformed", False) is None
        and getattr(result, "fit_distribution", None) is not None
    ):
        # the pushforward holds the bijector, which is not stored
        result = dataclasses.replace(
            result,
            fit_distribution_transformed=TransformedDistribution(
                result.fit_distribution, rebind["transform"].bijector
            ),
        )
        unbound.discard(f"{type(result).__name__}.fit_distribution_transformed")
    if unbound:
        warnings.warn(
            "load_result: callable fields were not saved and were not bound again: "
            f"{sorted(unbound)}. Pass `fn=` (the original target) to restore them, or "
            "resample() / elbo_estimates will fail."
        )
    return result

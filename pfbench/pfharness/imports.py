"""The check that the run loaded neither JAX nor the JAX package."""

from __future__ import annotations

import sys

# compared with the whole top-level name of each loaded module: the port's
# name, pathfinder_tpu_torch, begins with the JAX package's
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pathfinder_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: every module
    loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)

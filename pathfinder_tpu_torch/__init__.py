"""pathfinder_tpu_torch — Pathfinder (multi-path L-BFGS variational inference
with PSIS resampling) in PyTorch, for one NVIDIA H100.

A port of ``pathfinder_tpu`` (JAX), which stays the reference. The main path,
``multipathfinder`` with L-BFGS, Hager-Zhang and the component denominator,
runs on any torch device; on a CUDA device the Woodbury sample+logq and
whiten+sumsq steps run as hand-written CUDA kernels.
"""

from pathfinder_tpu_torch.multipath import (
    MultiPathfinderResult,
    multipathfinder,
    resample,
)
from pathfinder_tpu_torch.singlepath import (
    PathfinderConfig,
    PathfinderResult,
    pathfinder,
)

__all__ = [
    "pathfinder",
    "multipathfinder",
    "resample",
    "PathfinderConfig",
    "PathfinderResult",
    "MultiPathfinderResult",
]

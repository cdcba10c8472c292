"""pathfinder_tpu_torch — Pathfinder (multi-path L-BFGS variational inference
with PSIS resampling) in PyTorch, for one NVIDIA H100.

A port of ``pathfinder_tpu`` (JAX), which stays the reference. The main path,
``multipathfinder`` with L-BFGS, Hager-Zhang and the component denominator,
the remedies for a bad Pareto k̂ (``optimizer="cg"`` or ``"auto"``, the
mixture denominator, ``laplace_resample``), constrained models (``transform=``,
``models.bayes.BayesModel``, the GLMs of ``models.zoo``) and the HMC/NUTS warm
start from a Pathfinder result (``integrations``) run on any torch device; on
a CUDA device the Woodbury sample+logq and whiten+sumsq steps run as
hand-written CUDA kernels.
"""

from pathfinder_tpu_torch.integrations.hmc import WoodburyMetric, hmc, hmc_warm_start
from pathfinder_tpu_torch.integrations.nuts import (
    nuts,
    nuts_chains,
    nuts_warm_start,
    warm_start_chains,
)
from pathfinder_tpu_torch.models.bayes import BayesModel

from pathfinder_tpu_torch.multipath import (
    MultiPathfinderResult,
    laplace_resample,
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
    "laplace_resample",
    "PathfinderConfig",
    "PathfinderResult",
    "MultiPathfinderResult",
    "BayesModel",
    "WoodburyMetric",
    "hmc",
    "hmc_warm_start",
    "nuts",
    "nuts_chains",
    "nuts_warm_start",
    "warm_start_chains",
]

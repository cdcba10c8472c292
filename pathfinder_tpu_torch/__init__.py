"""pathfinder_tpu_torch — Pathfinder (multi-path L-BFGS variational inference
with PSIS resampling) in PyTorch, for one NVIDIA H100.

A port of ``pathfinder_tpu`` (JAX), which stays the reference. The main path,
``multipathfinder`` with L-BFGS, Hager-Zhang and the component denominator,
the remedies for a bad Pareto k̂ (``optimizer="cg"`` or ``"auto"``, the
mixture denominator, ``laplace_resample``), constrained models (``transform=``,
``models.bayes.BayesModel``, the GLMs of ``models.zoo``), the HMC/NUTS warm
start from a Pathfinder result (``integrations``), serving-scale runs
(``max_paths_per_launch``, ``keep_traces``, ``offload_launches``), the
``paths`` and ``dim`` axes of a device mesh
(``multipathfinder(mesh=paths_mesh(...))`` or ``paths_dim_mesh(...)``,
``nuts_chains(mesh=...)``, ``parallel.dim_sharding``) and result files
(``utils.serialize``) run on any torch device; on a CUDA device the Woodbury
sample+logq and whiten+sumsq steps run as hand-written CUDA kernels.

The JAX package's names are exported where it exports them. On the ``dim``
axis the port splits the L-BFGS core's rows and evaluates the target whole
on each block's first device, where GSPMD would partition the target too.
"""

from pathfinder_tpu_torch.integrations.hmc import WoodburyMetric, hmc, hmc_warm_start
from pathfinder_tpu_torch.integrations.nuts import (
    nuts,
    nuts_chains,
    nuts_warm_start,
    warm_start_chains,
)
from pathfinder_tpu_torch.models.bayes import BayesModel
from pathfinder_tpu_torch.models.protocol import LogDensity, as_log_density
from pathfinder_tpu_torch.multipath import (
    MultiPathfinderResult,
    laplace_resample,
    multipathfinder,
    resample,
)
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu_torch.ops.psis import PSISResult, psis
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat, pdfactorize, pdunfactorize
from pathfinder_tpu_torch.parallel.sharding import (
    make_path_executor,
    paths_dim_mesh,
    paths_mesh,
)
from pathfinder_tpu_torch.singlepath import (
    PathfinderConfig,
    PathfinderResult,
    pathfinder,
)
from pathfinder_tpu_torch.utils.diagnostics import ess_bulk, ess_tail, split_rhat, summarize

__all__ = [
    "pathfinder",
    "multipathfinder",
    "resample",
    "laplace_resample",
    "PathfinderResult",
    "MultiPathfinderResult",
    "PathfinderConfig",
    "LogDensity",
    "as_log_density",
    "BayesModel",
    "MvNormal",
    "UniformMixture",
    "WoodburyPDMat",
    "pdfactorize",
    "pdunfactorize",
    "PSISResult",
    "psis",
    "ess_bulk",
    "ess_tail",
    "split_rhat",
    "summarize",
    "WoodburyMetric",
    "hmc",
    "hmc_warm_start",
    "nuts",
    "nuts_chains",
    "nuts_warm_start",
    "warm_start_chains",
    "paths_mesh",
    "paths_dim_mesh",
    "make_path_executor",
]

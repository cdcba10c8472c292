"""Samplers warm-started from a Pathfinder result, bijectors, and the draw
export (counterpart of ``pathfinder_tpu/integrations``, with the same names).

``from_numpyro`` is not here: NumPyro is a JAX library with no meaning for
torch models.

As in the JAX package, the functions ``hmc`` and ``nuts`` are exported
under the names of their submodules, so ``from pathfinder_tpu_torch.integrations
import nuts`` (and ``import pathfinder_tpu_torch.integrations.nuts as m``)
give the function. Reach a submodule itself with
``importlib.import_module("pathfinder_tpu_torch.integrations.nuts")``.
"""

from pathfinder_tpu_torch.integrations.hmc import (
    WoodburyMetric,
    hmc,
    hmc_warm_start,
    leapfrog,
)
from pathfinder_tpu_torch.integrations.nuts import (
    NUTSResult,
    nuts,
    nuts_chains,
    nuts_warm_start,
    warm_start_chains,
)
from pathfinder_tpu_torch.integrations.ppl import draws_to_dict, to_inference_data
from pathfinder_tpu_torch.integrations.transforms import (
    Exp,
    Identity,
    Interval,
    Ordered,
    Simplex,
    Stacked,
    TransformedLogDensity,
)

__all__ = [
    "WoodburyMetric",
    "leapfrog",
    "hmc",
    "hmc_warm_start",
    "nuts",
    "nuts_chains",
    "nuts_warm_start",
    "warm_start_chains",
    "NUTSResult",
    "draws_to_dict",
    "to_inference_data",
    "Identity",
    "Exp",
    "Interval",
    "Ordered",
    "Simplex",
    "Stacked",
    "TransformedLogDensity",
]

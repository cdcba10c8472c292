from pathfinder_tpu_torch.ops.woodbury import (
    WoodburyFactor,
    WoodburyPDMat,
    pdfactorize,
    pdunfactorize,
)

__all__ = [
    "WoodburyFactor",
    "WoodburyPDMat",
    "pdfactorize",
    "pdunfactorize",
]

"""Named draw export (counterpart of the always-available helpers of
``pathfinder_tpu/integrations/ppl.py``): :func:`draws_to_dict` and
:func:`to_inference_data`."""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["draws_to_dict", "to_inference_data"]


def draws_to_dict(result, names=None, transform=None) -> Dict[str, Any]:
    """Named draws of a Pathfinder result: ``{name: (ndraws,) tensor}``.

    ``names`` labels the parameter axis (default ``x0..x{d-1}``);
    ``transform`` (a bijector or a ``TransformedLogDensity``) maps the draws
    to constrained space first."""
    draws = result.draws
    if transform is not None:
        fwd = getattr(transform, "forward_draws", None) or (
            lambda dz: transform.forward(dz.mT).mT
        )
        draws = fwd(draws)
    d = draws.shape[0]
    if names is None:
        names = [f"x{i}" for i in range(d)]
    elif len(names) != d:
        # a short names list would silently drop the trailing parameters
        raise ValueError(f"names has {len(names)} entries for {d} parameters")
    return {name: draws[i] for i, name in enumerate(names)}


def to_inference_data(result, names=None, transform=None):
    """The draws as an ArviZ ``InferenceData`` where ArviZ is installed, else
    the plain dict of :func:`draws_to_dict`."""
    data = draws_to_dict(result, names=names, transform=transform)
    try:
        import arviz  # optional
    except ImportError:
        return data
    return arviz.from_dict(
        posterior={k: v.detach().cpu().numpy()[None, :] for k, v in data.items()}
    )

"""``nuts_chains(mesh=)``: the chains split over the mesh's first axis.

Each block of chains runs on its own mesh entry with its own slice of the
chain ids, so a block is bitwise the unsharded ``nuts`` call on the same
chains with the same ``chain_ids`` (every field of the result, NaN where the
other has NaN), whatever the mesh width, with the Pathfinder metric, the
identity metric, a metric with a chain axis and windowed mass-matrix
adaptation. A chain count the mesh width does not divide raises with the
JAX package's message. A ``("paths", "dim")`` mesh splits the chains over
its first axis and replicates over the second, as the JAX package does: it is
bitwise the ``paths`` mesh over the same first axis.
"""

import importlib

import numpy as np
import pytest
import torch

from pathfinder_tpu_torch import multipathfinder, paths_mesh
from pathfinder_tpu_torch.integrations.hmc import WoodburyMetric
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.parallel import sharding
from pathfinder_tpu_torch.utils.diagnostics import summarize
from pathfinder_tpu_torch.utils.misc import tree_map

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

# the submodule: the package exports the function ``nuts`` under its name
tnuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")

D, C = 6, 4
OPTIONS = dict(num_warmup=20, num_samples=15, max_depth=5)


@pytest.fixture(scope="module")
def warm():
    target = tzoo.HierarchicalGaussian(D, seed=0)
    res = multipathfinder(target, 50, seed=1, nruns=4, maxiters=32, elbo_chunk=8, device="cpu",
                          dtype=torch.float64)
    return tnuts.warm_start_chains(res, C)


def _bitwise(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def _metric(kind, metric, x0s):
    if kind == "pathfinder":
        return metric
    if kind == "identity":
        return None
    # a metric with a chain axis: the Pathfinder metric with each chain's
    # diagonal scaled differently
    scale = torch.linspace(0.5, 2.0, C, dtype=x0s.dtype)[:, None]
    m = metric.minv
    return WoodburyMetric(type(m).from_parts(scale * m.A, m.B.expand(C, -1, -1),
                                             m.D.expand(C, -1, -1)))


@pytest.mark.parametrize("width, kind, adapt", [
    (2, "pathfinder", False),
    (4, "pathfinder", False),
    (2, "identity", True),
    (2, "per chain", False),
])
def test_a_block_is_the_unsharded_run_of_its_chains(warm, width, kind, adapt):
    vg, metric, x0s = warm
    metric = _metric(kind, metric, x0s)
    options = dict(OPTIONS, adapt_mass_matrix=adapt)
    out, summary = tnuts.nuts_chains(3, vg, metric, x0s, mesh=paths_mesh(["cpu"] * width),
                                     **options)
    per = C // width
    blocks = []
    for lo in range(0, C, per):
        m = metric if metric is None or not metric.batched else tree_map(
            lambda t: t[lo:lo + per], metric)
        blocks.append(tnuts.nuts(3, vg, m, x0s[lo:lo + per], chain_ids=list(range(lo, lo + per)),
                                 **options))
    for name, got, *parts in zip(out._fields, out, *blocks):
        if got is None:
            assert parts[0] is None, name
            continue
        assert _bitwise(got, torch.cat(parts)), name
    assert out.samples.shape == (C, OPTIONS["num_samples"], D)
    for key, value in summarize(out.samples).items():
        assert _bitwise(summary[key], value), key


def test_chain_counts_the_mesh_does_not_divide_raise(warm):
    vg, metric, x0s = warm
    with pytest.raises(ValueError, match="4 chains are not divisible over the 3-wide 'paths' mesh axis"):
        tnuts.nuts_chains(0, vg, metric, x0s, mesh=paths_mesh(["cpu"] * 3), **OPTIONS)
    dim_mesh = sharding.Mesh(np.array([["cpu", "cpu"]] * 2, dtype=object), ("paths", "dim"))
    out, summary = tnuts.nuts_chains(0, vg, metric, x0s, mesh=dim_mesh, **OPTIONS)
    ref, ref_summary = tnuts.nuts_chains(0, vg, metric, x0s, mesh=paths_mesh(["cpu"] * 2),
                                         **OPTIONS)
    for name, got, want in zip(out._fields, out, ref):
        assert (got is None and want is None) or _bitwise(got, want), name
    for key, value in ref_summary.items():
        assert _bitwise(summary[key], value), key

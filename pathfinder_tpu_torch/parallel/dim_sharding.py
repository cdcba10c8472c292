"""Parameter-dimension sharding: the mesh's ``dim`` axis (counterpart of
``pathfinder_tpu/parallel/dim_sharding.py``).

The JAX package places arrays with their leading axis split over a ``dim``
mesh axis and lets XLA partition whatever jitted program reads them. The
port has no partitioner, so the placement is a type of its own,
:class:`DimArray` (a leaf's row blocks in rank order, one on each mesh
device, or its copies where it is replicated), and :func:`dim_map` runs a
function on the blocks as a row group (``utils/rows.py``), launched by the
executor's own launcher (``parallel/sharding.py:run_row_groups``): one host
thread a mesh entry, each reduction over ``d`` inside the port's code summed
over the members in rank order. What runs on the blocks: the Woodbury
operations, with a diagonal or a dense ``A`` (a member holds its rows ``(d_r,
d)`` of a dense one); ``MvNormal`` sampling and ``rand_and_logpdf`` (B1
split); ``logpdf`` of a per-factor ``x`` (B2 split per factor) and of one
``x`` shared by batched normals (the shared-x kernel's split parts), and so
``UniformMixture.logpdf`` (the mixture denominator) and its ``sample``; and
every trajectory optimizer (L-BFGS and CG on their rows, BFGS with its
inverse Hessian split by rows) with every line search. What runs whole, once,
on the first device, where GSPMD would partition it: a ``LogDensity``
argument's evaluation, Newton's Hessian and ``eigh``, a user callable, and a
dense ``A``'s Cholesky and triangular solves (over its gathered rows).
``multipathfinder(mesh=paths_dim_mesh(...))`` splits each block's rows the
same way (``parallel/sharding.py``), and gathers the states on the mesh's
first device for the PSIS tail.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional, Sequence, Union

import torch

from pathfinder_tpu_torch.models.protocol import LogDensity
from pathfinder_tpu_torch.parallel.sharding import (
    DIM_AXIS,
    Mesh,
    device_list,
    run_row_groups,
)
from pathfinder_tpu_torch.utils.rows import row_target

__all__ = ["DIM_AXIS", "DimArray", "DimSharding", "dim_mesh", "dim_sharding_for", "shard_dim",
           "dim_map"]


def dim_mesh(devices=None) -> Mesh:
    """A 1-D mesh with a ``dim`` axis over ``devices`` (torch devices or
    their names, which may repeat), by default every CUDA device; without
    CUDA the default raises."""
    return Mesh(device_list(devices, "dim_mesh"), (DIM_AXIS,))


@dataclasses.dataclass(frozen=True)
class DimArray:
    """A leaf placed on a ``dim`` mesh: with ``split`` its row blocks along
    the leading axis, in rank order, block ``j`` on the mesh's ``j``-th
    device; without, one copy of the whole leaf on each device."""

    blocks: tuple
    mesh: Mesh
    split: bool

    @property
    def shape(self) -> tuple:
        head = tuple(self.blocks[0].shape)
        return (sum(b.shape[0] for b in self.blocks),) + head[1:] if self.split else head

    def gather(self, device=None) -> torch.Tensor:
        """The whole leaf on ``device`` (default: the mesh's first)."""
        device = self.mesh.devices.flat[0] if device is None else torch.device(device)
        if not self.split:
            return self.blocks[0].to(device)
        return torch.cat([b.to(device) for b in self.blocks])


@dataclasses.dataclass(frozen=True)
class DimSharding:
    """Where a leaf goes on ``mesh``: its leading axis split into one
    contiguous row block per mesh entry (``split``), or replicated."""

    mesh: Mesh
    split: bool

    def place(self, leaf: torch.Tensor) -> DimArray:
        devices = list(self.mesh.devices.flat)
        if not self.split:
            return DimArray(tuple(leaf.to(d, copy=True) for d in devices), self.mesh, False)
        n = len(devices)
        if leaf.shape[0] % n:
            raise ValueError(f"a leading axis of {leaf.shape[0]} does not split over {n} devices")
        rows = leaf.shape[0] // n
        return DimArray(tuple(leaf[j * rows:(j + 1) * rows].to(d, copy=True).contiguous()
                              for j, d in enumerate(devices)), self.mesh, True)


def dim_sharding_for(mesh: Mesh, leaf) -> DimSharding:
    """The placement that splits the leading axis of ``leaf`` over the
    ``dim`` axis (0-d leaves replicate). It splits whatever axis 0 is: which
    leaves are the parameter dimension is :func:`shard_dim`'s rule."""
    return DimSharding(mesh, torch.as_tensor(leaf).ndim > 0)


def _leaves(tree) -> list:
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_dim(tree, mesh: Mesh, dim: Optional[int] = None):
    """Place a tree (tuples, lists and dicts of tensors) on ``mesh``: every
    leaf whose leading axis equals ``dim`` as row blocks on the mesh's
    devices, every other leaf replicated on each of them (:class:`DimArray`).

    ``dim`` defaults to the largest leading axis that divides over the mesh
    and is longer than 1; m×m cores and scalars then replicate. An explicit
    ``dim`` the mesh cannot divide, or one that matches no leaf, raises
    ``ValueError`` (either would replicate every leaf); a default that finds
    no leaf warns that everything is replicated."""
    n_dev = mesh.size
    leaves = [torch.as_tensor(x) for x in _leaves(tree)]
    if dim is not None and dim % n_dev != 0:
        raise ValueError(
            f"dim={dim} is not divisible by the {n_dev}-device mesh; pad the parameter "
            f"dimension to a multiple of {n_dev} (e.g. torch.nn.functional.pad) or use a "
            "divisible mesh."
        )
    if dim is None:
        sizes = [x.shape[0] for x in leaves if x.ndim >= 1 and x.shape[0] % n_dev == 0
                 and x.shape[0] > 1]
        dim = max(sizes) if sizes else -1
        if dim == -1:
            warnings.warn(
                f"shard_dim: no leaf has a leading axis divisible by the {n_dev}-device "
                "mesh; every leaf will be REPLICATED, not sharded. Pass dim= explicitly or "
                "pad the arrays."
            )
    elif not any(x.ndim >= 1 and x.shape[0] == dim for x in leaves):
        raise ValueError(
            f"dim={dim} matches no leaf's leading axis; leading axes are "
            f"{sorted({x.shape[0] for x in leaves if x.ndim >= 1})}."
        )

    def place(leaf):
        leaf = torch.as_tensor(leaf)
        split = leaf.ndim >= 1 and leaf.shape[0] == dim
        return DimSharding(mesh, split).place(leaf)

    return _map(place, tree)


def dim_map(fn: Callable, mesh: Mesh, out_split: Union[bool, Sequence[bool]] = True) -> Callable:
    """``fn`` run on ``mesh``'s row blocks, the counterpart of jitting ``fn``
    on ``shard_dim``-placed inputs: ``dim_map(fn, mesh, out_split)(*args)``
    calls ``fn`` once a mesh entry, from a host thread of its own as member
    ``j`` of one row group, with each :class:`DimArray` argument replaced by
    its block ``j`` (or copy), each tensor moved to entry ``j``'s device and
    each ``LogDensity`` evaluated whole on the first device. Every argument
    that is split must split the same ``d``. ``out_split`` says, for ``fn``'s
    output (or each output of a tuple), whether it holds the member's rows
    (the outputs are joined as a split :class:`DimArray`) or is replicated
    (each member's copy, as an unsplit one)."""
    devices = list(mesh.devices.flat)

    def run(*args):
        split = [a for a in args if isinstance(a, DimArray) and a.split]
        dims = {a.shape[0] for a in split}
        if len(dims) > 1:
            raise ValueError(f"the split arguments split different dimensions: {sorted(dims)}")
        if any(a.mesh is not mesh for a in args if isinstance(a, DimArray)):
            raise ValueError("an argument is placed on another mesh")
        d = dims.pop() if dims else len(devices)

        def member(_, j, dev):
            def arg(a):
                if isinstance(a, DimArray):
                    return a.blocks[j]
                if isinstance(a, torch.Tensor):
                    return a.to(dev)
                if isinstance(a, LogDensity):
                    return row_target(a)
                return a

            return fn(*(arg(a) for a in args))

        outs = run_row_groups([devices], d, member)
        single = not isinstance(outs[0], tuple)
        flags = [out_split] if isinstance(out_split, bool) else list(out_split)
        per = [(o,) for o in outs] if single else outs
        if len(flags) != len(per[0]):
            raise ValueError(f"out_split names {len(flags)} outputs; fn gave {len(per[0])}")
        joined = tuple(DimArray(tuple(p[i] for p in per), mesh, flags[i])
                       for i in range(len(flags)))
        return joined[0] if single else joined

    return run

"""Which L-BFGS runs take the iteration kernel (``Iterations`` in
``ops/kernels/linesearch_kernels.py``), held on the CPU.

The kernel takes L-BFGS with the Hager-Zhang search on float32 or float64
tensors on a CUDA device, with a history of at most ``MAX_HISTORY`` pairs,
outside a row group. Everything else (CPU tensors, 16-bit dtypes, the mesh's
``dim`` axis, CG, BFGS and Newton, the other three searches) takes the plain
iteration and never counts ``launch.lbfgs_iter``. To see the route on a
machine without a card, some tests make the CPU look like a card to
``iterates`` and put a stand-in that raises in place of the kernel's batch:
a run that raises would have launched the kernel. The kernel itself is held
against the plain iteration on the card (``test_torch_lbfgs_kernel.py``).
"""

import warnings

import pytest
import torch

from hz_kernel_cases import same_bits
from lbfgs_kernel_cases import iteration_launches
from pathfinder_tpu_torch import multipathfinder, paths_dim_mesh
from pathfinder_tpu_torch.models import zoo
from pathfinder_tpu_torch.ops import lbfgs
from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


class _Launched(Exception):
    pass


class _Stand:
    def __init__(self, *a, **k):
        raise _Launched


@pytest.fixture
def card_like(monkeypatch):
    """The CPU's float32 and float64 look like a card's to the route, and
    the kernel's batch raises ``_Launched``."""
    monkeypatch.setattr(lk, "iterates", lambda device, dtype, history_length: (
        dtype in (torch.float32, torch.float64) and 0 <= history_length <= lk.MAX_HISTORY))
    monkeypatch.setattr(lk, "Iterations", _Stand)


def _target(d=8):
    return zoo.HierarchicalGaussian(d, seed=1)


def _x0(K=4, d=8, dtype=torch.float64):
    return (torch.rand(K, d, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
            * 4 - 2).to(dtype)


@pytest.mark.parametrize("device, dtype, J, takes", [
    ("cuda", torch.float64, 6, True),
    ("cuda", torch.float32, 6, True),
    ("cuda:1", torch.float64, 0, True),
    ("cuda", torch.float64, 32, True),
    ("cuda", torch.float64, 33, False),
    ("cuda", torch.bfloat16, 6, False),
    ("cuda", torch.float16, 6, False),
    ("cpu", torch.float64, 6, False),
    ("cpu", torch.float32, 6, False),
])
def test_iterates_follows_device_dtype_and_history(device, dtype, J, takes):
    """``iterates`` from the device's type, the dtype and the history's
    length alone (no card needed to ask)."""
    assert lk.iterates(device, dtype, J) is takes


def _runs():
    """(name, a call of the port) that take the plain iteration on the CPU."""
    t = _target()
    vg = t.value_and_grad
    return {
        "cpu": lambda: lbfgs.minimize_lbfgs_trace(vg, _x0(), maxiters=20),
        "bfloat16": lambda: lbfgs.minimize_lbfgs_trace(
            lambda z: tuple(v.to(torch.bfloat16) for v in vg(z.double())),
            _x0(dtype=torch.bfloat16), maxiters=20),
        "bfgs": lambda: multipathfinder(t, 50, nruns=4, maxiters=20, seed=0, device="cpu",
                                        dtype=torch.float64, optimizer="bfgs"),
        "more_thuente": lambda: lbfgs.minimize_lbfgs_trace(vg, _x0(), maxiters=20,
                                                           line_search="more_thuente"),
        "dim_mesh": lambda: multipathfinder(t, 50, nruns=4, maxiters=20, seed=0, device="cpu",
                                            dtype=torch.float64,
                                            mesh=paths_dim_mesh(1, ["cpu"] * 2)),
    }


def _bits(result):
    trace = result if isinstance(result, lbfgs.OptimizationTrace) else result.states.trace
    return [trace.xs, trace.log_densities, trace.gradients, trace.num_fn_evals, trace.num_valid]


@pytest.mark.parametrize("name", ["cpu", "bfloat16", "bfgs", "more_thuente", "dim_mesh"])
def test_plain_route_leaves_the_counter_and_the_bits(name):
    """Each run takes the plain iteration: ``launch.lbfgs_iter`` stays, and
    a repeat gives the same bits."""
    run = _runs()[name]
    before = iteration_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bad-k̂ hint, not under test here
        first, again = run(), run()
    assert iteration_launches() == before
    for a, b in zip(_bits(first), _bits(again)):
        assert same_bits(a, b)


@pytest.mark.parametrize("name", ["bfgs", "more_thuente", "dim_mesh"])
def test_plain_route_where_the_tensors_would_take_the_kernel(card_like, name):
    """With the CPU looking like a card, BFGS, the Moré-Thuente search and a
    row group still take the plain iteration."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _runs()[name]()


def test_kernel_route_where_the_tensors_take_it(card_like):
    """With the CPU looking like a card, L-BFGS with the Hager-Zhang search
    reaches the kernel's batch, from ``minimize_lbfgs_trace`` and from
    ``multipathfinder``'s default optimizer."""
    with pytest.raises(_Launched):
        lbfgs.minimize_lbfgs_trace(_target().value_and_grad, _x0(), maxiters=20)
    with pytest.raises(_Launched):
        multipathfinder(_target(), 50, nruns=4, maxiters=20, seed=0, device="cpu",
                        dtype=torch.float64)

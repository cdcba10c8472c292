"""The L-BFGS iteration kernel (``lbfgs_iter_kernel`` of
``csrc/linesearch_kernels.cu``) on the card, against the plain iteration it
replaces.

Every test here needs a CUDA card and skips with a reason without one. The
file imports no JAX, so it runs on a machine with the card and without JAX,
where ``tests/conftest.py`` (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lbfgs_kernel.py

The crafted batches and the checks, with the tolerances of the numbers that
are sums over ``d``, live in ``lbfgs_kernel_cases.py``; which runs take the
kernel is held on the CPU by ``test_torch_lbfgs_route.py``.
"""

import pytest
import torch

from lbfgs_kernel_cases import SHAPES, check_iteration, check_progress, check_run, check_start

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card"),
]

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
SHAPE_IDS = [f"K{K}-d{d}-J{J}" for K, d, J in SHAPES]


@DTYPES
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_lbfgs_kernel_matches_the_plain_iteration_on_the_card(shape, dtype):
    """One launch against the plain iteration on a crafted batch whose lanes
    are frozen, at their first iteration, rejecting the curvature pair, at
    ``hlen < J``, with ``pos`` wrapping, aborting on a non-finite gradient,
    converged, stalled or after an exhausted search: integers, booleans,
    trace, history rows, search state and trial point bit for bit; the
    direction, diagonal, step and dφ(0) to rounding."""
    check_iteration(*shape, dtype)


@DTYPES
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_lbfgs_kernel_start_matches_the_plain_start_on_the_card(shape, dtype):
    """A launch in start mode against the plain start: the run mask, the
    first direction bit for bit, ``initial_step_size`` to rounding, the first
    search's state and trial point."""
    check_start(*shape, dtype)


def test_lbfgs_kernel_run_on_the_hierarchical_posterior_on_the_card():
    """L-BFGS at K = 16, d = 1000 in float64 on the benchmark's hierarchical
    posterior, both kernels against neither: the same optimum and the same
    first points to 1e-10 relative, the valid points and evaluations in all
    within 2%, and ``launch.lbfgs_iter`` one a search plus the start's."""
    check_run()


def test_lbfgs_kernel_prints_the_progress_lines_on_the_card(capsys):
    """``progress_every`` on the kernel's route: the plain loop's lines, one
    a lane at each iteration divisible by it, with the trace's ``logp``."""
    assert check_progress(capsys) > 0

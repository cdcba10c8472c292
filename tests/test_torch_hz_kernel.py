"""The Hager-Zhang state-update kernel (``csrc/linesearch_kernels.cu``) on
the card, against its plain version ``ops/linesearch._hz_step_torch``.

Every test here needs a CUDA card and skips with a reason without one. The
file imports no JAX, so it runs on a machine with the card and without JAX,
where ``tests/conftest.py`` (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_hz_kernel.py

The checks and the line-search problems live in ``hz_kernel_cases.py``;
``test_torch_linesearch.py`` holds the problems' searches against the JAX
package's, and the route and the launch count on CPU tensors.
"""

import pytest
import torch

from hz_kernel_cases import PROBLEMS, SMALL, check_lbfgs, check_steps, count_launches

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card"),
]


def test_hz_kernel_launches_once_an_evaluation_on_the_card():
    """``launch.hz_step`` counts one launch for each evaluation of a search
    on the card."""
    n, calls = count_launches("cuda")
    assert calls > 1
    assert n == calls


@pytest.mark.parametrize("budget", ["full", "small"])
@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_hz_kernel_matches_the_plain_step_on_the_card(dtype, name, budget):
    """The kernel against ``_hz_step_torch`` from the same inputs, every
    lane of every ``ALPHA0S``: after each evaluation every state entry, the
    trial point and the flag bit for bit, then every ``LineSearchResult``
    field; with the full budget, and with 3 evaluations and inactive lanes."""
    check_steps(name, dtype, **(SMALL if budget == "small" else {}))


def test_hz_kernel_lbfgs_on_the_hierarchical_posterior_on_the_card():
    """L-BFGS at K = 16, d = 1000 in float64 on the benchmark's hierarchical
    posterior: the trace, ``num_fn_evals`` and ``num_valid`` with the kernel
    equal those with the plain step bit for bit."""
    check_lbfgs()

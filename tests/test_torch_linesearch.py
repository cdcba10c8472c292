"""Parity of the port's batched line searches with the JAX package's.

Each search (Hager-Zhang, Moré-Thuente, strong-Wolfe bracket and zoom,
backtracking) runs on the same problems in f64: a 1-D quartic, a 1-D
objective that is NaN beyond x = 1 (a pocket the trial steps fall into), and
an ill-conditioned d = 8 objective. The lanes of one batch are different
initial steps (and directions), so lanes finish at different evaluation
counts and the finished ones must stay frozen. Evaluation counts and flags
are equal. Step sizes and values agree to ``rtol=1e-9``: the state machines
are the same, but a secant or cubic step divides differences of nearly
equal numbers, which magnifies the last-bit differences between XLA's and
torch's arithmetic.

The problems live in ``hz_kernel_cases.py``, with the checks of the
Hager-Zhang state-update kernel against its plain version that
``test_torch_hz_kernel.py`` runs on the card (bit for bit, without JAX).
"""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from hz_kernel_cases import ALPHA0S, PROBLEMS, count_launches, search_inputs
from hz_kernel_cases import problems as _problems
from pathfinder_tpu.ops import linesearch as jls
from pathfinder_tpu_torch.ops import linesearch as tls
from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

SEARCHES = ["hager_zhang", "more_thuente", "wolfe", "backtracking"]


def _run_jax(search, name, **kw):
    f, x, p = _problems(jnp)[name]
    vg = jax.value_and_grad(f)
    x = jnp.asarray(x)
    f0, g0 = vg(x)
    p = -g0 if p is None else jnp.asarray(p)
    fn = getattr(jls, f"{search}_line_search")
    run = jax.vmap(lambda a0: fn(vg, x, f0, g0, p, a0, c1=jls.resolve_c1(None, search), **kw))
    return run(jnp.asarray(ALPHA0S))


def _run_torch(search, name, active=None, **kw):
    vg, xs, f0, g0, ps, alpha0 = search_inputs(name)
    fn = getattr(tls, f"{search}_line_search")
    return fn(vg, xs, f0, g0, ps, alpha0, c1=tls.resolve_c1(None, search), active=active, **kw)


@pytest.mark.parametrize("name", PROBLEMS)
@pytest.mark.parametrize("search", SEARCHES)
def test_search_matches_jax(search, name):
    jr, tr = _run_jax(search, name), _run_torch(search, name)
    np.testing.assert_array_equal(tr.num_evals.numpy(), np.asarray(jr.num_evals))
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    np.testing.assert_array_equal(
        tr.exhausted.numpy(), np.broadcast_to(np.asarray(jr.exhausted), (len(ALPHA0S),)))
    np.testing.assert_allclose(tr.step_size.numpy(), np.asarray(jr.step_size), rtol=1e-9)
    np.testing.assert_allclose(tr.f.numpy(), np.asarray(jr.f), rtol=1e-9)
    np.testing.assert_allclose(tr.g.numpy(), np.asarray(jr.g), rtol=1e-8, atol=1e-9)
    assert torch.isfinite(tr.f).all() and torch.isfinite(tr.g).all()


@pytest.mark.parametrize("search", SEARCHES)
def test_small_budget_and_inactive_lanes(search):
    """With 3 evaluations most lanes run out and take their fallback, as in
    JAX; a lane that is not active does no work and keeps the start."""
    jr, tr = _run_jax(search, "valley", max_evals=3), _run_torch(search, "valley", max_evals=3)
    np.testing.assert_array_equal(tr.num_evals.numpy(), np.asarray(jr.num_evals))
    np.testing.assert_array_equal(tr.ok.numpy(), np.asarray(jr.ok))
    np.testing.assert_allclose(tr.step_size.numpy(), np.asarray(jr.step_size), rtol=1e-9)
    active = torch.tensor([True, False, True, False, True])
    full, part = _run_torch(search, "valley"), _run_torch(search, "valley", active=active)
    assert part.num_evals[~active].tolist() == [0, 0]
    assert part.step_size[~active].tolist() == [0.0, 0.0] and not part.ok[~active].any()
    assert torch.equal(part.step_size[active], full.step_size[active])
    assert torch.equal(part.num_evals[active], full.num_evals[active])


def test_the_pocket_is_really_entered():
    """The NaN problem does make trial steps land where f is NaN."""
    f, x, p = _problems(torch)["pocket"]
    assert torch.isnan(f(torch.tensor(x) + 7.0 * torch.tensor(p)))
    tr = _run_torch("hager_zhang", "pocket")
    assert tr.ok.all() and (tr.step_size < 1.0).all() and (tr.num_evals > 1).any()


def test_resolve_line_search_and_c1_match_jax():
    for name in SEARCHES:
        assert tls.resolve_line_search(name) is getattr(tls, f"{name}_line_search")
        assert tls.resolve_c1(None, name) == jls.resolve_c1(None, name)
        assert tls.resolve_c1(0.3, name) == 0.3
    with pytest.raises(ValueError) as jerr:
        jls.resolve_line_search("golden")
    with pytest.raises(ValueError) as terr:
        tls.resolve_line_search("golden")
    assert str(terr.value) == str(jerr.value)


def test_hz_state_update_route():
    """Each Hager-Zhang evaluation's state update takes the kernel for
    float32 and float64 on a CUDA device, and the plain version for every
    other device and dtype."""
    for dtype in (torch.float32, torch.float64):
        assert lk.takes("cuda", dtype) and lk.takes(torch.device("cuda", 1), dtype)
        assert not lk.takes("cpu", dtype) and not lk.takes(torch.device("meta"), dtype)
    for dtype in (torch.float16, torch.bfloat16, torch.int64):
        assert not lk.takes("cuda", dtype) and not lk.takes("cpu", dtype)


def test_hz_kernel_layout_is_the_sources():
    """The wrapper's rows of the state tensor and the plain version's stage
    codes are the CUDA source's enums."""
    text = lk._SOURCE.read_text()
    fields = re.search(r"enum Field : int \{([^}]*)\}", text).group(1)
    names = [n.strip() for n in fields.split(",") if n.strip()]
    assert names[-1] == "kFields"
    snake = ["_".join(w.lower() for w in re.findall(r"[A-Z][a-z0-9]*", n[1:])) for n in names[:-1]]
    assert tuple(snake) == lk.FIELDS + lk.CONSTANTS
    stages = dict(re.findall(r"(k[A-Za-z0-9]+) = (\d+)", re.search(
        r"enum Stage : int64_t \{([^}]*)\}", text).group(1)))
    assert {k: int(v) for k, v in stages.items()} == {
        "kBracket": tls._HZ_BRACKET, "kU3": tls._HZ_U3, "kSecant1": tls._HZ_SECANT1,
        "kSecant2": tls._HZ_SECANT2, "kBisectG": tls._HZ_BISECT_G, "kDone": tls._HZ_DONE}


@pytest.mark.parametrize("device", ["cpu"])
def test_hz_kernel_launches_once_an_evaluation(device):
    """``launch.hz_step`` counts no launch for a search on CPU tensors
    (``test_torch_hz_kernel.py`` counts one an evaluation on the card)."""
    n, calls = count_launches(device)
    assert calls > 1
    assert n == 0

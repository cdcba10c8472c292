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
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops import linesearch as jls
from pathfinder_tpu_torch.ops import linesearch as tls

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

SEARCHES = ["hager_zhang", "more_thuente", "wolfe", "backtracking"]
ALPHA0S = [1.0, 1e-3, 0.3, 7.0, 60.0]
LAM = np.logspace(-2, 2, 8)


def _problems(xp):
    """name -> (f, x, direction) with ``f`` written for ``xp`` (jnp or torch)."""
    def quartic(x):
        return ((x - 2.0) ** 4 + x**2).sum(-1)

    def pocket(x):  # NaN where x >= 1
        return (-xp.log(1.0 - x) + (x - 3.0) ** 2).sum(-1)

    lam = xp.asarray(LAM) if xp is jnp else torch.tensor(LAM)

    def valley(x):
        return 0.5 * (lam * x * x).sum(-1) + xp.cos(x).sum(-1) + 0.1 * ((x**2).sum(-1)) ** 2

    rng = np.random.default_rng(0)
    x8 = rng.standard_normal(8)
    return {
        "quartic": (quartic, np.array([-1.0]), None),
        "pocket": (pocket, np.array([0.0]), np.array([1.0])),
        "pocket_descent": (pocket, np.array([0.9]), None),
        "valley": (valley, x8, None),
        "valley_skewed": (valley, x8, -x8 / LAM**0.5),
    }


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
    f, x, p = _problems(torch)[name]

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            val = f(z)
            (g,) = torch.autograd.grad(val.sum(), z)
        return val.detach(), g

    K = len(ALPHA0S)
    xs = torch.tensor(x).expand(K, -1).contiguous()
    f0, g0 = vg(xs)
    ps = -g0 if p is None else torch.tensor(p).expand(K, -1).contiguous()
    fn = getattr(tls, f"{search}_line_search")
    return fn(vg, xs, f0, g0, ps, torch.tensor(ALPHA0S, dtype=torch.float64), c1=tls.resolve_c1(None, search),
              active=active, **kw)


@pytest.mark.parametrize("name", ["quartic", "pocket", "pocket_descent", "valley", "valley_skewed"])
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

"""Tree-parameterized targets in the port (the counterpart of
``tests/test_pytree_target.py``): the flat log density equals the JAX
package's on the same flat vectors to 1e-12 (both lay a dict out by sorted
key), ``ravel``/``unravel`` invert each other, and both entry points run on
the flat target.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import from_pytree_logp as jfrom_pytree_logp
from pathfinder_tpu_torch import multipathfinder, pathfinder
from pathfinder_tpu_torch.models import PytreeTarget, from_pytree_logp

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


DATA = [1.1, 0.9, 1.3, 0.8, 1.0]
CPU = dict(device="cpu", dtype=torch.float64)


def _jax_logp_tree(params):
    data = jnp.asarray(DATA)
    mu, log_sigma = params["mu"], params["log_sigma"]
    loglik = -0.5 * jnp.sum(((data[:, None] - mu[None, :]) / jnp.exp(log_sigma)) ** 2)
    loglik = loglik - data.size * 3 * log_sigma
    return loglik - 0.5 * jnp.sum(mu**2) / 100.0 - 0.5 * log_sigma**2


def _logp_tree(params):
    """The same density over a batch: ``mu (K, 3)``, ``log_sigma (K,)``."""
    data = torch.tensor(DATA, dtype=params["mu"].dtype)
    mu, log_sigma = params["mu"], params["log_sigma"]
    z = (data[None, :, None] - mu[:, None, :]) / torch.exp(log_sigma)[:, None, None]
    loglik = -0.5 * (z**2).sum((1, 2)) - len(DATA) * 3 * log_sigma
    return loglik - 0.5 * (mu**2).sum(-1) / 100.0 - 0.5 * log_sigma**2


def test_pytree_target_matches_jax_and_roundtrips():
    # the example's dict order is not sorted: the layout sorts it, as JAX does
    pt = from_pytree_logp(_logp_tree, {"mu": torch.zeros(3), "log_sigma": torch.tensor(0.0)})
    jpt = jfrom_pytree_logp(_jax_logp_tree, {"mu": jnp.zeros(3), "log_sigma": jnp.asarray(0.0)})
    assert isinstance(pt, PytreeTarget) and pt.target.dim == jpt.target.dim == 4
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (6, 4))
    want = np.asarray(jax.vmap(jpt.target.logp)(jnp.asarray(x)))
    np.testing.assert_allclose(pt.target.logp(torch.tensor(x)).numpy(), want, rtol=1e-12)
    tree = pt.unravel(torch.tensor(x[0]))
    jtree = jpt.unravel(jnp.asarray(x[0]))
    for k in ("mu", "log_sigma"):
        assert tree[k].shape == jtree[k].shape
        np.testing.assert_array_equal(tree[k].numpy(), np.asarray(jtree[k]))
    assert torch.equal(pt.ravel(tree), torch.tensor(x[0]))
    batched = pt.unravel(torch.tensor(x))
    assert batched["mu"].shape == (6, 3) and batched["log_sigma"].shape == (6,)
    assert torch.equal(pt.example_flat, torch.zeros(4))
    # tuples and lists nest as JAX's do
    nested = from_pytree_logp(lambda p: p[0].sum(-1) + p[1][0].sum((-2, -1)),
                              (torch.zeros(2), [torch.zeros(2, 2)]))
    assert nested.target.dim == 6
    t = nested.unravel(torch.arange(6.0))
    assert isinstance(t, tuple) and isinstance(t[1], list) and t[1][0].shape == (2, 2)
    assert torch.equal(nested.ravel(t), torch.arange(6.0))


def test_pytree_target_fit():
    pt = from_pytree_logp(_logp_tree, {"mu": torch.zeros(3), "log_sigma": torch.tensor(0.0)})
    res = pathfinder(pt.target, seed=0, ndraws=50, maxiters=60, **CPU)
    assert res.success
    draws = pt.unravel_draws(res.draws)
    assert draws["mu"].shape == (50, 3) and draws["log_sigma"].shape == (50,)
    # the posterior of mu concentrates near the data mean
    np.testing.assert_allclose(draws["mu"].mean(0).numpy(), np.full(3, np.mean(DATA)), atol=0.3)


def test_pytree_target_multipath():
    pt = from_pytree_logp(lambda p: -0.5 * (p["a"] ** 2).sum((-2, -1)) - 0.5 * (p["b"] ** 2).sum(-1),
                          {"a": torch.zeros(2, 2), "b": torch.zeros(3)})
    assert pt.target.dim == 7
    res = multipathfinder(pt.target, 100, seed=1, nruns=4, maxiters=30, **CPU)
    assert res.draws.shape == (7, 100)
    td = pt.unravel_draws(res.draws)
    assert td["a"].shape == (100, 2, 2) and td["b"].shape == (100, 3)

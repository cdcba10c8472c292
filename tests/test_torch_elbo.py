"""Parity of the port's chunked ELBO maximization with the JAX package's.

The JAX core runs a few paths; its traces are carried into the port with
``interop.trace_from_numpy`` and its per-candidate noise
(``jax.random.normal(fold_in(key_elbo, i), (d, 5))``, as
``ops/elbo.py`` draws it) is injected. Per-candidate ELBO values agree to
``rtol=1e-8`` in f64 (same arithmetic, other summation order) and the winner
index is equal. Also the NaN / −Inf semantics of ``findmax_skipnan``.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models.zoo import HierarchicalGaussian as JHier
from pathfinder_tpu.parallel.sharding import make_path_executor
from pathfinder_tpu.singlepath import PathfinderConfig as JConfig
from pathfinder_tpu.utils.misc import findmax_skipnan as jfindmax
from pathfinder_tpu_torch.interop import trace_from_numpy
from pathfinder_tpu_torch.models.zoo import HierarchicalGaussian
from pathfinder_tpu_torch.ops.elbo import maximize_elbo_chunked
from pathfinder_tpu_torch.ops.lbfgs import lbfgs_history_aux
from pathfinder_tpu_torch.singlepath import candidate_dists
from pathfinder_tpu_torch.utils.misc import findmax_skipnan

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


def test_elbo_values_and_winner_match_jax_with_injected_noise():
    d, K, L, N, chunk = 16, 3, 24, 5, 8
    jt = JHier(d, seed=1)
    cfg = JConfig(maxiters=L, ndraws_elbo=N, ndraws=N, elbo_chunk=chunk)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(K))
    x0s = jnp.asarray(np.random.default_rng(3).uniform(-2, 2, (K, d)))
    st = jax.jit(make_path_executor(None), static_argnums=(2, 3))(keys, x0s, jt, cfg)

    noise = np.zeros((K, L, d, N))
    for k in range(K):
        key_elbo, _ = jax.random.split(keys[k])
        for i in range(L):
            noise[k, i] = np.asarray(jax.random.normal(
                jax.random.fold_in(key_elbo, i), (d, N), dtype=jnp.float64
            ))
    noise_t = torch.tensor(noise)

    tr = trace_from_numpy(st.trace.xs, st.trace.log_densities, st.trace.gradients, st.trace.num_valid)
    aux = lbfgs_history_aux(tr)
    lanes = torch.arange(K)[:, None]
    best, vals, ses, best_val = maximize_elbo_chunked(
        HierarchicalGaussian(d, seed=1).logp,
        candidate_dists(tr, aux, 6),
        lambda idx: noise_t[lanes, torch.clamp(idx, max=L - 1)],
        num_candidates=L,
        chunk_size=chunk,
        valid_mask=aux.point_mask[:, 1:],
        dtype=torch.float64,
    )
    jv = np.asarray(st.elbo_values)
    np.testing.assert_array_equal(np.isnan(vals.numpy()), np.isnan(jv))
    np.testing.assert_allclose(vals.numpy(), jv, rtol=1e-8)
    np.testing.assert_allclose(ses.numpy(), np.asarray(st.elbo_se), rtol=1e-7)
    np.testing.assert_array_equal(best.numpy() + 1, np.asarray(st.fit_iteration))
    assert np.isfinite(jv).sum(axis=1).min() > 3


@pytest.mark.parametrize(
    "values",
    [
        [1.0, 3.0, 3.0, 2.0],
        [math.nan, 2.0, math.nan, 5.0],
        [math.nan, math.nan, math.nan],
        [math.nan, -math.inf, -math.inf],
        [-math.inf, math.nan, -math.inf],
        [math.inf, 1.0, math.inf],
        [-1.0, -math.inf, math.nan, -1.0],
    ],
)
def test_findmax_skipnan_matches_jax(values):
    jv, ji = jfindmax(jnp.asarray(values))
    tv, ti = findmax_skipnan(torch.tensor(values, dtype=torch.float64))
    assert int(ti) == int(ji)
    np.testing.assert_array_equal(float(tv), float(jv))


def test_findmax_skipnan_batched_with_mask():
    vals = torch.tensor([[1.0, 5.0, 2.0], [math.nan, 3.0, 4.0]], dtype=torch.float64)
    mask = torch.tensor([[True, False, True], [True, True, False]])
    v, i = findmax_skipnan(vals, mask)
    for r in range(2):
        jv, ji = jfindmax(jnp.asarray(vals[r].numpy()), jnp.asarray(mask[r].numpy()))
        assert int(i[r]) == int(ji) and float(v[r]) == float(jv)

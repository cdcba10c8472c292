"""Parity of the port's PSIS and resampling with the JAX package's.

PSIS takes the same log ratios (seeded numpy, with NaN, +inf and tied
entries) in f64: weights and k̂ agree to 1e-10. Resampling gets the JAX
package's own uniforms / Gumbel noise injected and must pick the same
indices.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops.psis import psis as jpsis
from pathfinder_tpu.ops.resample import resample_indices as jresample
from pathfinder_tpu_torch.ops.psis import pareto_k_verdict, psis
from pathfinder_tpu_torch.ops.resample import resample_draws, resample_indices
from pathfinder_tpu_torch.utils.rng import RESAMPLE, Stream


def _ratios(case, S=400):
    rng = np.random.default_rng(len(case) + S)
    lr = rng.standard_normal(S) * 2.0
    if case == "heavy":
        lr = rng.standard_t(2, S) * 3.0
    elif case == "nan_inf":
        lr[[3, 7, S - 2]] = np.nan
        lr[[10, 11]] = np.inf
    elif case == "ties":
        lr = np.round(lr, 1)
        lr[-40:] = lr.max()
    elif case == "all_nan":
        lr[:] = np.nan
    return lr


@pytest.mark.parametrize("case", ["normal", "heavy", "nan_inf", "ties", "all_nan"])
@pytest.mark.parametrize("S", [20, 400, 1000])
def test_psis_matches_jax(case, S):
    lr = _ratios(case, S)
    j = jpsis(jnp.asarray(lr))
    t = psis(torch.tensor(lr))
    np.testing.assert_allclose(t.log_weights.numpy(), np.asarray(j.log_weights), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(t.pareto_shape), float(j.pareto_shape), rtol=1e-10)
    assert t.tail_length == j.tail_length
    assert t.diagnosis == j.diagnosis == pareto_k_verdict(float(j.pareto_shape))


@pytest.mark.parametrize("weighted", [True, False])
def test_resample_with_replacement_matches_jax(weighted):
    total, ndraws = 300, 500
    lw = jnp.asarray(_ratios("heavy", total)) if weighted else None
    key = jax.random.key(5)
    want = jresample(key, total, ndraws, lw, replace=True)
    if weighted:
        u = jax.random.uniform(key, (ndraws,), dtype=jnp.float64)
        got = resample_indices(None, total, ndraws, torch.tensor(np.asarray(lw)), u=torch.tensor(np.asarray(u)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        # JAX's randint has no uniform to inject: check the range and spread
        u = torch.tensor(np.random.default_rng(0).uniform(size=ndraws))
        got = resample_indices(None, total, ndraws, u=u)
        assert got.min() >= 0 and got.max() < total and len(set(got.tolist())) > total / 2


def test_resample_without_replacement_gumbel_top_k_matches_jax():
    total, ndraws = 300, 40
    lw = jnp.asarray(_ratios("ties", total))
    key = jax.random.key(9)
    want = jresample(key, total, ndraws, lw, replace=False)
    g = jax.random.gumbel(key, (total,), dtype=jnp.float64)
    got = resample_indices(
        None, total, ndraws, torch.tensor(np.asarray(lw)), replace=False,
        gumbel=torch.tensor(np.asarray(g)),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        lw_t = torch.full((5,), -torch.inf, dtype=torch.float64)
        lw_t[0] = 0.0
        resample_indices(None, 5, 2, lw_t, replace=False, gumbel=torch.zeros(5))


def test_resample_draws_pools_component_major():
    K, N, d = 4, 3, 2
    pool = torch.arange(K * N * d, dtype=torch.float64).reshape(K, N, d)
    res = psis(torch.zeros(K * N, dtype=torch.float64))
    draws, ids = resample_draws(Stream(0, 0, 0, RESAMPLE), pool, res, 50)
    flat = pool.reshape(K * N, d)
    for j in range(50):
        row = int(draws[0, j]) // d
        assert torch.equal(draws[:, j], flat[row]) and ids[j] == row // N

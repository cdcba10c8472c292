"""Parity of the port's batched L-BFGS + Hager-Zhang with the JAX package's
``minimize_lbfgs_trace`` under ``vmap``, and of the inverse-Hessian fits.

Same ``x0`` (seeded numpy) and same target data in f64. Trajectories agree
to ``rtol=1e-8`` (the same algorithm, sums taken in another order); the
discrete outcomes (valid points, per-lane evaluation counts, rejections,
exhausted searches) are equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.ops import lbfgs as jl
from pathfinder_tpu_torch.interop import trace_from_numpy
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.ops import lbfgs as tl

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

MAXITERS = 40
K = 6


def _targets(name, d):
    if name == "hierarchical":
        return jzoo.HierarchicalGaussian(d, seed=3), tzoo.HierarchicalGaussian(d, seed=3)
    return jzoo.StandardNormal(d), tzoo.StandardNormal(d)


@pytest.fixture(scope="module", params=["hierarchical", "standard_normal"])
def both_traces(request):
    d = 16
    jt, tt = _targets(request.param, d)
    x0s = np.random.default_rng(11).uniform(-2.0, 2.0, (K, d))
    run = jax.jit(jax.vmap(
        lambda x0: jl.minimize_lbfgs_trace(jt.value_and_grad, x0, maxiters=MAXITERS)
    ))
    jtr = run(jnp.asarray(x0s))
    ttr = tl.minimize_lbfgs_trace(tt.value_and_grad, torch.tensor(x0s), maxiters=MAXITERS)
    return jtr, ttr


def test_trajectories_and_counts_match_jax(both_traces):
    jtr, ttr = both_traces
    nv = np.asarray(jtr.num_valid)
    np.testing.assert_array_equal(ttr.num_valid.numpy(), nv)
    np.testing.assert_array_equal(ttr.num_fn_evals.numpy(), np.asarray(jtr.num_fn_evals))
    np.testing.assert_array_equal(
        ttr.num_bfgs_updates_rejected.numpy(), np.asarray(jtr.num_bfgs_updates_rejected)
    )
    np.testing.assert_array_equal(
        ttr.num_ls_exhausted.numpy(), np.asarray(jtr.num_ls_exhausted)
    )
    assert nv.min() > 2  # the lanes really iterate
    for k in range(K):
        n = nv[k]
        np.testing.assert_allclose(
            ttr.xs[k, :n].numpy(), np.asarray(jtr.xs[k, :n]), rtol=1e-8, atol=1e-10
        )
        np.testing.assert_allclose(
            ttr.log_densities[k, :n].numpy(), np.asarray(jtr.log_densities[k, :n]), rtol=1e-8
        )
        np.testing.assert_allclose(
            ttr.gradients[k, :n].numpy(), np.asarray(jtr.gradients[k, :n]), rtol=1e-8, atol=1e-8
        )


def test_fits_from_a_jax_trace_match_jax(both_traces):
    jtr, _ = both_traces
    J = 6
    tr = trace_from_numpy(
        jtr.xs, jtr.log_densities, jtr.gradients, jtr.num_valid,
        jtr.num_bfgs_updates_rejected, jtr.num_fn_evals,
    )
    aux = tl.lbfgs_history_aux(tr)
    L = MAXITERS
    points = torch.arange(L + 1).expand(K, L + 1)
    fits = tl.lbfgs_fits_at(aux, points, J)
    np.testing.assert_array_equal(aux.num_rejected.numpy(), np.asarray(jtr.num_bfgs_updates_rejected))
    v = np.random.default_rng(2).standard_normal((16, 2))
    for k in range(K):
        one = jax.tree_util.tree_map(lambda leaf: leaf[k], jtr)
        jaux = jl.lbfgs_history_aux(one)
        jfits = jl.lbfgs_fits_at(jaux, jnp.arange(L + 1), J)
        n = int(jtr.num_valid[k])
        # compare at the valid points (padding points rebuild from zeros)
        np.testing.assert_allclose(
            fits.A[k, :n].numpy(), np.asarray(jfits.A[:n]), rtol=1e-10
        )
        np.testing.assert_allclose(
            fits.logdet()[k, :n].numpy(), np.asarray(jfits.logdet()[:n]), rtol=1e-9, atol=1e-12
        )
        got = fits.mul(torch.tensor(v).expand(L + 1, 16, 2))[k, :n].numpy()
        want = np.asarray(jax.vmap(lambda w: w.mul(jnp.asarray(v)))(jfits))[:n]
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_history_windows_match_jax():
    accept = np.array([[1, 0, 1, 1, 0, 1, 1, 1, 0, 1], [0, 0, 1, 1, 1, 1, 1, 1, 1, 1]], bool)
    J = 3
    for k in range(2):
        jidx, jmask = jl.history_windows(jnp.asarray(accept[k]), J)
        acc_list, c_points = tl._accept_index(torch.tensor(accept))
        points = torch.arange(11).expand(2, 11)
        idx, mask = tl._windows_at(acc_list, c_points, points, J)
        np.testing.assert_array_equal(mask[k].numpy(), np.asarray(jmask))
        np.testing.assert_array_equal(idx[k].numpy(), np.asarray(jidx))


def test_gilbert_init_matches_jax():
    rng = np.random.default_rng(4)
    alpha, s, y = rng.uniform(0.5, 2, 9), rng.standard_normal(9), rng.standard_normal(9)
    np.testing.assert_allclose(
        tl.gilbert_init(torch.tensor(alpha)[None], torch.tensor(s)[None], torch.tensor(y)[None])[0].numpy(),
        np.asarray(jl.gilbert_init(jnp.asarray(alpha), jnp.asarray(s), jnp.asarray(y))),
        rtol=1e-12,
    )


def test_nonfinite_start_aborts_like_jax():
    """A lane starting where logp is NaN stops at once; the others run."""
    tt = tzoo.StandardNormal(4)

    def logp(x):
        out = tt.logp(x)
        return torch.where(x[:, 0] > 10, torch.nan, out)

    from pathfinder_tpu_torch.models.protocol import LogDensity

    x0 = torch.tensor([[11.0, 0, 0, 0], [1.0, 1, 1, 1]], dtype=torch.float64)
    tr = tl.minimize_lbfgs_trace(LogDensity(logp, 4).value_and_grad, x0, maxiters=10)
    assert tr.num_valid.tolist()[0] == 1 and tr.num_fn_evals.tolist()[0] == 1
    assert tr.num_valid.tolist()[1] > 1

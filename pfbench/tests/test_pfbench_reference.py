"""The plain reference on small fixed inputs: its PSIS, its fits and its
log densities against independent computations, and against a float64 run
of the program, where every gap is rounding."""

import math

import numpy as np
import pytest
import torch

from reference import pathfinder as pf
from reference.check import readings
from reference.precision import Prec, tf32_round
from reference.psis import psis

F64 = Prec("f64")


@pytest.mark.parametrize("S,scale", [(1000, 1.0), (1000, 3.0), (40960, 2.0), (12, 1.0)])
def test_psis_matches_the_programs(S, scale):
    from pathfinder_tpu_torch.ops.psis import psis as program_psis

    rng = np.random.default_rng(S)
    lr = rng.standard_normal(S) * scale
    lw, k = psis(lr)
    ours = program_psis(torch.as_tensor(lr, dtype=torch.float64))
    assert np.allclose(lw, ours.log_weights.numpy(), atol=1e-10)
    if S < 25:
        assert math.isnan(k) and math.isnan(float(ours.pareto_shape))
    else:
        assert k == pytest.approx(float(ours.pareto_shape), abs=1e-10)
    assert np.exp(lw).sum() == pytest.approx(1.0)


def test_psis_of_equal_ratios_gives_equal_weights():
    lw, _ = psis(np.zeros(500))
    assert np.allclose(np.exp(lw), 1 / 500)


def test_psis_weighs_nan_nothing_and_caps_inf():
    lr = np.random.default_rng(0).standard_normal(200)
    lr[3], lr[7] = np.nan, np.inf
    lw, _ = psis(lr)
    assert lw[3] == -np.inf and lw[7] == lw[np.isfinite(lr)].max()


def _history(K=3, J=4, d=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    S = torch.randn(K, J, d, generator=g, dtype=torch.float64)
    Y = S + 0.3 * torch.randn(K, J, d, generator=g, dtype=torch.float64)  # sᵀy > 0
    alpha = torch.rand(K, d, generator=g, dtype=torch.float64) + 0.5
    mask = torch.tensor([[True] * J, [False] + [True] * (J - 1), [False] * (J - 1) + [True]])
    return alpha, S, Y, mask


def test_compact_fit_is_the_two_loop_matrix():
    alpha, S, Y, mask = _history()
    K, J, d = S.shape
    X, M = pf.compact_fit(alpha, S, Y, mask, F64)
    eye = torch.eye(d, dtype=torch.float64)
    for k in range(K):
        cols = [pf.two_loop(eye[i][None], alpha[k:k + 1], S[k:k + 1], Y[k:k + 1],
                            mask[k:k + 1], F64)[0] for i in range(d)]
        H = torch.stack(cols, 1)
        ah = alpha[k].sqrt()
        dense = ah[:, None] * (eye + X[k] @ M[k] @ X[k].T) * ah[None, :]
        assert torch.allclose(dense, H, atol=1e-10)


def test_a_fits_log_det_and_whitening_are_the_dense_normals():
    alpha, S, Y, mask = _history(K=3, J=3, d=8, seed=4)
    X, M = pf.compact_fit(alpha, S, Y, mask, F64)
    g = torch.Generator().manual_seed(5)
    mu = torch.randn(3, 8, generator=g, dtype=torch.float64)
    x = torch.randn(3, 6, 8, generator=g, dtype=torch.float64)
    ld, maha = pf.fit_logdet(alpha, X, M, F64), pf.fit_maha(mu, alpha, X, M, x, F64)
    eye = torch.eye(8, dtype=torch.float64)
    for k in range(3):
        ah = alpha[k].sqrt()
        cov = ah[:, None] * (eye + X[k] @ M[k] @ X[k].T) * ah[None, :]
        assert ld[k] == pytest.approx(float(torch.linalg.slogdet(cov)[1]), abs=1e-10)
        v = x[k] - mu[k]
        want = (v * torch.linalg.solve(cov, v.T).T).sum(-1)
        assert torch.allclose(maha[k], want, rtol=1e-10)


def test_a_factors_draws_and_covariance_are_its_dense_ones():
    g = torch.Generator().manual_seed(1)
    K, d, m, N = 2, 8, 4, 5
    a_half = torch.rand(K, d, generator=g, dtype=torch.float64) + 0.5
    X = torch.randn(K, d, m, generator=g, dtype=torch.float64) * 0.3
    C = torch.randn(K, m, m, generator=g, dtype=torch.float64) * 0.3
    mean = torch.randn(K, d, generator=g, dtype=torch.float64)
    u = torch.randn(K, d, N, generator=g, dtype=torch.float64)
    v = torch.randn(K, d, generator=g, dtype=torch.float64)
    x, cv = pf.factor_draws(mean, a_half, X, C, u, F64), pf.factor_cov_mul(a_half, X, C, v)
    eye = torch.eye(d, dtype=torch.float64)
    for k in range(K):
        L = a_half[k][:, None] * (eye + X[k] @ C[k] @ X[k].T)
        assert torch.allclose(x[k], mean[k][:, None] + L @ u[k], atol=1e-12)
        assert torch.allclose(cv[k], L @ L.T @ v[k], atol=1e-12)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12, 3.0])
    assert tf32_round(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10, 3.0]


def test_a_float64_run_of_the_program_reads_rounding_only():
    import pathfinder_tpu_torch as pft
    from conftest import BENCH
    from pfharness.registry import load_module
    from pfharness.window import extract

    t = load_module(BENCH / "configs" / "hiergauss1000-f64.py", "hg_test")
    g = torch.Generator().manual_seed(3)
    data = t.make_data({"dim": 60, "dtype": "float64"}, g, "cpu")
    init = (torch.rand(6, 60, generator=g, dtype=torch.float64) * 2 - 1) * 2
    res = pft.multipathfinder(lambda x: t.logp(x, data), 200, seed=5, nruns=6, init=init,
                              maxiters=40, elbo_chunk=8, device="cpu", dtype=torch.float64)
    r = readings(extract(res, "cpu"), dict(init=init, logp=t.logp, data=data),
                 dict(history_length=6, ndraws_elbo=5, epsilon_curvature=1e-12))
    exact = ("x0_gap", "lanes_gap", "duplicate_paths", "winner_gap", "resample_gap", "vg_gap",
             "zero_steps", "ascent_steps")
    for name in exact:
        assert r[name] == 0, name
    close = ("step_gap", "step_gap_median", "fit_mean_gap", "cov_gap", "draw_gap", "logdet_gap", "elbo_gap",
             "khat_gap", "weights_tv")
    for name in close:
        assert r[name] < 1e-7, (name, r[name])
    assert set(r) == set(exact) | set(close)


def test_the_frozen_streams_are_the_programs():
    from pathfinder_tpu_torch.utils import rng as program_rng
    from reference import rng

    path, cand = torch.arange(5), torch.tensor([0, 3, 9, 63, 1])
    for purpose in (rng.ELBO, rng.EXTRA):
        ours = rng.Stream(2**40 + 3, path, 0, purpose, cand).normal(3000, torch.float64)
        theirs = program_rng.Stream(2**40 + 3, path, 0, purpose, cand).normal(3000, torch.float64)
        assert torch.equal(ours, theirs)
    ours = rng.Stream(2**40 + 3, 0, 0, rng.RESAMPLE).uniform(1000, torch.float64)
    theirs = program_rng.Stream(2**40 + 3, 0, 0, program_rng.RESAMPLE).uniform(1000, torch.float64)
    assert torch.equal(ours, theirs)

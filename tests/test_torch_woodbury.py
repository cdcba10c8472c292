"""Parity of the port's Woodbury factorization with the JAX package's.

Inputs come from a seeded numpy RNG and go through both packages in f64;
tolerance ``rtol=1e-10`` (the same algorithm in the same precision, summed
in a different order), ``1e-8`` where a result passes through a second
factorization or an inverse. Every operator is also held against the dense
matrix it stands for.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops.woodbury import (
    WoodburyPDMat as JWoodbury,
    pdfactorize as jfactorize,
    pdunfactorize as junfactorize,
)
from pathfinder_tpu_torch.interop import woodbury_from_numpy
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat, pdfactorize, pdunfactorize

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

RTOL = 1e-10


def _parts(d, m, seed, masked=0):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0.5, 2.0, d)
    B = rng.standard_normal((d, m))
    Q = rng.standard_normal((m, m))
    D = Q @ Q.T / max(m, 1) + 0.1 * np.eye(m)
    mask = np.ones(m)
    if masked:
        mask[:masked] = 0.0
    return A, B, D, mask


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=rtol)


@pytest.mark.parametrize(
    "d,m,masked",
    [(7, 0, 0), (7, 4, 0), (7, 12, 0), (64, 4, 0), (64, 12, 0), (64, 12, 5), (7, 12, 3)],
)
def test_factor_ops_match_jax(d, m, masked):
    A, B, D, mask = _parts(d, m, seed=d * 100 + m + masked)
    cm = mask if masked else None
    jf = jfactorize(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D), col_mask=cm)
    tf = pdfactorize(
        torch.tensor(A), torch.tensor(B), torch.tensor(D),
        col_mask=None if cm is None else torch.tensor(cm),
    )
    x = np.random.default_rng(1).standard_normal((d, 3))
    xt = torch.tensor(x)
    _close(tf.L_mul(xt), jf.L_mul(jnp.asarray(x)))
    _close(tf.Lt_mul(xt), jf.Lt_mul(jnp.asarray(x)))
    _close(tf.L_solve(xt), jf.L_solve(jnp.asarray(x)))
    _close(tf.Lt_solve(xt), jf.Lt_solve(jnp.asarray(x)))
    _close(tf.mul(xt), jf.mul(jnp.asarray(x)))
    _close(tf.solve(xt), jf.solve(jnp.asarray(x)))
    _close(tf.log_det, jf.log_det)

    jw = JWoodbury.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D), col_mask=cm)
    tw = WoodburyPDMat.from_parts(
        torch.tensor(A), torch.tensor(B), torch.tensor(D),
        col_mask=None if cm is None else torch.tensor(cm),
    )
    _close(tw.logdet(), jw.logdet())
    _close(tw.invquad(xt), jw.invquad(jnp.asarray(x)))
    _close(tw.unwhiten(xt), jw.unwhiten(jnp.asarray(x)))
    _close(tw.mul(xt), jw.mul(jnp.asarray(x)))
    dense = np.diag(tw.A.numpy()) + tw.B.numpy() @ tw.D.numpy() @ tw.B.numpy().T
    _close(torch.tensor(dense), jw.to_dense())  # masked parts stored zeroed
    assert bool(tw.is_finite_pd()) and bool(jw.is_finite_pd())


def test_batched_factor_matches_per_element():
    """Leading batch dims give each element's own factor."""
    parts = [_parts(16, 6, seed=s, masked=s % 3) for s in range(4)]
    A, B, D, M = (torch.tensor(np.stack(p)) for p in zip(*parts))
    x = torch.tensor(np.random.default_rng(2).standard_normal((4, 16, 2)))
    batched = WoodburyPDMat.from_parts(A, B, D, col_mask=M)
    for i in range(4):
        one = WoodburyPDMat.from_parts(A[i], B[i], D[i], col_mask=M[i])
        torch.testing.assert_close(batched.unwhiten(x)[i], one.unwhiten(x[i]), rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(batched.invquad(x)[i], one.invquad(x[i]), rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(batched.logdet()[i], one.logdet(), rtol=RTOL, atol=RTOL)


def test_non_pd_gives_nan_not_an_exception():
    A, B, _, _ = _parts(7, 4, seed=3)
    D = -50.0 * np.eye(4)  # A + B D Bᵀ is indefinite
    tw = WoodburyPDMat.from_parts(torch.tensor(A), torch.tensor(B), torch.tensor(D))
    jw = JWoodbury.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D))
    assert not bool(tw.is_finite_pd())
    assert not bool(jw.is_finite_pd())
    assert torch.isnan(tw.logdet())
    assert torch.isnan(tw.unwhiten(torch.ones(7, 1, dtype=torch.float64))).all()


def _dense_A(d, seed):
    Q = np.random.default_rng(seed).standard_normal((d, d))
    return Q @ Q.T / d + 0.5 * np.eye(d)


def _both(A, B, D, mask=None, method="chol"):
    jw = JWoodbury.from_parts(
        jnp.asarray(A), jnp.asarray(B), jnp.asarray(D), col_mask=mask, method=method)
    return jw, woodbury_from_numpy(A, B, D, mask, method=method)


# (dense A?, d, m, masked columns, method)
CASES = [
    (True, 7, 4, 0, "chol"), (True, 16, 12, 3, "chol"), (True, 9, 0, 0, "chol"),
    (True, 7, 4, 0, "eigh"), (False, 16, 6, 0, "eigh"), (False, 7, 12, 3, "eigh"),
    (False, 16, 6, 2, "chol"), (False, 9, 0, 0, "chol"),
]


@pytest.mark.parametrize("dense,d,m,masked,method", CASES)
def test_dense_A_rank_0_and_eigh_match_jax_and_the_dense_matrix(dense, d, m, masked, method):
    """The factor and every ``WoodburyPDMat`` operator, for a dense ``A``,
    an empty low-rank part and the eigendecomposition route, against JAX
    and against plain dense linear algebra."""
    A, B, D, mask = _parts(d, m, seed=d + 31 * m + masked)
    if dense:
        A = _dense_A(d, seed=d + m)
    jw, tw = _both(A, B, D, mask if masked else None, method)
    assert tw.diag_A == (not dense) and tw.factor.diag_A == (not dense)
    x = np.random.default_rng(1).standard_normal((d, 3))
    xt, xj = torch.tensor(x), jnp.asarray(x)
    W = tw.to_dense().numpy()
    _close(tw.to_dense(), jw.to_dense())
    np.testing.assert_allclose(W, W.T, atol=1e-12)
    L = tw.unwhiten(torch.eye(d, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(L @ L.T, W, rtol=1e-9, atol=1e-9)
    for name, want in (
        ("mul", W @ x), ("solve", np.linalg.solve(W, x)),
        ("whiten", np.linalg.solve(L, x)), ("unwhiten", L @ x),
        ("inv_unwhiten", np.linalg.solve(L.T, x)),
        ("quad", np.sum(x * (W @ x), axis=0)),
        ("invquad", np.sum(x * np.linalg.solve(W, x), axis=0)),
    ):
        got = getattr(tw, name)(xt)
        _close(got, getattr(jw, name)(xj), rtol=1e-9)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-9, err_msg=name)
    _close(tw.logdet(), jw.logdet())
    np.testing.assert_allclose(float(tw.logdet()), np.linalg.slogdet(W)[1], rtol=1e-9)
    _close(tw.diag(), jw.diag())
    np.testing.assert_allclose(tw.diag().numpy(), np.diag(W), rtol=1e-10)
    for i, j in ((0, 0), (2, 5), (d - 1, 1)):
        np.testing.assert_allclose(float(tw.entry(i, j)), W[i, j], rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(tw.entry(i, j)), float(jw.entry(i, j)), rtol=1e-10, atol=1e-12)
    _close(tw.inv(method).to_dense(), jw.inv(method).to_dense(), rtol=1e-8)
    np.testing.assert_allclose(tw.inv(method).to_dense().numpy(), np.linalg.inv(W), rtol=1e-7, atol=1e-8)
    _close(tw.add_scaled_identity(0.7, method).to_dense(), jw.add_scaled_identity(0.7, method).to_dense())
    _close(tw.add_scaled_identity(0.7, method).logdet(), jw.add_scaled_identity(0.7, method).logdet(), rtol=1e-9)
    _close(tw.scale(2.5, method).logdet(), jw.scale(2.5, method).logdet(), rtol=1e-9)
    np.testing.assert_allclose((tw * 2.5).to_dense().numpy(), 2.5 * W, rtol=1e-10)
    neg = tw.scale(-2.0)  # no longer PD: the dense matrix comes back
    assert isinstance(neg, torch.Tensor)
    _close(neg, jw.scale(-2.0))
    # unfactorize gives parts of the same matrix
    A2, B2, D2 = pdunfactorize(tw.factor)
    jA2, jB2, jD2 = junfactorize(jw.factor)
    _close(A2, jA2, rtol=1e-9)
    back = (torch.diag_embed(A2) if A2.ndim == 1 else A2) + B2 @ D2 @ B2.mT
    np.testing.assert_allclose(back.numpy(), W, rtol=1e-8, atol=1e-9)
    assert bool(tw.is_finite_pd())


@pytest.mark.parametrize("dense1,dense2", [(False, False), (False, True), (True, True)])
def test_add_matches_jax(dense1, dense2):
    d = 8
    A1, B1, D1, _ = _parts(d, 3, seed=1)
    A2, B2, D2, _ = _parts(d, 5, seed=2)
    A1 = _dense_A(d, 3) if dense1 else A1
    A2 = _dense_A(d, 4) if dense2 else A2
    (j1, t1), (j2, t2) = _both(A1, B1, D1), _both(A2, B2, D2)
    for method in ("chol", "eigh"):
        ts, js = t1.add(t2, method), j1.add(j2, method=method)
        assert ts.B.shape == (d, 8) and ts.diag_A == (not (dense1 or dense2))
        _close(ts.to_dense(), js.to_dense())
        _close(ts.logdet(), js.logdet(), rtol=1e-9)
        np.testing.assert_allclose(
            ts.to_dense().numpy(), t1.to_dense().numpy() + t2.to_dense().numpy(), rtol=1e-10)
    _close((t1 + t2).logdet(), (j1 + j2).logdet(), rtol=1e-9)


def test_eigh_handles_collinear_columns_like_jax():
    """Duplicated columns: the rank-revealing route projects them out."""
    A, B, D, _ = _parts(10, 4, seed=5)
    B = np.concatenate([B, B[:, :2]], axis=1)
    D = np.eye(6)
    jw, tw = _both(A, B, D, method="eigh")
    x = np.random.default_rng(0).standard_normal((10, 2))
    _close(tw.solve(torch.tensor(x)), jw.solve(jnp.asarray(x)), rtol=1e-8)
    np.testing.assert_allclose(
        tw.solve(torch.tensor(x)).numpy(), np.linalg.solve(tw.to_dense().numpy(), x), rtol=1e-8)
    with pytest.raises(ValueError, match="unknown factorization method"):
        woodbury_from_numpy(A, B, D, method="qr")


def test_batched_dense_A_and_rank_0_match_per_element():
    d = 6
    As = np.stack([_dense_A(d, s) for s in range(3)])
    Bs = np.zeros((3, d, 0))
    Ds = np.zeros((3, 0, 0))
    batched = woodbury_from_numpy(As, Bs, Ds)
    assert batched.factor.a_half.shape == (3, d, d) and batched.factor.X.shape == (3, d, 0)
    x = torch.tensor(np.random.default_rng(3).standard_normal((3, d, 2)))
    for i in range(3):
        one = woodbury_from_numpy(As[i], Bs[i], Ds[i])
        torch.testing.assert_close(batched.unwhiten(x)[i], one.unwhiten(x[i]), rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(batched.invquad(x)[i], one.invquad(x[i]), rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(batched.diag()[i], one.diag(), rtol=RTOL, atol=RTOL)
        torch.testing.assert_close(batched.entry(1, 2)[i], one.entry(1, 2), rtol=RTOL, atol=RTOL)
    # a dense A that is not PD gives NaN, not an exception, on its own lane
    As[1] = -As[1]
    bad = woodbury_from_numpy(As, Bs, Ds)
    assert bad.is_finite_pd().tolist() == [True, False, True]
    with pytest.raises(ValueError, match="A must be"):
        pdfactorize(torch.ones(4), torch.ones(3, 1), torch.ones(1, 1))

"""Parity of the port's Woodbury factorization with the JAX package's.

Inputs come from a seeded numpy RNG and go through both packages in f64;
tolerance ``rtol=1e-10`` (the same algorithm in the same precision, summed
in a different order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodbury, pdfactorize as jfactorize
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat, pdfactorize

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


def test_dense_A_is_not_ported():
    with pytest.raises(NotImplementedError):
        pdfactorize(torch.eye(3), torch.ones(3, 1), torch.ones(1, 1))

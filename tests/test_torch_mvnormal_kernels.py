"""Parity of the port's MvNormal and the plain versions of kernels B1
(sample+logq) and B2 (whiten+sumsq) with the JAX package's MvNormal.

The JAX side draws its noise as ``jax.random.normal(key, (d, N))``, exactly
as ``MvNormal.rand_and_logpdf`` does; the port is handed that same noise.
f64 throughout, ``rtol=1e-10``: the same arithmetic summed in another order.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal, UniformMixture as JMixture
from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JWoodbury
from pathfinder_tpu_torch.interop import mvnormal_from_numpy
from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.ops.mvnormal import MvNormal, UniformMixture
from pathfinder_tpu_torch.utils.misc import tree_map

RTOL = 1e-10


def _dist_parts(d, m, seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(d)
    A = rng.uniform(0.5, 2.0, d)
    B = rng.standard_normal((d, m)) / np.sqrt(d)
    Q = rng.standard_normal((m, m))
    D = Q @ Q.T / m + 0.1 * np.eye(m)
    return mean, A, B, D


def _jax_dist(mean, A, B, D):
    return JMvNormal(jnp.asarray(mean), JWoodbury.from_parts(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D)))


@pytest.mark.parametrize("d,m,N", [(16, 4, 5), (64, 12, 10), (7, 12, 3)])
def test_rand_and_logpdf_match_jax_with_injected_noise(d, m, N):
    parts = _dist_parts(d, m, seed=d + m)
    jd = _jax_dist(*parts)
    td = mvnormal_from_numpy(*parts)
    key = jax.random.key(d * 7 + N)
    xj, logqj = jd.rand_and_logpdf(key, N)
    u = np.asarray(jax.random.normal(key, (d, N), dtype=jnp.float64))
    xt, logqt = td.rand_and_logpdf(u=torch.tensor(u))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(logqt.numpy(), np.asarray(logqj), rtol=RTOL)
    np.testing.assert_allclose(
        td.sample(u=torch.tensor(u)).numpy(), np.asarray(jd.sample(key, N)), rtol=RTOL, atol=RTOL
    )
    np.testing.assert_allclose(
        td.logpdf(xt).numpy(), np.asarray(jd.logpdf(xj)), rtol=RTOL
    )
    np.testing.assert_allclose(float(td.entropy()), float(jd.entropy()), rtol=RTOL)


def test_plain_kernel_versions_match_jax_and_batch():
    """The plain versions of B1/B2 on a batch equal JAX's per-element
    ``rand_and_logpdf`` and ``logpdf`` (Mahalanobis term)."""
    Bn, d, m, N = 3, 32, 12, 5
    dists = [_dist_parts(d, m, seed=10 + b) for b in range(Bn)]
    tds = [mvnormal_from_numpy(*p) for p in dists]
    U = np.random.default_rng(0).standard_normal((Bn, d, N))
    stack = lambda f: torch.stack([f(t) for t in tds])
    a_half = stack(lambda t: t.cov.factor.a_half)
    X = stack(lambda t: t.cov.factor.X)
    C = stack(lambda t: t.cov.factor.C)
    Ci = stack(lambda t: t.cov.factor.Ci)
    mu = stack(lambda t: t.mean)
    logdet = stack(lambda t: t.cov.factor.log_det)
    x, logq = wk.sample_and_logq_torch(torch.tensor(U), a_half, X, C, mu, logdet)
    maha = wk.whiten_sumsq_torch(x, a_half, X, Ci, mu)
    for b, parts in enumerate(dists):
        jd = _jax_dist(*parts)
        xj = jd.cov.unwhiten(jnp.asarray(U[b])) + jd.mean[:, None]
        np.testing.assert_allclose(x[b].numpy(), np.asarray(xj), rtol=RTOL, atol=RTOL)
        logqj = jd.logpdf(xj)  # equals logq: x was drawn from this normal
        np.testing.assert_allclose(logq[b].numpy(), np.asarray(logqj), rtol=1e-9)
        np.testing.assert_allclose(
            maha[b].numpy(), np.asarray(jd.cov.invquad(xj - jd.mean[:, None])), rtol=1e-9
        )


def test_uniform_mixture_logpdf_matches_jax():
    K, d, m, N = 4, 16, 6, 7
    parts = [_dist_parts(d, m, seed=30 + k) for k in range(K)]
    mean, A, B, D = (np.stack(p) for p in zip(*parts))
    jcomp = JMvNormal(
        jnp.asarray(mean),
        jax.vmap(JWoodbury.from_parts)(jnp.asarray(A), jnp.asarray(B), jnp.asarray(D)),
    )
    tcomp = mvnormal_from_numpy(mean, A, B, D)
    x = np.random.default_rng(5).standard_normal((d, N))
    np.testing.assert_allclose(
        UniformMixture(tcomp).logpdf(torch.tensor(x)).numpy(),
        np.asarray(JMixture(jcomp).logpdf(jnp.asarray(x))),
        rtol=RTOL,
    )


def test_wrapper_on_cpu_uses_the_plain_version_and_counts_nothing():
    wk.reset_launch_counts()
    td = mvnormal_from_numpy(*_dist_parts(16, 4, seed=1), dtype=torch.float32)
    u = torch.randn(2, 16, 5, generator=torch.Generator().manual_seed(0))
    comps = MvNormal(td.mean.expand(2, 16), _expand_cov(td.cov, 2))
    x, logq = comps.rand_and_logpdf(u=u)
    comps.logpdf(x)
    assert wk.launch_counts() == {"sample_and_logq": 0, "whiten_sumsq": 0}
    assert wk.launch_counts_by_shape() == {"sample_and_logq": {}, "whiten_sumsq": {}}
    ref = wk.sample_and_logq_torch(
        u, comps.cov.factor.a_half, comps.cov.factor.X, comps.cov.factor.C,
        comps.mean, comps.cov.factor.log_det,
    )
    assert torch.equal(x, ref[0]) and torch.equal(logq, ref[1])


def _expand_cov(cov, n):
    return tree_map(lambda t: t.expand((n,) + t.shape).contiguous(), cov)


def test_wrapper_rejects_other_devices():
    meta = torch.empty(1, 4, 2, device="meta")
    with pytest.raises(ValueError):
        wk.sample_and_logq(meta, meta[..., 0], meta, meta, meta[..., 0], meta[:, 0, 0])
    with pytest.raises(ValueError):
        wk.whiten_sumsq(meta, meta[..., 0], meta, meta, meta[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "Bn,d,m,N",
    [
        (100, 1000, 12, 10),  # main path: fresh draws, PSIS ratios
        (800, 1000, 12, 5),  # main path: an ELBO chunk
        (3, 999, 7, 3),  # odd d, m and N: unaligned runs, rank padding
        (4, 100, 12, 33),  # N not a multiple of 5
        (100, 10000, 12, 10),  # large d: a cluster of 8
        (8, 30000, 32, 10),  # rows that do not fit: the row-tiled path
        (1, 1000, 12, 1000),  # more columns than one round of the kernel
    ],
)
def test_kernels_match_plain_versions_on_the_card(Bn, d, m, N):
    """B1 and B2 against their plain versions at main-path and odd shapes
    (f32; different summation order, so rtol/atol 1e-5 on x, 1e-4 on the
    sums), and the same bits from a repeated launch. Runs where the card and
    JAX are both installed; ``chip_smoke.py`` makes the same check on a
    machine with the card alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    u = t(rng.standard_normal((Bn, d, N)))
    a_half = t(rng.uniform(0.5, 1.5, (Bn, d)))
    X = t(rng.standard_normal((Bn, d, m)) / np.sqrt(d))
    C = t(0.1 * rng.standard_normal((Bn, m, m)))
    mu = t(rng.standard_normal((Bn, d)))
    logdet = t(rng.standard_normal(Bn))
    x, logq = wk.sample_and_logq(u, a_half, X, C, mu, logdet)
    xr, logqr = wk.sample_and_logq_torch(u, a_half, X, C, mu, logdet)
    torch.testing.assert_close(x, xr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logq, logqr, rtol=1e-4, atol=1e-4)
    maha = wk.whiten_sumsq(x, a_half, X, C, mu)
    torch.testing.assert_close(maha, wk.whiten_sumsq_torch(x, a_half, X, C, mu), rtol=1e-4, atol=1e-4)
    assert torch.equal(wk.sample_and_logq(u, a_half, X, C, mu, logdet)[0], x)
    assert torch.equal(wk.whiten_sumsq(x, a_half, X, C, mu), maha)

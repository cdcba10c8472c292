"""The port's bijectors and transformed densities, held against the JAX
package in f64 on the CPU.

Inputs come from a seeded numpy RNG. The JAX bijectors act on one vector and
are ``vmap``-ed over the rows; the port's act on the batch. Tolerance 1e-12
for ``forward``, ``inverse`` and ``forward_log_det``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.integrations import transforms as jtr
from pathfinder_tpu_torch import interop
from pathfinder_tpu_torch.integrations import transforms as ttr
from pathfinder_tpu_torch.ops.mvnormal import MvNormal
from pathfinder_tpu_torch.ops.woodbury import WoodburyPDMat
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

TOL = 1e-12
K, D = 16, 5

# (name, JAX bijector, the port's spec)
BIJECTORS = [
    ("identity", jtr.Identity(), ("Identity", {})),
    ("exp", jtr.Exp(), ("Exp", {})),
    ("interval", jtr.Interval(-1.5, 2.0), ("Interval", {"low": -1.5, "high": 2.0})),
    ("ordered", jtr.Ordered(), ("Ordered", {})),
    ("simplex", jtr.Simplex(), ("Simplex", {})),
    (
        "stacked",
        jtr.Stacked(((jtr.Ordered(), 2), (jtr.Exp(), 1), (jtr.Simplex(), 2))),
        ("Stacked", [(("Ordered", {}), 2), (("Exp", {}), 1), (("Simplex", {}), 2)]),
    ),
]
IDS = [b[0] for b in BIJECTORS]


def _z(seed=0, scale=1.5):
    return np.random.default_rng(seed).standard_normal((K, D)) * scale


@pytest.mark.parametrize("name,jb,spec", BIJECTORS, ids=IDS)
def test_bijector_matches_jax(name, jb, spec):
    tb = interop.bijector_from_spec(spec)
    z = _z()
    zt = torch.tensor(z)
    jx = np.asarray(jax.vmap(jb.forward)(jnp.asarray(z)))
    tx = tb.forward(zt)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=TOL, atol=TOL)
    jld = np.asarray(jax.vmap(jb.forward_log_det)(jnp.asarray(z)))
    np.testing.assert_allclose(tb.forward_log_det(zt).numpy(), jld, rtol=TOL, atol=TOL)
    jinv = np.asarray(jax.vmap(jb.inverse)(jnp.asarray(jx)))
    np.testing.assert_allclose(tb.inverse(tx).numpy(), jinv, rtol=TOL, atol=TOL)
    # round trip, and a single vector goes through like a batch of one
    np.testing.assert_allclose(tb.inverse(tx).numpy(), z, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tb.forward(zt[3]).numpy(), jx[3], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,jb,spec", BIJECTORS, ids=IDS)
def test_log_det_is_the_jacobian(name, jb, spec):
    """Σ forward_log_det equals log|det J| of forward by autograd."""
    tb = interop.bijector_from_spec(spec)
    z = torch.tensor(_z(1, 0.8)[0])
    J = torch.autograd.functional.jacobian(tb.forward, z)
    want = torch.linalg.slogdet(J)[1]
    np.testing.assert_allclose(float(tb.forward_log_det(z).sum()), float(want), atol=1e-10)


@pytest.mark.parametrize("name,jb,spec", BIJECTORS[3:], ids=IDS[3:])
def test_block_bijector_gradients_finite_in_f32_far_out(name, jb, spec):
    """Where a line search probes (|z| up to 30) the value and the gradient
    of forward + log-det stay finite in f32."""
    tb = interop.bijector_from_spec(spec)
    z = torch.tensor(_z(2, 12.0), dtype=torch.float32).clamp(-30, 30).requires_grad_(True)
    out = tb.forward(z).sum() + tb.forward_log_det(z).sum()
    (g,) = torch.autograd.grad(out, z)
    assert torch.isfinite(out) and torch.isfinite(g).all()


def test_supports():
    z = torch.tensor(_z(3, 3.0))
    x = ttr.Ordered().forward(z)
    assert bool((torch.diff(x, dim=-1) > 0).all())
    s = ttr.Simplex().forward(z)
    assert bool((s > 0).all()) and bool((s.sum(-1) < 1).all())
    iv = ttr.Interval(2.0, 5.0).forward(z)
    assert bool(((iv > 2.0) & (iv < 5.0)).all())


def test_interval_and_stacked_validation():
    with pytest.raises(ValueError, match="high must exceed low"):
        ttr.Interval(1.0, 1.0)
    with pytest.raises(ValueError, match="block sizes must be >= 1"):
        ttr.Stacked(((ttr.Exp(), 0),))
    st = ttr.Stacked(((ttr.Exp(), 2), (ttr.Identity(), 2)))
    with pytest.raises(ValueError, match="cover 4 entries"):
        st.forward(torch.zeros(3, 5))


def _lognormal_pair():
    """Constrained density Π LogNormal(0.3, 0.7) over 3 positives."""
    mu, sig = 0.3, 0.7

    def jlogp(x):
        lx = jnp.log(x)
        return jnp.sum(-0.5 * ((lx - mu) / sig) ** 2 - lx)

    def tlogp(x):
        lx = torch.log(x)
        return torch.sum(-0.5 * ((lx - mu) / sig) ** 2 - lx, dim=-1)

    def tgrad(x):
        return (-(torch.log(x) - mu) / sig**2 - 1.0) / x

    def jgrad(x):
        return (-(jnp.log(x) - mu) / sig**2 - 1.0) / x

    return jlogp, tlogp, jgrad, tgrad


@pytest.mark.parametrize("with_grad", [False, True], ids=["autograd", "grad_constrained"])
def test_transformed_log_density_matches_jax(with_grad):
    jlogp, tlogp, jgrad, tgrad = _lognormal_pair()
    jtld = jtr.TransformedLogDensity(
        jlogp, jtr.Exp(), 3, grad_constrained=jgrad if with_grad else None
    )
    ttld = ttr.TransformedLogDensity(
        tlogp, ttr.Exp(), 3, grad_constrained=tgrad if with_grad else None
    )
    z = np.random.default_rng(4).standard_normal((K, 3))
    jv, jg = jax.vmap(jtld.unconstrained.value_and_grad)(jnp.asarray(z))
    tv, tg = ttld.unconstrained.value_and_grad(torch.tensor(z))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        ttld.unconstrained.logp(torch.tensor(z)).numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10
    )
    draws = torch.tensor(z.T.copy())  # (dim, ndraws)
    np.testing.assert_allclose(
        ttld.forward_draws(draws).numpy(), np.asarray(jtld.forward_draws(jnp.asarray(z.T))),
        rtol=TOL, atol=TOL,
    )
    np.testing.assert_allclose(
        ttld.inverse_point(torch.exp(torch.tensor(z[0]))).numpy(), z[0], rtol=1e-12, atol=1e-12
    )


def test_grad_constrained_never_differentiates_the_user_logp():
    """With ``grad_constrained`` the user's logp may be opaque to autograd."""
    _, tlogp, _, tgrad = _lognormal_pair()

    def opaque(x):
        return torch.as_tensor(tlogp(torch.tensor(x.detach().numpy())))

    tld = ttr.TransformedLogDensity(opaque, ttr.Exp(), 3, grad_constrained=tgrad)
    ref = ttr.TransformedLogDensity(tlogp, ttr.Exp(), 3)
    z = torch.tensor(np.random.default_rng(5).standard_normal((4, 3)))
    v, g = tld.unconstrained.value_and_grad(z)
    vr, gr = ref.unconstrained.value_and_grad(z)
    np.testing.assert_allclose(v.numpy(), vr.numpy(), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), gr.numpy(), rtol=1e-10, atol=1e-12)


def _mvnormal(d, m, seed=0):
    r = np.random.default_rng(seed)
    A = torch.tensor(r.uniform(0.5, 1.5, d))
    B = torch.tensor(r.standard_normal((d, m)) * 0.3)
    D0 = r.standard_normal((m, m)) * 0.3
    return MvNormal(torch.tensor(r.standard_normal(d)), WoodburyPDMat.from_parts(A, B, torch.tensor(D0 @ D0.T)))


def test_transformed_distribution_matches_jax():
    """The pushforward's logpdf against the JAX package's on the same base
    normal; outside the support it is −inf, never NaN; samples are the
    base's samples mapped forward."""
    from pathfinder_tpu.ops.mvnormal import MvNormal as JMvNormal
    from pathfinder_tpu.ops.woodbury import WoodburyPDMat as JW

    d = 4
    base = _mvnormal(d, 2)
    jbase = JMvNormal(
        jnp.asarray(base.mean.numpy()),
        JW.from_parts(*(jnp.asarray(t.numpy()) for t in (base.cov.A, base.cov.B, base.cov.D))),
    )
    jb = jtr.Stacked(((jtr.Exp(), 2), (jtr.Interval(0.0, 3.0), 2)))
    tb = ttr.Stacked(((ttr.Exp(), 2), (ttr.Interval(0.0, 3.0), 2)))
    jd, td = jtr.TransformedDistribution(jbase, jb), ttr.TransformedDistribution(base, tb)
    z = np.random.default_rng(6).standard_normal((7, d))
    x = np.asarray(jax.vmap(jb.forward)(jnp.asarray(z))).T  # (d, N)
    np.testing.assert_allclose(
        td.logpdf(torch.tensor(x)).numpy(), np.asarray(jd.logpdf(jnp.asarray(x))),
        rtol=1e-10, atol=1e-10,
    )
    np.testing.assert_allclose(
        float(td.logpdf(torch.tensor(x[:, 0]))), float(jd.logpdf(jnp.asarray(x[:, 0]))), rtol=1e-10
    )
    outside = torch.tensor(x[:, :2].copy())
    outside[0, 0] = -1.0  # a negative "positive"
    outside[3, 1] = 3.5  # beyond the interval
    lp = td.logpdf(outside)
    assert bool((lp == -torch.inf).all())
    stream = rng.Stream(0, 0, 0, rng.EXTRA)
    np.testing.assert_allclose(
        td.sample(stream, 5).numpy(), tb.forward(base.sample(stream, 5).mT).mT.numpy(), rtol=1e-14
    )


def test_resolve_transform_dispatch_and_errors():
    _, tlogp, _, tgrad = _lognormal_pair()
    tld = ttr.TransformedLogDensity(tlogp, ttr.Exp(), 3)

    class Model:
        transformed = tld

    assert ttr.resolve_transform(tlogp, None) == (tlogp, None)
    for fn, tr in ((tld, None), (Model(), None), (None, tld)):
        target, got = ttr.resolve_transform(fn, tr)
        assert got is tld and target is tld.unconstrained
    target, got = ttr.resolve_transform(tlogp, ttr.Exp(), dim=3, grad=tgrad)
    assert got.grad_constrained is tgrad and got.dim == 3 and target is got.unconstrained
    for fn, tr in ((tld, None), (Model(), None), (None, tld)):
        with pytest.raises(ValueError, match="grad= cannot be combined"):
            ttr.resolve_transform(fn, tr, grad=tgrad)
    with pytest.raises(TypeError, match="Bijector or TransformedLogDensity"):
        ttr.resolve_transform(tlogp, "exp", dim=3)
    with pytest.raises(ValueError, match="dim is required"):
        ttr.resolve_transform(tlogp, ttr.Exp())
    with pytest.raises(TypeError, match="callable log density"):
        ttr.resolve_transform(3.0, ttr.Exp(), dim=3)


def test_bijector_spec_errors():
    with pytest.raises(ValueError, match="unknown bijector"):
        interop.bijector_from_spec(("Softplus", {}))

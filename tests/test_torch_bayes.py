"""The port's Bayesian model layer, held against the JAX package in f64 on
the CPU: every prior's ``log_prob`` (1e-12), ``BayesModel``'s linked density
and gradient (1e-10), its draw conversion, init strategies and prior
samplers, and the model as an input of ``pathfinder``/``multipathfinder``.

A model crosses over as names and numpy parameters
(``interop.bayes_model_from_spec``); the likelihood is written twice, for one
row in JAX and for a batch in torch.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.stats as st
import torch

from pathfinder_tpu.models import bayes as jb
from pathfinder_tpu_torch import interop, multipathfinder, pathfinder, resample
from pathfinder_tpu_torch.integrations import transforms as ttr
from pathfinder_tpu_torch.models import bayes as tb
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

TOL = 1e-12

# (distribution name, parameters, points inside the support)
_POS = [0.05, 0.3, 1.0, 1.7, 6.0]
_REAL = [-4.0, -0.3, 0.0, 0.9, 5.0]
_UNIT = [0.01, 0.2, 0.5, 0.77, 0.99]
PRIORS = [
    ("Normal", {"loc": 0.5, "scale": 2.0}, _REAL),
    ("HalfNormal", {"scale": 1.5}, _POS),
    ("LogNormal", {"loc": 0.2, "scale": 0.7}, _POS),
    ("Exponential", {"rate": 1.3}, _POS),
    ("Uniform", {"low": -1.0, "high": 2.0}, [-0.9, 0.0, 1.9]),
    ("Beta", {"a": 2.5, "b": 1.5}, _UNIT),
    ("Beta", {"a": 1.0, "b": 3.0}, _UNIT),
    ("Gamma", {"concentration": 2.5, "rate": 1.7}, _POS),
    ("Gamma", {"concentration": 1.0, "rate": 0.4}, _POS),
    ("Cauchy", {"loc": -0.5, "scale": 1.2}, _REAL),
    ("HalfCauchy", {"scale": 2.5}, _POS),
    ("StudentT", {"df": 4.0, "loc": 0.1, "scale": 1.2}, _REAL),
]
IDS = [f"{n}-{i}" for i, (n, _, _) in enumerate(PRIORS)]


def _spec_of(model):
    """A JAX ``BayesModel``'s priors as names and numpy parameters."""
    out = []
    for name, dist, size in model.priors:
        if isinstance(dist, jb.Dirichlet):
            params = {"alpha": np.asarray(dist.alpha)}
        else:
            params = {
                f.name: np.asarray(getattr(dist, f.name))
                for f in dataclasses.fields(dist) if f.name != "bijector"
            }
        out.append((name, type(dist).__name__, params, size))
    return out


@pytest.mark.parametrize("name,params,points", PRIORS, ids=IDS)
def test_prior_log_prob_matches_jax(name, params, points):
    jd = getattr(jb, name)(**params)
    td = getattr(tb, name)(**params)
    x = np.asarray(points)
    want = np.asarray(jd.log_prob(jnp.asarray(x)))
    np.testing.assert_allclose(td.log_prob(torch.tensor(x)).numpy(), want, rtol=TOL, atol=TOL)
    # batched: a (K, n) block gives the same numbers
    xb = torch.tensor(np.stack([x, x[::-1]]))
    np.testing.assert_allclose(td.log_prob(xb)[1].numpy(), want[::-1], rtol=TOL, atol=TOL)
    assert type(td.bijector).__name__ == type(jd.bijector).__name__


def test_dirichlet_log_prob_matches_jax():
    for alpha in ([2.0, 3.0, 1.5], [1.0, 1.0, 1.0], [1.0, 4.0], [0.5, 1.0, 2.0, 3.0]):
        jd, td = jb.Dirichlet(alpha), tb.Dirichlet(alpha)
        r = np.random.default_rng(0)
        full = r.dirichlet(np.ones(len(alpha)), size=6)
        x = full[:, :-1]
        want = np.asarray(jax.vmap(jd.log_prob)(jnp.asarray(x)))
        np.testing.assert_allclose(td.log_prob(torch.tensor(x)).numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(want, st.dirichlet(alpha).logpdf(full.T), rtol=1e-9)
        assert td.size == jd.size and isinstance(td.bijector, ttr.Simplex)


def test_prior_validation_and_boundaries():
    with pytest.raises(ValueError, match="'scale' must be positive"):
        tb.Normal(0.0, -1.0)
    with pytest.raises(ValueError, match="alpha\\[1\\]"):
        tb.Dirichlet([1.0, 0.0])
    with pytest.raises(ValueError, match="high must exceed low"):
        tb.Uniform(2.0, 1.0)
    with pytest.raises(ValueError, match="requires block size 2"):
        tb.BayesModel({"w": (tb.Dirichlet([1.0, 2.0, 3.0]), 3)})
    # the corners a saturated bijector reaches in f32: value and gradient
    # stay free of NaN
    for dist, x0 in ((tb.Gamma(1.0, 2.0), 0.0), (tb.Beta(1, 3.0), 0.0), (tb.LogNormal(), 0.0)):
        x = torch.tensor([x0], requires_grad=True)
        lp = dist.log_prob(x)
        (g,) = torch.autograd.grad(lp.sum(), x)
        assert not torch.isnan(lp).any() and not torch.isnan(g).any(), dist
    d = tb.Dirichlet([1.0, 1.0, 2.0])
    x = torch.tensor([[0.7, 0.3 + 1e-7]], requires_grad=True)  # the sum a hair past 1
    assert not torch.isnan(d.log_prob(x)).any()
    # array-valued parameters
    u = tb.Uniform(np.array([0.0, 1.0]), np.array([2.0, 5.0]))
    np.testing.assert_allclose(
        u.log_prob(torch.tensor([1.0, 2.0], dtype=torch.float64)).numpy(), -np.log([2.0, 4.0])
    )


DATA = np.asarray([1.2, 0.8, 1.1, 0.9, 1.0, 1.3])
COUNTS = np.asarray([3.0, 5.0, 2.0])


def _models():
    """A model with a Normal, a HalfNormal, a Beta and a Dirichlet(3) prior:
    location/scale data, a binomial count and a multinomial count."""
    priors = lambda m: [
        ("mu", m.Normal(0.0, 10.0)),
        ("sigma", m.HalfNormal(2.0)),
        ("theta", m.Beta(2.0, 2.0)),
        ("w", m.Dirichlet([1.0, 2.0, 1.5])),
    ]

    def jloglik(p):
        w = jnp.concatenate([p["w"], 1.0 - jnp.sum(p["w"], keepdims=True)])
        return (
            jnp.sum(-0.5 * ((DATA - p["mu"]) / p["sigma"]) ** 2 - jnp.log(p["sigma"]))
            + 7.0 * jnp.log(p["theta"]) + 3.0 * jnp.log1p(-p["theta"])
            + jnp.sum(COUNTS * jnp.log(w))
        )

    def tloglik(p):
        data = torch.as_tensor(DATA, dtype=p["mu"].dtype, device=p["mu"].device)
        counts = torch.as_tensor(COUNTS, dtype=p["mu"].dtype, device=p["mu"].device)
        w = torch.cat([p["w"], 1.0 - p["w"].sum(-1, keepdim=True)], dim=-1)
        mu, sigma = p["mu"][..., None], p["sigma"][..., None]
        return (
            torch.sum(-0.5 * ((data - mu) / sigma) ** 2 - torch.log(sigma), dim=-1)
            + 7.0 * torch.log(p["theta"]) + 3.0 * torch.log1p(-p["theta"])
            + torch.sum(counts * torch.log(w), dim=-1)
        )

    jm = jb.BayesModel(priors(jb), jloglik)
    tm = interop.bayes_model_from_spec(_spec_of(jm), tloglik)
    return jm, tm


def test_model_crosses_over_with_its_link():
    jm, tm = _models()
    assert tm.names == jm.names and tm.dim == jm.dim == 5
    assert [type(b).__name__ for b, _ in tm.bijector.blocks] == [
        type(b).__name__ for b, _ in jm.bijector.blocks
    ]
    with pytest.raises(ValueError, match="unknown distribution"):
        interop.bayes_model_from_spec([("a", "Weibull", {}, 1)])


def test_linked_density_and_gradient_match_jax():
    jm, tm = _models()
    z = np.random.default_rng(0).standard_normal((16, jm.dim))
    jv, jg = jax.vmap(jm.transformed.unconstrained.value_and_grad)(jnp.asarray(z))
    tv, tg = tm.transformed.unconstrained.value_and_grad(torch.tensor(z))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    x = tm.bijector.forward(torch.tensor(z))
    jx = jax.vmap(jm.bijector.forward)(jnp.asarray(z))
    np.testing.assert_allclose(
        tm.constrained_logp(x).numpy(), np.asarray(jax.vmap(jm.constrained_logp)(jx)), rtol=1e-10
    )
    p = tm.split(x)
    assert p["mu"].shape == (16,) and p["w"].shape == (16, 2)
    np.testing.assert_allclose(tm.join(p).numpy(), x.numpy())
    np.testing.assert_allclose(
        tm.logprior(p).numpy(),
        np.asarray(jax.vmap(lambda xi: jm.logprior(jm.split(xi)))(jx)), rtol=1e-10,
    )
    # one unbatched point goes through the same code
    np.testing.assert_allclose(float(tm.constrained_logp(x[2])), float(tm.constrained_logp(x)[2]))


def test_draw_conversion_matches_jax():
    jm, tm = _models()
    draws = np.random.default_rng(1).standard_normal((jm.dim, 9))
    jc, tc = jm.draws_to_chain(jnp.asarray(draws)), tm.draws_to_chain(torch.tensor(draws))
    assert set(tc) == set(jc) == {"mu", "sigma", "theta", "w", "logprior", "loglikelihood", "logjoint"}
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-10, atol=1e-10)
    con = tm.constrain_draws(torch.tensor(draws))
    assert bool((con["sigma"] > 0).all()) and bool(((con["theta"] > 0) & (con["theta"] < 1)).all())
    assert bool((con["w"].sum(-1) < 1).all()) and con["w"].shape == (9, 2)
    stats = tm.pointwise_stats(torch.tensor(draws))
    np.testing.assert_allclose(stats["logjoint"].numpy(), np.asarray(jc["logjoint"]), rtol=1e-10)


SAMPLERS = [
    (tb.Normal(0.5, 2.0), st.norm(0.5, 2.0)),
    (tb.HalfNormal(1.5), st.halfnorm(scale=1.5)),
    (tb.LogNormal(0.2, 0.5), st.lognorm(s=0.5, scale=np.exp(0.2))),
    (tb.Exponential(1.3), st.expon(scale=1 / 1.3)),
    (tb.Uniform(-1.0, 2.0), st.uniform(-1.0, 3.0)),
    (tb.Beta(2.5, 1.5), st.beta(2.5, 1.5)),
    (tb.Gamma(2.5, 1.7), st.gamma(2.5, scale=1 / 1.7)),
    (tb.Gamma(0.4, 1.0), st.gamma(0.4)),
    (tb.Cauchy(-0.5, 1.2), st.cauchy(-0.5, 1.2)),
    (tb.HalfCauchy(2.5), st.halfcauchy(scale=2.5)),
    (tb.StudentT(4.0, 0.1, 1.2), st.t(4.0, loc=0.1, scale=1.2)),
]


@pytest.mark.parametrize("dist,ref", SAMPLERS, ids=[type(d).__name__ + str(i) for i, (d, _) in enumerate(SAMPLERS)])
def test_prior_samplers_follow_their_distribution(dist, ref):
    """20,000 draws from the port's stream pass a Kolmogorov-Smirnov test
    against scipy's distribution (p > 1e-3), and a stream's element does not
    depend on the batch it is drawn in."""
    x = dist.sample(rng.Stream(7, 0, 0, rng.PRIOR), (20000,), torch.float64)
    assert x.shape == (20000,) and bool(torch.isfinite(x).all())
    assert st.kstest(x.numpy(), ref.cdf).pvalue > 1e-3
    paths = torch.arange(3)
    xb = dist.sample(rng.Stream(7, paths, 0, rng.PRIOR), (5,), torch.float64)
    x1 = dist.sample(rng.Stream(7, 1, 0, rng.PRIOR), (5,), torch.float64)
    assert xb.shape == (3, 5) and torch.equal(xb[1], x1)


def test_dirichlet_sampler():
    alpha = [2.0, 3.0, 0.7]
    d = tb.Dirichlet(alpha)
    x = d.sample(rng.Stream(3, torch.arange(20000), 0, rng.PRIOR), (2,), torch.float64)
    assert x.shape == (20000, 2)
    np.testing.assert_allclose(x.mean(0).numpy(), np.asarray(alpha[:2]) / sum(alpha), atol=0.01)
    for k in range(2):
        assert st.kstest(x[:, k].numpy(), st.beta(alpha[k], sum(alpha) - alpha[k]).cdf).pvalue > 1e-3
    with pytest.raises(ValueError, match="must have size 2"):
        d.sample(rng.Stream(3, 0, 0, rng.PRIOR), (3,))


def test_init_strategies():
    _, tm = _models()
    sampler = tm.init_from_prior()
    paths = torch.arange(64)
    z = sampler(rng.Stream(0, paths, 0, rng.INIT), tm.dim, torch.float64, "cpu")
    assert z.shape == (64, tm.dim) and bool(torch.isfinite(z).all())
    x = tm.sample_prior(rng.Stream(0, paths, 0, rng.INIT), torch.float64)
    np.testing.assert_allclose(tm.bijector.inverse(x).numpy(), z.numpy(), rtol=1e-12)
    assert bool((x[:, 1] > 0).all())  # sigma
    # a path's init does not depend on the batch
    z5 = sampler(rng.Stream(0, torch.tensor([5]), 0, rng.INIT), tm.dim, torch.float64, "cpu")
    assert torch.equal(z5[0], z[5])

    z0 = tm.init_from_params({"mu": 1.0, "sigma": 0.5}, dtype=torch.float64)
    x0 = tm.bijector.forward(z0)
    np.testing.assert_allclose(x0[:2].numpy(), [1.0, 0.5], rtol=1e-12)
    with pytest.raises(KeyError, match="unknown parameter"):
        tm.init_from_params({"nu": 1.0})
    with pytest.raises(ValueError, match="\\['sigma'\\] are outside the support"):
        tm.init_from_params({"sigma": -1.0})


def _gauss_model():
    def loglik(p):
        data = torch.as_tensor(DATA, dtype=p["mu"].dtype, device=p["mu"].device)
        mu, sigma = p["mu"][..., None], p["sigma"][..., None]
        return torch.sum(-0.5 * ((data - mu) / sigma) ** 2 - torch.log(sigma), dim=-1)

    return tb.BayesModel({"mu": tb.Normal(0.0, 10.0), "sigma": tb.HalfNormal(2.0)}, loglik)


def test_pathfinder_on_model_end_to_end():
    model = _gauss_model()
    res = pathfinder(model, ndraws=200, seed=0, device="cpu", dtype=torch.float64)
    assert res.success and res.transform is model.transformed
    chain = res.draws_transformed
    assert chain["mu"].shape == (200,) and bool((chain["sigma"] > 0).all())
    np.testing.assert_allclose(
        chain["logjoint"].numpy(), (chain["logprior"] + chain["loglikelihood"]).numpy(), rtol=1e-12
    )
    assert abs(float(chain["mu"].mean()) - DATA.mean()) < 0.15
    # the pushforward's density is the base's with the Jacobian taken off
    x = torch.stack([chain["mu"], chain["sigma"]])[:, :5]
    z = res.draws[:, :5]
    want = res.fit_distribution.logpdf(z) - z[1]
    np.testing.assert_allclose(
        res.fit_distribution_transformed.logpdf(x).numpy(), want.numpy(), rtol=1e-9
    )
    # init from the prior, linked
    res2 = pathfinder(model, ndraws=50, seed=1, device="cpu", dtype=torch.float64,
                      init_sampler=model.init_from_prior())
    assert res2.success


def test_multipath_on_model_and_resample_retransform():
    model = _gauss_model()
    res = multipathfinder(model, 300, nruns=4, seed=0, device="cpu", dtype=torch.float64)
    assert bool(res.states.success.all())
    chain = res.draws_transformed
    np.testing.assert_allclose(
        torch.stack([chain["mu"], chain["sigma"]]).numpy(),
        model.transformed.forward_draws(res.draws).numpy(), rtol=1e-12,
    )
    again = resample(res, 120)
    assert again.draws_transformed["mu"].shape == (120,)
    np.testing.assert_allclose(
        again.draws_transformed["sigma"].numpy(), torch.exp(again.draws[1]).numpy(), rtol=1e-12
    )
    dr, ids = res.fit_distribution_transformed.sample(rng.Stream(0, 0, 9, rng.EXTRA), 50)
    assert dr.shape == (2, 50) and bool((dr[1] > 0).all()) and ids.shape == (50,)

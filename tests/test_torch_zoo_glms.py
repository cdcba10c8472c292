"""The port's zoo targets and data generators, held against the JAX package
in f64 on the CPU: ``logp`` and its gradient at 16 random points (1e-10),
generators equal, and the GLM families through ``multipathfinder`` against a
NUTS referee (the JAX package's sampler on the same density, with the
thresholds of ``tests/test_zoo_glms.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.integrations.nuts import nuts as jnuts
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.utils.diagnostics import ess_bulk as jess_bulk
from pathfinder_tpu_torch import multipathfinder
from pathfinder_tpu_torch.integrations.transforms import TransformedLogDensity
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.models.protocol import batched_hessian

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

GENERATORS = [
    ("poisson_synthetic", dict(n=50, d=4, seed=3)),
    ("student_t_synthetic", dict(n=40, d=5, seed=1)),
    ("negative_binomial_synthetic", dict(n=60, d=3, seed=2)),
    ("ordered_logistic_synthetic", dict(n=70, d=3, n_cats=5, seed=4)),
    ("german_credit_synthetic", dict(n=30, d=6, seed=5)),
    ("german_credit_synthetic", dict()),
]


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_generators_give_the_same_data(name, kw):
    for a, b in zip(getattr(jzoo, name)(**kw), getattr(tzoo, name)(**kw)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def _targets():
    out = {
        "funnel": (jzoo.NealsFunnel(7, 2.0), tzoo.NealsFunnel(7, 2.0)),
        "banana": (jzoo.Banana(), tzoo.Banana()),
    }
    X, y, _ = jzoo.german_credit_synthetic(n=80, d=6)
    out["logistic"] = (jzoo.LogisticRegression(X, y), tzoo.LogisticRegression(X, y))
    X, y, _ = jzoo.poisson_synthetic(n=60, d=5)
    out["poisson"] = (jzoo.PoissonRegression(X, y), tzoo.PoissonRegression(X, y))
    X, y, _ = jzoo.student_t_synthetic(n=60, d=5)
    out["student_t"] = (jzoo.StudentTRegression(X, y, df=5.0, sigma=1.3),
                        tzoo.StudentTRegression(X, y, df=5.0, sigma=1.3))
    X, y, _, _ = jzoo.ordered_logistic_synthetic(n=90, d=3, n_cats=4)
    out["ordered"] = (jzoo.OrderedLogisticRegression(X, y, 4), tzoo.OrderedLogisticRegression(X, y, 4))
    X, y, _ = jzoo.negative_binomial_synthetic(n=70, d=4)
    out["negbin"] = (jzoo.NegativeBinomialRegression(X, y), tzoo.NegativeBinomialRegression(X, y))
    return out


TARGETS = _targets()


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_logp_and_gradient_match_jax(name):
    jt, tt = TARGETS[name]
    if isinstance(tt, TransformedLogDensity):
        # the constrained density at points of the support, then the linked one
        z = np.random.default_rng(1).standard_normal((16, tt.dim)) * 0.7
        x = tt.bijector.forward(torch.tensor(z))
        want = jax.vmap(jt.logp_constrained)(jnp.asarray(x.numpy()))
        np.testing.assert_allclose(tt.logp_constrained(x).numpy(), np.asarray(want), rtol=1e-10)
        jt, tt = jt.unconstrained, tt.unconstrained
    z = np.random.default_rng(0).standard_normal((16, tt.dim)) * 0.7
    jv, jg = jax.vmap(jt.value_and_grad)(jnp.asarray(z))
    tv, tg = tt.value_and_grad(torch.tensor(z))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tt.logp(torch.tensor(z)).numpy(), np.asarray(jv), rtol=1e-10, atol=1e-10)
    # f32 on the same data: the per-dtype copy of the data is used
    tv32 = tt.logp(torch.tensor(z, dtype=torch.float32))
    assert tv32.dtype == torch.float32
    np.testing.assert_allclose(tv32.numpy(), np.asarray(jv), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["logistic", "ordered", "negbin"])
def test_hessian_by_torch_func_matches_jax(name):
    """The Laplace correction's Hessian (``torch.func``) of the linked
    densities, which hold their data per dtype and device. Tolerance 1e-6:
    the two packages' trigamma (the second derivative of ``lgamma`` in the
    negative binomial) agree to about 2e-8."""
    jt, tt = TARGETS[name]
    if isinstance(tt, TransformedLogDensity):
        jt, tt = jt.unconstrained, tt.unconstrained
    z = np.random.default_rng(2).standard_normal((3, tt.dim)) * 0.5
    want = jax.vmap(jax.hessian(jt.logp))(jnp.asarray(z))
    got = batched_hessian(tt.logp)(torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # and again: nothing of the first trace was kept
    got2 = batched_hessian(tt.logp)(torch.tensor(z))
    np.testing.assert_allclose(got2.numpy(), got.numpy())


def test_ordered_logistic_far_out_is_finite_in_f32():
    """Cutpoints pushed beyond the ±200 pad, as a line-search trial can: a
    finite penalty and a finite gradient, never NaN."""
    _, tt = TARGETS["ordered"]
    z = torch.zeros(2, tt.dim, dtype=torch.float32)
    z[0, 0], z[0, 1] = -250.0, 6.2  # c₁ below the pad, a gap of e^6.2
    z[1, 0], z[1, 2] = 199.0, 5.0
    v, g = tt.unconstrained.value_and_grad(z)
    assert torch.isfinite(v).all() and torch.isfinite(g).all()


def _jax_referee(jtarget, d, key, num_samples=1500, num_warmup=400):
    out = jnuts(key, jtarget.value_and_grad, None, jnp.zeros(d), num_samples=num_samples,
                num_warmup=num_warmup, adapt_mass_matrix=True)
    xs = np.asarray(out.samples)
    assert np.all(np.asarray(jess_bulk(xs[None])) > 100)
    return xs.mean(axis=0), xs.std(axis=0)


def _check_against_referee(res, mean_ref, sd_ref):
    assert bool(res.states.success.all())
    k = float(res.psis_result.pareto_shape)
    assert k < 0.7, f"khat {k} should be good/ok on a log-concave GLM"
    z = res.draws.numpy()
    # posterior-mean agreement in posterior-sd units (importance-sampling
    # bias + Monte-Carlo error), sds within 35%
    assert np.max(np.abs(z.mean(axis=1) - mean_ref) / sd_ref) < 0.35
    np.testing.assert_allclose(z.std(axis=1), sd_ref, rtol=0.35)


@pytest.mark.parametrize("family", ["poisson", "student_t", "logistic"])
def test_glm_posterior_recovery(family):
    d = 8
    if family == "poisson":
        X, y, _ = jzoo.poisson_synthetic(n=500, d=d, seed=0)
        jt, tt = jzoo.PoissonRegression(X, y), tzoo.PoissonRegression(X, y)
    elif family == "student_t":
        X, y, _ = jzoo.student_t_synthetic(n=400, d=d, seed=0)
        jt, tt = jzoo.StudentTRegression(X, y), tzoo.StudentTRegression(X, y)
    else:
        X, y, _ = jzoo.german_credit_synthetic(n=300, d=d, seed=0)
        jt, tt = jzoo.LogisticRegression(X, y), tzoo.LogisticRegression(X, y)
    mean_ref, sd_ref = _jax_referee(jt, d, jax.random.key(10))
    res = multipathfinder(tt, 2000, seed=11, nruns=8, maxiters=64, ndraws_per_run=400,
                          device="cpu", dtype=torch.float64)
    _check_against_referee(res, mean_ref, sd_ref)
    assert res.transform is None and res.draws_transformed is res.draws


def test_ordered_logistic_full_pipeline():
    """The ``Ordered`` bijector (stacked with ``Identity`` for β) through
    the whole pipeline: optimization in unconstrained space, constrained
    draws with strictly increasing cutpoints."""
    d, K = 4, 4
    X, y, _, _ = jzoo.ordered_logistic_synthetic(n=600, d=d, n_cats=K, seed=0)
    jt, tt = jzoo.OrderedLogisticRegression(X, y, K), tzoo.OrderedLogisticRegression(X, y, K)
    mean_ref, sd_ref = _jax_referee(jt.unconstrained, jt.dim, jax.random.key(20))
    res = multipathfinder(tt, 2000, seed=21, nruns=8, maxiters=80, ndraws_per_run=400,
                          device="cpu", dtype=torch.float64)
    _check_against_referee(res, mean_ref, sd_ref)
    cut = res.draws_transformed[: K - 1]
    assert bool((torch.diff(cut, dim=0) > 0).all()), "Ordered constraint violated"
    assert res.transform is tt


def test_negative_binomial_full_pipeline():
    """NB2 regression with learned dispersion: the mixed Identity + Exp block
    transform through the whole pipeline, the dispersion's posterior near
    the generating φ."""
    d, phi_true = 6, 3.0
    X, y, _ = jzoo.negative_binomial_synthetic(n=500, d=d, phi=phi_true, seed=0)
    jt, tt = jzoo.NegativeBinomialRegression(X, y), tzoo.NegativeBinomialRegression(X, y)
    mean_ref, sd_ref = _jax_referee(jt.unconstrained, jt.dim, jax.random.key(30))
    res = multipathfinder(tt, 2000, seed=31, nruns=8, maxiters=80, ndraws_per_run=400,
                          device="cpu", dtype=torch.float64)
    _check_against_referee(res, mean_ref, sd_ref)
    phi = res.draws_transformed[d]
    assert bool((phi > 0).all()) and 1.0 < float(phi.mean()) < 9.0

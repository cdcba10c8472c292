"""The port's multipathfinder as a whole, held against the JAX package.

* Statistical parity at d=16, K=8, maxiters=64 over 5 seeds: both packages
  start from the same initial points (seeded numpy) in f64, so their L-BFGS
  trajectories and evaluation counts agree up to stopping-rule ties at the
  f64 noise floor; their
  noise differs (threefry vs the port's Philox streams), so k̂ and the moment
  error are compared as medians against a band around the JAX values:
  ``[min − r/2, max + r/2]`` of the JAX per-seed values, r their range.
* Determinism: a path's draws are bitwise identical alone, in a batch of 8,
  and in a retry batch.
* The numpy copy of ``hierarchical_gaussian_truth`` equals the original.
* ``import pathfinder_tpu_torch`` loads no JAX.
* ``grad=`` and ``transform=`` at both entry points, their errors, and the
  constrained-space result fields through ``resample`` and
  ``laplace_resample``.
* The slice as a whole, ``multipathfinder(transform=...)`` then
  ``nuts_chains``, on the negative-binomial model against the JAX package.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu import multipathfinder as jmultipathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu_torch import laplace_resample, multipathfinder, resample
from pathfinder_tpu_torch.integrations import transforms as ttr
from pathfinder_tpu_torch.models import bayes as tb
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.singlepath import PathfinderConfig, pathfinder_core, pathfinder
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

# the submodule: the package exports the function ``nuts`` under its name
tnuts = importlib.import_module("pathfinder_tpu_torch.integrations.nuts")


def _moment_err(draws, mean_t, sd_t):
    """Max standardized error of the draw means (draws ``(d, N)``)."""
    x = np.asarray(draws, dtype=np.float64)
    return float(np.max(np.abs(x.mean(axis=1) - mean_t) / sd_t))


def _band(values):
    lo, hi = min(values), max(values)
    r = hi - lo
    return lo - r / 2, hi + r / 2


def _statistical_parity(d, K, seeds, maxiters=64):
    jt, tt = jzoo.HierarchicalGaussian(d, seed=0), tzoo.HierarchicalGaussian(d, seed=0)
    mean_t, sd_t = tzoo.hierarchical_gaussian_truth(d, seed=0)
    jk, jm, tk, tm = [], [], [], []
    n_equal = 0
    for s in seeds:
        init = np.random.default_rng(100 + s).uniform(-2.0, 2.0, (K, d))
        jr = jmultipathfinder(
            jt, 1000, key=jax.random.key(s), init=jnp.asarray(init),
            maxiters=maxiters, elbo_chunk=8,
        )
        tr = multipathfinder(
            tt, 1000, seed=s, init=init, maxiters=maxiters, elbo_chunk=8, device="cpu"
        )
        assert bool(np.all(np.asarray(jr.states.success)))
        assert bool(tr.states.success.all())
        assert int(tr.num_tries.max()) == 1
        # same initial points, same deterministic optimizer: the evaluation
        # counts agree, except where a late step's ftol stall test (10 ulps
        # of f) is decided by summation-order rounding of logp
        t_ev = tr.states.num_fn_evals.numpy()
        j_ev = np.asarray(jr.states.num_fn_evals)
        n_equal += int(np.sum(t_ev == j_ev))
        assert abs(int(t_ev.sum()) - int(j_ev.sum())) <= 0.01 * j_ev.sum()
        assert torch.isfinite(tr.draws).all()
        jk.append(float(jr.psis_result.pareto_shape))
        tk.append(float(tr.psis_result.pareto_shape))
        jm.append(_moment_err(jr.draws, mean_t, sd_t))
        tm.append(_moment_err(tr.draws.numpy(), mean_t, sd_t))
    assert n_equal >= 0.8 * K * len(seeds)
    for name, jv, tv in (("khat", jk, tk), ("moment error", jm, tm)):
        lo, hi = _band(jv)
        med = float(np.median(tv))
        assert lo <= med <= hi, f"{name}: port median {med} outside JAX band [{lo}, {hi}] (JAX {jv})"


def test_multipathfinder_statistical_parity_small():
    _statistical_parity(16, 8, seeds=range(5))


@pytest.mark.slow
def test_multipathfinder_statistical_parity_headline():
    _statistical_parity(1000, 100, seeds=range(5))


def test_a_paths_draws_do_not_depend_on_its_batch():
    d, K, seed = 16, 8, 3
    target = tzoo.HierarchicalGaussian(d, seed=0)
    res = multipathfinder(
        target, 100, seed=seed, nruns=K, maxiters=64, elbo_chunk=8, device="cpu"
    )
    cfg = res.config

    def run(path_ids, round_idx):
        ids = torch.tensor(path_ids)
        stream = rng.Stream(seed, ids, round_idx, rng.INIT)
        x0 = stream.uniform(d, torch.float32, "cpu") * 4.0 - 2.0
        return pathfinder_core(target, x0, cfg, seed, ids, round_idx)

    for k in (0, 5):
        alone = run([k], 0)
        assert torch.equal(alone.draws[0], res.states.draws[k])
        assert torch.equal(alone.trace.xs[0], res.states.trace.xs[k])
    # a retry batch: failed lanes compacted and padded by repeating the first
    retry = run([5, 2, 5, 5], 1)
    alone = run([5], 1)
    assert torch.equal(retry.draws[0], alone.draws[0])
    assert torch.equal(retry.draws[2], alone.draws[0])
    assert not torch.equal(alone.draws[0], res.states.draws[5])  # a new round
    again = multipathfinder(
        target, 100, seed=seed, nruns=K, maxiters=64, elbo_chunk=8, device="cpu"
    )
    assert torch.equal(again.draws, res.draws)


def test_resample_reuses_psis_and_chained_calls_differ():
    target = tzoo.HierarchicalGaussian(16, seed=0)
    res = multipathfinder(target, 50, seed=2, nruns=4, maxiters=32, elbo_chunk=8, device="cpu")
    r1 = resample(res, 30)
    r2 = resample(r1, 30)
    assert r1.psis_result is res.psis_result and r1.draws.shape == (16, 30)
    assert not torch.equal(r1.draws, r2.draws)
    fresh = resample(res, 30, ndraws_per_run=7)
    assert fresh.draws_per_component.shape == (4, 7, 16)
    assert fresh.psis_result.weights.shape == (28,)
    assert torch.isfinite(fresh.draws).all()
    uniform = resample(res, 30, importance=False)
    assert uniform.psis_result is None


def test_single_path_pathfinder_runs_and_succeeds():
    r = pathfinder(
        tzoo.HierarchicalGaussian(16, seed=0), seed=1, maxiters=64, ndraws=12, device="cpu"
    )
    assert r.success and r.draws.shape == (16, 12) and torch.isfinite(r.draws).all()
    assert r.num_fn_evals > r.optim_trace.num_valid.item() > 2


def test_truth_copy_equals_the_original():
    for d, seed in ((16, 0), (1000, 0), (50, 3)):
        jm, js = jzoo.hierarchical_gaussian_truth(d, seed)
        tm, ts = tzoo.hierarchical_gaussian_truth(d, seed)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ts, js)


def test_targets_equal_jax_targets():
    x = np.random.default_rng(0).standard_normal((5, 16))
    for jt, tt in (
        (jzoo.HierarchicalGaussian(16, seed=2), tzoo.HierarchicalGaussian(16, seed=2)),
        (jzoo.StandardNormal(16), tzoo.StandardNormal(16)),
        (jzoo.CorrelatedGaussian(16, seed=4), tzoo.CorrelatedGaussian(16, seed=4)),
    ):
        want = np.asarray(jax.vmap(jt.logp)(jnp.asarray(x)))
        np.testing.assert_allclose(tt.logp(torch.tensor(x)).numpy(), want, rtol=1e-12)
        _, g = tt.value_and_grad(torch.tensor(x))
        jg = np.asarray(jax.vmap(jax.grad(jt.logp))(jnp.asarray(x)))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tt.mean, jt.mean)  # the correlated Gaussian's moments
    np.testing.assert_array_equal(tt.cov, jt.cov)


def test_target_hessians_equal_jax_and_survive_repeated_tracing():
    """``batched_hessian`` of a zoo target equals ``jax.hessian`` per row,
    whether the target is first called under ``torch.func`` (its cached
    data must then not be a tensor of that trace) or outside it."""
    from pathfinder_tpu_torch.models.protocol import batched_hessian

    x = np.random.default_rng(1).standard_normal((3, 8))
    for jt, tt in (
        (jzoo.HierarchicalGaussian(8, seed=2), tzoo.HierarchicalGaussian(8, seed=2)),
        (jzoo.CorrelatedGaussian(8, seed=4), tzoo.CorrelatedGaussian(8, seed=4)),
    ):
        want = np.asarray(jax.vmap(jax.hessian(jt.logp))(jnp.asarray(x)))
        hess = batched_hessian(tt.logp)
        assert batched_hessian(tt.logp) is hess  # derived once per target
        for _ in range(2):  # the second trace finds whatever the first left
            np.testing.assert_allclose(hess(torch.tensor(x)).numpy(), want, rtol=1e-10, atol=1e-12)
        lp = tt.logp(torch.tensor(x))  # now cached outside a trace
        np.testing.assert_allclose(hess(torch.tensor(x)).numpy(), want, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jax.vmap(jt.logp)(jnp.asarray(x))), rtol=1e-12)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pathfinder_tpu_torch, pathfinder_tpu_torch.interop, "
        "pathfinder_tpu_torch.ops.kernels.woodbury_kernels, "
        "pathfinder_tpu_torch.integrations.nuts, pathfinder_tpu_torch.integrations.ppl, "
        "pathfinder_tpu_torch.models.bayes, pathfinder_tpu_torch.models.zoo, "
        "pathfinder_tpu_torch.models, pathfinder_tpu_torch.integrations, "
        "pathfinder_tpu_torch.parallel.sharding, pathfinder_tpu_torch.utils.serialize, "
        "pathfinder_tpu_torch.utils.progress; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathfinder_tpu')]; "
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)


def test_unported_options_raise():
    """Every option of the JAX entry point is taken: a mesh over the paths
    and the parameter dimension, and the serving-scale options. On the
    ``dim`` axis every optimizer runs (``test_torch_dim_optimizers.py``
    holds what they give)."""
    from pathfinder_tpu_torch.parallel.sharding import Mesh, paths_mesh

    t = tzoo.StandardNormal(4)
    dim_mesh = Mesh(np.array([["cpu", "cpu"]], dtype=object), ("paths", "dim"))
    assert dim_mesh.shape == {"paths": 1, "dim": 2}
    r = multipathfinder(t, 10, nruns=2, maxiters=3, device="cpu", mesh=dim_mesh)
    assert r.states.draws.shape == (2, 4, 5) and bool(torch.isfinite(r.draws).all())
    r = multipathfinder(t, 10, nruns=2, maxiters=3, device="cpu", mesh=dim_mesh, optimizer="cg")
    assert r.states.draws.shape == (2, 4, 5) and bool(torch.isfinite(r.draws).all())
    r = multipathfinder(t, 10, nruns=3, maxiters=3, device="cpu", max_paths_per_launch=2,
                        keep_traces=False, offload_launches=True, progress=False, progress_every=0,
                        mesh=paths_mesh(["cpu"]))
    assert r.max_paths_per_launch == 2 and r.states.trace.xs.shape == (3, 0, 4)


@pytest.mark.parametrize("options", [
    {"optimizer": "cg"},
    {"optimizer": "auto"},
    {"optimizer": "auto", "auto_laplace": True},
    {"optimizer": "auto", "auto_laplace": "full", "auto_optimizers": ("cg",),
     "auto_khat_early_exit": None},
    {"importance_denominator": "mixture"},
    {"line_search": "backtracking"},
    {"line_search": "wolfe"},
    {"line_search": "more_thuente", "optimizer": "bfgs"},
])
def test_ported_options_run(options):
    """The options of the k̂-remedy path run through the entry point on the
    CPU, and without ``device=`` they ask for the card like any call."""
    import warnings

    t = tzoo.HierarchicalGaussian(8, seed=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the bad-k̂ hint, not under test here
        r = multipathfinder(t, 40, nruns=4, maxiters=30, seed=1, device="cpu", **options)
    assert r.draws.shape == (8, 40) and torch.isfinite(r.draws).all()
    assert bool(r.states.success.all())
    assert r.config.line_search == options.get("line_search", "hager_zhang")
    assert r.importance_denominator == options.get("importance_denominator", "component")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multipathfinder(t, 40, nruns=4, maxiters=30, seed=1, **options)


def test_config_carried_over_from_jax():
    from pathfinder_tpu.singlepath import PathfinderConfig as JConfig
    from pathfinder_tpu_torch.interop import config_from_fields

    jc = JConfig(maxiters=7, optimizer="cg", line_search="wolfe", c1=0.2, elbo_chunk=4)
    tc = config_from_fields(jc)
    assert isinstance(tc, PathfinderConfig)
    for name in PathfinderConfig.__dataclass_fields__:
        assert getattr(tc, name) == getattr(jc, name), name
    assert config_from_fields(dict(maxiters=3)) == PathfinderConfig(maxiters=3)
    assert config_from_fields(JConfig(progress_every=5)).progress_every == 5
    with pytest.raises(NotImplementedError, match="no_such_field"):
        config_from_fields(dict(maxiters=3, no_such_field=1))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        multipathfinder(tzoo.StandardNormal(4), 10, nruns=2, maxiters=3, device="cuda")


@pytest.mark.parametrize("entry", ["multipathfinder", "pathfinder"])
def test_entry_points_default_to_the_card(entry):
    """With no ``device`` argument the entry points run on the card, so on
    a machine without CUDA they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    target = tzoo.StandardNormal(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "multipathfinder":
            multipathfinder(target, 10, nruns=2, maxiters=3)
        else:
            pathfinder(target, maxiters=3)


def _lognormal_target():
    """Π LogNormal(0.3, 0.7) over 3 positives: the constrained density, its
    gradient, and the ``Exp`` link."""
    mu, sig = 0.3, 0.7

    def logp(x):
        lx = torch.log(x)
        return torch.sum(-0.5 * ((lx - mu) / sig) ** 2 - lx, dim=-1)

    def grad(x):
        return (-(torch.log(x) - mu) / sig**2 - 1.0) / x

    return logp, grad


@pytest.mark.parametrize("entry", ["multipathfinder", "pathfinder"])
def test_grad_option_replaces_autograd(entry):
    """A user gradient, batched ``(K, d) -> (K, d)``, is what the optimizer
    calls; the result equals the autograd run's bit for bit."""
    t = tzoo.CorrelatedGaussian(5, seed=2)
    calls = []

    def grad(x):
        calls.append(tuple(x.shape))
        return t.value_and_grad(x)[1]

    kw = dict(seed=3, maxiters=40, device="cpu", dtype=torch.float64)
    if entry == "multipathfinder":
        a = multipathfinder(t.logp, 30, nruns=4, dim=5, grad=grad, **kw)
        b = multipathfinder(t.logp, 30, nruns=4, dim=5, **kw)
        assert all(shape[1] == 5 for shape in calls) and (4, 5) in calls
    else:
        a = pathfinder(t.logp, dim=5, grad=grad, **kw)
        b = pathfinder(t.logp, dim=5, **kw)
    assert calls and torch.equal(a.draws, b.draws)
    assert a.transform is None and a.draws_transformed is a.draws


@pytest.mark.parametrize("entry", ["multipathfinder", "pathfinder"])
def test_transform_option_with_bijector_and_constrained_grad(entry):
    """``transform=<bijector>``: ``fn`` and ``grad=`` are in the constrained
    space, the run in the unconstrained one; with the chain-ruled gradient
    the user's logp is never differentiated and the draws are the autograd
    run's up to rounding. The dimension comes from ``init`` where ``dim`` is
    not given."""
    logp, grad = _lognormal_target()
    kw = dict(seed=0, maxiters=40, device="cpu", dtype=torch.float64)
    run = (lambda **o: multipathfinder(logp, 64, nruns=4, **o, **kw)) if entry == "multipathfinder" \
        else (lambda **o: pathfinder(logp, ndraws=64, **o, **kw))
    a = run(transform=ttr.Exp(), dim=3, grad=grad)
    b = run(transform=ttr.Exp(), dim=3)
    np.testing.assert_allclose(a.draws.numpy(), b.draws.numpy(), rtol=1e-6, atol=1e-8)
    assert isinstance(a.transform, ttr.TransformedLogDensity) and a.transform.grad_constrained is grad
    assert a.draws_transformed.shape == (3, 64) and bool((a.draws_transformed > 0).all())
    np.testing.assert_allclose(a.draws_transformed.numpy(), torch.exp(a.draws).numpy(), rtol=1e-12)
    # the pushforward of the fit: log q(x) = log q_z(log x) − Σ log x
    x = a.draws_transformed[:, :4]
    want = a.fit_distribution.logpdf(torch.log(x)) - torch.log(x).sum(0)
    np.testing.assert_allclose(a.fit_distribution_transformed.logpdf(x).numpy(), want.numpy(), rtol=1e-9)
    # E[log x] = 0.3 under the target
    assert abs(float(a.draws.mean()) - 0.3) < 0.25
    init = np.zeros((4, 3)) if entry == "multipathfinder" else np.zeros(3)
    c = (multipathfinder(logp, 16, init=init, transform=ttr.Exp(), **kw) if entry == "multipathfinder"
         else pathfinder(logp, init=init, transform=ttr.Exp(), **kw))
    assert c.transform.dim == 3


def test_transform_inputs_and_errors():
    logp, grad = _lognormal_target()
    tld = ttr.TransformedLogDensity(logp, ttr.Exp(), 3)
    kw = dict(seed=0, maxiters=30, device="cpu", dtype=torch.float64)
    by_fn = multipathfinder(tld, 16, nruns=2, **kw)
    by_kw = multipathfinder(None, 16, nruns=2, transform=tld, **kw)
    assert by_fn.transform is tld and torch.equal(by_fn.draws, by_kw.draws)
    assert torch.equal(pathfinder(tld, **kw).draws, pathfinder(None, transform=tld, **kw).draws)
    hess = lambda x: torch.zeros(x.shape[0], 3, 3, dtype=x.dtype)
    for call in (lambda **o: multipathfinder(tld, 16, nruns=2, **o, **kw),
                 lambda **o: pathfinder(tld, **o, **kw)):
        with pytest.raises(ValueError, match="hess= cannot be combined with a transform"):
            call(hess=hess)
        with pytest.raises(ValueError, match="grad= cannot be combined"):
            call(grad=grad)
    with pytest.raises(TypeError, match="Bijector or TransformedLogDensity"):
        multipathfinder(logp, 16, nruns=2, dim=3, transform="exp", **kw)
    with pytest.raises(ValueError, match="dim is required"):
        multipathfinder(logp, 16, nruns=2, transform=ttr.Exp(), **kw)


def test_explicit_transform_overrides_the_models_chain_conversion():
    """A model run under its own link gets the named chain dict; under
    another ``transform=`` the draws are mapped by that transform, so that
    they stay consistent with ``fit_distribution_transformed``."""
    model = tb.BayesModel({"a": tb.HalfNormal(1.0), "b": (tb.Normal(0.0, 1.0), 2)})
    kw = dict(seed=0, maxiters=30, device="cpu", dtype=torch.float64)
    own = multipathfinder(model, 20, nruns=2, **kw)
    assert set(own.draws_transformed) >= {"a", "b", "logjoint"}
    assert own.draws_transformed["b"].shape == (20, 2)
    other = ttr.TransformedLogDensity(model.constrained_logp, ttr.Exp(), 3)
    res = multipathfinder(model, 20, nruns=2, transform=other, **kw)
    assert isinstance(res.draws_transformed, torch.Tensor)
    np.testing.assert_allclose(res.draws_transformed.numpy(), torch.exp(res.draws).numpy(), rtol=1e-12)


def test_resample_and_laplace_resample_rebuild_the_transformed_fields():
    X, y, _ = tzoo.negative_binomial_synthetic(n=120, d=3, seed=1)
    tld = tzoo.NegativeBinomialRegression(X, y)
    res = multipathfinder(tld, 60, nruns=4, seed=2, maxiters=60, device="cpu", dtype=torch.float64)
    again = resample(res, 25)
    assert again.draws_transformed.shape == (4, 25)
    np.testing.assert_allclose(again.draws_transformed.numpy(), tld.forward_draws(again.draws).numpy())
    assert again.fit_distribution_transformed is res.fit_distribution_transformed
    for method in ("diag", "full"):
        lap = laplace_resample(res, 40, method=method)
        # the Hessian is the linked density's: finite everywhere, PD near the mode
        assert lap.fit_distribution.components.cov.B.shape[-1] == 0
        assert lap.fit_distribution_transformed.base is lap.fit_distribution
        assert lap.fit_distribution_transformed is not res.fit_distribution_transformed
        np.testing.assert_allclose(lap.draws_transformed.numpy(), tld.forward_draws(lap.draws).numpy())
        assert bool((lap.draws_transformed[3] > 0).all()) and np.isfinite(float(lap.psis_result.pareto_shape))
        x = lap.draws_transformed[:, :3]
        z = lap.draws[:, :3]
        np.testing.assert_allclose(
            lap.fit_distribution_transformed.logpdf(x).numpy(),
            (lap.fit_distribution.logpdf(z) - z[3]).numpy(), rtol=1e-9,
        )


def test_transform_run_follows_the_jax_trajectories():
    """From the same initial points in f64 the port's L-BFGS on the linked
    ordered-logistic density walks the JAX package's trajectories: equal
    evaluation counts on at least 3 of 4 paths (a stopping-rule tie at the
    noise floor may move one), optima within 1e-5."""
    X, y, _, _ = jzoo.ordered_logistic_synthetic(n=200, d=3, n_cats=4, seed=0)
    jt, tt = jzoo.OrderedLogisticRegression(X, y, 4), tzoo.OrderedLogisticRegression(X, y, 4)
    init = np.random.default_rng(0).uniform(-1.0, 1.0, (4, jt.dim))
    jr = jmultipathfinder(jt, 40, key=jax.random.key(0), init=jnp.asarray(init), maxiters=60)
    tr = multipathfinder(tt, 40, seed=0, init=init, maxiters=60, device="cpu")
    assert tr.draws.dtype == torch.float64
    je, te = np.asarray(jr.states.num_fn_evals), tr.states.num_fn_evals.numpy()
    assert int((je == te).sum()) >= 3, (je, te)
    jbest = np.asarray(jr.states.trace.log_densities).max(axis=1)
    tbest = tr.states.trace.log_densities.nan_to_num(nan=-np.inf).max(dim=1).values.numpy()
    np.testing.assert_allclose(tbest, jbest, rtol=1e-5)
    cut = tr.draws_transformed[:3]
    assert bool((torch.diff(cut, dim=0) > 0).all())
    assert np.asarray(jr.draws_transformed).shape == tuple(tr.draws_transformed.shape)


def _jnuts():
    return importlib.import_module("pathfinder_tpu.integrations.nuts")


def test_slice_as_a_whole_negative_binomial_against_jax():
    """``multipathfinder(transform=...)`` then ``nuts_chains`` on the
    negative-binomial model at its test size, in both packages: the posterior
    means agree within Monte-Carlo error (5 standard errors from both ESS),
    the sds within 25%, and both runs mix (R̂ < 1.05)."""
    d = 6
    X, y, _ = jzoo.negative_binomial_synthetic(n=500, d=d, phi=3.0, seed=0)
    jt, tt = jzoo.NegativeBinomialRegression(X, y), tzoo.NegativeBinomialRegression(X, y)
    jres = jmultipathfinder(jt, 200, key=jax.random.key(1), nruns=8, maxiters=80)
    jvg, jmetric, jx0 = _jnuts().warm_start_chains(jres, 4)
    jout, jsum = _jnuts().nuts_chains(jax.random.key(2), jvg, jmetric, jx0, num_samples=200,
                                   num_warmup=100, max_depth=6)
    # the port, with the constrained density and the bijector given apart
    res = multipathfinder(tt.logp_constrained, 200, transform=tt.bijector, dim=tt.dim, seed=1,
                          nruns=8, maxiters=80, device="cpu", dtype=torch.float64)
    assert bool(res.states.success.all()) and float(res.psis_result.pareto_shape) < 0.7
    assert bool((res.draws_transformed[d] > 0).all())
    vg, metric, x0s = tnuts.warm_start_chains(res, 4)
    out, summ = tnuts.nuts_chains(2, vg, metric, x0s, num_samples=200, num_warmup=100, max_depth=6)
    assert not bool(out.diverging.any())
    assert float(summ["rhat"].max()) < 1.05 and float(np.max(np.asarray(jsum["rhat"]))) < 1.05
    jmean, jsd = np.asarray(jsum["mean"]), np.asarray(jsum["sd"])
    se = np.sqrt(jsd**2 / np.asarray(jsum["ess_bulk"]) + summ["sd"].numpy() ** 2 / summ["ess_bulk"].numpy())
    assert np.max(np.abs(summ["mean"].numpy() - jmean) / se) < 5.0
    np.testing.assert_allclose(summ["sd"].numpy(), jsd, rtol=0.25)
    # the Pathfinder draws themselves are near the NUTS posterior
    assert np.max(np.abs(res.draws.mean(1).numpy() - jmean) / jsd) < 0.35

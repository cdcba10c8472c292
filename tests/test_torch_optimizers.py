"""Parity of the port's trajectory optimizers other than L-BFGS (CG, BFGS,
Newton) with the JAX package's, and of the optimizer registry.

Same ``x0`` (seeded numpy) and the same target data in f64, through the JAX
function under ``vmap`` and the port's batched one. Trajectories agree to
``rtol=1e-8`` (the same algorithm, sums taken in another order) on the rows
both made. The discrete outcomes (valid points, per-lane evaluation counts,
rejections, exhausted searches) are equal, with one allowance: a lane's last
step may be decided the other way where the ``ftol`` stall test (10 ulps of
f) falls on a rounding tie, so a lane may end one step apart, and at least
5 of the 6 lanes must agree exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.models.protocol import cached_hessian
from pathfinder_tpu.ops import optimizers as jopt
from pathfinder_tpu.ops.bfgs import minimize_bfgs_trace as j_bfgs
from pathfinder_tpu.ops.cg import minimize_cg_trace as j_cg
from pathfinder_tpu.ops.newton import minimize_newton_trace as j_newton
from pathfinder_tpu_torch import multipathfinder, pathfinder
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.models.protocol import LogDensity, as_log_density, batched_hessian
from pathfinder_tpu_torch.ops import optimizers as topt
from pathfinder_tpu_torch.ops.bfgs import minimize_bfgs_trace
from pathfinder_tpu_torch.ops.cg import minimize_cg_trace
from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace
from pathfinder_tpu_torch.ops.newton import minimize_newton_trace

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

MAXITERS = 40
K, D = 6, 12


def _targets(name):
    if name == "hierarchical":
        return jzoo.HierarchicalGaussian(D, seed=3), tzoo.HierarchicalGaussian(D, seed=3)
    return jzoo.CorrelatedGaussian(D, seed=1), tzoo.CorrelatedGaussian(D, seed=1)


def _run_both(opt, target, line_search):
    jt, tt = _targets(target)
    # Newton's first steps from far out are long (a near-flat direction of
    # the hierarchical target) and land where f overflows; the searches then
    # end on rounding ties, and JAX itself takes another path alone than
    # under vmap. So Newton starts nearer the mode.
    scale = 0.5 if opt == "newton" else 2.0
    x0s = np.random.default_rng(11).uniform(-scale, scale, (K, D))
    kw = dict(maxiters=MAXITERS, line_search=line_search)
    if opt == "newton":
        jmin = lambda x0: j_newton(jt.value_and_grad, x0, hess=cached_hessian(jt.logp), **kw)
        tmin = lambda x0: minimize_newton_trace(
            tt.value_and_grad, x0, hess=batched_hessian(tt.logp), **kw)
    else:
        jfn, tfn = {"cg": (j_cg, minimize_cg_trace), "bfgs": (j_bfgs, minimize_bfgs_trace)}[opt]
        jmin = lambda x0: jfn(jt.value_and_grad, x0, **kw)
        tmin = lambda x0: tfn(tt.value_and_grad, x0, **kw)
    return jax.jit(jax.vmap(jmin))(jnp.asarray(x0s)), tmin(torch.tensor(x0s))


@pytest.mark.parametrize("opt,target,line_search", [
    ("cg", "hierarchical", "hager_zhang"),
    ("cg", "correlated", "hager_zhang"),
    ("cg", "hierarchical", "backtracking"),
    ("bfgs", "hierarchical", "hager_zhang"),
    ("bfgs", "correlated", "wolfe"),
    ("bfgs", "hierarchical", "more_thuente"),
    ("newton", "hierarchical", "hager_zhang"),
    ("newton", "correlated", "more_thuente"),
])
def test_trajectories_and_counts_match_jax(opt, target, line_search):
    jtr, ttr = _run_both(opt, target, line_search)
    jn, tn = np.asarray(jtr.num_valid), ttr.num_valid.numpy()
    # the lanes really iterate (Newton is exact on a Gaussian: one step)
    assert jn.min() > (1 if (opt, target) == ("newton", "correlated") else 2)
    assert np.all(np.abs(tn - jn) <= 1)
    same = tn == jn
    assert same.sum() >= K - 1
    for name in ("num_fn_evals", "num_bfgs_updates_rejected", "num_ls_exhausted"):
        got, want = getattr(ttr, name).numpy(), np.asarray(getattr(jtr, name))
        np.testing.assert_array_equal(got[same], want[same], err_msg=name)
    for k in range(K):
        n = min(jn[k], tn[k])
        np.testing.assert_allclose(
            ttr.xs[k, :n].numpy(), np.asarray(jtr.xs[k, :n]), rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(
            ttr.log_densities[k, :n].numpy(), np.asarray(jtr.log_densities[k, :n]), rtol=1e-8)
        np.testing.assert_allclose(
            ttr.gradients[k, :n].numpy(), np.asarray(jtr.gradients[k, :n]), rtol=1e-7, atol=1e-7)


def test_finished_lanes_keep_their_state():
    """A lane's trajectory and evaluation count are the same alone and in a
    batch with lanes that run longer (the masked loop freezes it)."""
    tt = tzoo.HierarchicalGaussian(D, seed=3)
    x0s = torch.tensor(np.random.default_rng(5).uniform(-2.0, 2.0, (4, D)))
    for fn in (minimize_cg_trace, minimize_bfgs_trace):
        batch = fn(tt.value_and_grad, x0s, maxiters=MAXITERS)
        assert len(set(batch.num_valid.tolist())) > 1
        for k in range(4):
            alone = fn(tt.value_and_grad, x0s[k : k + 1], maxiters=MAXITERS)
            assert torch.equal(alone.xs[0], batch.xs[k])
            assert int(alone.num_fn_evals[0]) == int(batch.num_fn_evals[k])


def test_nonfinite_start_aborts_and_nonfinite_hessian_falls_back():
    tt = tzoo.StandardNormal(4)

    def logp(x):
        return torch.where(x[:, 0] > 10, torch.nan, tt.logp(x))

    x0 = torch.tensor([[11.0, 0, 0, 0], [1.0, 1, 1, 1]], dtype=torch.float64)
    for fn in (minimize_cg_trace, minimize_bfgs_trace):
        tr = fn(LogDensity(logp, 4).value_and_grad, x0, maxiters=10)
        assert tr.num_valid.tolist()[0] == 1 and tr.num_fn_evals.tolist()[0] == 1
        assert tr.num_valid.tolist()[1] > 1
    # a Hessian that is NaN on one lane: that lane takes steepest descent
    nan_hess = lambda x: torch.full((x.shape[0], 4, 4), torch.nan, dtype=x.dtype)
    tr = minimize_newton_trace(tt.value_and_grad, x0[1:], hess=nan_hess, maxiters=10)
    assert tr.num_valid.item() > 1 and torch.isfinite(tr.xs).all()
    with pytest.raises(ValueError, match="requires hess"):
        minimize_newton_trace(tt.value_and_grad, x0)


def test_registry_names_and_errors_match_jax():
    assert tuple(topt.OPTIMIZERS) == tuple(jopt.OPTIMIZERS)
    assert topt.NEWTON_DENSE_DIM_WARN == jopt.NEWTON_DENSE_DIM_WARN
    target = tzoo.StandardNormal(3)
    assert topt.resolve_optimizer("lbfgs", target) is minimize_lbfgs_trace
    assert topt.resolve_optimizer("cg", target) is minimize_cg_trace
    assert topt.resolve_optimizer("bfgs", target) is minimize_bfgs_trace
    mine = lambda *a, **k: None
    assert topt.resolve_optimizer(mine, target) is mine
    jtarget = jzoo.StandardNormal(3)
    for bad, exc in (("auto", ValueError), ("adam", ValueError), (3, TypeError)):
        with pytest.raises(exc) as jerr:
            jopt.resolve_optimizer(bad, jtarget)
        with pytest.raises(exc) as terr:
            topt.resolve_optimizer(bad, target)
        assert str(terr.value) == str(jerr.value).replace("pathfinder_tpu.", "pathfinder_tpu_torch.")
    with pytest.raises(ValueError, match="multipathfinder feature"):
        pathfinder(target, optimizer="auto", device="cpu")
    with pytest.warns(UserWarning, match="optimizer='newton' at d=2001"):
        topt.resolve_optimizer("newton", LogDensity(target.logp, 2001), dim=2001)


def test_newton_uses_the_targets_own_hessian():
    calls = []

    def hess(x):
        calls.append(x.shape)
        return -torch.eye(3, dtype=x.dtype).expand(x.shape[0], 3, 3)

    r = multipathfinder(tzoo.StandardNormal(3), 20, nruns=4, maxiters=8, seed=0,
                        optimizer="newton", hess=hess, device="cpu")
    assert calls and bool(r.states.success.all())
    # exact curvature: one Newton step from anywhere lands on the mode
    assert int(r.states.trace.num_valid.max()) == 2
    # the explicit argument wins over a target's own
    other = lambda x: None
    assert as_log_density(LogDensity(lambda x: x, 3, hess=hess), hess=other).hess is other
    assert as_log_density(LogDensity(lambda x: x, 3, hess=hess)).hess is hess


def test_a_user_callable_with_the_trace_contract_plugs_in():
    """An optimizer of the user's own: steepest descent on top of the
    port's L-BFGS with no history."""
    seen = {}

    def my_optimizer(value_and_grad, x0, **kw):
        seen.update(kw)
        return minimize_lbfgs_trace(value_and_grad, x0, **{**kw, "history_length": 0})

    target = tzoo.HierarchicalGaussian(8, seed=0)
    r = multipathfinder(target, 40, nruns=4, maxiters=30, seed=1, optimizer=my_optimizer,
                        device="cpu")
    assert r.config.optimizer is my_optimizer
    assert set(seen) == {
        "maxiters", "history_length", "gtol", "ftol", "epsilon_curvature", "max_ls_evals",
        "c1", "c2", "fail_on_nonfinite", "line_search",
    }
    assert bool(r.states.success.all()) and torch.isfinite(r.draws).all()
    one = pathfinder(target, seed=1, maxiters=30, optimizer=my_optimizer, device="cpu")
    assert one.success


@pytest.mark.parametrize("opt", ["cg", "bfgs", "newton"])
def test_multipathfinder_runs_each_optimizer(opt):
    r = multipathfinder(tzoo.HierarchicalGaussian(8, seed=0), 40, nruns=4, maxiters=30, seed=2,
                        optimizer=opt, device="cpu", dtype=torch.float64)
    assert r.config.optimizer == opt
    assert bool(r.states.success.all()) and torch.isfinite(r.draws).all()
    assert np.isfinite(float(r.psis_result.pareto_shape))

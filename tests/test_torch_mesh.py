"""The paths axis of the port's device mesh (``parallel/sharding.py``,
``multipathfinder(mesh=)``), held against the JAX package's mesh and against
the port without a mesh.

* Against the JAX package on its 8 virtual CPU devices: the same seeded numpy
  ``init=`` points through ``multipathfinder(mesh=paths_mesh(devices[:4]))``
  and the port's ``paths_mesh(["cpu"] * 4)``, with the JAX package's ELBO
  noise injected into the port (the ELBO picks each path's fit by Monte
  Carlo, and the two packages' generators differ). The result holds
  ``nruns`` paths; success flags are equal; per-lane evaluation counts are
  equal on at least 80% of the lanes (the rest: the f64 ``ftol`` stall test
  decided by summation order, as in ``test_torch_multipath.py``), and on
  those lanes the trajectories agree to ``rtol=1e-8`` (as
  ``test_torch_lbfgs.py``) and the fit iterations are equal.
* ``pad_paths`` and ``chunk_launches``' cap rounding equal the JAX
  package's (``align=False``) exactly.
* Port against port: a mesh of ``n`` blocks with launches of ``n·c`` lanes
  is bitwise the run without a mesh with launches of ``c`` (states, pooled
  draws, PSIS weights, resampled ids and draws), for mesh widths 1, 2 and
  4, the CG optimizer, retry rounds, offloaded launches, the mixture
  denominator, ``optimizer="auto"`` and a path count the width does not
  divide.
* On a mesh with a ``dim`` axis another optimizer than L-BFGS raises; an
  exception in one block propagates;
  the kernels' launch counts and the zoo's per-device copies are safe from
  several threads.
"""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pathfinder_tpu import multipathfinder as jmultipathfinder
from pathfinder_tpu.models import zoo as jzoo
from pathfinder_tpu.parallel import sharding as jsharding
from pathfinder_tpu_torch import make_path_executor, multipathfinder, paths_mesh
from pathfinder_tpu_torch import singlepath as tsinglepath
from pathfinder_tpu_torch.models import zoo as tzoo
from pathfinder_tpu_torch.parallel import sharding
from pathfinder_tpu_torch.utils.misc import tree_map

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

D, MAXITERS = 16, 64


def _jax_elbo_noise(seed, K, maxiters, ndraws, d):
    """The JAX package's ELBO noise of round 0 as ``(K, maxiters, d, N)``:
    candidate ``c`` of path ``k`` draws ``normal(fold_in(key_elbo, c))``
    with ``key_elbo`` the first half of the path key
    ``fold_in(fold_in(key, k), 0)``."""
    key = jax.random.key(seed)

    def path(k):
        key_elbo, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, k), 0))
        return jax.vmap(lambda c: jax.random.normal(
            jax.random.fold_in(key_elbo, c), (d, ndraws), dtype=jnp.float64))(jnp.arange(maxiters))

    return torch.tensor(np.asarray(jax.vmap(path)(jnp.arange(K))))


@pytest.mark.parametrize("nruns", [6, 8])
def test_mesh_run_matches_the_jax_mesh_run(nruns, monkeypatch):
    seed = 2
    init = np.random.default_rng(100 + seed).uniform(-2.0, 2.0, (nruns, D))
    jr = jmultipathfinder(
        jzoo.HierarchicalGaussian(D, seed=0), 200, key=jax.random.key(seed), init=jnp.asarray(init),
        maxiters=MAXITERS, elbo_chunk=8, mesh=jsharding.paths_mesh(jax.devices()[:4]),
    )
    noise = _jax_elbo_noise(seed, nruns, MAXITERS, 5, D)

    def injected(seed_, path_ids, round_idx, cand_idx, d, ndraws, dtype, device):
        assert round_idx == 0  # no path needs a retry here
        return noise[path_ids[:, None], cand_idx.clamp(max=MAXITERS - 1)].to(dtype)

    monkeypatch.setattr(tsinglepath, "elbo_noise", injected)
    tr = multipathfinder(
        tzoo.HierarchicalGaussian(D, seed=0), 200, seed=seed, init=init, maxiters=MAXITERS,
        elbo_chunk=8, device="cpu", mesh=paths_mesh(["cpu"] * 4),
    )
    assert tr.nruns == nruns and tr.states.draws.shape == (nruns, D, tr.config.ndraws)
    np.testing.assert_array_equal(tr.states.success.numpy(), np.asarray(jr.states.success))
    t_ev, j_ev = tr.states.num_fn_evals.numpy(), np.asarray(jr.states.num_fn_evals)
    same = t_ev == j_ev
    assert same.sum() >= 0.8 * nruns
    assert abs(int(t_ev.sum()) - int(j_ev.sum())) <= 0.01 * j_ev.sum()
    t_nv, j_nv = tr.states.trace.num_valid.numpy(), np.asarray(jr.states.trace.num_valid)
    for k in np.nonzero(same)[0]:
        n = j_nv[k]
        assert t_nv[k] == n
        np.testing.assert_allclose(tr.states.trace.xs[k, :n].numpy(), np.asarray(jr.states.trace.xs[k, :n]),
                                   rtol=1e-8, atol=1e-10)
        assert int(tr.states.fit_iteration[k]) == int(jr.states.fit_iteration[k])


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_padding_and_cap_rounding_match_jax(width):
    tmesh = paths_mesh(["cpu"] * width)
    jmesh = jsharding.paths_mesh(jax.devices()[:width])
    for n in range(1, 41):
        assert sharding.pad_paths(n, tmesh) == jsharding.pad_paths(n, jmesh, align=False)

    for K in (width, 3 * width, 17 * width):
        for cap in range(1, 10):
            j_seen, t_seen = [], []

            def jexec(keys, x0s, target, config):
                j_seen.append(keys.shape[0])
                return x0s

            def texec(ids, x0s):
                t_seen.append(ids.shape[0])
                return x0s

            jsharding.chunk_launches(jexec, cap, jmesh)(jnp.arange(K), jnp.zeros((K, 1)), None, None)
            sharding.chunk_launches(texec, cap, tmesh)(torch.arange(K), torch.zeros((K, 1)))
            assert t_seen == j_seen, (K, cap)


def _bitwise(a, b):
    """NaN-aware bitwise equality of two tensors."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    same = a == b
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def _assert_same_run(a, b):
    leaves_a, leaves_b = [], []
    tree_map(lambda t: leaves_a.append(t), a.states)
    tree_map(lambda t: leaves_b.append(t), b.states)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert _bitwise(x.cpu(), y.cpu())
    for name in ("draws_per_component", "draws", "draw_component_ids", "num_tries"):
        assert _bitwise(getattr(a, name).cpu(), getattr(b, name).cpu()), name
    assert _bitwise(a.psis_result.log_weights, b.psis_result.log_weights)


def _nan_wall_logp(x):
    """N(0, I) inside |x|_inf < 3, NaN outside: the forced-retry target of
    the JAX package's retry tests."""
    clean = -0.5 * torch.sum(x * x, dim=-1)
    return torch.where((x.abs() > 3.0).any(dim=-1), torch.nan, clean)


# (width, per-device lanes, options): a mesh of `width` blocks with launches
# of width·lanes against no mesh with launches of `lanes`
CASES = {
    "width 1": (1, 2, {}),
    "width 2": (2, 2, {}),
    "width 4": (4, 2, {}),
    "cg": (2, 2, {"optimizer": "cg"}),
    "offloaded": (2, 2, {"offload_launches": True, "keep_traces": False}),
    "mixture": (2, 2, {"importance_denominator": "mixture"}),
    "auto": (2, 2, {"optimizer": "auto"}),
    "nruns 6 over 4": (4, 2, {"nruns": 6}),
    "retry rounds": (2, 1, {"fn": _nan_wall_logp, "dim": 2, "nruns": 6, "init_scale": 8.0,
                            "ntries": 400, "maxiters": 30}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_is_bitwise_the_run_at_the_same_per_device_width(case):
    width, lanes, options = CASES[case]
    options = dict(options)
    fn = options.pop("fn", tzoo.HierarchicalGaussian(D, seed=0))
    kw = dict(seed=3, nruns=8, maxiters=MAXITERS, elbo_chunk=8, device="cpu", dtype=torch.float64)
    kw.update(options)
    with np.errstate(all="ignore"):
        ref = multipathfinder(fn, 100, max_paths_per_launch=lanes, **kw)
        got = multipathfinder(fn, 100, mesh=paths_mesh(["cpu"] * width),
                              max_paths_per_launch=width * lanes, **kw)
    if case == "retry rounds":
        assert int(ref.num_tries.max()) > 1  # retries fired
    if case == "offloaded":
        assert got.states.draws.device.type == "cpu"
    assert got.nruns == kw["nruns"] and got.max_paths_per_launch == lanes
    _assert_same_run(got, ref)


def test_dim_axis_raises_and_device_must_be_the_first():
    """The ``dim`` axis runs every optimizer (``test_torch_dim_sharding.py``
    and ``test_torch_dim_optimizers.py`` hold what they give): the states of
    its row groups are joined along ``d``."""
    mesh = sharding.Mesh(np.array([["cpu", "cpu"]], dtype=object), ("paths", "dim"))
    assert mesh.shape == {"paths": 1, "dim": 2}
    t = tzoo.StandardNormal(4)
    r = multipathfinder(t, 10, nruns=2, maxiters=3, device="cpu", mesh=mesh, optimizer="bfgs")
    assert r.states.draws.shape == (2, 4, 5) and bool(torch.isfinite(r.draws).all())
    st = make_path_executor(mesh)(torch.arange(2), torch.zeros(2, 4), t,
                                  tsinglepath.PathfinderConfig(optimizer="newton"), 0, 0)
    assert st.trace.xs.shape[-1] == 4 and st.fit_distribution.mean.shape == (2, 4)
    with pytest.raises(ValueError, match="lanes do not divide"):
        make_path_executor(paths_mesh(["cpu"] * 2))(
            torch.arange(3), torch.zeros(3, 4), t, tsinglepath.PathfinderConfig(), 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        sharding.Mesh(np.array(["cpu", "meta"], dtype=object), ("paths",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paths_mesh()


def test_an_exception_in_one_block_propagates():
    calls = []

    def logp(x):
        calls.append(threading.get_ident())
        if bool((x[..., 0] > 100).any()):
            raise FloatingPointError("block 2 failed")
        return -0.5 * torch.sum(x * x, dim=-1)

    init = np.zeros((4, 3))
    init[2, 0] = 1000.0
    with pytest.raises(FloatingPointError, match="block 2 failed"):
        multipathfinder(logp, 10, init=init, maxiters=5, device="cpu",
                        mesh=paths_mesh(["cpu"] * 4))
    assert len(set(calls)) > 1  # the blocks ran on threads of their own


def test_plan_per_device_and_lanes_over_the_mesh():
    peak, state, card = 1000, 10, 60_000  # 30 lanes fit in half the card
    assert sharding.plan_launches(100, peak, state, card) == (25, False)
    # two blocks of 50 lanes: two launches of 25 a block, 50 over the mesh
    assert sharding.plan_launches(100, peak, state, card, width=2) == (50, False)
    assert sharding.plan_launches(60, peak, state, card, width=2) == (None, False)
    # the gathered states count against the first device's share
    assert sharding.plan_launches(100, peak, 200, card, width=2) == (50, True)


def _run_threads(target, n):
    """``n`` threads of ``target``, switching often; each joined within 60 s."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target) for _ in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)


def test_launch_counts_and_zoo_copies_are_thread_safe():
    from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk

    wk.reset_launch_counts()

    def count():
        for _ in range(2000):
            wk._count("whiten_sumsq", (1, 2, 3, False))

    _run_threads(count, 16)  # more threads than the cores
    assert wk.launch_counts()["whiten_sumsq"] == 32000
    assert wk.launch_counts_by_shape()["whiten_sumsq"] == {(1, 2, 3, False): 32000}
    wk.reset_launch_counts()

    get = tzoo._per_dtype_and_device(np.arange(5.0))
    like = torch.zeros(1, dtype=torch.float64)
    barrier = threading.Barrier(16, timeout=60)
    got = []

    def fetch():
        barrier.wait()
        got.append(get(like))

    _run_threads(fetch, 16)
    assert len(got) == 16 and all(torch.equal(g, get(like)) for g in got)
    assert get(like) is get(like)


def test_importing_the_mesh_loads_no_jax():
    code = (
        "import sys; from pathfinder_tpu_torch import paths_mesh, make_path_executor; "
        "from pathfinder_tpu_torch.parallel.sharding import Mesh, run_on_devices; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pathfinder_tpu')]; "
        "assert not bad, bad"
    )
    root = Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root)

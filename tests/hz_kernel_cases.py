"""The line-search tests' problems, and the checks of the Hager-Zhang
state-update kernel (``ops/kernels/linesearch_kernels.py``) against its plain
version, ``ops/linesearch._hz_step_torch``.

This module imports no JAX: ``test_torch_hz_kernel.py`` runs its checks on
the card, where JAX need not be installed, and ``test_torch_linesearch.py``
holds the problems' searches against the JAX package's.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ALPHA0S = [1.0, 1e-3, 0.3, 7.0, 60.0]
LAM = np.logspace(-2, 2, 8)
PROBLEMS = ("quartic", "pocket", "pocket_descent", "valley", "valley_skewed")
# the small budget with inactive lanes of the checks (the full budget is 12)
SMALL = dict(max_evals=3, active=(True, False, True, False, True))


def problems(xp):
    """name -> (f, x, direction) with ``f`` written for ``xp`` (jnp or torch)."""
    def quartic(x):
        return ((x - 2.0) ** 4 + x**2).sum(-1)

    def pocket(x):  # NaN where x >= 1
        return (-xp.log(1.0 - x) + (x - 3.0) ** 2).sum(-1)

    lam = torch.tensor(LAM) if xp is torch else xp.asarray(LAM)

    def valley(x):
        lx = lam.to(x) if xp is torch else lam
        return 0.5 * (lx * x * x).sum(-1) + xp.cos(x).sum(-1) + 0.1 * ((x**2).sum(-1)) ** 2

    rng = np.random.default_rng(0)
    x8 = rng.standard_normal(8)
    return {
        "quartic": (quartic, np.array([-1.0]), None),
        "pocket": (pocket, np.array([0.0]), np.array([1.0])),
        "pocket_descent": (pocket, np.array([0.9]), None),
        "valley": (valley, x8, None),
        "valley_skewed": (valley, x8, -x8 / LAM**0.5),
    }


def value_and_grad(f):
    """``z -> (f(z), ∇f(z))`` by autograd."""
    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            val = f(z)
            (g,) = torch.autograd.grad(val.sum(), z)
        return val.detach(), g

    return vg


def search_inputs(name, dtype=torch.float64, device="cpu"):
    """``(value_and_grad, x, f0, g0, direction, alpha0)`` of problem
    ``name``: one lane for each of ``ALPHA0S``, the steepest descent where the
    problem gives no direction."""
    f, x, p = problems(torch)[name]
    vg = value_and_grad(f)
    K = len(ALPHA0S)
    xs = torch.tensor(x, dtype=dtype, device=device).expand(K, -1).contiguous()
    f0, g0 = vg(xs)
    if p is None:
        ps = -g0
    else:
        ps = torch.tensor(p, dtype=dtype, device=device).expand(K, -1).contiguous()
    return vg, xs, f0, g0, ps, torch.tensor(ALPHA0S, dtype=dtype, device=device)


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32, torch.float16: torch.int16,
         torch.bfloat16: torch.int16}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in _BITS:
        return torch.equal(a.contiguous().view(_BITS[a.dtype]), b.contiguous().view(_BITS[b.dtype]))
    return torch.equal(a, b)


def launches() -> int:
    """The line-search kernel's launches since the counter's last reset."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk
    from pathfinder_tpu_torch.utils import tracing

    return tracing.counts(lk.COUNTER).get(lk.COUNTER, 0)


@contextlib.contextmanager
def plain_steps():
    """Every Hager-Zhang search in the block updates its state by the plain
    version, on any device and dtype."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    real = lk.takes
    lk.takes = lambda device, dtype: False
    try:
        yield
    finally:
        lk.takes = real


@contextlib.contextmanager
def plain_iterations():
    """Every L-BFGS run in the block takes the plain iteration, on any device
    and dtype (the searches' state updates keep their route)."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    real = lk.iterates
    lk.iterates = lambda device, dtype, history_length: False
    try:
        yield
    finally:
        lk.iterates = real


def check_steps(name: str, dtype, max_evals: int = 12, active=None, device="cuda") -> dict:
    """One search of problem ``name`` on ``device``, driven with both steps
    from the same state: after every evaluation the kernel's state, trial
    point and flag against the plain version's, bit for bit; then the
    results of both, and of ``hager_zhang_line_search`` itself, field by
    field. Raises AssertionError at the first difference; returns what ran."""
    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    vg, x, f0, g0, p, alpha0 = search_inputs(name, dtype, device)
    if active is not None:
        active = torch.tensor(active, device=device)
    kw = dict(c1=tls.resolve_c1(None, "hager_zhang"), c2=0.9, max_evals=max_evals, expand=5.0,
              epsilon=1e-6, gamma=0.66, theta=0.5)
    s, k = tls._hz_start(x, f0, g0, p, alpha0, active, kw["c1"], kw["c2"], max_evals,
                         kw["expand"], kw["epsilon"], kw["gamma"], kw["theta"])
    plain, fused = s, lk.pack(s, k)
    more = bool(tls._hz_running(s, max_evals).any())
    x_c = x + s["c"][:, None] * p
    evals = 0
    while more:
        phi_c, g_c = vg(x_c)
        dphi_c = torch.sum(g_c * p, dim=-1)
        plain, x_p, more_p = tls._hz_step_torch(plain, phi_c, g_c, dphi_c, x, p, k)
        fused, x_k, more_k = lk.step(fused, phi_c, g_c, dphi_c, x, p, k)
        evals += 1
        for key, want in plain.items():
            assert same_bits(fused[key], want), (name, dtype, evals, key, fused[key], want)
        assert same_bits(x_k, x_p), (name, dtype, evals, "trial point")
        more = bool(more_p)
        assert bool(more_k) == more, (name, dtype, evals, "flag")
        x_c = x_k
    want = tls._hz_result(plain, k, g0)
    before = launches()
    whole = tls.hager_zhang_line_search(vg, x, f0, g0, p, alpha0, active=active, **kw)
    assert launches() - before == evals, (name, dtype, "launches", launches() - before, evals)
    for got in (tls._hz_result(fused, k, g0), whole):
        for field in ("step_size", "f", "g", "num_evals", "ok", "exhausted"):
            assert same_bits(getattr(got, field), getattr(want, field)), (name, dtype, field)
    return dict(problem=name, dtype=str(dtype), max_evals=max_evals, evals=evals,
                nev=want.num_evals.tolist())


def count_launches(device: str, dtype=torch.float64) -> tuple:
    """``(kernel launches, target calls)`` of one Hager-Zhang search of the
    ``valley`` problem on ``device``."""
    from pathfinder_tpu_torch.ops import linesearch as tls

    vg, x, f0, g0, p, alpha0 = search_inputs("valley", dtype, device)
    calls = [0]

    def counted(z):
        calls[0] += 1
        return vg(z)

    before = launches()
    tls.hager_zhang_line_search(counted, x, f0, g0, p, alpha0)
    return launches() - before, calls[0]


def hiergauss_logp(z: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """The 1000-D hierarchical posterior of the benchmark's configuration
    ``hiergauss1000-f64``: ``z = (log τ, θ)``, ``log τ ~ N(0, 1)``, ``θ ~ N(0,
    I)``, ``obs ~ N(e^{log τ / 2} θ, I)``."""
    log_tau, theta = z[..., 0], z[..., 1:]
    sigma = torch.exp(0.5 * log_tau)
    return (-0.5 * log_tau**2 - 0.5 * torch.sum(theta * theta, dim=-1)
            - 0.5 * torch.sum((obs - sigma[..., None] * theta) ** 2, dim=-1))


def check_lbfgs(K: int = 16, d: int = 1000, seed: int = 2**33 + 17) -> dict:
    """L-BFGS (Hager-Zhang) on the hierarchical posterior in float64 on the
    card, with the kernel and with the plain step: trace, ``num_fn_evals``
    and ``num_valid`` bit for bit, and one launch per evaluation. Both runs
    take the plain iteration, so the search's update is all that differs."""
    from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad
    from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    obs = torch.randn(d - 1, generator=gen, device="cuda", dtype=torch.float64)
    x0 = (torch.rand(K, d, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 2.0
    calls = [0]
    vg = autograd_value_and_grad(lambda z: hiergauss_logp(z, obs))

    def counted(z):
        calls[0] += 1
        return vg(z)

    before = launches()
    with plain_iterations():
        fused = minimize_lbfgs_trace(counted, x0, maxiters=64, history_length=6)
        fused_launches, fused_calls = launches() - before, calls[0]
        with plain_steps():
            plain = minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)
    assert launches() - before == fused_launches, "the plain run launched the kernel"
    for field in ("xs", "log_densities", "gradients", "num_fn_evals", "num_valid"):
        assert same_bits(getattr(fused, field), getattr(plain, field)), ("lbfgs", field)
    iters = int(fused.num_valid.max())
    # every target call but the start's is one evaluation of a search
    assert fused_launches == fused_calls - 1, (fused_launches, fused_calls)
    return dict(K=K, d=d, launches=fused_launches, target_calls=fused_calls,
                num_valid_max=iters, evals_mean=float(fused.num_fn_evals.double().mean()))

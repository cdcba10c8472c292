"""The checks of the L-BFGS iteration kernel (``Iterations`` in
``ops/kernels/linesearch_kernels.py``) against the plain iteration it
replaces: ``ops/linesearch._hz_result``, ``ops/trajectory.advance`` with
``ops/lbfgs._lbfgs_update``, then ``ops/lbfgs._lbfgs_direction`` and
``ops/linesearch._hz_start`` for the next search.

This module imports no JAX: ``test_torch_lbfgs_kernel.py`` runs its checks on
the card, where JAX need not be installed.

What must agree bit for bit: every integer and boolean (the counts, ``pos``,
``hlen``, ``done``, the run mask, the next search's stage, count and flag),
the iterates, the trace rows, the history's new rows ``s`` and ``y``, the
next search's state except ``dphi0`` and the step, and the first trial point
``x + c p`` from the kernel's ``c`` and ``p``. What runs in another order:
the sums over ``d``. So the direction, the diagonal ``alpha``, the step
``alpha0`` and ``dphi0`` agree to rounding, within ``4 d eps`` of the
magnitudes the sums add (the bound on a sum of ``d`` terms, with a factor 4
of room), amplified where the formula cancels: by the condition number of
``R = triu(S Yᵀ)`` for the direction (its two triangular solves), by the
ratio of the terms' absolute sum to the result for ``alpha``.
"""

from __future__ import annotations

import torch

from hz_kernel_cases import hiergauss_logp, plain_iterations, plain_steps, same_bits

# the crafted states: (K, d, J); dtypes float32 and float64
SHAPES = [(1, 56, 6), (100, 56, 6), (100, 1000, 6), (7, 4099, 12), (5, 33, 0), (5, 33, 1)]
MAXITERS = 10
# lane kinds, dealt out by lane index (one of each where K allows)
KINDS = ("accepted", "rejected_curvature", "exhausted", "no_progress", "nonfinite",
         "converged", "stalled", "done", "at_maxiters", "first", "wrap")


def iteration_launches() -> int:
    """The iteration kernel's launches since the counter's last reset."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk
    from pathfinder_tpu_torch.utils import tracing

    return tracing.counts(lk.ITER_COUNTER).get(lk.ITER_COUNTER, 0)


def _settings(dtype):
    from pathfinder_tpu_torch.ops import linesearch as tls

    eps = float(torch.finfo(dtype).eps)
    return dict(maxiters=MAXITERS, ftol_rel=10.0 * eps, epsilon_curvature=1e-12,
                fail_on_nonfinite=True, epsilon=tls.HZ_EPSILON, psi0=tls.PSI0,
                c1=tls.resolve_c1(None, "hager_zhang"), c2=0.9, max_evals=12)


def craft(K: int, d: int, J: int, dtype, device="cuda", seed: int = 0) -> dict:
    """A batch in the middle of an L-BFGS run, its search just ended: the
    plain state ``st``, the trace, the effective gtol, the direction ``p``
    the search took, and the search's plain state ``s`` and constants ``k``.
    Lane ``i`` is of kind ``KINDS[i % len(KINDS)]``; every lane has its own
    history length and position (``hlen < J`` on some, ``pos`` about to
    wrap on others)."""
    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.lbfgs import lbfgs_carry

    gen = torch.Generator(device="cpu").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    cfg = _settings(dtype)
    eps = float(torch.finfo(dtype).eps)
    kinds = [KINDS[i % len(KINDS)] for i in range(K)]
    x = randn(K, d)
    g = randn(K, d)
    f = 10.0 + 5.0 * rand(K)
    p = -g * (0.5 + rand(K, d))
    hess = 0.5 + 1.5 * rand(K, d)  # the curvature the steps see
    st = lbfgs_carry(x, J)
    alpha = 0.5 + 1.5 * rand(K, d)
    S, Y = st["S"], st["Y"]
    pos = torch.zeros(K, dtype=torch.int64)
    hlen = torch.zeros(K, dtype=torch.int64)
    it = torch.randint(1, MAXITERS, (K,), generator=gen)
    done = torch.zeros(K, dtype=torch.bool)
    for i, kind in enumerate(kinds):
        if J > 0:
            hlen[i] = 0 if kind == "first" else (J if i % 2 else int(rand(1) * J) + 1)
            hlen[i] = min(int(hlen[i]), J)
            pos[i] = J - 1 if kind == "wrap" else int(rand(1) * J) % J
            for r in range(int(hlen[i])):
                slot = (int(pos[i]) - r) % J
                s_r = 0.1 * randn(d)
                S[i, slot] = s_r
                Y[i, slot] = hess[i] * s_r + 0.01 * randn(d) * s_r.abs()
        if kind == "first":
            it[i] = 0
            alpha[i] = 1.0
        elif kind == "done":
            done[i] = True
        elif kind == "at_maxiters":
            it[i] = MAXITERS
    # the search's end, lane by lane
    a_acc = 0.2 + 1.3 * rand(K)
    accepted = torch.ones(K, dtype=torch.bool)
    a = torch.zeros(K, dtype=torch.float64)
    phi_a = f.clone()
    phi_acc = f - 0.1 * f.abs() * (0.5 + rand(K))
    g_acc = g + hess * a_acc[:, None] * p
    g_a = g.clone()
    gtol = torch.full((K,), 1e-8 if dtype == torch.float64 else 1e-4, dtype=torch.float64)
    for i, kind in enumerate(kinds):
        if kind == "rejected_curvature":
            g_acc[i] = g[i] - hess[i] * a_acc[i] * p[i]
        elif kind == "exhausted":
            accepted[i] = False
            a[i] = 0.3
            phi_a[i] = f[i] - 0.05 * abs(float(f[i]))
            g_a[i] = g[i] + hess[i] * 0.3 * p[i]
        elif kind == "no_progress":
            accepted[i] = False
        elif kind == "nonfinite":
            g_acc[i, d // 2] = float("inf")
        elif kind == "converged":
            g_acc[i] = 1e-3 * gtol[i] * randn(d).clamp(-1, 1)
        elif kind == "stalled":
            phi_acc[i] = f[i] * (1.0 - 2.0 * eps)
    nev = torch.randint(1, 13, (K,), generator=gen)
    to = dict(dtype=dtype, device=device)
    st = {name: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
          for name, v in dict(st, alpha=alpha, S=S, Y=Y).items()}
    st.update(
        it=it.to(device), x=x.to(**to), f=f.to(**to), g=g.to(**to),
        nev=torch.randint(1, 60, (K,), generator=gen).to(device),
        nexh=torch.randint(0, 3, (K,), generator=gen).to(device),
        done=done.to(device), pos=pos.to(device), hlen=hlen.to(device),
        nrej=torch.randint(0, 3, (K,), generator=gen).to(device))
    xs = randn(K, MAXITERS + 1, d).to(**to)
    fs = randn(K, MAXITERS + 1).to(**to)
    gs = randn(K, MAXITERS + 1, d).to(**to)
    p = p.to(**to)
    running = (~st["done"]) & (st["it"] < MAXITERS)
    s, k = tls._hz_start(st["x"], st["f"], st["g"], p, torch.ones(K, **to), running,
                         cfg["c1"], cfg["c2"], cfg["max_evals"], tls.HZ_EXPAND, cfg["epsilon"],
                         tls.HZ_GAMMA, tls.HZ_THETA)
    s = dict(s, stage=torch.full((K,), 5, dtype=torch.int64, device=device),
             nev=torch.where(running, nev.to(device), 0), accepted=accepted.to(device) & running,
             a=a.to(**to), phi_a=phi_a.to(**to), g_a=g_a.to(**to),
             a_acc=a_acc.to(**to), phi_acc=phi_acc.to(**to), g_acc=g_acc.to(**to))
    return dict(st=st, trace=(xs, fs, gs), gtol=gtol.to(**to), p=p, s=s, k=k, J=J,
                kinds=kinds)


def _clone(case: dict) -> dict:
    st = {n: v.clone() for n, v in case["st"].items()}
    s = {n: v.clone() for n, v in case["s"].items()}
    return dict(case, st=st, s=s, trace=tuple(t.clone() for t in case["trace"]))


def plain_iteration(case: dict) -> dict:
    """The plain iteration from ``case`` (its copy): the state, trace and
    search start after it, the next direction and step, the trial point and
    whether any lane runs on."""
    import functools

    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops import lbfgs, trajectory

    c = _clone(case)
    cfg = _settings(c["p"].dtype)
    st = c["st"]
    run = trajectory.running(st, MAXITERS)
    ls = tls._hz_result(c["s"], c["k"], st["g"])
    update = functools.partial(lbfgs._lbfgs_update, history_length=c["J"],
                               epsilon_curvature=cfg["epsilon_curvature"])
    trajectory.advance(st, run, ls, c["p"], None, update, c["trace"], c["gtol"],
                       ftol_rel=cfg["ftol_rel"], fail_on_nonfinite=True, progress_every=0,
                       maxiters=MAXITERS, name="L-BFGS")
    run_next = trajectory.running(st, MAXITERS)
    direction, alpha0, _ = lbfgs._lbfgs_direction(st, c["trace"][2])
    s, k = tls._hz_start(st["x"], st["f"], st["g"], direction, alpha0, run_next, cfg["c1"],
                         cfg["c2"], cfg["max_evals"], tls.HZ_EXPAND, cfg["epsilon"],
                         tls.HZ_GAMMA, tls.HZ_THETA)
    return dict(st=st, trace=c["trace"], run=run_next, p=direction, alpha0=alpha0, s=s, k=k,
                x_c=st["x"] + s["c"][:, None] * direction,
                more=bool(tls._hz_running(s, cfg["max_evals"]).any()))


def kernel_batch(case: dict, start: bool = False):
    """An ``Iterations`` batch holding ``case``'s state (copied)."""
    from pathfinder_tpu_torch.ops import trajectory
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    c = _clone(case)
    st, cfg = c["st"], _settings(c["p"].dtype)
    batch = lk.Iterations(st["x"], st["f"], st["g"], st["done"], c["gtol"], c["trace"],
                          history_length=c["J"], maxiters=MAXITERS, ftol_rel=cfg["ftol_rel"],
                          epsilon_curvature=cfg["epsilon_curvature"], fail_on_nonfinite=True,
                          epsilon=cfg["epsilon"], psi0=cfg["psi0"])
    for name in ("alpha", "S", "Y"):
        getattr(batch, name).copy_(st[name])
    for name in lk.INTS:
        getattr(batch, name).copy_(st[name])
    if not start:
        batch.p.copy_(c["p"])
        batch.run.copy_(trajectory.running(st, MAXITERS))
        s, k = c["s"], c["k"]
        hz = batch.search
        for name in lk.FIELDS + ("stage", "nev", "accepted", "g_a", "g_acc"):
            hz[name].copy_(s[name])
        for row, t in zip(hz.floats[len(lk.FIELDS):], (k.f0, k.dphi0, k.eps_k)):
            row.copy_(t)
    return batch


def _close(got, want, tol, what, lanes):
    """``|got − want| <= tol`` on ``lanes``."""
    gap = (got - want).abs()
    bad = ~(gap <= tol) & lanes.reshape(lanes.shape + (1,) * (gap.dim() - 1))
    assert not bool(bad.any()), (what, float(gap[bad].max()), int(bad.sum()))


def _direction_tol(st, p_plain, J):
    """``4 d eps (1 + κ(R)) (|α g|∞ + |p|∞)`` a lane, κ the condition number
    of the window's ``R`` in float64."""
    from pathfinder_tpu_torch.ops.lbfgs import _compact_pieces

    d = p_plain.shape[-1]
    eps = torch.finfo(p_plain.dtype).eps
    scale = (st["alpha"] * st["g"]).abs().amax(-1) + p_plain.abs().amax(-1)
    kappa = torch.ones_like(scale)
    if J > 0:
        ar = torch.arange(J, device=p_plain.device)
        order = (st["pos"][:, None] - (J - 1) + ar) % J
        mask = (ar >= (J - st["hlen"][:, None])).double()
        S = torch.gather(st["S"].double(), 1, order[..., None].expand_as(st["S"])) * mask[..., None]
        Y = torch.gather(st["Y"].double(), 1, order[..., None].expand_as(st["Y"])) * mask[..., None]
        R, _, _, _ = _compact_pieces(S, Y, st["alpha"].double(), mask)
        kappa = torch.linalg.cond(R).to(scale.dtype)
    return (4 * d * eps * (1 + kappa) * scale)[:, None]


def _alpha_tol(case, st_plain):
    """``4 d eps |α| (Σ|y s| / |Σ y s| + (|a/α| + y² + |a/c| (s/α)²) / |den|)``
    on the lanes whose diagonal was refreshed (gilbert_init's three sums)."""
    old = case["st"]
    d = old["x"].shape[-1]
    eps = torch.finfo(old["x"].dtype).eps
    s = (st_plain["x"] - old["x"]).double()
    y = (st_plain["g"] - old["g"]).double()
    al = old["alpha"].double()
    a = (y * al * y).sum(-1, keepdim=True)
    b = (y * s).sum(-1, keepdim=True)
    c = (s / al * s).sum(-1, keepdim=True)
    t1, t2, t3 = a / al, y * y, (a / c) * (s / al) ** 2
    den = t1 + t2 - t3
    ratio = (y * s).abs().sum(-1, keepdim=True) / b.abs() + (t1.abs() + t2 + t3.abs()) / den.abs()
    tol = 4 * d * eps * st_plain["alpha"].double().abs() * ratio
    return torch.nan_to_num(tol, nan=0.0, posinf=0.0).to(old["x"].dtype)


def check_iteration(K: int, d: int, J: int, dtype, seed: int = 0) -> dict:
    """One launch against the plain iteration on a crafted batch: the
    integers, booleans, iterates, trace, history rows, search state and
    trial point bit for bit, the direction, diagonal, step and dφ(0) to
    rounding (module docstring). Raises AssertionError at the first
    difference; returns what the lanes did."""
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    case = craft(K, d, J, dtype, seed=seed)
    want = plain_iteration(case)
    batch = kernel_batch(case)
    before = iteration_launches()
    x_c, flag = batch.launch()
    assert iteration_launches() - before == 1
    tag = (K, d, J, str(dtype))
    st = want["st"]
    for name in lk.INTS + ("done",):
        assert same_bits(getattr(batch, name), st[name]), (tag, name)
    assert same_bits(batch.run, want["run"]), (tag, "run")
    for name in ("x", "f", "g", "S", "Y"):
        assert same_bits(getattr(batch, name), st[name]), (tag, name)
    for got, wanted, name in zip((batch.xs, batch.fs, batch.gs), want["trace"], ("xs", "fs", "gs")):
        assert same_bits(got, wanted), (tag, name)
    # the rounding-level numbers, on the lanes that run on (a lane that does
    # not searches nowhere: its direction only moves its trial point, which
    # the search evaluates and never reads)
    run = want["run"]
    _close(batch.alpha, st["alpha"], _alpha_tol(case, st), (tag, "alpha"), run)
    _close(batch.p, want["p"], _direction_tol(st, want["p"], J), (tag, "direction"), run)
    hz = batch.search
    eps = torch.finfo(dtype).eps
    a0_tol = 4 * d * eps * want["alpha0"].abs()
    _close(hz["c"], want["alpha0"], a0_tol, (tag, "alpha0"), run)
    first = st["it"] == 0
    assert same_bits(hz["c"][~first], want["alpha0"][~first]), (tag, "alpha0 = 1")
    # dφ(0) is the kernel's own sum of g p: against the same sum in float64
    dphi0 = hz.floats[len(lk.FIELDS) + 1]
    exact = (st["g"].double() * batch.p.double()).sum(-1)
    bound = 4 * d * eps * (st["g"].double() * batch.p.double()).abs().sum(-1)
    _close(dphi0.double(), exact, bound, (tag, "dphi0"), run)
    for name in ("dphi_a", "dphi_b", "dphi_a0", "dphi_b0"):
        assert same_bits(hz[name], dphi0), (tag, name)
    for name in ("a", "phi_a", "b", "phi_b", "a0", "b0", "phi_a0", "phi_b0", "a_acc", "phi_acc",
                 "stage", "nev", "accepted", "g_a", "g_acc"):
        assert same_bits(hz[name], want["s"][name]), (tag, name)
    for i, name in enumerate(("f0", "eps_k")):
        row = hz.floats[len(lk.FIELDS) + 2 * i]
        assert same_bits(row, getattr(want["k"], name)), (tag, name)
    assert same_bits(x_c, batch.x + hz["c"][:, None] * batch.p), (tag, "trial point")
    assert bool(flag) == want["more"], (tag, "flag")
    return dict(K=K, d=d, J=J, dtype=str(dtype), moved=int((st["it"] != case["st"]["it"]).sum()),
                done=int(st["done"].sum()), running=int(want["run"].sum()))


def check_start(K: int, d: int, J: int, dtype, seed: int = 0) -> dict:
    """A launch in start mode against the plain start: from an initial point
    (one lane with a non-finite gradient, so it starts done), the run mask,
    the first direction, the step guess ``initial_step_size``, the first
    search's state and trial point."""
    from pathfinder_tpu_torch.ops import lbfgs, trajectory
    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    case = craft(K, d, J, dtype, seed=seed)
    st = case["st"]
    st["g"][0, 0] = float("nan")
    st.update(lbfgs.lbfgs_carry(st["x"], J), it=torch.zeros_like(st["it"]),
              nev=torch.ones_like(st["nev"]),
              nexh=torch.zeros_like(st["nexh"]),
              done=trajectory.should_abort_nonfinite(-st["f"], -st["g"]))
    batch = kernel_batch(case, start=True)
    x_c, flag = batch.launch(start=True)
    cfg = _settings(dtype)
    run = trajectory.running(st, MAXITERS)
    direction, alpha0, _ = lbfgs._lbfgs_direction(st, case["trace"][2])
    s, k = tls._hz_start(st["x"], st["f"], st["g"], direction, alpha0, run, cfg["c1"],
                         cfg["c2"], cfg["max_evals"], tls.HZ_EXPAND, cfg["epsilon"],
                         tls.HZ_GAMMA, tls.HZ_THETA)
    tag = ("start", K, d, J, str(dtype))
    assert same_bits(batch.run, run), (tag, "run")
    eps = torch.finfo(dtype).eps
    # an empty history: the direction is −α g, one rounding, on every lane
    assert same_bits(batch.p, direction), (tag, "direction")
    _close(batch.search["c"], alpha0, 4 * d * eps * alpha0.abs(), (tag, "alpha0"), run)
    for name in ("a", "phi_a", "stage", "nev", "accepted", "g_a", "g_acc"):
        assert same_bits(batch.search[name], s[name]), (tag, name)
    assert same_bits(x_c, batch.x + batch.search["c"][:, None] * batch.p), (tag, "trial point")
    assert bool(flag) == bool(run.any()), (tag, "flag")
    return dict(start=True, K=K, d=d, J=J, dtype=str(dtype), running=int(run.sum()))


# the points of a run that follow the same path whatever the order of the sums
# over d, and the tolerance of the counts summed over the lanes (``evals_per_path``'s
# in the benchmark)
SAME_PATH_POINTS = 7
COUNT_SHARE = 0.02


def check_run(K: int = 16, d: int = 1000, seed: int = 2**33 + 17) -> dict:
    """``minimize_lbfgs_trace`` on the hierarchical posterior in float64 on
    the card, with both kernels and with neither: the same optimum (each
    lane's last ``logp`` within 1e-10 relative), the same path over the first
    ``SAME_PATH_POINTS`` points (1e-10 relative), the lanes' valid points and
    evaluations in all within ``COUNT_SHARE``, and one iteration launch a
    search plus the start's.

    Later points are not compared: the funnel of this posterior amplifies a
    rounding-level change in a sum over d until the paths part, and the
    plain iteration on the CPU parts from the plain iteration on the card
    as far as the kernel does (the same seed on an H100: from point 8 on,
    logp up to 180% apart, a lane's ``num_valid`` 4 apart, every lane at the
    same optimum)."""
    from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad
    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    obs = torch.randn(d - 1, generator=gen, device="cuda", dtype=torch.float64)
    x0 = (torch.rand(K, d, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 2.0
    vg = autograd_value_and_grad(lambda z: hiergauss_logp(z, obs))
    searches = [0]
    real = tls.hz_evaluations

    def counted(*a, **kw):
        searches[0] += 1
        return real(*a, **kw)

    tls.hz_evaluations = counted
    try:
        before = iteration_launches()
        fused = minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)
        n = iteration_launches() - before
    finally:
        tls.hz_evaluations = real
    with plain_steps():
        plain = minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)
    assert iteration_launches() - before == n, "the plain run launched the iteration kernel"
    assert n == searches[0] + 1, (n, searches[0])
    assert searches[0] >= int(fused.num_valid.max()) - 1

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-300)).max())

    lanes = torch.arange(K, device="cuda")
    last = rel(fused.log_densities[lanes, fused.num_valid - 1],
               plain.log_densities[lanes, plain.num_valid - 1])
    assert last <= 1e-10, ("optimum", last)
    assert bool((fused.num_valid >= SAME_PATH_POINTS).all())
    path = rel(fused.log_densities[:, :SAME_PATH_POINTS], plain.log_densities[:, :SAME_PATH_POINTS])
    assert path <= 1e-10, ("path", path)
    counts = {}
    for name in ("num_valid", "num_fn_evals"):
        a, b = int(getattr(fused, name).sum()), int(getattr(plain, name).sum())
        counts[name] = (a, b)
        assert abs(a - b) <= COUNT_SHARE * b, (name, a, b)
    return dict(K=K, d=d, launches=n, searches=searches[0], optimum_rel_gap=last,
                path_rel_gap=path, counts=counts)


def iteration_times(K: int = 100, d: int = 1000, dtype=torch.float64,
                    seed: int = 2**33 + 29) -> dict:
    """L-BFGS (``maxiters=64``, ``history_length=6``) on the hierarchical
    posterior on the card, with the iteration kernel and with the plain
    iteration (the search's kernel in both): the card's microseconds a
    launch of the kernel (the profiler's device time of its launches in one
    run), and the host's microseconds an iteration spent in the iteration's
    own work in another run (in the kernel's ``launch``; in the plain
    version's ``_lbfgs_direction``, ``advance``, ``_hz_start``, ``pack`` and
    ``_hz_result``), with the runs' walls."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad
    from pathfinder_tpu_torch.ops import lbfgs, trajectory
    from pathfinder_tpu_torch.ops import linesearch as tls
    from pathfinder_tpu_torch.ops.kernels import linesearch_kernels as lk

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    obs = torch.randn(d - 1, generator=gen, device="cuda", dtype=dtype)
    x0 = (torch.rand(K, d, generator=gen, device="cuda", dtype=dtype) * 2 - 1) * 2.0
    vg = autograd_value_and_grad(lambda z: hiergauss_logp(z, obs))

    def run():
        out = lbfgs.minimize_lbfgs_trace(vg, x0, maxiters=64, history_length=6)
        torch.cuda.synchronize()
        return out

    run()  # the libraries and every op's first launch
    with plain_iterations():
        run()

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    (kernel,) = [e for e in prof.key_averages() if "lbfgs_iter_kernel" in e.key]
    card_us = kernel.device_time_total / kernel.count

    host = [0.0, 0]

    def timed(fn, count):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host[0] += time.perf_counter() - t0
            host[1] += count
            return out
        return wrapper

    def walled(patched):
        host[:] = [0.0, 0]
        reals = [getattr(m, n) for m, n, _ in patched]
        for (m, n, count), real in zip(patched, reals):
            setattr(m, n, timed(real, count))
        try:
            t0 = time.perf_counter()
            out = run()
            return out, time.perf_counter() - t0, 1e6 * host[0] / max(host[1], 1), host[1]
        finally:
            for (m, n, _), real in zip(patched, reals):
                setattr(m, n, real)

    fused, fused_s, kernel_host_us, launches = walled([(lk.Iterations, "launch", True)])
    with plain_iterations():
        plain, plain_s, plain_host_us, iterations = walled([
            (lbfgs, "_lbfgs_direction", True), (trajectory, "advance", False),
            (tls, "_hz_start", False), (tls, "_hz_result", False), (lk, "pack", False)])
    return dict(K=K, d=d, dtype=str(dtype), launches=launches, profiled_launches=kernel.count,
                card_us=card_us, host_us=kernel_host_us, plain_host_us=plain_host_us,
                plain_iterations=iterations, run_s=fused_s, plain_run_s=plain_s,
                num_valid_max=(int(fused.num_valid.max()), int(plain.num_valid.max())))


def check_progress(capsys, K: int = 4, d: int = 56, every: int = 5) -> int:
    """With ``progress_every``, the kernel's route prints the plain loop's
    line for each lane at each iteration divisible by ``every`` that it
    reached, in iteration order, with that iteration's ``logp`` from the
    trace; returns the lines' count."""
    from pathfinder_tpu_torch.models.protocol import autograd_value_and_grad
    from pathfinder_tpu_torch.ops.lbfgs import minimize_lbfgs_trace

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2**33 + 3)
    obs = torch.randn(d - 1, generator=gen, device="cuda", dtype=torch.float64)
    x0 = (torch.rand(K, d, generator=gen, device="cuda", dtype=torch.float64) * 2 - 1) * 2.0
    vg = autograd_value_and_grad(lambda z: hiergauss_logp(z, obs))
    capsys.readouterr()
    before = iteration_launches()
    tr = minimize_lbfgs_trace(vg, x0, maxiters=40, progress_every=every)
    assert iteration_launches() > before
    got = capsys.readouterr().out.splitlines()
    want = [f"  L-BFGS iter {it}/40 logp={float(tr.log_densities[k, it]):.4g}"
            for it in range(every, 41, every) for k in range(K) if it < int(tr.num_valid[k])]
    assert got == want, (got, want)
    return len(got)

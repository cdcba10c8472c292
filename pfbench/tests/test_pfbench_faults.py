"""A run with the timed path broken underneath comes out not correct, and
so does the control; a sound run comes out correct. On the CPU, past the
harness's look for a card, at the cell's own width (d = 1000) with fewer
paths, held to the cell's own limits."""

import dataclasses
import math
import time

import pytest
import torch

from conftest import describe_cpu, small_cell
from pfharness.judge import judge
from pfharness.registry import find_cell
from pfharness.window import prepare, run


def _run(root, seed=2**33 + 17):
    torch.set_num_threads(4)
    line = run(find_cell("small", root), seed, 0.001, False, time.perf_counter(),
               device="cpu", log=lambda *a: None, describe=describe_cpu)
    return line


def _step_unchanged(monkeypatch):
    """An L-BFGS iteration that returns its state unchanged: point 3 of every
    trajectory repeats point 2."""
    from pathfinder_tpu_torch.ops import lbfgs

    real = lbfgs.minimize_trace

    def broken(*a, **k):
        tr = real(*a, **k)
        xs, gs, fs = tr.xs.clone(), tr.gradients.clone(), tr.log_densities.clone()
        xs[:, 3], gs[:, 3], fs[:, 3] = xs[:, 2], gs[:, 2], fs[:, 2]
        return dataclasses.replace(tr, xs=xs, gradients=gs, log_densities=fs)

    monkeypatch.setattr(lbfgs, "minimize_trace", broken)


def _half_batch(monkeypatch):
    """Half of the paths left out, the other half's results standing in."""
    from pathfinder_tpu_torch import multipath
    from pathfinder_tpu_torch.utils.misc import tree_map

    real = multipath.chunk_launches

    def broken(executor, *a, **k):
        inner = real(executor, *a, **k)

        def launch(path_ids, x0s):
            h = (path_ids.shape[0] + 1) // 2
            st = inner(path_ids[:h], x0s[:h])
            return tree_map(lambda t: torch.cat([t, t])[: path_ids.shape[0]], st)

        return launch

    monkeypatch.setattr(multipath, "chunk_launches", broken)


def _b1_altered(monkeypatch):
    """B1's log densities altered where they are produced."""
    from pathfinder_tpu_torch.ops import mvnormal

    real = mvnormal.sample_and_logq
    monkeypatch.setattr(mvnormal, "sample_and_logq",
                        lambda *a: (lambda x, lq: (x, lq + 1.0))(*real(*a)))


def _b2_altered(monkeypatch):
    """B2's whitened sums altered where they are produced: every other
    pooled draw's log density off by one."""
    from pathfinder_tpu_torch.ops import mvnormal

    real = mvnormal.whiten_sumsq

    def broken(*a):
        maha = real(*a).clone()
        maha[..., ::2] += 2.0
        return maha

    monkeypatch.setattr(mvnormal, "whiten_sumsq", broken)


def _draw_altered(monkeypatch):
    """A resampled draw altered where it is produced."""
    from pathfinder_tpu_torch import multipath

    real = multipath.resample_draws

    def broken(*a, **k):
        draws, ids = real(*a, **k)
        draws = draws.clone()
        draws[0, 0] += 1e-3
        return draws, ids

    monkeypatch.setattr(multipath, "resample_draws", broken)


def _resampler_ignores_weights(monkeypatch):
    """The resampling draws uniformly from the pool, as if no weights were
    given."""
    from pathfinder_tpu_torch import multipath

    real = multipath.resample_draws
    monkeypatch.setattr(multipath, "resample_draws",
                        lambda stream, pool, psis_result, *a, **k: real(stream, pool, None, *a, **k))


def _steps_too_long(monkeypatch):
    """Every step the line search accepts taken three times as long."""
    import dataclasses as dc

    from pathfinder_tpu_torch.ops import trajectory

    real = trajectory.resolve_line_search

    def resolve(name):
        search = real(name)
        return lambda *a, **k: (lambda r: dc.replace(r, step_size=3 * r.step_size))(search(*a, **k))

    monkeypatch.setattr(trajectory, "resolve_line_search", resolve)


def _factor_scaled(monkeypatch):
    """Each returned normal's factor scaled by 1.01, its log det and
    inverse factor moved with it: a wrong normal that agrees with itself."""
    from pathfinder_tpu_torch.ops import woodbury

    real = woodbury.pdfactorize

    def broken(*a, **k):
        F = real(*a, **k)
        d = F.a_half.shape[-1]
        return dataclasses.replace(F, a_half=F.a_half * 1.01,
                                   log_det=F.log_det + 2 * d * math.log(1.01))

    monkeypatch.setattr(woodbury, "pdfactorize", broken)


def _log_det_off(monkeypatch):
    """Each returned normal's log det off by 0.1 nats, as float32 leaves it."""
    from pathfinder_tpu_torch.ops import woodbury

    real = woodbury.pdfactorize
    monkeypatch.setattr(woodbury, "pdfactorize", lambda *a, **k: (
        lambda F: dataclasses.replace(F, log_det=F.log_det + 0.1))(real(*a, **k)))


def test_a_sound_run_is_correct(tmp_path):
    line = _run(small_cell(tmp_path))
    assert line["correct"] is True, line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _b1_altered, _b2_altered,
                                   _draw_altered, _resampler_ignores_weights, _steps_too_long,
                                   _factor_scaled, _log_det_off])
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(small_cell(tmp_path))
    assert line["correct"] is False


def test_the_control_is_not_correct(tmp_path):
    """The reference in float32 put in the program's place fails the cell's
    limits; the program on the same call passes them."""
    torch.set_num_threads(4)
    cell = find_cell("small", small_cell(tmp_path, K=16))
    ses = prepare(cell, 2**33 + 23, "cpu")
    res, init = ses.call(0)
    assert judge(ses.readings(res, init), cell.limits)[0] is True
    assert judge(ses.readings(res, init, control=True), cell.limits)[0] is False

"""The port's sampling diagnostics and named draw export, held against the
JAX package on the CPU in f64: ``split_rhat``, ``ess_bulk``, ``ess_tail`` and
``summarize`` on the same ``(4, 200, 5)`` array (1e-8), on tied and
heavy-tailed chains, and the behaviour tests of ``tests/test_diagnostics.py``
and ``tests/test_ppl_export.py``.
"""

import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pathfinder_tpu.utils import diagnostics as jd
from pathfinder_tpu_torch.integrations import ppl
from pathfinder_tpu_torch.integrations import transforms as ttr
from pathfinder_tpu_torch.utils import diagnostics as td
from pathfinder_tpu_torch.utils import rng

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)

TOL = 1e-8


def _ar1(rho, shape, seed):
    r = np.random.default_rng(seed)
    C, N, d = shape
    x = np.zeros(shape)
    x[:, 0] = r.standard_normal((C, d))
    for t in range(1, N):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho**2) * r.standard_normal((C, d))
    return x


CASES = {
    "iid": np.random.default_rng(0).standard_normal((4, 200, 5)),
    "ar1": _ar1(0.8, (4, 200, 5), 1),
    "shifted": np.random.default_rng(2).standard_normal((4, 200, 5)) + np.arange(4)[:, None, None],
    "heavy": np.random.default_rng(3).standard_cauchy((4, 200, 5)),
    "tied": np.round(np.random.default_rng(4).standard_normal((4, 200, 5)) * 2.0),
    "odd": np.random.default_rng(5).standard_normal((3, 101, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", ["split_rhat", "ess_bulk", "ess_tail"])
def test_diagnostic_matches_jax(fn, case):
    x = CASES[case]
    want = np.asarray(getattr(jd, fn)(jnp.asarray(x)))
    got = getattr(td, fn)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_summarize_matches_jax():
    x = CASES["ar1"]
    want, got = jd.summarize(jnp.asarray(x)), td.summarize(torch.tensor(x))
    assert set(got) == set(want) == {"mean", "sd", "ess_bulk", "ess_tail", "rhat"}
    for k in want:
        assert got[k].shape == (5,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL)
    one = td.summarize(torch.tensor(x[0]))  # (samples, dim): one chain
    np.testing.assert_allclose(
        one["ess_bulk"].numpy(), np.asarray(jd.summarize(jnp.asarray(x[0]))["ess_bulk"]), rtol=TOL
    )
    assert td.summarize(x)["mean"].shape == (5,)  # numpy goes in too


def test_rhat_iid_near_one_and_detects_disagreement():
    r = td.split_rhat(torch.tensor(CASES["iid"]))
    assert bool((r < 1.03).all())
    assert bool((td.split_rhat(torch.tensor(CASES["shifted"])) > 1.5).all())
    # the folded variant catches chains that differ in scale only
    x = CASES["iid"].copy()
    x[0] *= 5.0
    assert bool((td.split_rhat(torch.tensor(x)) > 1.1).all())


def test_ess_iid_near_total_and_ar1_matches_theory():
    x = torch.tensor(np.random.default_rng(6).standard_normal((4, 1000, 3)))
    ess = td.ess_bulk(x)
    assert bool((ess > 3000).all()) and bool((ess < 5500).all())
    rho = 0.7
    y = torch.tensor(_ar1(rho, (4, 4000, 2), 7))
    theory = 16000 * (1 - rho) / (1 + rho)
    np.testing.assert_allclose(td.ess_bulk(y).numpy(), theory, rtol=0.25)
    assert bool((td.ess_tail(y) < td.ess_tail(torch.tensor(np.random.default_rng(8).standard_normal((4, 4000, 2))))).all())


def test_ess_tail_degenerate_is_nan_and_bool_chains_rank():
    const = torch.ones(2, 50, 1, dtype=torch.float64)
    assert bool(torch.isnan(td.ess_tail(const)).all())
    flags = torch.tensor(np.random.default_rng(9).uniform(size=(2, 100, 2)) < 0.3)
    r = td.split_rhat(flags)
    assert r.dtype == torch.float32 and bool(torch.isfinite(r).all())


def test_diagnostics_of_sampler_output_shapes():
    x = torch.tensor(CASES["iid"], dtype=torch.float32)
    s = td.summarize(x)
    assert all(v.dtype == torch.float32 and v.shape == (5,) for v in s.values())


def _result(draws):
    return types.SimpleNamespace(draws=draws)


def test_draws_to_dict_default_names_and_transform():
    draws = torch.tensor(np.random.default_rng(0).standard_normal((3, 7)))
    out = ppl.draws_to_dict(_result(draws))
    assert list(out) == ["x0", "x1", "x2"] and torch.equal(out["x1"], draws[1])
    bij = ttr.Stacked(((ttr.Exp(), 1), (ttr.Identity(), 2)))
    named = ppl.draws_to_dict(_result(draws), names=["s", "a", "b"], transform=bij)
    np.testing.assert_allclose(named["s"].numpy(), np.exp(draws[0].numpy()), rtol=1e-12)
    assert torch.equal(named["b"], draws[2])
    tld = ttr.TransformedLogDensity(lambda x: x.sum(-1), bij, 3)
    by_tld = ppl.draws_to_dict(_result(draws), transform=tld)
    assert torch.equal(by_tld["x0"], named["s"])
    with pytest.raises(ValueError, match="names has 2 entries for 3 parameters"):
        ppl.draws_to_dict(_result(draws), names=["a", "b"])


def test_to_inference_data_fallback():
    draws = torch.tensor(np.random.default_rng(1).standard_normal((2, 5)))
    try:
        import arviz  # noqa: F401
    except ImportError:
        out = ppl.to_inference_data(_result(draws), names=["a", "b"])
        assert isinstance(out, dict) and torch.equal(out["a"], draws[0])
    else:
        out = ppl.to_inference_data(_result(draws), names=["a", "b"])
        assert out.posterior["a"].shape == (1, 5)


def test_stream_purposes_are_distinct_and_rounds_are_bounded():
    purposes = [rng.INIT, rng.ELBO, rng.EXTRA, rng.RESAMPLE, rng.RESAMPLE_FRESH, rng.LAPLACE_DRAWS,
                rng.LAPLACE_RESAMPLE, rng.MOMENTUM, rng.NUTS_TREE, rng.HMC_JITTER, rng.HMC_ACCEPT, rng.PRIOR, rng.PRIOR_AUX]
    assert len(set(purposes)) == len(purposes) and max(purposes) < 256
    u = [rng.Stream(0, 1, 2, p).uniform(4, torch.float64) for p in purposes]
    assert len({tuple(t.tolist()) for t in u}) == len(purposes)
    # the transition shares a 32-bit word with the purpose: 24 bits
    rng.Stream(0, 0, rng.MAX_ROUND - 1, rng.MOMENTUM).uniform(1)
    with pytest.raises(ValueError, match="outside"):
        rng.Stream(0, 0, rng.MAX_ROUND, rng.MOMENTUM)
    a = rng.Stream(0, 0, rng.MAX_ROUND - 1, rng.MOMENTUM).uniform(2, torch.float64)
    b = rng.Stream(0, 0, 0, rng.MOMENTUM).uniform(2, torch.float64)
    assert not torch.equal(a, b)

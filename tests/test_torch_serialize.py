"""Result files of the port (the counterpart of ``tests/test_serialize.py``,
without its three orbax tests: the port has only the ``.npz`` path).

Everything runs on the CPU (``load_result(device="cpu")``); ``resample`` on a
loaded result is bitwise the one on the result it was saved from, since the
stored seed, resample count and PSIS weights drive the same streams.
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from pathfinder_tpu_torch import laplace_resample, multipathfinder, pathfinder, resample
from pathfinder_tpu_torch.models import bayes, zoo
from pathfinder_tpu_torch.utils.serialize import FORMAT_VERSION, TYPE_REGISTRY, load_result, save_result

# one intra-op thread: the suite runs in several worker processes at once, and a
# thread per core in each makes them contend for the cores
torch.set_num_threads(1)


CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def single():
    target = zoo.StandardNormal(4)
    return target, pathfinder(target, seed=0, ndraws=20, maxiters=30, **CPU)


@pytest.fixture(scope="module")
def multi():
    target = zoo.StandardNormal(3)
    return target, multipathfinder(target, 60, seed=1, nruns=4, maxiters=30, **CPU)


def test_singlepath_roundtrip(tmp_path, single):
    target, res = single
    save_result(str(tmp_path / "single"), res)
    loaded = load_result(tmp_path / "single", fn=target, **CPU)
    assert torch.equal(loaded.draws, res.draws) and loaded.fit_iteration == res.fit_iteration
    assert torch.equal(loaded.fit_distribution.cov.to_dense(), res.fit_distribution.cov.to_dense())
    assert loaded.config == res.config and loaded.seed == res.seed
    x = torch.zeros(2, 4)
    assert torch.equal(loaded.logp(x), target.logp(x))  # the log density is bound again
    # the replays work on the loaded result
    nan = torch.isnan(res.elbo_values)
    assert torch.equal(loaded.elbo_estimates.value[~nan], res.elbo_values[~nan])


def test_singlepath_roundtrip_cg_config(tmp_path):
    target = zoo.StandardNormal(4)
    res = pathfinder(target, seed=1, ndraws=20, maxiters=30, optimizer="cg", **CPU)
    save_result(tmp_path / "single_cg", res)
    loaded = load_result(tmp_path / "single_cg", fn=target, **CPU)
    assert loaded.config.optimizer == "cg" and torch.equal(loaded.draws, res.draws)


def test_multipath_roundtrip_and_resample(tmp_path, multi):
    target, res = multi
    save_result(tmp_path / "multi", res)
    loaded = load_result(tmp_path / "multi", fn=target, **CPU)
    assert torch.equal(loaded.draws, res.draws)
    assert torch.equal(loaded.psis_result.weights, res.psis_result.weights)
    # a tensor two fields share is stored once and shared again
    assert loaded.fit_distribution.components.mean is loaded.states.fit_distribution.mean
    a, b = resample(loaded, 40), resample(res, 40)
    assert a.draws.shape == (3, 40) and torch.equal(a.draws, b.draws)
    assert torch.equal(resample(a, 40, ndraws_per_run=5).draws, resample(b, 40, ndraws_per_run=5).draws)


def test_chunked_offloaded_result_roundtrip(tmp_path):
    target = zoo.StandardNormal(3)
    res = multipathfinder(target, 50, seed=3, nruns=5, maxiters=30, max_paths_per_launch=2,
                          offload_launches=True, keep_traces=False, **CPU)
    save_result(tmp_path / "serving", res)
    loaded = load_result(tmp_path / "serving", fn=target, **CPU)
    assert loaded.max_paths_per_launch == 2 and loaded.states.trace.xs.shape == (5, 0, 3)
    assert torch.equal(resample(loaded, 30, ndraws_per_run=4).draws, resample(res, 30, ndraws_per_run=4).draws)


def test_schema_evolution_tolerant_load(tmp_path, single):
    target, res = single
    p = tmp_path / "evo"
    save_result(p, res)
    data = dict(np.load(str(p) + ".npz", allow_pickle=False))
    meta = json.loads(bytes(data["__meta__"]).decode())
    assert meta["v"] == FORMAT_VERSION
    root = meta["root"]
    assert root["type"] == "PathfinderResult"
    # an old file: a field the class does not have, and one the file lacks
    root["fields"]["legacy_field"] = {"lit": 42}
    del root["fields"]["num_tries"]
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(tmp_path / "evo_old", **data)
    with pytest.warns(UserWarning, match="legacy_field"):
        loaded = load_result(tmp_path / "evo_old", fn=target, **CPU)
    assert torch.equal(loaded.draws, res.draws) and loaded.num_tries is None


def test_roundtrip_bayes_model_result(tmp_path):
    obs = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)

    def loglik(p):
        return torch.sum(-0.5 * ((obs - p["mu"][..., None]) / p["sigma"][..., None]) ** 2
                         - torch.log(p["sigma"][..., None]), dim=-1)

    model = bayes.BayesModel({"mu": bayes.Normal(0.0, 5.0), "sigma": bayes.HalfNormal(2.0)}, loglik)
    res = multipathfinder(model, 100, seed=0, nruns=4, maxiters=40, dtype=torch.float64, **CPU)
    save_result(tmp_path / "bayes_run", res)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = load_result(tmp_path / "bayes_run", fn=model, **CPU)
    for k in res.draws_transformed:
        assert torch.equal(loaded.draws_transformed[k], res.draws_transformed[k])
    x = res.draws_transformed["sigma"][:7]
    z = torch.stack([res.draws_transformed["mu"][:7], x])
    np.testing.assert_allclose(loaded.fit_distribution_transformed.logpdf(z).numpy(),
                               res.fit_distribution_transformed.logpdf(z).numpy(), rtol=1e-12)
    a, b = resample(loaded, 50), resample(res, 50)
    assert torch.equal(a.draws, b.draws) and bool((a.draws_transformed["sigma"] > 0).all())


def test_bfloat16_leaves_roundtrip_exactly(tmp_path, single):
    target, res = single
    vals = torch.linspace(-3.0, 3.0, res.draws.numel()).reshape(res.draws.shape).to(torch.bfloat16)
    save_result(tmp_path / "bf16", dataclasses.replace(res, draws=vals))
    loaded = load_result(tmp_path / "bf16", fn=target, **CPU)
    assert loaded.draws.dtype == torch.bfloat16 and torch.equal(loaded.draws, vals)


def test_unregistered_root_raises_at_save_time(tmp_path):
    for bad in (lambda x: x, object()):
        with pytest.raises(TypeError, match="not a serializable"):
            save_result(tmp_path / "bad", bad)


def test_type_registry_and_devices(tmp_path, single):
    from pathfinder_tpu_torch.ops.mvnormal import MvNormal

    assert TYPE_REGISTRY["MvNormal"] is MvNormal and "MultiPathfinderResult" in TYPE_REGISTRY
    target, res = single
    save_result(tmp_path / "dev", res)
    with pytest.warns(UserWarning, match="not bound again"):
        unbound = load_result(tmp_path / "dev", **CPU)
    assert unbound.logp is None and torch.equal(unbound.draws, res.draws)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_result(tmp_path / "dev", fn=target)


def test_laplace_corrected_result_roundtrip(tmp_path, multi):
    target, res = multi
    corrected = laplace_resample(res, 50, method="diag")
    assert corrected.fit_distribution.components.cov.B.shape[-1] == 0
    save_result(tmp_path / "laplace", corrected)
    loaded = load_result(tmp_path / "laplace", fn=target, **CPU)
    assert torch.equal(loaded.draws, corrected.draws)
    assert loaded.fit_distribution.components.cov.B.shape[-1] == 0
    assert torch.equal(loaded.fit_distribution.components.cov.diag(),
                       corrected.fit_distribution.components.cov.diag())
    assert torch.equal(resample(loaded, 30).draws, resample(corrected, 30).draws)

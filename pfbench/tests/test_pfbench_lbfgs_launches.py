"""The reader of lbfgs_fused_launches.call: the program's ``launch.lbfgs_iter``
count over the window's calls, and None without the counter, without a
traced profile or without a completed call."""

import dataclasses

import pytest

from conftest import ROOT
from pfharness import registry

NAME = "lbfgs_fused_launches.call"


@dataclasses.dataclass
class _Run:  # what the reader reads of a window's Run
    profile: object
    calls: list


@pytest.fixture
def reader():
    from pathfinder_tpu_torch.utils import tracing

    tracing.reset(tracing.LAUNCH)
    yield registry.find_cell("hg1000-k100-f64", ROOT).metric_reader(NAME)
    tracing.reset(tracing.LAUNCH)


def test_launches_over_calls(reader):
    from pathfinder_tpu_torch.utils import tracing

    tracing.count(tracing.LAUNCH + "lbfgs_iter", 340)
    tracing.count(tracing.LAUNCH + "lbfgs_iter_other", 7)  # another name is not read
    assert reader.read(_Run(profile=object(), calls=[{}, {}])) == 170.0


def test_none_without_the_counter_a_profile_or_a_call(reader):
    from pathfinder_tpu_torch.utils import tracing

    assert reader.read(_Run(profile=object(), calls=[{}])) is None  # no counter, as at the parent
    tracing.count(tracing.LAUNCH + "lbfgs_iter", 3)
    assert reader.read(_Run(profile=None, calls=[{}])) is None
    assert reader.read(_Run(profile=object(), calls=[])) is None
    assert reader.read(_Run(profile=object(), calls=[{}])) == 3.0


def test_the_benchmark_lists_it_for_the_cell():
    cell = registry.find_cell("hg1000-k100-f64", ROOT)
    (entry,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"]) == (
        "launches", "higher", "program_counter", "call_s")

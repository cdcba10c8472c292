"""How the port's CUDA libraries are built, loaded and launched
(``pathfinder_tpu_torch/ops/kernels/_build.py``), on the CPU.

A stand-in ``nvcc`` (a Python script) writes a file for a library and
records each source it is handed, and fails on a source that holds
``#error``; a stand-in ``ctypes.CDLL`` opens nothing. So the library's
name, the build's parallel ``nvcc`` runs, its failure and the table of
loaded libraries are held here without a card or a toolkit; the launch is
held with a stand-in entry point.
"""

import contextlib
import sys
import types

import pytest
import torch

from pathfinder_tpu_torch.ops.kernels import _build
from pathfinder_tpu_torch.utils import tracing

FAKE_NVCC = """#!{python}
import pathlib, sys
args = sys.argv[1:]
src = pathlib.Path(args[-1])
with open({calls!r}, "a") as f:
    f.write(src.name + "\\n")
text = src.read_text()
if "#error" in text:
    print("ptxas fatal : " + src.name + " does not compile")
    sys.exit(2)
pathlib.Path(args[args.index("-o") + 1]).write_text("library of " + text)
print("ptxas info    : Used 40 registers, " + src.name)
"""


@pytest.fixture
def nvcc(tmp_path, monkeypatch):
    """The stand-in compiler, an empty build directory and an empty table;
    returns a function that gives the sources compiled so far."""
    calls = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    script.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_logs", {})
    return lambda: calls.read_text().split() if calls.exists() else []


def _source(directory, name, text):
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / name
    path.write_text(text)
    return path


def test_the_library_is_named_by_the_sources_bytes_and_the_flags(tmp_path, monkeypatch):
    a = _source(tmp_path / "one", "k.cu", "__global__ void k() {}\n")
    same = _source(tmp_path / "two", "k.cu", "__global__ void k() {}\n")
    edited = _source(tmp_path / "three", "k.cu", "__global__ void k() { }\n")
    path = _build.library_path(a)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("k_") and path.suffix == ".so"
    assert _build.library_path(same) == path
    assert _build.library_path(edited) != path
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path(a) != path


def test_a_build_runs_one_nvcc_a_source_and_is_not_repeated(tmp_path, nvcc):
    a = _source(tmp_path / "csrc", "a.cu", "a\n")
    b = _source(tmp_path / "csrc", "b.cu", "b\n")
    _build.build([a, b])
    assert sorted(nvcc()) == ["a.cu", "b.cu"]
    for src in (a, b):
        lib = _build.library_path(src)
        assert lib.read_text() == "library of " + src.read_text()
        assert "Used 40 registers, " + src.name in lib.with_suffix(".log").read_text()
    _build.build([a, b])
    assert sorted(nvcc()) == ["a.cu", "b.cu"]
    a.write_text("a, edited\n")
    _build.build([a, b])
    assert sorted(nvcc()) == ["a.cu", "a.cu", "b.cu"]


def test_a_failing_compiler_raises_with_its_output_and_leaves_no_library(tmp_path, nvcc):
    good = _source(tmp_path / "csrc", "good.cu", "good\n")
    bad = _source(tmp_path / "csrc", "bad.cu", "#error no\n")
    said = r"nvcc failed on bad.cu \(2\):\nptxas fatal : bad.cu does not compile"
    with pytest.raises(RuntimeError, match=said):
        _build.build([good, bad])
    assert sorted(nvcc()) == ["bad.cu", "good.cu"]
    assert _build.library_path(good).exists() and not _build.library_path(bad).exists()
    assert sorted(p.name for p in _build.BUILD_DIR.glob("*.so")) == [
        _build.library_path(good).name]  # no temporary file left


class _Opened:
    """Stands in for ``ctypes.CDLL``."""

    def __init__(self, path):
        self.path = path


def test_load_builds_the_directory_and_keys_the_table_by_the_library(tmp_path, nvcc,
                                                                     monkeypatch):
    """The first load builds every source beside it; a source of another
    directory with equal bytes shares the library, with other bytes it gets
    its own, and each library is bound once."""
    monkeypatch.setattr(_build.ctypes, "CDLL", _Opened)
    bound = []
    x = _source(tmp_path / "one" / "csrc", "x.cu", "x\n")
    y = _source(tmp_path / "one" / "csrc", "y.cu", "y\n")
    lib = _build.load(x, bound.append)
    assert sorted(nvcc()) == ["x.cu", "y.cu"] and bound == [lib]
    assert lib.path == str(_build.library_path(x))
    assert "Used 40 registers, x.cu" in _build.log(x)
    assert _build.load(x, bound.append) is lib and bound == [lib]
    assert _build.load(y, bound.append).path == str(_build.library_path(y))
    assert sorted(nvcc()) == ["x.cu", "y.cu"] and len(bound) == 2
    copy = _source(tmp_path / "two" / "csrc", "x.cu", "x\n")
    assert _build.load(copy, bound.append) is lib and len(bound) == 2
    other = _source(tmp_path / "three" / "csrc", "x.cu", "x, another checkout\n")
    theirs = _build.load(other, bound.append)
    assert theirs is not lib and bound[-1] is theirs
    assert sorted(nvcc()) == ["x.cu", "x.cu", "y.cu"]


def test_a_load_whose_build_fails_raises_and_keeps_nothing(tmp_path, nvcc, monkeypatch):
    monkeypatch.setattr(_build.ctypes, "CDLL", _Opened)
    src = _source(tmp_path / "csrc", "z.cu", "#error no\n")
    for _ in range(2):  # the next load builds again
        with pytest.raises(RuntimeError, match="z.cu does not compile"):
            _build.load(src, lambda lib: None)
    assert nvcc() == ["z.cu", "z.cu"] and _build._libs == {}


@pytest.mark.parametrize("code, error", [(0, None),
                                         (-1, r"rejected its launch plan .* \(1, 2\.5, None\)"),
                                         (700, "cudaError 700")])
def test_launch_passes_the_stream_checks_the_code_and_counts(monkeypatch, code, error):
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    calls = []

    def entry(*args):
        calls.append(args)
        return code

    tracing.reset(tracing.LAUNCH)
    if error is None:
        _build.launch("stand_in", entry, 1, 2.5, None, device=torch.device("cpu"), key=(4, 5))
    else:
        with pytest.raises(RuntimeError, match=error):
            _build.launch("stand_in", entry, 1, 2.5, None, device=torch.device("cpu"),
                          key=(4, 5))
    assert calls == [(1, 2.5, None, 1234)]
    counted = tracing.counts_by_key(tracing.LAUNCH)
    assert counted == ({} if error else {tracing.LAUNCH + "stand_in": {(4, 5): 1}})
    tracing.reset(tracing.LAUNCH)

"""run.py refuses to run without the cards a cell asks for, without the
program beside it, and where JAX was loaded, printing no result."""

import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, describe_cpu, small_cell


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "pfbench/run.py", "--workload", "hg1000-k100-f64", "--seed", str(2**33 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_exits_non_zero_without_a_card():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_exits_non_zero_with_only_the_benchmark(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_card):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_no_result_where_a_metric_reader_loads_jax(tmp_path, monkeypatch, capsys):
    """A metric reader that imports a module named ``jax`` after the window:
    run.py prints no result and exits non-zero."""
    import functools

    from pfharness import registry, window
    from pfharness.registry import load_module

    root = small_cell(tmp_path / "checkout")
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    reader = root / BENCH.name / "metrics" / "setup_s.py"
    reader.write_text(f"import sys\nsys.path.insert(0, {str(fake)!r})\nimport jax  # noqa\n"
                      + reader.read_text())
    run_py = load_module(BENCH / "run.py", "pfbench_run_under_test")
    monkeypatch.setattr(run_py, "cards_missing", lambda chips: "")
    real_find = registry.find_cell
    monkeypatch.setattr(registry, "find_cell", lambda name: real_find(name, root))
    monkeypatch.setattr(window, "run", functools.partial(window.run, device="cpu",
                                                         log=lambda *a: None,
                                                         describe=describe_cpu))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        rc = run_py.main(["--workload", "small", "--seed", str(2**33 + 9), "--seconds", "0.001",
                          "--trace", "0"])
        out = capsys.readouterr()
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    assert rc != 0
    assert out.out.strip() == ""
    assert "forbidden modules loaded: jax" in out.err

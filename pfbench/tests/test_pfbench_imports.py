"""The check that no JAX is loaded compares whole top-level names."""

import subprocess
import sys

from conftest import BENCH
from pfharness.imports import forbidden_loaded


def test_whole_names_are_compared():
    assert forbidden_loaded(["pathfinder_tpu_torch", "pathfinder_tpu_torch.ops", "jaxtyping",
                             "torch", "flaxen.x"]) == []
    assert forbidden_loaded(["jax"]) == ["jax"]
    assert forbidden_loaded(["jax.numpy", "jaxlib.xla", "flax"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_loaded(["pathfinder_tpu.ops.psis"]) == ["pathfinder_tpu"]


def test_the_harness_and_reference_load_no_jax():
    code = (f"import sys; sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}]\n"
            "import pfharness.window, reference.check, pathfinder_tpu_torch\n"
            "from pfharness.imports import forbidden_loaded\n"
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "pathfinder_tpu" not in text and "import jax" not in text, path

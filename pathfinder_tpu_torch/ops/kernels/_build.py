"""Build, load and launch the port's CUDA libraries.

Each ``.cu`` source is one library with a plain C interface, built by
``nvcc`` into the ``build/`` directory beside the package and named by a
hash of the source's bytes and the flags. :func:`load` is the one way in:
the first load of a library builds every source beside it not built yet,
one ``nvcc`` each, all started together, and binds the library with its
wrapper's binder. A wrapper names its sources relative to its own file, and
the table of loaded libraries is keyed by the library's path, so a wrapper
loaded from another checkout binds that checkout's sources. :func:`launch`
is the one way an entry point is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

import torch

from pathfinder_tpu_torch.utils import tracing

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "launch", "library_path", "load", "log", "nvcc"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "pathfinder_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = {}  # library path -> the loaded library
_logs = {}  # library path -> what nvcc (ptxas -v) said when it built it
_lock = threading.Lock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path) -> Path:
    """Where the library of ``source`` is built: named by a hash of the
    source's bytes and the flags."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{tag}.so"


def build(sources) -> None:
    """Build the libraries of ``sources`` not built yet, one ``nvcc`` each,
    all started together. A failure raises with ``nvcc``'s output and leaves
    no library of that source behind."""
    todo = [src for src in sources if not library_path(src).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
            continue
        so_path = library_path(src)
        so_path.with_suffix(".log").write_text(out)
        os.replace(tmp, so_path)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path, binder: Callable) -> ctypes.CDLL:
    """The library of ``source``, bound by ``binder`` at its first load in
    this process, which builds every ``.cu`` source beside ``source`` not
    built yet (:func:`build`)."""
    with _lock:
        path = library_path(source)
        lib = _libs.get(path)
        if lib is None:
            build(sorted(source.parent.glob("*.cu")))
            lib = ctypes.CDLL(str(path))
            binder(lib)
            log_path = path.with_suffix(".log")
            _logs[path] = log_path.read_text() if log_path.exists() else ""
            _libs[path] = lib
        return lib


def log(source: Path) -> str:
    """What ``nvcc`` (``ptxas -v``) said when it built the loaded library of
    ``source``."""
    return _logs[library_path(source)]


def launch(name: str, entry: Callable, *args, device, key=None) -> None:
    """``entry(*args, stream)`` on ``device``'s current stream, counted as
    ``launch.<name>`` under ``key``. The entry point returns 0, −1 where the
    kernel rejected its plan or its arguments, or a ``cudaError``."""
    with torch.cuda.device(device):
        code = entry(*args, torch.cuda.current_stream().cuda_stream)
    if code == -1:
        raise RuntimeError(f"{name} kernel rejected its launch plan or arguments {args}")
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {code}")
    tracing.count(tracing.LAUNCH + name, key=key)

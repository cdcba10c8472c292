"""Woodbury sample+logq (B1) and whiten+sumsq (B2): CUDA kernels and their
plain torch versions.

They replace the JAX package's Pallas TPU kernels ``_sample_kernel`` and
``_whiten_kernel`` (``pathfinder_tpu/ops/pallas/woodbury_kernels.py`` at
commit ``c548d16^``). The CUDA source, with the notes on what bounds the
kernels and how they are laid out, is ``pathfinder_tpu_torch/csrc/
woodbury_kernels.cu``.

Each wrapper takes tensors on the CPU through the plain version, and
tensors on a CUDA device through the kernel; on a CUDA tensor it launches
the kernel or raises, and never falls back. The kernel is built with
``nvcc`` at first use, from the sources in the package, into the ``build/``
directory beside the package, and bound with ``ctypes``.

Shapes (batch ``B`` of independent factors, dimension ``d``, rank ``m``,
``N`` draws): ``u``/``x`` ``(B, d, N)``, ``a_half``/``mu`` ``(B, d)``,
``X`` ``(B, d, m)``, ``C``/``Ci`` ``(B, m, m)``, ``logdet`` ``(B,)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = [
    "sample_and_logq",
    "sample_and_logq_torch",
    "whiten_sumsq",
    "whiten_sumsq_torch",
    "launch_counts",
    "reset_launch_counts",
    "load_library",
]

_LOG_2PI = math.log(2.0 * math.pi)
_PKG_DIR = Path(__file__).resolve().parents[2]
_SOURCE = _PKG_DIR / "csrc" / "woodbury_kernels.cu"
_BUILD_DIR = _PKG_DIR.parent / "build" / "pathfinder_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
MAX_RANK = 32

# launches of each kernel since the last reset (plain-version calls on CPU
# tensors do not count)
_launches = {"sample_and_logq": 0, "whiten_sumsq": 0}
_lib = None
_lib_lock = threading.Lock()


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


# -- plain versions -----------------------------------------------------------


def sample_and_logq_torch(u, a_half, X, C, mu, logdet):
    """``x = a½ ∘ (u + X (C (Xᵀ u))) + μ`` and
    ``logq = −(d·log2π + logdet + ‖u‖²)/2`` per column."""
    d = u.shape[-2]
    core = u + X @ (C @ (X.mT @ u))
    x = a_half[..., None] * core + mu[..., None]
    usq = torch.sum(u * u, dim=-2)
    logq = -0.5 * (d * _LOG_2PI + logdet[..., None] + usq)
    return x, logq


def whiten_sumsq_torch(x, a_half, X, Ci, mu):
    """``‖v + X (Ci (Xᵀ v))‖²`` per column, ``v = (x − μ)/a½``."""
    v = (x - mu[..., None]) / a_half[..., None]
    w = v + X @ (Ci @ (X.mT @ v))
    return torch.sum(w * w, dim=-2)


# -- build and bind -----------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library() -> ctypes.CDLL:
    """Build (once per source and flags) and load the kernels' library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SOURCE.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        so_path = _BUILD_DIR / f"woodbury_kernels_{tag}.so"
        if not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(str(so_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pf_sample_logq.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.pf_sample_logq.restype = i
        lib.pf_whiten_sumsq.argtypes = [p] * 6 + [i] * 4 + [p]
        lib.pf_whiten_sumsq.restype = i
        lib.pf_max_rank.argtypes = []
        lib.pf_max_rank.restype = i
        if lib.pf_max_rank() != MAX_RANK:
            raise RuntimeError("kernel library and wrapper disagree on MAX_RANK")
        _lib = lib
        return lib


# -- wrappers -----------------------------------------------------------------


def _check_cuda_args(names_shapes, device):
    for name, t, shape in names_shapes:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _flat_shapes(u, X):
    if u.ndim < 2 or X.ndim != u.ndim:
        raise ValueError(
            f"expected u/x (..., d, N) and X (..., d, m); got {tuple(u.shape)}, "
            f"{tuple(X.shape)}"
        )
    batch = tuple(u.shape[:-2])
    d, N = u.shape[-2:]
    m = X.shape[-1]
    if d == 0:
        raise ValueError("the kernels need d >= 1")
    if m > MAX_RANK:
        raise ValueError(f"rank m={m} exceeds the kernel's cap of {MAX_RANK}")
    return batch, math.prod(batch), d, m, N


def _raise_on_error(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {code}")


def sample_and_logq(u, a_half, X, C, mu, logdet):
    """B1: fused ``(x, logq)`` from standard-normal draws ``u (..., d, N)``."""
    if u.device.type == "cpu":
        return sample_and_logq_torch(u, a_half, X, C, mu, logdet)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    batch, B, d, m, N = _flat_shapes(u, X)
    _check_cuda_args(
        [
            ("u", u, batch + (d, N)),
            ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)),
            ("C", C, batch + (m, m)),
            ("mu", mu, batch + (d,)),
            ("logdet", logdet, batch),
        ],
        u.device,
    )
    x = torch.empty_like(u)
    logq = torch.empty(batch + (N,), dtype=u.dtype, device=u.device)
    if B == 0 or N == 0:
        return x, logq
    lib = load_library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pf_sample_logq(
            u.data_ptr(), a_half.data_ptr(), X.data_ptr(), C.data_ptr(),
            mu.data_ptr(), logdet.data_ptr(), x.data_ptr(), logq.data_ptr(),
            B, d, m, N, stream,
        )
    _raise_on_error(code, "sample_and_logq")
    _launches["sample_and_logq"] += 1
    return x, logq


def whiten_sumsq(x, a_half, X, Ci, mu):
    """B2: Mahalanobis terms ``‖L⁻¹(x − μ)‖²`` for the columns of ``x``."""
    if x.device.type == "cpu":
        return whiten_sumsq_torch(x, a_half, X, Ci, mu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    batch, B, d, m, N = _flat_shapes(x, X)
    _check_cuda_args(
        [
            ("x", x, batch + (d, N)),
            ("a_half", a_half, batch + (d,)),
            ("X", X, batch + (d, m)),
            ("Ci", Ci, batch + (m, m)),
            ("mu", mu, batch + (d,)),
        ],
        x.device,
    )
    maha = torch.empty(batch + (N,), dtype=x.dtype, device=x.device)
    if B == 0 or N == 0:
        return maha
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pf_whiten_sumsq(
            x.data_ptr(), a_half.data_ptr(), X.data_ptr(), Ci.data_ptr(),
            mu.data_ptr(), maha.data_ptr(), B, d, m, N, stream,
        )
    _raise_on_error(code, "whiten_sumsq")
    _launches["whiten_sumsq"] += 1
    return maha

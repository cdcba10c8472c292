"""One Hager-Zhang evaluation's state update as one CUDA launch.

``ops/linesearch.py`` runs the Hager-Zhang search as a loop of batched
evaluations; after each, the state of every lane moves on by the stage
machine of :func:`pathfinder_tpu_torch.ops.linesearch._hz_step_torch`, about
175 eager torch ops on ``(K,)`` tensors. On a CUDA device, for float32 and
float64 (:func:`takes`), :func:`step` does the same update in one launch of
``pathfinder_tpu_torch/csrc/linesearch_kernels.cu`` and gives the same bits:
every lane follows the path it follows in the plain version, with the same
evaluations, steps, values and counts. Every other device and dtype takes
the plain version; the choice follows only the tensors' device and dtype.

The search's state lives in a few tensors allocated once a search
(:func:`pack`): its floats and the constants ``f0``, ``dphi0``, ``eps_k`` in
one ``(len(FIELDS) + 3, K)`` tensor, the stage and the evaluation count in
one int64 ``(2, K)``, and ``accepted``, ``g_a`` and ``g_acc`` of their own.
The state is a dict with the plain version's keys whose entries are views of
those tensors, so the search's epilogue reads either. A launch updates them
in place, writes the next trial point into a new tensor and sets the flag
that the search's next check reads (two int32 slots, taken in turn).

The library is built by ``nvcc`` at first use with the Woodbury kernels'
flags, named by a hash of the source and the flags, and bound with
``ctypes`` (``woodbury_kernels._load_all``). Each launch counts once in the
always-on launch counter, ``launch.hz_step`` (``utils/tracing.py``), with no
shape: it is not one of ``woodbury_kernels``' kernels, whose counts are kept
by ``(B, m, N, shared)``.
"""

from __future__ import annotations

import ctypes

import torch

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.utils import tracing

__all__ = ["COUNTER", "FIELDS", "CONSTANTS", "HZState", "load_library", "pack", "step", "takes"]

_SOURCE = wk._PKG_DIR / "csrc" / "linesearch_kernels.cu"
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}  # csrc: pf_hz_step's dtype
COUNTER = tracing.LAUNCH + "hz_step"  # launches since the family's last reset

# the rows of the state tensor (csrc: enum Field), then the search's constants
FIELDS = ("c", "a", "phi_a", "dphi_a", "b", "phi_b", "dphi_b", "a0", "b0", "phi_a0",
          "dphi_a0", "phi_b0", "dphi_b0", "a_acc", "phi_acc")
CONSTANTS = ("f0", "dphi0", "eps_k")


def takes(device, dtype) -> bool:
    """Whether a search on ``device`` in ``dtype`` updates its state by the
    kernel (float32 and float64 on a CUDA device) or by the plain version."""
    return torch.device(device).type == "cuda" and dtype in _DTYPE_CODES


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pf_hz_step.argtypes = [i] + [p] * 12 + [i] * 4 + [f] * 6 + [p]
    lib.pf_hz_step.restype = i
    lib.pf_hz_fields.argtypes = []
    lib.pf_hz_fields.restype = i
    if lib.pf_hz_fields() != len(FIELDS) + len(CONSTANTS):
        raise RuntimeError("line-search kernel library and wrapper disagree on the state's rows")


_lib = None  # the library once loaded, read by every launch without a lock


def load_library() -> ctypes.CDLL:
    """Build and load the line-search kernel's library; returns it."""
    global _lib
    if _lib is None:
        wk._load_all({_SOURCE: _bind})
        _lib = wk._libs[_SOURCE.name]
    return _lib


class HZState(dict):
    """A search's state in the kernel's tensors: the plain version's keys,
    each a view of (or one of) the tensors a launch updates in place."""

    __slots__ = ("floats", "ints", "flags", "evals")


def pack(s: dict, k) -> HZState:
    """The plain version's initial state ``s`` and the constants ``k`` (an
    ``ops/linesearch._HZConst``) in the kernel's tensors, copied."""
    floats = torch.stack([s[name] for name in FIELDS] + [k.f0, k.dphi0, k.eps_k])
    ints = torch.stack([s["stage"], s["nev"]])
    st = HZState(zip(FIELDS, floats.unbind(0)))
    st["stage"], st["nev"] = ints.unbind(0)
    st["accepted"] = s["accepted"].clone()
    for name in ("g_a", "g_acc"):
        st[name] = s[name].clone(memory_format=torch.contiguous_format)
    st.floats, st.ints, st.evals = floats, ints, 0
    st.flags = torch.zeros(2, dtype=torch.int32, device=floats.device)
    return st


def step(s: HZState, phi_c, g_c, dphi_c, x, p, k) -> tuple:
    """:func:`~pathfinder_tpu_torch.ops.linesearch._hz_step_torch` by one
    launch: updates ``s`` in place and returns ``(s, the next trial point,
    the flag: whether any lane runs on)``, the flag a 0-d int32 tensor on
    the card."""
    floats = s.floats
    dtype, dev = floats.dtype, floats.device
    K, d = s["g_a"].shape
    for name, t, shape in (("phi_c", phi_c, (K,)), ("dphi_c", dphi_c, (K,)), ("g_c", g_c, (K, d)),
                           ("x", x, (K, d)), ("p", p, (K, d))):
        if t.dtype != dtype or t.device != dev or t.shape != shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}; the state is "
                             f"{dtype} with {K} lanes of {d} on {dev}")
    phi_c, dphi_c, g_c = phi_c.contiguous(), dphi_c.contiguous(), g_c.contiguous()
    x, p = x.contiguous(), p.contiguous()
    x_next = torch.empty_like(x)
    parity = s.evals & 1
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.pf_hz_step(
            _DTYPE_CODES[dtype], floats.data_ptr(), s.ints.data_ptr(), s["accepted"].data_ptr(),
            s["g_a"].data_ptr(), s["g_acc"].data_ptr(), phi_c.data_ptr(), dphi_c.data_ptr(),
            g_c.data_ptr(), x.data_ptr(), p.data_ptr(), x_next.data_ptr(), s.flags.data_ptr(),
            parity, K, d, int(k.max_evals), float(k.delta), float(k.sigma),
            2.0 * float(k.delta) - 1.0, float(k.gamma), float(k.theta), float(k.expand), stream)
    if code != 0:
        raise RuntimeError(f"hz_step kernel launch failed with cudaError {code}")
    s.evals += 1
    tracing.count(COUNTER)
    return s, x_next, s.flags[parity]

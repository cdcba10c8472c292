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

:class:`Iterations` does the rest of an L-BFGS iteration with this search
in one launch of the same library (``lbfgs_iter_kernel``): from the state
the search's last update left, the search's result, the trajectory's trace
rows, stopping and abort rules, the curvature-guarded history update, the
next direction and the next search's start, the plain version of which is
``ops/trajectory.advance``, ``ops/lbfgs._lbfgs_update``,
``ops/lbfgs._lbfgs_direction`` and ``ops/linesearch._hz_start``. Its
elementwise parts and its integers give the plain version's bits; its sums
over ``d`` (the directions' dots and solves, the curvature test, the
diagonal's refresh) run in the kernel's order and differ from torch's at
rounding level. It is taken where :func:`iterates` says so, and counts
``launch.lbfgs_iter``.
"""

from __future__ import annotations

import ctypes

import torch

from pathfinder_tpu_torch.ops.kernels import woodbury_kernels as wk
from pathfinder_tpu_torch.utils import tracing

__all__ = ["COUNTER", "FIELDS", "CONSTANTS", "HZState", "INTS", "ITER_COUNTER", "Iterations",
           "MAX_HISTORY", "iterates", "load_library", "pack", "step", "takes"]

_SOURCE = wk._PKG_DIR / "csrc" / "linesearch_kernels.cu"
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}  # csrc: pf_hz_step's dtype
COUNTER = tracing.LAUNCH + "hz_step"  # launches since the family's last reset

# the rows of the state tensor (csrc: enum Field), then the search's constants
FIELDS = ("c", "a", "phi_a", "dphi_a", "b", "phi_b", "dphi_b", "a0", "b0", "phi_a0",
          "dphi_a0", "phi_b0", "dphi_b0", "a_acc", "phi_acc")
CONSTANTS = ("f0", "dphi0", "eps_k")
ITER_COUNTER = tracing.LAUNCH + "lbfgs_iter"
# the rows of an L-BFGS batch's int64 state (csrc: enum LbfgsInt)
INTS = ("it", "nev", "nexh", "pos", "hlen", "nrej")
MAX_HISTORY = 32  # the longest L-BFGS history an iteration's launch takes (csrc: kMaxHistory)


def takes(device, dtype) -> bool:
    """Whether a search on ``device`` in ``dtype`` updates its state by the
    kernel (float32 and float64 on a CUDA device) or by the plain version."""
    return torch.device(device).type == "cuda" and dtype in _DTYPE_CODES


def iterates(device, dtype, history_length: int) -> bool:
    """Whether an L-BFGS iteration with the Hager-Zhang search on ``device``
    in ``dtype`` keeping ``history_length`` pairs takes one launch of the
    iteration kernel: where the search's update does (:func:`takes`), for a
    history of at most :data:`MAX_HISTORY` pairs."""
    return takes(device, dtype) and 0 <= history_length <= MAX_HISTORY


class _LbfgsArgs(ctypes.Structure):
    """csrc: struct LbfgsArgs."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "x", "f", "g", "alpha", "S", "Y", "p", "x_c", "xs", "fs", "gs", "gtol", "ints", "done",
            "run", "hz", "hz_ints", "accepted", "g_a", "g_acc", "flags")]
        + [(name, ctypes.c_double) for name in ("ftol_rel", "eps_curv", "hz_epsilon", "psi0")]
        + [(name, ctypes.c_int) for name in (
            "K", "d", "J", "maxiters", "fail_nonfinite", "parity", "start")])


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pf_hz_step.argtypes = [i] + [p] * 12 + [i] * 4 + [f] * 6 + [p]
    lib.pf_hz_step.restype = i
    lib.pf_lbfgs_iter.argtypes = [i, p, p]
    lib.pf_lbfgs_iter.restype = i
    for name in ("pf_hz_fields", "pf_lbfgs_args_size", "pf_lbfgs_max_history"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    if lib.pf_hz_fields() != len(FIELDS) + len(CONSTANTS):
        raise RuntimeError("line-search kernel library and wrapper disagree on the state's rows")
    if (lib.pf_lbfgs_args_size() != ctypes.sizeof(_LbfgsArgs)
            or lib.pf_lbfgs_max_history() != MAX_HISTORY):
        raise RuntimeError("line-search kernel library and wrapper disagree on an L-BFGS batch")


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


def _state(floats, ints, accepted, g_a, g_acc) -> HZState:
    st = HZState(zip(FIELDS, floats.unbind(0)))
    st["stage"], st["nev"] = ints.unbind(0)
    st["accepted"], st["g_a"], st["g_acc"] = accepted, g_a, g_acc
    st.floats, st.ints, st.evals = floats, ints, 0
    st.flags = torch.zeros(2, dtype=torch.int32, device=floats.device)
    return st


def pack(s: dict, k) -> HZState:
    """The plain version's initial state ``s`` and the constants ``k`` (an
    ``ops/linesearch._HZConst``) in the kernel's tensors, copied."""
    floats = torch.stack([s[name] for name in FIELDS] + [k.f0, k.dphi0, k.eps_k])
    ints = torch.stack([s["stage"], s["nev"]])
    return _state(floats, ints, s["accepted"].clone(),
                  *(s[name].clone(memory_format=torch.contiguous_format)
                    for name in ("g_a", "g_acc")))


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


class Iterations:
    """A batch of L-BFGS trajectories with the Hager-Zhang search in the
    kernels' tensors, allocated once a batch: the iterates ``x``, ``f`` and
    ``g`` (the minimizer's view), the diagonal ``alpha``, the circular
    history ``S`` and ``Y`` ``(K, J, d)``, the search's direction ``p``, the
    int64 rows :data:`INTS` (``ints``; ``it``, ``nev``, ... their views), the
    masks ``done`` and ``run`` (the lanes of the search under way), and the
    search's state ``search`` (an :class:`HZState`, updated by :func:`step`
    between launches). The trace buffers ``xs``, ``fs``, ``gs`` (row 0
    written) and the effective ``gtol`` are the caller's; each launch writes
    the trace rows of the lanes that moved in place. ``x0``, ``f0`` and
    ``g0`` are copied; ``done`` marks the lanes that start done."""

    def __init__(self, x0, f0, g0, done, gtol, trace: tuple, *, history_length: int,
                 maxiters: int, ftol_rel: float, epsilon_curvature: float,
                 fail_on_nonfinite: bool, epsilon: float, psi0: float):
        K, d = x0.shape
        dtype, dev = x0.dtype, x0.device
        J = history_length
        contiguous = torch.contiguous_format
        self.x = x0.clone(memory_format=contiguous)
        self.f = f0.clone(memory_format=contiguous)
        self.g = g0.clone(memory_format=contiguous)
        self.alpha = torch.ones_like(self.x)
        self.S = torch.zeros((K, J, d), dtype=dtype, device=dev)
        self.Y = torch.zeros((K, J, d), dtype=dtype, device=dev)
        self.p = torch.empty_like(self.x)
        self.ints = torch.zeros((len(INTS), K), dtype=torch.int64, device=dev)
        self.ints[INTS.index("nev")] = 1  # the evaluation at x0
        for name, row in zip(INTS, self.ints.unbind(0)):
            setattr(self, name, row)
        self.masks = torch.stack([done, torch.zeros_like(done)])
        self.done, self.run = self.masks.unbind(0)
        self.gtol = gtol.contiguous()
        self.xs, self.fs, self.gs = trace
        floats = torch.empty((len(FIELDS) + len(CONSTANTS), K), dtype=dtype, device=dev)
        self.search = _state(floats, torch.empty((2, K), dtype=torch.int64, device=dev),
                             torch.empty(K, dtype=torch.bool, device=dev),
                             torch.empty_like(self.x), torch.empty_like(self.x))
        for name, t, shape in (("gtol", self.gtol, (K,)), ("xs", self.xs, (K, maxiters + 1, d)),
                               ("fs", self.fs, (K, maxiters + 1)),
                               ("gs", self.gs, (K, maxiters + 1, d))):
            if (t.dtype != dtype or t.device != dev or t.shape != shape
                    or not t.is_contiguous()):
                raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}; the batch "
                                 f"takes a contiguous {dtype} {shape} on {dev}")
        self._dtype = _DTYPE_CODES[dtype]
        s = self.search
        self._args = _LbfgsArgs(
            *(t.data_ptr() for t in (self.x, self.f, self.g, self.alpha, self.S, self.Y, self.p,
                                     self.p, self.xs, self.fs, self.gs, self.gtol, self.ints,
                                     self.done, self.run, s.floats, s.ints, s["accepted"],
                                     s["g_a"], s["g_acc"], s.flags)),
            float(ftol_rel), float(epsilon_curvature), float(epsilon), float(psi0),
            K, d, J, int(maxiters), int(bool(fail_on_nonfinite)), 0, 0)

    def launch(self, start: bool = False) -> tuple:
        """One launch: with ``start``, the first search's start from the
        initial point; else the iteration that the search's last update
        ended. Returns ``(the next search's first trial point, the flag:
        whether any lane runs on)``, the flag a 0-d int32 tensor on the card,
        to be read before the next launch of the search's state."""
        s = self.search
        x_c = torch.empty_like(self.x)
        parity = s.evals & 1
        args = self._args
        args.x_c, args.parity, args.start = x_c.data_ptr(), parity, int(start)
        lib = load_library()
        with torch.cuda.device(self.x.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.pf_lbfgs_iter(self._dtype, ctypes.addressof(args), stream)
        if code != 0:
            raise RuntimeError(f"lbfgs_iter kernel launch failed with cudaError {code}")
        s.evals += 1
        tracing.count(ITER_COUNTER)
        return x_c, s.flags[parity]

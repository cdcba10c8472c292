"""Serving-scale launches over the paths axis (counterpart of
``pathfinder_tpu/parallel/sharding.py``, without the device mesh).

Tens of thousands of paths do not fit one batch: one lane's trace, history
and ELBO chunk are megabytes at d=1000. :func:`chunk_launches` runs a batch
of paths as launches of one fixed lane count, and can stream each launch's
output into host memory as it completes, so that the card holds one or two
launches and never the whole pool. Every random number of a path comes from
its ``(seed, path id, round)`` streams, so the cap and the offload change no
random number and no decision.

The defaults come from this card's memory: :func:`plan_launches` takes the
card's total memory, a per-lane estimate of one launch's peak
(:func:`lane_bytes`) and of the state a lane keeps (:func:`state_bytes`),
all three fixed for a card and a configuration. The plan is taken from the
total, not the free memory, because the cap can change a result's last bits
(a kernel's launch plan and a library's algorithm follow the batch), so the
same card and the same options always choose the same cap. Memory that
other work holds on the card is the caller's to leave room for, by passing
``max_paths_per_launch``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from pathfinder_tpu_torch.utils.misc import tree_map

__all__ = [
    "pad_paths",
    "chunk_launches",
    "lane_bytes",
    "state_bytes",
    "plan_launches",
    "device_memory_bytes",
    "LAUNCH_SHARE",
    "OFFLOAD_SHARE",
]

# Of the card's memory: what one launch's estimated peak may take (the rest
# is for the caching allocator's fragmentation, the accumulated states and
# the PSIS tail), and what the accumulated states of all launches may take
# before they are streamed to the host instead.
LAUNCH_SHARE = 0.5
OFFLOAD_SHARE = 0.25


def pad_paths(n: int, cap: Optional[int] = None) -> int:
    """Lanes that ``n`` paths occupy in launches of ``cap`` lanes: ``n``
    rounded up to whole launches (``n`` itself without a cap). The padding
    lanes repeat the leading paths and their results are dropped."""
    if cap is None or cap >= n:
        return n
    return -(-n // cap) * cap


def chunk_launches(executor: Callable, cap: Optional[int], offload: bool = False) -> Callable:
    """Wrap ``executor(path_ids (B,), x0s (B, d)) -> state`` (batched over
    ``B``) so that a batch of more than ``cap`` paths runs as launches of
    ``cap`` lanes each, the last padded by repeating the leading lanes.

    The chunks' outputs are written into buffers of the batch's own row
    count, one per leaf: on the device, or with ``offload`` in host memory
    (pinned where the executor runs on a CUDA device). An offloaded chunk is
    copied on a side stream while the next chunk runs: the wrapper launches
    chunk c+1 before it waits on chunk c's copy, so at most two chunk
    outputs live on the card. The copies move bits, so the values are those
    of the un-offloaded run. ``offload`` also moves a batch that runs as one
    launch.
    """
    if cap is not None and cap <= 0:
        raise ValueError(f"max_paths_per_launch must be positive; got {cap}")

    def run(path_ids: torch.Tensor, x0s: torch.Tensor):
        K = path_ids.shape[0]
        c = K if cap is None else min(cap, K)
        n_chunks = -(-K // c)
        if n_chunks == 1 and not offload:
            return executor(path_ids, x0s)
        pad = pad_paths(K, c) - K
        if pad:
            path_ids = torch.cat([path_ids, path_ids[:pad]])
            x0s = torch.cat([x0s, x0s[:pad]])
        dev = x0s.device
        pin = offload and dev.type == "cuda"
        side = torch.cuda.Stream(dev) if pin else None
        bufs = None
        pending = None  # (a chunk's output, the event its copy records)
        for i in range(n_chunks):
            out = executor(path_ids[i * c:(i + 1) * c], x0s[i * c:(i + 1) * c])
            if bufs is None:
                bufs = tree_map(
                    lambda t: torch.empty(
                        (K,) + t.shape[1:], dtype=t.dtype,
                        device="cpu" if offload else dev, pin_memory=pin,
                    ),
                    out,
                )
            lo, rows = i * c, min(c, K - i * c)

            def put(buf, t):
                return buf[lo:lo + rows].copy_(t[:rows], non_blocking=pin)

            if side is None:
                tree_map(put, bufs, out)
                continue
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                side.wait_event(ready)
                tree_map(put, bufs, out)
                done = torch.cuda.Event()
                done.record(side)
            if pending is not None:
                pending[1].synchronize()  # chunk i-1's copy; chunk i has run
            # the output stays referenced until its copy is done, so the
            # caching allocator cannot hand its memory to the next chunk early
            pending = (out, done)
        if pending is not None:
            pending[1].synchronize()
        return bufs

    return run


def state_bytes(d: int, maxiters: int, history_length: int, ndraws: int,
                dtype=torch.float32, keep_traces: bool = True) -> int:
    """Bytes of one lane's ``SinglePathState``: the trace (none with
    ``keep_traces=False``), the ELBO values, the fitted normal and its
    factor, the draws, ten int64 counters and ids, and the success flag.
    ``ndraws`` is the draws per path."""
    m, L = 2 * history_length, maxiters
    trace = (2 * (L + 1) * d + (L + 1)) if keep_traces else 0
    fit = d + (d + d * m + m * m) + (d + d * m + 2 * m * m + 1)  # mean; A, B, D; the factor
    floats = trace + 2 * L + fit + d * ndraws
    return floats * (torch.finfo(dtype).bits // 8) + 8 * 10 + 1


def lane_bytes(d: int, maxiters: int, history_length: int, ndraws_elbo: int,
               elbo_chunk: int, ndraws: int, dtype=torch.float32) -> int:
    """An upper estimate of one lane's share of a launch's peak device
    memory, for L-BFGS with the component denominator.

    The peak falls in the ELBO stage: the trace and the history arrays that
    rebuild a fit at any point (steps, gradient differences, diagonals and
    their stack) are held while one chunk of ``C`` candidates is either
    built (history windows, factors and their temporaries, about ``11·J·d``
    floats a candidate) or sampled (the factors kept, ``(4·J + 3)·d``
    floats, the noise, the draws and the target's temporaries, ``4·d·N``,
    and the noise's Philox words, int64, about 40 bytes a normal at the
    stream's peak). The winner's ``ndraws`` draws are sampled alike, one
    candidate a lane. Measured on the card: ``tools/serving_memory.py``."""
    f = torch.finfo(dtype).bits // 8
    J, L, C = history_length, maxiters, min(elbo_chunk, maxiters)
    held = f * (2 * (L + 1) * d + (L + 1) + (2 * L + 2 * (L + 1)) * d)

    def sample(n):
        return f * ((4 * J + 3) * d + 4 * d * n) + 40 * d * n

    return held + max(C * f * 11 * J * d, C * sample(ndraws_elbo), sample(ndraws))


def plan_launches(K: int, peak_per_lane: int, state_per_lane: int, device_bytes: int,
                  cap: Optional[int] = None, offload: Optional[bool] = None):
    """``(cap, offload)`` for ``K`` paths on a card of ``device_bytes`` of
    memory. A ``cap`` or ``offload`` that is given is kept.

    Without a cap the paths run in the fewest launches whose estimated peak
    fits in ``LAUNCH_SHARE`` of the card's memory, split evenly (``None``:
    one launch). Without an offload choice the states go to the host when
    the run is chunked and the states of all ``K`` lanes would pass
    ``OFFLOAD_SHARE`` of it."""
    if cap is None:
        fit = max(1, int(LAUNCH_SHARE * device_bytes) // max(1, peak_per_lane))
        n_chunks = -(-K // fit)
        cap = None if n_chunks == 1 else -(-K // n_chunks)
    if offload is None:
        chunked = cap is not None and cap < K
        offload = chunked and K * state_per_lane > OFFLOAD_SHARE * device_bytes
    return cap, bool(offload)


def device_memory_bytes(device) -> int:
    """The card's total memory, as the CUDA runtime reports it."""
    return torch.cuda.mem_get_info(device)[1]

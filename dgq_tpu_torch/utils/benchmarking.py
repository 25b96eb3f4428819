"""Device timing of a function by chains of dependent calls.

Port of ``dgq_tpu/utils/benchmarking.py`` with the same signatures and the
same estimator: run ``fn`` in a chain where each output, through
``feedback``, becomes the next input, time a short and a long chain
``repeats`` times each, and take the difference of the two minima over the
difference in length, with ``min_dt`` as the floor.

On CUDA tensors each chain is timed with ``torch.cuda.Event`` before its
first call and after its last, read after the end event completes: device
time, host launch gaps included where the host falls behind.  On CPU
tensors the caller asked for the CPU: the chains run on the host clock, and
the result says so (``Seconds.clock`` is ``"host"``; on the card it is
``"cuda-events"``).  ``flushed_seconds`` times single calls on the card
instead, each after an L2 flush: for a call shorter than the host's launch
of it, where a chain would time the host.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

CUDA_EVENTS, HOST, FLUSHED = "cuda-events", "host", "cuda-events, L2 flushed"


class Seconds(float):
    """Seconds per call, and the clock that measured them (``clock``)."""

    clock: str

    def __new__(cls, value: float, clock: str):
        obj = super().__new__(cls, value)
        obj.clock = clock
        return obj


def _same_shape_feedback(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if out.shape == x.shape and out.dtype == x.dtype:
        return out
    raise ValueError("fn output does not match input; pass feedback=(out, x) -> next_x")


def device_time(
    fn: Callable,
    x: torch.Tensor,
    *rest,
    feedback: Optional[Callable] = None,
    iters: int = 96,
    base_iters: int = 24,
    repeats: int = 3,
    min_dt: float = 0.0,
) -> Seconds:
    """Seconds per invocation of ``fn(x, *rest)``.

    The minima of the short (``base_iters``) and the long (``iters``) chains
    are differenced, which cancels the fixed cost of starting and ending a
    chain.  ``min_dt``: the physical floor (the call's time at the card's
    peak); a difference at or below it is replaced by the long chain alone
    over its length, never reported below the floor."""
    feedback = feedback or _same_shape_feedback
    on_card = x.device.type == "cuda"

    def run(n: int) -> float:
        a = x
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                a = feedback(fn(a, *rest), a)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            a = feedback(fn(a, *rest), a)
        return time.perf_counter() - t0

    run(2)  # warm-up: kernel builds, allocator, clocks
    shorts, longs = [], []
    for _ in range(repeats):
        shorts.append(run(base_iters))
        longs.append(run(iters))
    dt = (min(longs) - min(shorts)) / (iters - base_iters)
    if dt <= min_dt:
        dt = max(min(longs) / iters, min_dt)
    return Seconds(dt, CUDA_EVENTS if on_card else HOST)


# passes of a 128 MB L2 flush before each call: enough card time (~40 us a pass on an H100)
# that the host's launch of the next call (~40 us of Python) never leaves the card idle; with
# one pass the host's gaps entered 12 us calls' times (up to 1.3x the profiler's)
FLUSHES = 3
# readings, of which the median is kept: one reading gave outliers both ways (2-3x)
READINGS = 3


def flushed_seconds(fn: Callable, flush: torch.Tensor, iters: int) -> Seconds:
    """Device seconds a call of ``fn()`` on the card, from CUDA events
    alone: ``iters`` calls, each after FLUSHES passes of an L2 flush (``flush``
    a 128 MB uint8 tensor on the card), less the same flushes without the
    calls, the median of READINGS such readings.  The flushes keep the card
    busier than the host's launches, so host gaps stay out of the
    difference, and every call finds its operands in device memory, not in
    L2.  (torch.profiler loses its records after some tens of traces in one
    process.)"""
    fn()

    def run(call: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            for _ in range(FLUSHES):
                flush.zero_()
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    readings = sorted((run(True) - run(False)) / iters for _ in range(READINGS))
    return Seconds(readings[READINGS // 2], FLUSHED)


def int8_gemm_feedback(m: int, k: int):
    """Feedback for GEMM-shaped fns: fold the f32/int32 (M, N) output back
    into an int8 (M, K) input, ``(out[:, :k] as int32) & 0x7F`` (one cheap
    elementwise pass per call: give the baseline the same feedback)."""

    def fb(out, x):
        del x
        src = out[:, :k] if out.shape[1] >= k else torch.nn.functional.pad(
            out, (0, k - out.shape[1]))
        return (src.to(torch.int32) & 0x7F).to(torch.int8)

    return fb


def gemm_tops(fn: Callable, args, m: int, n: int, k: int,
              peak_tops: Optional[float] = None, **kw) -> Tuple[Seconds, float]:
    """(seconds, TOP/s) for a GEMM-shaped ``fn(*args)``; ``peak_tops`` (the
    card's int8 peak in TOP/s) sets ``min_dt``, so that no result claims
    more operations a second than the card has."""
    kw.setdefault("feedback", int8_gemm_feedback(m, k))
    if peak_tops:
        kw.setdefault("min_dt", 2.0 * m * n * k / (peak_tops * 1e12))
    dt = device_time(fn, *args, **kw)
    return dt, 2.0 * m * n * k / dt / 1e12

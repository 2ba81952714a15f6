"""Timing utilities and the port's spans.

Counterpart of ``various_image_processings_tpu/utils/profiling.py`` and of
the reference's ``MEASURE`` macro (sample/benchmark/main.cpp:20-33): N+1
calls, the first thrown away, the mean of fenced wall-clock msec; MP/s; the
chain-slope method; and ``torch.profiler`` traces.  ``cuda_time_ms`` times
the device alone with CUDA events.  ``SPANS`` records the port's spans at
its layer boundaries: ``ops.<entry>`` (a public entry's whole call),
``ops.validate`` and ``ops.tables`` inside it, ``cuda_wrappers.<kernel>``
(a kernel wrapper; ``btf``: a whole BTF call's kernels) and
``enqueue.<kernel>`` (its ctypes call) inside that, and SLIC's host pieces
``models.slic.download``, ``models.slic.connectivity`` and
``models.slic.upload``.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from time import perf_counter_ns
from typing import NamedTuple

import torch


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)


def fence(out) -> None:
    """Wait until the work that produced ``out`` is done: synchronize the
    CUDA device of every tensor leaf of a nested dict/list/tuple.  CPU
    tensors are computed when they are returned: nothing to wait for."""
    for device in {t.device for t in _leaves(out) if t.is_cuda}:
        torch.cuda.synchronize(device)


def measure(fn, iters: int = 50) -> float:
    """Mean msec per call over ``iters`` calls, a first (warm-up) call
    discarded.  Each call is fenced, so the time includes the host's launch
    work and one synchronization: what a caller waiting for the result sees."""
    fence(fn())
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fence(fn())
        total += time.perf_counter() - t0
    return total / iters * 1e3


def measure_chained(step, init, iters: int = 30, repeats: int = 3) -> float:
    """Per-step msec by the chain-slope method: time data-dependent chains
    of two lengths (each fenced once) and take the slope, so the fixed cost
    of the fence cancels in the difference.  Each length is timed
    ``repeats`` times and the minimum kept."""
    def chain(n):
        out = init
        for _ in range(n):
            out = step(out)
        fence(out)

    def best_of(n):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            chain(n)
            best = min(best, time.perf_counter() - t0)
        return best

    chain(2)  # warm-up
    n1 = max(2, iters // 8)
    t_short = best_of(n1)
    t_long = best_of(iters)
    return (t_long - t_short) / (iters - n1) * 1e3


def measure_throughput(fn, pixels: int, iters: int = 50):
    """(mean msec, MP/s), fenced per call."""
    ms = measure(fn, iters)
    return ms, pixels / ms / 1e3


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` context that writes a Chrome trace
    (``trace.json``) into ``log_dir`` (default: ``vip_torch_trace`` under
    the temporary directory), with the CUDA activity when a card is present.
    Yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vip_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` calls, after
    ``warmup`` untimed calls.  Events are recorded on the current stream
    around each call, so the time is the device's, not the host's enqueue
    time.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for start, end in zip(starts, ends):
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


class Drained(NamedTuple):
    """The spans a recorder held, in the order they opened: parallel lists
    of names, starts and ends (``time.perf_counter_ns``; an end of 0: never
    closed), parents (an index into these lists, -1 for none) and call ids;
    and the spans dropped because the lists were full."""
    names: list
    starts: list
    ends: list
    parents: list
    calls: list
    dropped: int


class SpanRecorder:
    """Spans in memory, off until ``start``.

    A span is a name, a start and an end on ``time.perf_counter_ns``, the
    span that was open when it opened (its parent) and the call it belongs
    to: a span that opens with none open starts a new call, and every span
    opened inside it shares that call's id.  The spans sit in preallocated
    parallel lists; one that finds them full is dropped and counted.  A
    boundary reads ``on`` and, when it is off, does nothing more::

        s = SPANS.open("ops.validate") if SPANS.on else -1
        ...
        if s >= 0:
            SPANS.close(s)

    Closing a span makes its parent the open one again, so a span left open
    by an exception is closed over by its parent's close."""

    __slots__ = ("on", "capacity", "n", "dropped", "top", "next_call",
                 "names", "starts", "ends", "parents")

    def __init__(self):
        self.on = False
        self.capacity = self.n = self.dropped = self.next_call = 0
        self.top = -1
        self.names, self.starts, self.ends, self.parents = [], [], [], []

    def start(self, capacity: int = 1 << 20) -> None:
        """Empty the recorder, make room for ``capacity`` spans and turn it on."""
        if capacity != self.capacity:
            self.capacity = capacity
            self.names, self.parents = [None] * capacity, [0] * capacity
            self.starts, self.ends = [0] * capacity, [0] * capacity
        self._empty()
        self.on = True

    def stop(self) -> None:
        self.on = False

    def drain(self) -> Drained:
        """The spans recorded since ``start`` or the last drain, and the
        count dropped; the recorder keeps its room and its state, on or off.
        Call ids count on from one drain to the next."""
        n = self.n
        parents = self.parents[:n]
        calls = [0] * n
        for i, parent in enumerate(parents):
            if parent < 0:
                calls[i] = self.next_call
                self.next_call += 1
            else:
                calls[i] = calls[parent]
        out = Drained(self.names[:n], self.starts[:n], self.ends[:n], parents, calls,
                      self.dropped)
        self._empty()
        return out

    def _empty(self) -> None:
        self.ends[:self.n] = [0] * self.n  # a span never closed reads an end of 0
        self.n = self.dropped = 0
        self.top = -1

    def open(self, name: str) -> int:
        """Open a span; its index, for ``close``, or -1 if it was dropped."""
        i = self.n
        if i >= self.capacity:
            self.dropped += 1
            return -1
        self.n = i + 1
        self.names[i] = name
        self.parents[i] = self.top
        self.top = i
        self.starts[i] = perf_counter_ns()
        return i

    def close(self, i: int) -> None:
        self.ends[i] = perf_counter_ns()
        self.top = self.parents[i]


SPANS = SpanRecorder()  # the port's one recorder

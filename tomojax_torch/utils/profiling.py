"""Profiling and timing (counterpart of ``tomojax.utils.profiling``).

- :func:`trace` records a ``torch.profiler`` trace (CPU, and the card's
  kernels where CUDA is available) and writes it as a Chrome trace
  (``chrome://tracing`` or Perfetto).
- :func:`timed` times calls on the host clock, synchronizing the card after
  each call (tomojax's ``block_until_ready``).
- :func:`event_timed` and :func:`cuda_ms` time device work with CUDA
  events.
- :class:`IterationTimer` accumulates per-iteration wall times.
- :func:`kernel_times` reads a finished trace: device time per kernel name.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def synchronize():
    """Wait for the card's queued work; a no-op where CUDA was never
    initialized (no device work can be pending)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace('/tmp/trace') as prof: step()``.

    Yields the ``torch.profiler.profile``; on exit writes
    ``log_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_times(prof) -> dict:
    """Device microseconds per kernel name in a finished :func:`trace`,
    largest first (empty where the trace holds no device time)."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def timed(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Synchronized timing: ``(last result, seconds per call)`` over
    ``reps`` calls after ``warmup`` calls; the card is synchronized after
    every call, so its work is counted."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
        synchronize()
    return out, (time.perf_counter() - t0) / max(reps, 1)


def event_timed(fn, reps: int = 1):
    """``(last output, mean ms)`` of ``reps`` runs of ``fn`` between two
    CUDA events (no warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs, after one
    warm-up run (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    return event_timed(fn, reps)[1]


class IterationTimer:
    """Accumulates per-iteration wall times for host-side loops."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def total(self):
        return sum(self.times)

    @property
    def mean(self):
        return self.total / max(len(self.times), 1)

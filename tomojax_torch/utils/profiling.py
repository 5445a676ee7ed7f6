"""Profiling and timing (counterpart of ``tomojax.utils.profiling``).

- :func:`trace` records a ``torch.profiler`` trace (CPU, and the card's
  kernels where CUDA is available) and writes it as a Chrome trace
  (``chrome://tracing`` or Perfetto).
- :func:`timed` times calls on the host clock, synchronizing the card after
  each call (tomojax's ``block_until_ready``).
- :func:`event_timed` and :func:`cuda_ms` time device work with CUDA
  events.
- :func:`kernel_times` reads a finished trace: device time per kernel name.
- :func:`span` and :func:`count`: the program's own spans and counters at
  its layer boundaries (CC chain, solver, operator, kernel launch,
  alignment driver, LM), recorded while a ``torch.profiler`` records or
  inside :func:`tracing`, and read back with :func:`records`.

The recorder is one per process, for the thread that runs the program. A
span holds its name, its start and end on the host clock
(``time.perf_counter``) and the index of its enclosing span, so a layer's
self time is its duration less its children's (:func:`child_seconds`).
While the profiler records, each span is also a ``record_function``: it
shows on the trace's host timeline, the clock the device's kernels are
on. A span given a CUDA ``device`` also records a CUDA event at each end,
on that device's current stream, and :func:`records` gives the device
seconds between them (``device_s``; None on the CPU). With the switch
off, :func:`span` returns a shared no-op and :func:`count` returns at
once: neither allocates, calls into torch or reads a clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


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
    largest first (empty where the trace holds no device time). The spans'
    own device ranges (user annotations over the kernels they launched)
    are left out: they would count those kernels again."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not getattr(e, "is_user_annotation", False)):
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


class Span(NamedTuple):
    """One recorded span: host seconds on ``time.perf_counter``'s clock,
    the index of the enclosing span in :func:`records` (-1: none) and, for
    a span on a CUDA device, the device seconds between its two events
    (None otherwise)."""

    name: str
    t0: float
    t1: float
    parent: int
    device_s: float | None = None


_tracing = 0    # depth of open tracing() blocks
_spans = []     # [name, t0, t1, parent, device] per span, in order of
#                 entry; device: None, the two CUDA events, or their seconds
_open = []      # indices of the spans entered and not yet left
_counters = {}


class _Off:
    """The span of a switched-off recorder: enters and leaves, records
    nothing. Its enter and exit are builtins, not methods, so a ``with``
    on it binds no method and runs no Python frame: enter returns None,
    exit returns ``""`` (false: an exception goes on)."""

    __slots__ = ()
    __enter__ = type(None)
    __exit__ = "".format


_OFF = _Off()


class _On:
    """A recording span: appended to the records on entry, its end written
    on exit; on a CUDA ``device``, a timing event recorded at each end."""

    __slots__ = ("name", "device", "i", "rf")

    def __init__(self, name, device):
        self.name = name
        self.device = device

    def __enter__(self):
        i = self.i = len(_spans)
        events = None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        _spans.append([self.name, 0.0, 0.0, _open[-1] if _open else -1,
                       events])
        _open.append(i)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if events is not None:
            events[0].record(torch.cuda.current_stream(self.device))
        _spans[i][1] = time.perf_counter()
        return i

    def __exit__(self, *exc):
        t = time.perf_counter()
        events = _spans[self.i][4]
        if events is not None:
            events[1].record(torch.cuda.current_stream(self.device))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _spans[self.i][2] = t
        _open.pop()
        return False


def span(name: str, device=None):
    """``with span("cc.view"):`` records the block as a span (and as a
    ``record_function`` while the profiler records); ``as i`` gives its
    index in :func:`records`, None with the switch off. With a CUDA
    ``device`` (a ``torch.device``) the span also times the device's work
    inside it (:attr:`Span.device_s`)."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _On(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (``host_sync.<layer>.<site>``
    where the host waits on the card), under the same switch as
    :func:`span`."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        return
    _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def tracing():
    """Record spans and counters inside the block without a profiler."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


def records():
    """``(spans, counters)`` recorded since the last :func:`reset`: a list
    of :class:`Span` in order of entry (a span still open has ``t1`` 0)
    and a dict of counts. A closed span's device seconds are read here
    once, after the device has reached its end."""
    for s in _spans:
        if isinstance(s[4], tuple) and s[2] > 0.0:
            start, end = s[4]
            end.synchronize()
            s[4] = 1e-3 * start.elapsed_time(end)
    return ([Span(name, t0, t1, parent,
                  dev if isinstance(dev, float) else None)
             for name, t0, t1, parent, dev in _spans], dict(_counters))


def reset() -> None:
    """Forget what was recorded; not inside an open span, whose end has
    yet to be written."""
    if _open:
        raise RuntimeError("profiling.reset() inside an open span")
    _spans.clear()
    _counters.clear()


def host_syncs(counters) -> int:
    """The sum of the ``host_sync.*`` counters of :func:`records`."""
    return sum(n for name, n in counters.items()
               if name.startswith("host_sync."))


def inner_seconds(spans, i: int) -> dict:
    """Seconds per name of the spans inside span ``i`` (at any depth)."""
    out = {}
    for s in spans[i + 1:]:
        if s.t0 > spans[i].t1:
            break
        out[s.name] = out.get(s.name, 0.0) + s.t1 - s.t0
    return out


def child_seconds(spans, i: int) -> dict:
    """Seconds per name of the direct children of span ``i``."""
    out = {}
    for s in spans:
        if s.parent == i:
            out[s.name] = out.get(s.name, 0.0) + s.t1 - s.t0
    return out

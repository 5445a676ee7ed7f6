"""The traced part of a window: ``torch.profiler`` over a few steps,
reduced to the device's busy time, the device operations that took most
time and the idle gaps by what the host was doing.

The trace goes to a temporary file (under ``TMPDIR``) and is deleted once
read: only its reduction is kept.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160


class Profile:
    """``start()`` a profiler and a host span named ``TRACE_WINDOW``;
    ``stop()`` ends both once the device is done and returns
    :func:`reduce`'s dict."""

    def __init__(self, device):
        self.device = device

    def start(self):
        import torch
        from benchmark.harness import TRACE_WINDOW, synchronize

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(TRACE_WINDOW)
        self.span.__enter__()

    def stop(self) -> dict:
        from benchmark.harness import TRACE_WINDOW, synchronize

        synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return reduce(events, TRACE_WINDOW)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top(totals: dict) -> list:
    return [[name[:NAME_CHARS], sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce(events: list, window_name: str) -> dict:
    """Reduce Chrome-trace events (µs) to ``busy_s`` (the union of device
    operations inside the window span), ``window_s`` (the span's length),
    ``device_ops`` (seconds per device operation name, largest first) and
    ``idle_gaps`` (seconds of device idleness per name of the innermost
    host operation running at each gap's middle)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("name") == window_name
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {window_name!r} span")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, ops = [], {}
    for e in xs:
        if str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            dev.append((a, b))
            ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
    merged = _merge(dev)
    busy = sum(b - a for a, b in merged)
    # host operations of the window's thread, each with its innermost
    # enclosing operation (they nest on one thread)
    tid = spans[0].get("tid")
    host = sorted((e for e in xs if e.get("cat") in HOST_CATS
                   and e.get("tid") == tid and e is not spans[0]),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    starts = [float(e["ts"]) for e in host]
    ends = [float(e["ts"]) + float(e["dur"]) for e in host]
    parent, stack = [], []
    for i, t in enumerate(starts):
        while stack and ends[stack[-1]] < t:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid) - 1
        while j >= 0 and ends[j] < mid:
            j = parent[j]
        name = host[j]["name"] if j >= 0 else "host outside any operation"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": _top(ops), "idle_gaps": _top(gaps)}

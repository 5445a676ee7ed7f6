"""The general harness: a cell found by name, its measured window, the
traced part of the window, the metric readers and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``) and a
traffic mix (``benchmark/traffic/<mix>.json``). The mix's ``kind`` names
the driver (``benchmark/drivers/<kind>.py``), which makes the inputs from
the seed, builds and warms up the program, runs one unit of work per
``step()`` and, once the window has closed, judges what the window
produced against the plain reference (``check()``). Every metric has a
reader ``benchmark/metrics/<name>.py`` whose ``read(run)`` returns a
number, or None where the run holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
# top-level module names that may not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "tomojax")
TRACE_WINDOW = "benchmark.traced"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, mix and
    metrics resolved."""

    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Run:
    """What a reader sees: the cell, the window's steps (host seconds from
    the window's start, with the driver's counts, and ``pause_s``: the
    profiler's start before the step, or its stop and the trace's
    reduction after it), the driver's own readings (``extra``) and the
    reduced trace of a traced run."""

    cell: Cell
    setup_s: float
    window_s: float
    steps: list
    extra: dict
    trace: dict | None
    device_kind: str

    def total(self, key: str) -> float:
        return float(sum(s.get(key, 0) for s in self.steps))


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, prefix: str):
    """Import the file ``path`` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = f"_bench_{prefix}_{re.sub(r'[^0-9A-Za-z_]', '_', path.stem)}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve_cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``spec`` with its files read."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                mix=mix,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _applies(m, workload)])


def driver_of(cell: Cell, root: Path = ROOT):
    return load_module(root / "benchmark" / "drivers"
                       / f"{cell.mix['kind']}.py", "driver")


def reader_of(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       "metric")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``tomojax_torch`` is not ``tomojax``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Phases:
    """Set-up phases timed on the host clock (the device synchronized at
    each mark), printed to standard error as they end."""

    def __init__(self, device):
        self.device = device
        synchronize(device)
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        synchronize(self.device)
        t = time.perf_counter()
        print(f"setup {name}: {t - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = t


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forget_peak(device) -> None:
    """Start the memory peak afresh once the benchmark's own data maker is
    freed: a deployment loads its data, and the peak is the program's."""
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _paused(fn, device):
    """``(fn(), host seconds)`` of the profiler's start, or of its stop
    and the trace's reduction, with the device done before and after: the
    program's time excludes them."""
    synchronize(device)
    t = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t


def run_window(job, seconds: float, device, trace_steps=None):
    """Step ``job`` until ``seconds`` have passed and the job holds what
    its check needs; the window closes at the first step boundary after
    that, once the device is done. With ``trace_steps = (first, count)``
    the profiler records those steps (the window runs on until they are
    done).

    :returns: ``(t0, window_s, steps, trace)``: the window's start on the
        host clock, its length, per step its host times from the start and
        the driver's counts, and the reduced trace (None untraced)."""
    from benchmark import trace as tr

    synchronize(device)
    t0 = time.perf_counter()
    steps, prof, reduced = [], None, None
    first, count = trace_steps or (None, 0)
    i, pause = 0, 0.0
    while True:
        if i == first:
            prof = tr.Profile(device)
            pause = _paused(prof.start, device)[1]
        s0 = time.perf_counter()
        counts = job.step()
        s1 = time.perf_counter()
        steps.append(dict(counts, t0=s0 - t0, t1=s1 - t0, pause_s=pause))
        i += 1
        pause = 0.0
        if prof is not None and i == first + count:
            reduced, p = _paused(prof.stop, device)
            steps[-1]["pause_s"] += p
            prof = None
        traced = trace_steps is None or reduced is not None
        if s1 - t0 >= seconds and traced and job.ready():
            break
    synchronize(device)
    return t0, time.perf_counter() - t0, steps, reduced


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_proc: float, variant: str | None = None,
             root: Path = ROOT) -> dict:
    """Run ``cell`` once: set-up, the window, the readers and the check.
    ``t_proc`` is the process's start on the host clock; ``variant``
    (None for every benchmark run) selects a driver's control."""
    import torch

    driver = driver_of(cell, root)
    synchronize(device)
    print(f"setup process start to the driver: "
          f"{time.perf_counter() - t_proc:.3f} s", file=sys.stderr)
    job = driver.setup(cell, seed, device, trace=trace, variant=variant)
    steps_traced = tuple(cell.mix["trace_steps"]) if trace else None
    t0, window_s, steps, reduced = run_window(job, seconds, device,
                                              steps_traced)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    run = Run(cell=cell, setup_s=t0 - t_proc, window_s=window_s,
              steps=steps, extra=job.readings(), trace=reduced,
              device_kind=kind)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader_of(m["name"], root).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = job.check()
    correct = bool(checks) and all(math.isfinite(v) and v <= lim
                                   for _, v, lim in checks)
    out = {"correct": correct, "attempted": len(steps),
           "failed": 0 if correct else 1, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda"
                      else device.type, "kind": kind,
                      "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    # a number that is not finite is written as text: JSON has no NaN
    out["checks"] = {name: {"value": v if math.isfinite(v) else str(v),
                            "limit": lim} for name, v, lim in checks}
    return out


def print_result(result: dict) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line of standard
    output."""
    for name, c in result["checks"].items():
        ok = ("ok" if isinstance(c["value"], float)
              and c["value"] <= c["limit"] else "FAIL")
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

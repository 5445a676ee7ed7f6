"""Device seconds of named kernels in a traced run's ``device_ops`` (the
trace's largest device operations), and a kernel's roofline share over
the applies that the traced steps counted."""

from __future__ import annotations

import re

from benchmark import roofline


def kernel_seconds(run, patterns) -> float | None:
    """The device seconds of the operations whose names match any of the
    regular expressions ``patterns``; None where the run holds no trace or
    none of them is among its largest operations."""
    tr = run.trace
    if not tr or tr["busy_s"] <= 0:
        return None
    hits = [sec for name, sec in tr["device_ops"]
            if any(re.search(p, name) for p in patterns)]
    return sum(hits) if hits else None


def traced_total(run, key: str) -> float:
    """The driver's count ``key`` summed over the traced steps."""
    first, count = run.cell.mix["trace_steps"]
    return float(sum(s.get(key, 0) for s in run.steps[first:first + count]))


def share_pct(run, work: dict, applies: float, seconds) -> float | None:
    """``100 · applies · bound(work) / seconds``, or None."""
    if not seconds or applies <= 0:
        return None
    bound = roofline.bound_ms(work, run.device_kind)
    if bound is None:
        return None
    return 100.0 * applies * bound * 1e-3 / seconds

"""Helpers the metric readers share: a roofline share from the CUDA-event
times of a driver's applies, and the device's idle share from the trace."""

from __future__ import annotations

from benchmark import roofline


def apply_roofline_pct(run, key: str, quad: str):
    """The share of the roofline of one slab apply over all views, from
    the mean of the driver's event times ``run.extra[key]`` (ms)."""
    ms = run.extra.get(key) or []
    if not ms:
        return None
    cfg = run.cell.config
    work = roofline.slab_apply(cfg["vox_shape"], cfg["det_shape"],
                               run.extra["views"], quad)
    return roofline.share_pct(work, run.device_kind, sum(ms) / len(ms))


def idle_pct(run):
    """100 · (1 − busy / window) over the traced steps; None without a
    trace or without device time in it."""
    tr = run.trace
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

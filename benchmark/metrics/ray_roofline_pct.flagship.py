"""The exact ray projector's forward and adjoint applies as a share of
their roofline over the traced outer: the applies (the views of the
program's ``ray.A`` and ``ray.AT`` spans, from their ``.views`` counters,
over the configuration's views: SIRT's, the LM's costs and the moment
hook's reprojection) times one apply's bound (``roofline_ray``), over the
device seconds of those spans (CUDA events at their two ends). The same
work is counted whatever implements the apply."""

from benchmark import roofline
from benchmark.program_records import recorded
from benchmark.roofline_ray import ray_apply

SPANS = ("ray.A", "ray.AT")


def read(run):
    rec = recorded(run)
    if rec is None:
        return None
    spans, counters = rec
    views = sum(counters.get(f"{name}.views", 0) for name in SPANS)
    secs = [getattr(s, "device_s", None) for s in spans if s.name in SPANS]
    if not views or not secs or None in secs:
        return None
    cfg = run.cell.config
    bound = roofline.bound_ms(ray_apply(cfg["vox_shape"], cfg["det_shape"],
                                        cfg["n_proj"]), run.device_kind)
    if bound is None:
        return None
    return 100.0 * views / cfg["n_proj"] * bound * 1e-3 / sum(secs)

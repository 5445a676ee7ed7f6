"""The exact ray family's fused projection and Jacobian applies as a
share of their roofline over the traced outer: the applies (the views of
the program's ``ray.jac`` spans, from its ``ray.jac.views`` counter, over
the configuration's views: the exact LM's steps) times one apply's bound
(``roofline_ray_jac``), over the device seconds of those spans (CUDA
events at their two ends). The same work is counted whatever implements
the apply."""

from benchmark import roofline
from benchmark.program_records import recorded
from benchmark.roofline_ray_jac import ray_jac_apply

SPAN = "ray.jac"


def read(run):
    rec = recorded(run)
    if rec is None:
        return None
    spans, counters = rec
    views = counters.get(f"{SPAN}.views", 0)
    secs = [getattr(s, "device_s", None) for s in spans if s.name == SPAN]
    if not views or not secs or None in secs:
        return None
    cfg = run.cell.config
    bound = roofline.bound_ms(ray_jac_apply(cfg["vox_shape"],
                                            cfg["det_shape"], cfg["n_proj"]),
                              run.device_kind)
    if bound is None:
        return None
    return 100.0 * views / cfg["n_proj"] * bound * 1e-3 / sum(secs)

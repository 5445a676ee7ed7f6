"""The fused arc Jacobian (K5, ``arc_march_kernel<true>``) as a share of
its roofline over the traced job: the applies (one per LM step over all
views, K5's launches over the orientation groups) times one apply's bound
(``roofline_jac``), over K5's device seconds."""

from benchmark.roofline_jac import slab_jac
from benchmark.trace_kernels import kernel_seconds, share_pct, traced_total

K5 = (r"\barc_march_kernel<true>",)


def read(run):
    cfg = run.cell.config
    work = slab_jac(cfg["vox_shape"], cfg["det_shape"], run.extra["views"])
    applies = traced_total(run, "k5_launches") / run.extra["groups"]
    return share_pct(run, work, applies, kernel_seconds(run, K5))

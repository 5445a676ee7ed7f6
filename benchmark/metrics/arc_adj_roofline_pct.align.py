"""The arc adjoint (K4, ``arc_adj_kernel`` and the ``add_kernel`` that
sums its two sides) as a share of the arc apply's roofline over the
traced job: the applies (the solver's Aᵀ over all views, K4's launches
over the orientation groups) times one apply's bound, over K4's device
seconds."""

from benchmark import roofline
from benchmark.trace_kernels import kernel_seconds, share_pct, traced_total

K4 = (r"\barc_adj_kernel\(", r"\badd_kernel\(")


def read(run):
    cfg = run.cell.config
    work = roofline.slab_apply(cfg["vox_shape"], cfg["det_shape"],
                               run.extra["views"], "arc")
    applies = traced_total(run, "k4_launches") / run.extra["groups"]
    return share_pct(run, work, applies, kernel_seconds(run, K4))

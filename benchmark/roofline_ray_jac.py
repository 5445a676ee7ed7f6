"""The yardstick of the exact ray family's fused projection and 6-DoF
Jacobian: the operations and bytes that one apply over all views needs,
whatever implements it.

An apply marches the samples of :func:`benchmark.roofline_ray.ray_apply`
and takes four multiply-adds a corner: one for the value and one for each
of the three components of the weight's gradient, ``4 ×`` the forward's
operations. The weight gradient's own products and the step weighting
are left out, so the count is a floor. Bytes: the volume read once, seven
float32 outputs written for each detector pixel of every view (the value
and the six Jacobian fields), and six float32 parameters per view. At 64³
× 90 views of 64² (128 steps) its bound is 45.07 µs, by the operations.
"""

from __future__ import annotations

from benchmark import roofline
from benchmark.roofline_ray import ray_apply

MACS_PER_CORNER = 4
OUTPUTS = 7


def ray_jac_apply(vox_shape, det_shape, n_views: int,
                  step: float = 1.0) -> dict:
    """Operations and bytes of one fused projection and Jacobian apply
    over ``n_views`` views."""
    nx, ny, nz = vox_shape
    nu, nv = det_shape
    flops = MACS_PER_CORNER * ray_apply(vox_shape, det_shape, n_views,
                                        step)["flops"]
    nbytes = 4.0 * (nx * ny * nz + OUTPUTS * n_views * nu * nv) \
        + roofline.VIEW_PARAM_BYTES * n_views
    return {"flops": flops, "bytes": nbytes}

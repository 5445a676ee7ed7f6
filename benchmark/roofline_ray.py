"""The yardstick of the exact ray projector: the operations and bytes that
one forward or adjoint apply over all views needs, whatever implements it.

An apply marches ``n_steps = int(2·ny / step)`` samples along each ray of
every view (``n_views · n_det · n_steps`` samples) and interpolates each
from its 8 trilinear corners, one multiply-add a corner: ``2 · 8 · n_views
· n_det · n_steps`` operations. Bytes as :func:`benchmark.roofline.
slab_apply`'s: the volume, the sinogram and six float32 parameters per
view, each read or written once. At 64³ × 90 views of 64² (128 steps) its
bound is 11.268 µs, by the operations.
"""

from __future__ import annotations

from benchmark import roofline

TAPS = 8


def ray_apply(vox_shape, det_shape, n_views: int, step: float = 1.0) -> dict:
    """Operations and bytes of one forward or adjoint ray apply over
    ``n_views`` views."""
    nx, ny, nz = vox_shape
    nu, nv = det_shape
    n_steps = int(2.0 * ny / step)
    flops = 2.0 * TAPS * n_views * nu * nv * n_steps
    nbytes = 4.0 * (nx * ny * nz + n_views * nu * nv) \
        + roofline.VIEW_PARAM_BYTES * n_views
    return {"flops": flops, "bytes": nbytes}

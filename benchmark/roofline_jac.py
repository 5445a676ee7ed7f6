"""The yardstick of the fused arc Jacobian (K5): the operations and bytes
that one Jacobian apply over all views needs, whatever implements it.

The apply marches the arc samples once and reads 12 fields of them: the
forward value and 11 derivative building blocks (tomojax's
``slab_project_jac``), each a blend of 8 taps per sample with a
multiply-add each, so ``12 ×`` the operations of one arc apply
(:func:`benchmark.roofline.slab_apply`). Bytes: the volume and each view's
six float32 parameters read once and the 12 fields of every detector pixel
written once. At 256³ × 90 views of 256² its bound is 4.327 ms, by the
operations.
"""

from __future__ import annotations

from benchmark import roofline

FIELDS = 12


def slab_jac(vox_shape, det_shape, n_views: int) -> dict:
    """Operations and bytes of one Jacobian apply over ``n_views``
    views."""
    nx, ny, nz = vox_shape
    nu, nv = det_shape
    arc = roofline.slab_apply(vox_shape, det_shape, n_views, "arc")
    return {"flops": FIELDS * arc["flops"],
            "bytes": 4.0 * (nx * ny * nz + FIELDS * n_views * nu * nv)
            + roofline.VIEW_PARAM_BYTES * n_views}

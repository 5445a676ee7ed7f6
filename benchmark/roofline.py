"""The yardstick of the slab operators: the operations and bytes one apply
needs, whatever implements it, and the published peaks of the card.

One apply over ``V`` views of an ``n_det``-pixel detector marches
``n_march`` slabs per ray and interpolates each sample from ``taps``
voxels (plane quadrature: the 2 × 2 lerp, 4 taps; arc: the blend of two
slab lerps, 8 taps), one multiply-add each: ``2 · taps · V · n_det ·
n_march`` operations. Bytes: each input read once and each output written
once (the volume, the sinogram and six float32 parameters per view).

A share of the roofline is the least time these need at the card's peaks
(the larger of operations over the float32 rate and bytes over the HBM
rate) over the measured time, in %. A card missing from :data:`PEAKS` has
no roofline: the readers then report nothing.
"""

from __future__ import annotations

TAPS = {"plane": 4, "arc": 8}
VIEW_PARAM_BYTES = 6 * 4
# published dense peaks (NVIDIA H100 SXM data sheet, 700 W): float32
# outside the tensor cores, and HBM3 bandwidth
PEAKS = {"NVIDIA H100 80GB HBM3": {"flops": 67e12, "bytes_per_s": 3.35e12}}


def slab_apply(vox_shape, det_shape, n_views: int, quad: str) -> dict:
    """Operations and bytes of one forward or adjoint slab apply."""
    nx, ny, nz = vox_shape
    nu, nv = det_shape
    n_det = nu * nv
    flops = 2.0 * TAPS[quad] * n_views * n_det * ny
    nbytes = 4.0 * (nx * ny * nz + n_views * n_det) \
        + VIEW_PARAM_BYTES * n_views
    return {"flops": flops, "bytes": nbytes}


def bound_ms(work: dict, kind: str) -> float | None:
    """Least milliseconds for ``work`` on a card of ``kind`` (None for a
    card without published peaks here)."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return 1e3 * max(work["flops"] / peak["flops"],
                     work["bytes"] / peak["bytes_per_s"])


def share_pct(work: dict, kind: str, measured_ms: float) -> float | None:
    """``100 · bound / measured``, or None without peaks or a time."""
    b = bound_ms(work, kind)
    if b is None or not measured_ms or measured_ms <= 0:
        return None
    return 100.0 * b / measured_ms

"""Roofline model of the slab kernels K1-K5 (counterpart of
``tomojax.utils.roofline``).

tomojax counts its Pallas dataflow: MXU passes of one-hot selection
matmuls and VMEM re-streams, which mean nothing on Hopper. Here a kernel's
bound is the least time the card could take for the same work, whatever
implements it: the larger of

- the bytes the function must move (each oriented volume, the scalars and
  the detector images, each read or written once) over the HBM rate, and
- the operations it must do (a multiply-add per tap of each sample, one
  sample per slab per ray, for each field) over the fp32 rate.

Peaks come from the device kind (``torch.cuda.get_device_name``): the
table holds the NVIDIA H100 SXM's published figures (3.35 TB/s HBM, 67
TFLOP/s fp32 outside the tensor cores), the card this model is measured
on, and any other kind takes them too. ``TOMOJAX_PEAK_FLOPS`` /
``TOMOJAX_PEAK_BW`` (units: FLOP/s, B/s) override them.

The signatures are tomojax's; ``prec`` is checked by
:func:`~tomojax_torch.kernels.slab.resolve_prec`. Both tiers compute the
same function through the same fp32 interface (the bf16 tier rounds what
its kernels stage, not what they read or write, and does the same taps),
so the model and the bound of ``"bf16"`` equal those of ``"f32x2"``: the
bound is what any implementation needs, not what a bf16 kernel happens to
stage.
"""

from __future__ import annotations

import os

from tomojax_torch.core.geometry import Geometry
from tomojax_torch.core.slab_projector import NS
from tomojax_torch.kernels.slab import resolve_prec

H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
# (fp32 FLOP/s, HBM bytes/s) per device kind, lower case
_PEAKS = {"h100 80gb hbm3": (H100_F32_FLOPS, H100_HBM_BYTES_PER_S)}
# taps per sample: the plane lerp reads 2 x 2, the arc blend 2 x (2 x 2)
TAPS = {"plane": 4, "arc": 8}


def device_peaks(device_kind: str | None = None):
    """``(fp32 FLOP/s, HBM bytes/s)``: the environment's overrides, else
    the peaks of ``device_kind`` in the table, else the H100 SXM's."""
    env_f = os.environ.get("TOMOJAX_PEAK_FLOPS")
    env_b = os.environ.get("TOMOJAX_PEAK_BW")
    if env_f and env_b:
        return float(env_f), float(env_b)
    kind = (device_kind or "").lower()
    for key, peaks in _PEAKS.items():
        if key in kind:
            return peaks
    return _PEAKS["h100 80gb hbm3"]


def bound(nbytes: float, flops: float, device_kind: str | None = None):
    """``(ms, "bytes" or "operations")``: the least time for moving
    ``nbytes`` and doing ``flops`` at the peaks of ``device_kind``."""
    peak_f, peak_b = device_peaks(device_kind)
    tb = nbytes / peak_b * 1e3
    tf = flops / peak_f * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def slab_apply_model(geom: Geometry, quad: str, prec: str = "f32x2",
                     n_views: int | None = None, fields: int = 1,
                     n_groups: int = 1) -> dict:
    """Bytes and operations of one slab kernel apply (K1-K4, or K5 with
    ``fields=12``) over ``n_views`` views (default ``geom.n_proj``) in
    ``n_groups`` orientation groups: each group reads its oriented volume
    once; every view reads its scalars and writes (or reads) ``fields``
    detector images."""
    resolve_prec(prec)
    V = geom.n_proj if n_views is None else n_views
    n_det = geom.n_det
    nbytes = 4.0 * (n_groups * geom.n_vox + V * NS + fields * V * n_det)
    flops = 2.0 * TAPS[quad] * fields * V * n_det * geom.vox_shape[1]
    return {"bytes": nbytes, "flops": flops, "views": V, "groups": n_groups,
            "fields": fields}


def slab_bound(geom: Geometry, quad: str, prec: str = "f32x2",
               n_views: int | None = None, fields: int = 1,
               n_groups: int = 1):
    """:func:`bound` of :func:`slab_apply_model`."""
    m = slab_apply_model(geom, quad, prec, n_views, fields, n_groups)
    return bound(m["bytes"], m["flops"])


def roofline(geom: Geometry, quad: str, prec: str, t_fwd_s: float,
             t_adj_s: float, n_views: int | None = None,
             device_kind: str | None = None, n_groups: int = 1) -> dict:
    """Measured forward and adjoint times as shares of their bounds.

    :returns: per direction the bytes, operations, achieved GB/s and
        GFLOP/s, their shares of the peaks, the bound's time and what
        bounds it, and ``pct_sol`` = bound time / measured time."""
    peak_f, peak_b = device_peaks(device_kind)
    m = slab_apply_model(geom, quad, prec, n_views, 1, n_groups)
    out = {"model": m, "peaks": {"flops": peak_f, "bytes": peak_b}}
    for d, t in (("fwd", t_fwd_s), ("adj", t_adj_s)):
        sol_ms, by = bound(m["bytes"], m["flops"], device_kind)
        out[d] = {"time_s": t, "gbytes_per_s": m["bytes"] / t / 1e9,
                  "gflops": m["flops"] / t / 1e9,
                  "pct_hbm": m["bytes"] / t / peak_b,
                  "pct_flops": m["flops"] / t / peak_f,
                  "sol_time_s": sol_ms / 1e3, "bound": by,
                  "pct_sol": sol_ms / 1e3 / t}
    return out

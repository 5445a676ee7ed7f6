"""Matrix-free linear-operator layer (counterpart of
``tomojax.core.operators``): solvers program against ``TomoOperator`` and
never see how A is applied.

Ported families:

- ``family="ray"`` (the default, as tomojax's) — the exact ray-driven
  trilinear march (``core.projector``) with its scatter-add transpose; plain
  PyTorch on every device.
- ``family="slab"`` — the slab-marching operator in arc quadrature (the
  exact ray march's samples); on a CUDA device it runs the hand-written
  kernels K3/K4 (K3b/K4b in the bf16 tier, ``prec="bf16"``).
- ``family="slab_plane"`` — one sample per slab plane; on a CUDA device it
  runs K1/K2 (K1b/K2b in the bf16 tier).
- ``family="fast"`` — the multi-pass resampling family
  (``core.fast_projector``); on a CUDA device A runs K7 and Aᵀ K8.
- ``family="voxel"`` — the voxel-driven bilinear splat with its gather
  transpose (``core.voxel_projector``); plain PyTorch on every device.

``voxel_mask`` reproduces the masked system matrix: masked voxels
contribute nothing to A and receive nothing from Aᵀ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import projector as ray
from tomojax_torch.core import slab_projector as slabp
from tomojax_torch.core import voxel_projector as vox
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels.slab import resolve_prec

QUADS = {"slab": "arc", "slab_plane": "plane"}


def resolve_device(device=None) -> torch.device:
    """``torch.device`` of ``device`` (default ``cuda``). Raises when CUDA
    is asked for and absent: the port never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but "
                           "torch.cuda.is_available() is False")
    return device


@dataclasses.dataclass(frozen=True)
class TomoOperator:
    """Matrix-free A: volume → sinogram, with exact adjoint."""

    geom: Geometry
    views: Views
    A: Callable    # vol (vox_shape or flat) -> (n_proj, n_det)
    AT: Callable   # sino (n_proj, n_det) or flat -> vol (vox_shape)
    family: str
    dtype: torch.dtype
    device: torch.device
    prec: str | None = None   # the slab kernels' tier (None: no tier)

    @property
    def vol_shape(self):
        return self.geom.vox_shape

    @property
    def shape(self):
        return (self.geom.n_proj * self.geom.n_det, self.geom.n_vox)

    def row_sums(self):
        """A @ 1 — SIRT's W normalizer."""
        return self.A(torch.ones(self.geom.vox_shape, dtype=self.dtype,
                                 device=self.device))

    def col_sums(self):
        """Aᵀ @ 1 — SIRT's V normalizer."""
        return self.AT(torch.ones((self.geom.n_proj, self.geom.n_det),
                                  dtype=self.dtype, device=self.device))


def make_operator(geom: Geometry, views: Views, *, family: str = "ray",
                  dtype=torch.float32, views_chunk: int | None = None,
                  voxel_mask=None, prec: str | None = None,
                  device=None) -> TomoOperator:
    """Build the projection operator for a set of views on ``device``.

    For the slab families the per-view scalars and orientation groups are
    computed once, here.

    :param views_chunk: views per chunk of the ray and voxel families
        (default: sized as tomojax's). The slab and fast families size
        their own chunks; their results do not depend on it.
    :param voxel_mask: optional boolean volume; False voxels are excluded
        from the system.
    :param prec: the slab families' precision tier
        (:func:`~tomojax_torch.kernels.slab.resolve_prec`: ``"f32x2"`` is
        plain fp32 here, ``"bf16"`` the bulk tier); the other families
        ignore it, as tomojax's.
    """
    prec = resolve_prec(prec)
    if family == "ray":
        return _views_operator(
            geom, views, family, dtype, device, voxel_mask,
            lambda x, vws: ray.project(x, geom, vws, dtype=dtype,
                                       views_chunk=views_chunk),
            lambda y, vws: ray.backproject(y, geom.vox_shape, geom, vws,
                                           dtype=dtype,
                                           views_chunk=views_chunk))
    if family == "voxel":
        return _views_operator(
            geom, views, family, dtype, device, voxel_mask,
            lambda x, vws: vox.project(x, geom, vws, dtype=dtype,
                                       views_chunk=views_chunk),
            lambda y, vws: vox.backproject(y, geom, vws, dtype=dtype,
                                           views_chunk=views_chunk))
    if family == "fast":
        return _views_operator(
            geom, views, family, dtype, device, voxel_mask,
            lambda x, vws: fastp.project(x, geom, vws, dtype=dtype),
            lambda y, vws: fastp.backproject(y, geom, vws, dtype=dtype))
    if family not in QUADS:
        raise ValueError(f"unknown projector family: {family!r}")
    device = resolve_device(device)
    gstruct, scalars = slabp.scalar_groups(geom, views, QUADS[family],
                                           dtype=dtype, device=device)
    return operator_from_scalars(geom, gstruct, scalars, family=family,
                                 dtype=dtype, device=device, views=views,
                                 voxel_mask=voxel_mask, prec=prec)


def _mask(voxel_mask, geom: Geometry, dtype, device):
    if voxel_mask is None:
        return None
    return torch.as_tensor(voxel_mask, device=device).to(dtype).reshape(
        geom.vox_shape)


def _views_on(views: Views, device) -> Views:
    return Views(**{f: getattr(views, f).to(device=device)
                    for f in ("phi", "alpha", "beta", "t", "cor")})


def _views_operator(geom: Geometry, views: Views, family: str, dtype,
                    device, voxel_mask, project, backproject
                    ) -> TomoOperator:
    """The operator of a family applied from the views (ray, voxel, fast):
    ``project(x, views)`` and ``backproject(y, views)``, the views copied
    to the device once."""
    device = resolve_device(device)
    vws = _views_on(views, device)
    mask = _mask(voxel_mask, geom, dtype, device)

    def A(x):
        x = x.reshape(geom.vox_shape).to(dtype)
        if mask is not None:
            x = x * mask
        return project(x, vws)

    def AT(y):
        out = backproject(y.reshape(geom.n_proj, geom.n_det), vws)
        return out * mask if mask is not None else out

    return TomoOperator(geom=geom, views=views, A=A, AT=AT, family=family,
                        dtype=dtype, device=torch.device(device))


def operator_from_scalars(geom: Geometry, gstruct, scalars, *, family: str,
                          dtype, device, views=None, voxel_mask=None,
                          prec: str | None = None) -> TomoOperator:
    """The slab operator of a given group structure and per-view scalars
    (``slab_projector.scalar_groups``/``group_scalars_for``) in the tier
    ``prec``: the alternating driver rebuilds it from new scalars every
    outer."""
    quad = QUADS[family]
    prec = resolve_prec(prec)
    mask = _mask(voxel_mask, geom, dtype, device)

    def A(x):
        x = x.reshape(geom.vox_shape).to(dtype)
        if mask is not None:
            x = x * mask
        return slabp.project_scalars(x, geom, gstruct, scalars, quad, dtype,
                                     prec=prec)

    def AT(y):
        out = slabp.backproject_scalars(
            y.reshape(geom.n_proj, geom.n_det), geom, gstruct, scalars, quad,
            dtype, prec=prec)
        return out * mask if mask is not None else out

    return TomoOperator(geom=geom, views=views, A=A, AT=AT, family=family,
                        dtype=dtype, device=torch.device(device), prec=prec)

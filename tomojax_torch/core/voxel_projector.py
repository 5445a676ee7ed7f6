"""Voxel-driven projector family: bilinear splat and detector gather
(counterpart of ``tomojax.core.voxel_projector``).

- rigid map (a different composition order than the ray family's):
  ``x' = R_y(beta) (R_x(alpha) R_z(phi) x + t)``;
- each voxel centre is rotated, then dropped orthographically onto the
  detector (x, z) plane relative to ``vox_origin - cor`` and divided by
  the voxel downsampling factors ``geom.vox_ds``;
- forward: a bilinear splat of each voxel's value onto the 4 surrounding
  detector pixels (each corner kept only inside the detector), an
  ``index_add_``;
- adjoint: the bilinear gather from the detector at each voxel's
  footprint, its exact transpose;
- detector layout ``u * nv + v``, as every family of the port;
- the 6-DoF Jacobian is the analytic ``rec · ∇w · ∂p/∂θ`` with tomojax's
  corrected sign.

Parameter order ``(tx, ty, tz, phi, alpha, beta)``. tomojax has no Pallas
kernel for this family (its oracle tier), so neither has the port: plain
PyTorch on every device. Each function works on a batch of V views; on a
CUDA tensor ``index_add_`` accumulates with float atomics, so two forwards
may differ in their last bits.

``xs`` (a slice of the volume's x axis) restricts a call to that block of
voxels: the volume-sharded operator of ``tomojax_torch.dist`` gives each
rank its own x block.
"""

from __future__ import annotations

import torch

from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.rotations import (der_rot_x, der_rot_y, der_rot_z,
                                          rot_x, rot_y, rot_z)

# 4 bilinear corners (x, z); 0 = floor, 1 = ceil
_CORNERS2D = [(ox, oz) for ox in (0, 1) for oz in (0, 1)]


def voxel_transform(x, alpha, beta, phi, t):
    """Voxel-path rigid transform ``R_y(beta) (R_x(alpha) R_z(phi) x +
    t)``: ``x`` (..., 3, n), angles (...), ``t`` (..., 3) → (..., 3, n)."""
    ratx = rot_x(alpha) @ (rot_z(phi) @ x)
    return rot_y(beta) @ (ratx + t[..., :, None])


def derivative_voxel_points(x, alpha, beta, phi, t):
    """(..., 6, 3, n) derivative of the transformed voxel positions with
    respect to (tx, ty, tz, phi, alpha, beta)."""
    R_b, R_a, R_t = rot_y(beta), rot_x(alpha), rot_z(phi)
    dR_b, dR_a, dR_t = der_rot_y(beta), der_rot_x(alpha), der_rot_z(phi)
    rtx = R_t @ x
    ratx = R_a @ rtx
    rba = R_b @ R_a
    n = x.shape[-1]
    # d/dt = the columns of R_b
    dt = R_b.transpose(-1, -2)[..., :, :, None].expand(
        *R_b.shape[:-2], 3, 3, n)
    dphi = rba @ (dR_t @ x)
    dalpha = R_b @ (dR_a @ rtx)
    dbeta = dR_b @ (ratx + t[..., :, None])
    return torch.cat([dt, torch.stack([dphi, dalpha, dbeta], dim=-3)],
                     dim=-3)


def _centers(geom: Geometry, xs: slice, **kw):
    """(3, n) centres of the voxels of the x block ``xs``, x-major/z-minor
    (the whole volume's are ``geom.vox_centers``)."""
    (nx, ny, nz), (sx, sy, sz) = geom.vox_shape, geom.vox_size
    axes = [torch.as_tensor(geom._axis_centers(n, s), **kw)
            for n, s in ((nx, sx), (ny, sy), (nz, sz))]
    X, Y, Z = torch.meshgrid(axes[0][xs], axes[1], axes[2], indexing="ij")
    return torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)])


def _as_views(phi, alpha, beta, t, cor, **kw):
    return (torch.as_tensor(phi).to(**kw).reshape(-1),
            torch.as_tensor(alpha).to(**kw).reshape(-1),
            torch.as_tensor(beta).to(**kw).reshape(-1),
            torch.as_tensor(t).to(**kw).reshape(-1, 3),
            torch.as_tensor(cor).to(**kw).reshape(-1, 3))


def _footprint(geom: Geometry, phi, alpha, beta, t, cor, xs, **kw):
    """Detector-plane footprint of the block's voxel centres for V views:
    ``fx, fz`` (V, n) int64 floor pixel indices, ``ax, az`` (V, n)
    fractional offsets and the centres (3, n)."""
    centers = _centers(geom, xs, **kw)
    rc = voxel_transform(centers, alpha, beta, phi, t)          # (V, 3, n)
    orig = geom.vox_origin(**kw) - cor                          # (V, 3)
    ds = torch.as_tensor(geom.vox_ds, **kw)
    px = (rc[:, 0] - orig[:, 0, None]) / ds[0]
    pz = (rc[:, 2] - orig[:, 2, None]) / ds[2]
    fx = torch.floor(px)
    fz = torch.floor(pz)
    return (fx.to(torch.int64), fz.to(torch.int64), px - fx, pz - fz,
            centers)


def _corners(fx, fz, ax, az, det_shape):
    """Per corner ``(ox, oz, lin, w, inb)``: the clipped detector index
    ``u * nv + v``, the bilinear weight zeroed off the detector and the
    in-detector indicator."""
    nu, nv = det_shape
    wx = (1.0 - ax, ax)
    wz = (1.0 - az, az)
    for ox, oz in _CORNERS2D:
        ix = fx + ox
        iz = fz + oz
        inb = (ix >= 0) & (ix < nu) & (iz >= 0) & (iz < nv)
        lin = ix.clamp(0, nu - 1) * nv + iz.clamp(0, nv - 1)
        yield ox, oz, lin, torch.where(inb, wx[ox] * wz[oz], 0.0), inb


def _view_offsets(V, n_det, device):
    return (torch.arange(V, device=device) * n_det)[:, None]


def forward_views(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                  dtype=torch.float32, xs: slice = slice(None)):
    """Voxel-driven forward of V views → ``(V, n_det)``: the bilinear
    splat of every voxel (of the x block ``xs``; ``vol`` is then that
    block)."""
    kw = dict(dtype=dtype, device=vol.device)
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor, **kw)
    fx, fz, ax, az, _ = _footprint(geom, phi, alpha, beta, t, cor, xs, **kw)
    V = fx.shape[0]
    rec = vol.reshape(-1).to(dtype)
    off = _view_offsets(V, geom.n_det, vol.device)
    out = torch.zeros(V * geom.n_det, **kw)
    for _, _, lin, w, _ in _corners(fx, fz, ax, az, geom.det_shape):
        out.index_add_(0, (lin + off).reshape(-1), (w * rec).reshape(-1))
    return out.reshape(V, geom.n_det)


def backproject_views(det_img, geom: Geometry, phi, alpha, beta, t, cor, *,
                      dtype=torch.float32, xs: slice = slice(None)):
    """Exact transpose of :func:`forward_views`, summed over the V views:
    each voxel's bilinear gather from the detector → ``vox_shape`` (or the
    x block ``xs`` of it)."""
    kw = dict(dtype=dtype, device=det_img.device)
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor, **kw)
    fx, fz, ax, az, _ = _footprint(geom, phi, alpha, beta, t, cor, xs, **kw)
    V = fx.shape[0]
    y = det_img.reshape(-1).to(dtype)
    off = _view_offsets(V, geom.n_det, det_img.device)
    acc = torch.zeros_like(ax)
    for _, _, lin, w, _ in _corners(fx, fz, ax, az, geom.det_shape):
        acc += w * torch.take(y, lin + off)
    _, ny, nz = geom.vox_shape
    return acc.sum(0).reshape(-1, ny, nz)


def forward_views_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                      dtype=torch.float32):
    """Fused voxel-driven projection + analytic 6-DoF gradient of V views
    → ``(det (V, n_det), grad (V, 6, n_det))``. Only the x and z
    components of ``∂p/∂θ`` enter (the projection is along y), scaled by
    the inverse downsampling factors."""
    kw = dict(dtype=dtype, device=vol.device)
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor, **kw)
    fx, fz, ax, az, centers = _footprint(geom, phi, alpha, beta, t, cor,
                                         slice(None), **kw)
    der = derivative_voxel_points(centers, alpha, beta, phi, t)  # V,6,3,n
    ds = torch.as_tensor(geom.vox_ds, **kw)
    dpx = der[:, :, 0] / ds[0]                                  # (V, 6, n)
    dpz = der[:, :, 2] / ds[2]
    V, n_det = fx.shape[0], geom.n_det
    rec = vol.reshape(-1).to(dtype)
    off = _view_offsets(V, n_det, vol.device)
    det = torch.zeros(V * n_det, **kw)
    grad = torch.zeros(6, V * n_det, **kw)
    wx = (1.0 - ax, ax)
    wz = (1.0 - az, az)
    for ox, oz, lin, w, inb in _corners(fx, fz, ax, az, geom.det_shape):
        idx = (lin + off).reshape(-1)
        det.index_add_(0, idx, (w * rec).reshape(-1))
        # d w / d px = ±wz, d w / d pz = ±wx (floor corner −, ceil +)
        sx = 2.0 * ox - 1.0
        sz = 2.0 * oz - 1.0
        m = inb.to(dtype) * rec
        contrib = m[:, None] * (sx * wz[oz][:, None] * dpx
                                + sz * wx[ox][:, None] * dpz)   # (V, 6, n)
        grad.index_add_(1, idx, contrib.transpose(0, 1).reshape(6, -1))
    return det.reshape(V, n_det), grad.reshape(6, V, n_det).transpose(0, 1)


# ----------------------------------------------------------------------
# Single-view entry points (tomojax's signatures)
# ----------------------------------------------------------------------


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                 dtype=torch.float32):
    """Voxel-driven forward projection of one view → ``(n_det,)``."""
    return forward_views(vol, geom, phi, alpha, beta, t, cor, dtype=dtype)[0]


def backproject_view(det_img, geom: Geometry, phi, alpha, beta, t, cor, *,
                     dtype=torch.float32):
    """Voxel-driven backprojection of one view (the exact transpose of
    :func:`forward_view`) → ``vox_shape``."""
    return backproject_views(det_img, geom, phi, alpha, beta, t, cor,
                             dtype=dtype)


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                     dtype=torch.float32):
    """Fused projection + analytic 6-DoF gradient of one view →
    ``(det_img (n_det,), grad (6, n_det))``."""
    det, grad = forward_views_jac(vol, geom, phi, alpha, beta, t, cor,
                                  dtype=dtype)
    return det[0], grad[0]


# ----------------------------------------------------------------------
# Multi-view operators
# ----------------------------------------------------------------------


def views_chunk_for(geom: Geometry, n: int, views_chunk=None) -> int:
    """tomojax's chunk: ``views_chunk`` (default ``2^22 // (n_vox // 8)``
    views, which bounds the temporaries), lowered to a divisor of ``n``."""
    if views_chunk is None:
        views_chunk = max(1, (1 << 22) // max(1, geom.n_vox // 8))
    c = max(1, min(int(views_chunk), n))
    while n % c:
        c -= 1
    return c


def _fields(views: Views, sl, device):
    return [getattr(views, f)[sl].to(device)
            for f in ("phi", "alpha", "beta", "t", "cor")]


def project(vol, geom: Geometry, views: Views, *, dtype=torch.float32,
            views_chunk: int | None = None, xs: slice = slice(None)):
    """Multi-view voxel-driven forward → ``(n_proj, n_det)``, in chunks of
    views."""
    n = views.n_proj
    c = views_chunk_for(geom, n, views_chunk)
    return torch.cat([forward_views(vol, geom,
                                    *_fields(views, slice(i, i + c),
                                             vol.device),
                                    dtype=dtype, xs=xs)
                      for i in range(0, n, c)])


def backproject(sino, geom: Geometry, views: Views, *, dtype=torch.float32,
                views_chunk: int | None = None, xs: slice = slice(None)):
    """Multi-view voxel-driven adjoint (gather) → volume (or its x block
    ``xs``), summed over chunks of views."""
    n = views.n_proj
    c = views_chunk_for(geom, n, views_chunk)
    sino = sino.reshape(n, -1)
    acc = None
    for i in range(0, n, c):
        part = backproject_views(sino[i:i + c], geom,
                                 *_fields(views, slice(i, i + c),
                                          sino.device),
                                 dtype=dtype, xs=xs)
        acc = part if acc is None else acc + part
    return acc

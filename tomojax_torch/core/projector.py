"""The exact ray-driven projector family (counterpart of
``tomojax.core.projector``).

Every ray marches ``n_steps = int(ray_length / step_size)`` samples
``p(r, j) = p0_r + j · step_size · d̂`` through the volume; each sample
reads its 8 trilinear corners with ``floor``/``1 − frac`` weights, a
corner kept only if all three of its own indices lie inside the volume.
The forward is a gather, its exact transpose a scatter-add
(``index_add_``), and the analytic 6-DoF Jacobian is assembled from the
``der_static + step · der_direction`` decomposition.

- rigid map: ``p' = R_z(phi) R_x(alpha) (R_y(beta) p + t)``;
- the per-view centre-of-rotation shift is added to the x coordinate of
  the untransformed source and detector points;
- 6-DoF parameter order ``(tx, ty, tz, phi, alpha, beta)``.

tomojax runs one ``lax.scan`` over the steps per view and ``vmap``s the
views of a chunk. Here every function works on a batch of views (the
single-view entry points are batches of one) and marches the steps in
blocks, so a block's samples go through one gather (or one
``index_add_``); the backprojection adds every view of a chunk into one
volume. Sums are taken in another order than tomojax's, which agrees to
float64 rounding.

On a CUDA tensor :func:`forward_views`, :func:`backproject_views` and
:func:`forward_views_jac` launch the hand-written kernels R1, R2 and R3
(``tomojax_torch.kernels.ray``: one thread per ray; a gather over voxels
with no atomics, so two backprojections give the same bits; R1's march
with the Jacobian's sums beside the value, whose projection is R1's to
the bit), in float32 only: the plain march (:func:`forward_views_plain`,
:func:`backproject_views_plain`, :func:`forward_views_jac_plain`) is their
CPU path and the card tests' yardstick. The kernels take the setup's
``p0`` and ``d̂`` and round each sample as the march does, so they read
the same samples, corners and weights.

The batched entries record the spans ``ray.A``, ``ray.AT`` and
``ray.jac`` (timed on the card's clock too), count their views
(``ray.A.views``, …), and count the setup's three copies from host memory
as ``host_sync.ray.setup``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.rotations import (der_rot_x, der_rot_y, der_rot_z,
                                          rot_x, rot_y, rot_z)
from tomojax_torch.kernels import ray as rayk
from tomojax_torch.utils import profiling

# Samples (views × rays × steps) per block of the march: bounds the
# temporaries (~350 bytes per sample in float64).
BLOCK_SAMPLES = 1 << 21

# corner offsets in (x, y, z); 0 = floor, 1 = ceil; z fastest, x slowest
_CORNERS = [(ox, oy, oz) for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)]


def transform_points(x, alpha, beta, phi, t):
    """Ray-path rigid transform ``R_z(phi) R_x(alpha) (R_y(beta) x + t)``.

    :param x: (..., 3, n) points; angles (...) and ``t`` (..., 3) batch
        alike. :returns: (..., 3, n) transformed points.
    """
    rot_pa = rot_z(phi) @ rot_x(alpha)
    return rot_pa @ (rot_y(beta) @ x + t[..., :, None])


class _RaySetup(NamedTuple):
    """Per-view precomputation shared by forward, adjoint and Jacobian,
    for a batch of V views."""

    p0: torch.Tensor        # (V, 3, n_rays) source points, origin-relative
    d_hat: torch.Tensor     # (V, 3) unit ray direction (same for all rays)
    inv_rlen: torch.Tensor  # 0-d 1 / ray_length
    rpa: torch.Tensor | None      # (V, 3, 3) R_z R_x (columns = dp/dt)
    der_ang: torch.Tensor | None  # (V, 3, 3, n_rays) rows (phi, alpha,
    #                               beta), static part
    der_dir: torch.Tensor | None  # (V, 3, 3) rows (phi, alpha, beta),
    #                               step-scaled part


def _ray_setup(geom: Geometry, phi, alpha, beta, t, cor, dtype,
               with_jacobian: bool, rays: slice = slice(None)) -> _RaySetup:
    """Setup of V views: ``phi``, ``alpha``, ``beta`` (V,), ``t``, ``cor``
    (V, 3), on their device; ``rays`` a contiguous block of the detector's
    rays (all by default; the detector-sharded operator of
    ``tomojax_torch.dist`` takes one block per rank)."""
    kw = dict(dtype=dtype, device=phi.device)
    phi, alpha, beta, t, cor = (torch.as_tensor(a).to(**kw)
                                for a in (phi, alpha, beta, t, cor))
    # cor shift: x component added to untransformed source & detector
    shift = torch.zeros((cor.shape[0], 3, 1), **kw)
    shift[:, 0, 0] = cor[:, 0]
    # the detector grids and the origin are copied from host memory: on a
    # card each copy makes the host wait
    profiling.count("host_sync.ray.setup", 3)
    src = geom.source_centers(**kw)[None, :, rays] + shift
    det = geom.det_centers(**kw)[None, :, rays] + shift
    origin = geom.vox_origin(**kw)

    r_p, r_a, r_b = rot_z(phi), rot_x(alpha), rot_y(beta)
    rpa = r_p @ r_a
    p0 = rpa @ (r_b @ src + t[:, :, None]) - origin[:, None]
    # the ray vector is identical for every ray: det - src = (0, 2 sy, 0)
    v = (det[:, :, 0] - src[:, :, 0])[:, :, None]            # (V, 3, 1)
    r = (rpa @ (r_b @ v))[:, :, 0]
    r_length = torch.full((), geom.ray_length, **kw)
    d_hat = r / r_length

    der_ang = der_dir = None
    if with_jacobian:
        d_p, d_a, d_b = der_rot_z(phi), der_rot_x(alpha), der_rot_y(beta)
        rb_st = r_b @ src + t[:, :, None]                    # (V, 3, R)
        der_ang = torch.stack([d_p @ (r_a @ rb_st), r_p @ (d_a @ rb_st),
                               rpa @ (d_b @ src)], dim=1)    # (V, 3, 3, R)
        der_dir = torch.stack([d_p @ (r_a @ (r_b @ v)),
                               r_p @ (d_a @ (r_b @ v)),
                               rpa @ (d_b @ v)], dim=1)[..., 0]
    return _RaySetup(p0=p0, d_hat=d_hat, inv_rlen=1.0 / r_length,
                     rpa=rpa if with_jacobian else None, der_ang=der_ang,
                     der_dir=der_dir)


def _corner_indices_weights(p, vox_shape):
    """8-corner trilinear indices, weights and masks for points ``p`` (3,
    ...).

    :returns: ``idx (8, ...)`` int64 clipped linear indices, ``w (8,
        ...)`` weights zeroed out of bounds, ``parts (3, 2, ...)`` per-axis
        floor/ceil weights, ``mask (8, ...)`` the in-bounds indicator (in
        p's dtype). A corner is kept iff all three of its own indices are
        inside.
    """
    nx, ny, nz = vox_shape
    f = torch.floor(p)
    fi = f.to(torch.int64)
    frac = p - f
    parts = torch.stack([1.0 - frac, frac], dim=1)
    idx, w, mask = [], [], []
    for ox, oy, oz in _CORNERS:
        ix, iy, iz = fi[0] + ox, fi[1] + oy, fi[2] + oz
        inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
               & (iz < nz))
        wc = parts[0, ox] * parts[1, oy] * parts[2, oz]
        idx.append((ix.clamp(0, nx - 1) * ny + iy.clamp(0, ny - 1)) * nz
                   + iz.clamp(0, nz - 1))
        w.append(torch.where(inb, wc, 0.0))
        mask.append(inb)
    return (torch.stack(idx), torch.stack(w), parts,
            torch.stack(mask).to(p.dtype))


def _corner_weight_gradients(parts):
    """Per-corner gradient of the trilinear weight w.r.t. the sample
    point: ``∂w/∂p_x = s_x · w_y · w_z`` with ``s_x = −1`` for a floor and
    ``+1`` for a ceil corner (and cyclically).

    :param parts: (3, 2, ...) per-axis floor/ceil weights.
    :returns: (8, 3, ...) d(weight)/d(p).
    """
    out = []
    for ox, oy, oz in _CORNERS:
        sx, sy, sz = 2.0 * ox - 1.0, 2.0 * oy - 1.0, 2.0 * oz - 1.0
        out.append(torch.stack([sx * parts[1, oy] * parts[2, oz],
                                sy * parts[0, ox] * parts[2, oz],
                                sz * parts[0, ox] * parts[1, oy]]))
    return torch.stack(out)


def _step_blocks(setup: _RaySetup, geom: Geometry, dtype):
    """Yield ``(c (S,), p (3, V, R, S))``: the march positions ``c_j = j ·
    step_size`` of a block of steps and the samples at them."""
    V, _, R = setup.p0.shape
    dev = setup.p0.device
    n = geom.n_steps
    blk = max(1, min(n, BLOCK_SAMPLES // max(1, V * R)))
    step = torch.full((), geom.step_size, dtype=dtype, device=dev)
    for j0 in range(0, n, blk):
        c = torch.arange(j0, min(n, j0 + blk), dtype=dtype,
                         device=dev) * step
        p = setup.p0[..., None] + c * setup.d_hat[:, :, None, None]
        yield c, p.movedim(1, 0)


def _as_views(phi, alpha, beta, t, cor):
    return (torch.as_tensor(phi).reshape(-1),
            torch.as_tensor(alpha).reshape(-1),
            torch.as_tensor(beta).reshape(-1),
            torch.as_tensor(t).reshape(-1, 3),
            torch.as_tensor(cor).reshape(-1, 3))


def _march_forward(vol, setup: _RaySetup, geom: Geometry, dtype):
    vol_flat = vol.reshape(-1).to(dtype)
    acc = torch.zeros(setup.p0.shape[0], setup.p0.shape[2], dtype=dtype,
                      device=vol.device)
    for _, p in _step_blocks(setup, geom, dtype):
        idx, w, _, _ = _corner_indices_weights(p, geom.vox_shape)
        acc += (w * torch.take(vol_flat, idx)).sum(0).sum(-1)
    return acc


def _march_adjoint(y, setup: _RaySetup, geom: Geometry, dtype, out):
    for _, p in _step_blocks(setup, geom, dtype):
        idx, w, _, _ = _corner_indices_weights(p, geom.vox_shape)
        out.index_add_(0, idx.reshape(-1),
                       (w * y[None, :, :, None]).reshape(-1))
    return out


def forward_views(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                  dtype=torch.float32, rays: slice = slice(None)):
    """Forward-project V views at once → ``(V, n_det)`` (or the block
    ``rays`` of the detector); angles (V,), ``t`` and ``cor`` (V, 3), all
    on ``vol``'s device. On the card the kernel R1 (float32 only)."""
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    with profiling.span("ray.A", vol.device):
        profiling.count("ray.A.views", phi.shape[0])
        setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False,
                           rays)
        if vol.device.type == "cuda":
            return rayk.ray_fwd(vol.reshape(geom.vox_shape).to(dtype)
                                .contiguous(), setup.p0, setup.d_hat, geom,
                                rays)
        return _march_forward(vol, setup, geom, dtype)


def forward_views_plain(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                        dtype=torch.float32, rays: slice = slice(None)):
    """:func:`forward_views` by the plain march, on any device and in any
    dtype: its CPU path, and R1's yardstick on the card."""
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False, rays)
    return _march_forward(vol, setup, geom, dtype)


def backproject_views(det_img, vol_shape, geom: Geometry, phi, alpha, beta,
                      t, cor, *, dtype=torch.float32, out=None,
                      rays: slice = slice(None)):
    """Adjoint of :func:`forward_views`, summed over the V views: ``Σ_v
    P(θ_v)ᵀ y_v`` → ``vol_shape`` (added into the flat ``out`` if given;
    ``det_img`` holds the block ``rays`` of each view). On the card the
    kernel R2 (float32 only)."""
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    with profiling.span("ray.AT", det_img.device):
        profiling.count("ray.AT.views", phi.shape[0])
        setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False,
                           rays)
        y = det_img.reshape(setup.p0.shape[0], -1).to(dtype)
        n_vox = vol_shape[0] * vol_shape[1] * vol_shape[2]
        if out is None:
            out = torch.zeros(n_vox, dtype=dtype, device=y.device)
        if y.device.type == "cuda":
            rayk.ray_adj(y.contiguous(), setup.p0, setup.d_hat, phi, alpha,
                         beta, geom, out, rays)
        else:
            _march_adjoint(y, setup, geom, dtype, out)
    return out.reshape(vol_shape)


def backproject_views_plain(det_img, vol_shape, geom: Geometry, phi, alpha,
                            beta, t, cor, *, dtype=torch.float32,
                            rays: slice = slice(None)):
    """:func:`backproject_views` by the plain march (``index_add_``; float
    atomics on the card), on any device and in any dtype: its CPU path,
    and R2's yardstick on the card."""
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, False, rays)
    y = det_img.reshape(setup.p0.shape[0], -1).to(dtype)
    out = torch.zeros(vol_shape[0] * vol_shape[1] * vol_shape[2],
                      dtype=dtype, device=y.device)
    return _march_adjoint(y, setup, geom, dtype, out).reshape(vol_shape)


def _march_jac(vol, setup: _RaySetup, geom: Geometry, dtype):
    """The plain march of the fused projection and Jacobian: per block of
    steps, every corner's index, weight and weight gradient as tensors."""
    vol_flat = vol.reshape(-1).to(dtype)
    V = setup.p0.shape[0]
    kw = dict(dtype=dtype, device=vol.device)
    det = torch.zeros(V, geom.n_det, **kw)
    g_sum = torch.zeros(3, V, geom.n_det, **kw)
    g_step = torch.zeros(3, V, geom.n_det, **kw)
    for c, p in _step_blocks(setup, geom, dtype):
        idx, w, parts, mask = _corner_indices_weights(p, geom.vox_shape)
        vals = torch.take(vol_flat, idx)
        det += (w * vals).sum(0).sum(-1)
        # a zero weight still has a nonzero weight gradient: mask dw
        # explicitly rather than reusing w's zeros
        gval = ((vals * mask)[:, None] * _corner_weight_gradients(parts)
                ).sum(0)                                     # (3, V, R, S)
        g_sum += gval.sum(-1)
        g_step += (gval * (c * setup.inv_rlen)).sum(-1)
    jac_t = torch.einsum("vdp,dvr->vpr", setup.rpa, g_sum)
    jac_a = (torch.einsum("vpdr,dvr->vpr", setup.der_ang, g_sum)
             + torch.einsum("vpd,dvr->vpr", setup.der_dir, g_step))
    return det, torch.cat([jac_t, jac_a], dim=1)


def forward_views_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                      dtype=torch.float32):
    """Fused projection + analytic 6-DoF Jacobian of V views →
    ``(det (V, n_det), jac (V, 6, n_det))``.

    The sample-point Jacobian is ``g = der_static + step · der_dir`` with
    ``step = c_j / ray_length``; per corner the contribution is
    ``vol[corner] · (∇_p w · g)``. Being linear in ``g``, the per-sample
    gradients are summed over the steps first (plain and ``step``-weighted)
    and contracted with the static and direction parts once. On the card
    the kernel R3 (float32 only), whose ``det`` is R1's to the bit.
    """
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    with profiling.span("ray.jac", vol.device):
        profiling.count("ray.jac.views", phi.shape[0])
        setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, True)
        if vol.device.type == "cuda":
            return rayk.ray_jac(vol.reshape(geom.vox_shape).to(dtype)
                                .contiguous(), setup.p0, setup.d_hat,
                                setup.rpa, setup.der_ang,
                                setup.der_dir, geom)
        return _march_jac(vol, setup, geom, dtype)


def forward_views_jac_plain(vol, geom: Geometry, phi, alpha, beta, t, cor,
                            *, dtype=torch.float32):
    """:func:`forward_views_jac` by the plain march, on any device and in
    any dtype: its CPU path, and R3's yardstick on the card."""
    phi, alpha, beta, t, cor = _as_views(phi, alpha, beta, t, cor)
    setup = _ray_setup(geom, phi, alpha, beta, t, cor, dtype, True)
    return _march_jac(vol, setup, geom, dtype)


# ----------------------------------------------------------------------
# Single-view entry points (tomojax's signatures)
# ----------------------------------------------------------------------
#
# ``unroll`` is tomojax's ``lax.scan`` unroll of the march: accepted, and
# without effect here (the march runs in blocks of steps).


def _ray_block(geom: Geometry, ray_offset, ray_count) -> slice:
    """The detector rays ``[ray_offset, ray_offset + ray_count)`` (all with
    ``ray_count`` None), the offset clamped into the detector as
    ``lax.dynamic_slice`` clamps tomojax's."""
    if ray_count is None:
        return slice(None)
    off = min(max(int(ray_offset or 0), 0), geom.n_det - ray_count)
    return slice(off, off + ray_count)


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                 dtype=torch.float32, unroll: int = 1, ray_offset=None,
                 ray_count: int | None = None):
    """Forward-project one view: ``P(θ) · vol`` → ``(n_det,)``, or
    ``(ray_count,)`` for the block of rays from ``ray_offset``."""
    return forward_views(vol, geom, phi, alpha, beta, t, cor, dtype=dtype,
                         rays=_ray_block(geom, ray_offset, ray_count))[0]


def backproject_view(det_img, vol_shape, geom: Geometry, phi, alpha, beta, t,
                     cor, *, dtype=torch.float32, unroll: int = 1,
                     ray_offset=None, ray_count: int | None = None):
    """Adjoint of :func:`forward_view` for one view: ``P(θ)ᵀ · y``
    (``det_img`` holds the block of rays that ``ray_offset`` and
    ``ray_count`` give)."""
    return backproject_views(det_img, vol_shape, geom, phi, alpha, beta, t,
                             cor, dtype=dtype,
                             rays=_ray_block(geom, ray_offset, ray_count))


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                     dtype=torch.float32, unroll: int = 1):
    """Fused projection + analytic 6-DoF Jacobian for one view →
    ``(det_img (n_det,), jac (6, n_det))``."""
    det, jac = forward_views_jac(vol, geom, phi, alpha, beta, t, cor,
                                 dtype=dtype)
    return det[0], jac[0]


class _ProjectViewsT(torch.autograd.Function):
    """``P(θ_v) · vol`` for V views, differentiable in ``vol`` (the exact
    adjoint) and ``θ`` (the analytic Jacobian contraction)."""

    @staticmethod
    def forward(ctx, vol, theta, geom, cor, dtype):
        ctx.save_for_backward(vol, theta, cor)
        ctx.geom, ctx.dtype = geom, dtype
        return forward_views(vol, geom, theta[:, 3], theta[:, 4],
                             theta[:, 5], theta[:, :3], cor, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        vol, theta, cor = ctx.saved_tensors
        geom, dtype = ctx.geom, ctx.dtype
        args = (theta[:, 3], theta[:, 4], theta[:, 5], theta[:, :3], cor)
        vol_bar = theta_bar = None
        if ctx.needs_input_grad[0]:
            vol_bar = backproject_views(g, geom.vox_shape, geom, *args,
                                        dtype=dtype).reshape(vol.shape).to(
                                            vol.dtype)
        if ctx.needs_input_grad[1]:
            _, jac = forward_views_jac(vol, geom, *args, dtype=dtype)
            theta_bar = torch.einsum("vpr,vr->vp", jac, g.to(jac.dtype)
                                     ).to(theta.dtype)
        return vol_bar, theta_bar, None, None, None


def project_views_t(vol, theta, geom: Geometry, cor, dtype=torch.float32):
    """Differentiable projection of V views: ``theta`` (V, 6) in the order
    ``(tx, ty, tz, phi, alpha, beta)``, ``cor`` (V, 3) →  (V, n_det).
    ``cor`` gets no gradient."""
    return _ProjectViewsT.apply(vol, theta, geom, torch.as_tensor(cor),
                                dtype)


def project_view_t(vol, theta6, geom: Geometry, cor, dtype=torch.float32):
    """Differentiable single-view projection ``P(θ) · vol`` (tomojax's
    ``custom_vjp``): w.r.t. ``vol`` the exact adjoint, w.r.t. ``theta6``
    the analytic Jacobian contraction, ``cor`` non-differentiable."""
    return project_views_t(vol, theta6[None], geom,
                           torch.as_tensor(cor)[None], dtype)[0]


# ----------------------------------------------------------------------
# Multi-view operators
# ----------------------------------------------------------------------


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``target`` (≥ 1)."""
    c = max(1, min(int(target), n))
    while n % c:
        c -= 1
    return c


def _auto_forward_chunk(geom: Geometry) -> int:
    return _divisor_chunk(geom.n_proj, max(1, (1 << 23) // max(1, geom.n_det)))


def _auto_adjoint_chunk(geom: Geometry) -> int:
    return _divisor_chunk(geom.n_proj, max(1, (1 << 26) // max(1, geom.n_vox)))


def _chunks(n: int, chunk: int):
    return [slice(i, i + chunk) for i in range(0, n, chunk)]


def _view_fields(views: Views, sl, device):
    return [getattr(views, f)[sl].to(device)
            for f in ("phi", "alpha", "beta", "t", "cor")]


def project(vol, geom: Geometry, views: Views, *, dtype=torch.float32,
            views_chunk: int | None = None, unroll: int = 1,
            rays: slice = slice(None)):
    """Multi-view forward projection → sinogram ``(n_proj, n_det)`` (or
    the block ``rays`` of each view), in chunks of views (auto-sized as
    tomojax's; ``views_chunk`` overrides). ``unroll`` does nothing."""
    n = views.n_proj
    chunk = (_divisor_chunk(n, views_chunk) if views_chunk
             else _auto_forward_chunk(geom))
    return torch.cat([forward_views(vol, geom,
                                    *_view_fields(views, sl, vol.device),
                                    dtype=dtype, rays=rays)
                      for sl in _chunks(n, chunk)])


def backproject(sino, vol_shape, geom: Geometry, views: Views, *,
                dtype=torch.float32, views_chunk: int | None = None,
                unroll: int = 1, rays: slice = slice(None)):
    """Multi-view adjoint ``Aᵀ y`` → volume ``vol_shape``; each chunk of
    views adds into the one volume (``sino`` may hold the block ``rays``
    of each view). ``unroll`` does nothing."""
    n = views.n_proj
    chunk = (_divisor_chunk(n, views_chunk) if views_chunk
             else _auto_adjoint_chunk(geom))
    sino = sino.reshape(n, -1)
    out = torch.zeros(vol_shape[0] * vol_shape[1] * vol_shape[2],
                      dtype=dtype, device=sino.device)
    for sl in _chunks(n, chunk):
        backproject_views(sino[sl], vol_shape, geom,
                          *_view_fields(views, sl, sino.device), dtype=dtype,
                          out=out, rays=rays)
    return out.reshape(vol_shape)


def project_with_jacobians(vol, geom: Geometry, views: Views, *,
                           dtype=torch.float32,
                           views_chunk: int | None = None):
    """Batched fused projection + per-view 6-DoF Jacobians → ``(sino
    (n_proj, n_det), jac (n_proj, 6, n_det))``."""
    n = views.n_proj
    chunk = (_divisor_chunk(n, views_chunk) if views_chunk
             else _divisor_chunk(n, max(1, (1 << 22) // max(1, geom.n_det))))
    outs = [forward_views_jac(vol, geom,
                              *_view_fields(views, sl, vol.device),
                              dtype=dtype)
            for sl in _chunks(n, chunk)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))

"""Fast multi-pass projector family (counterpart of
``tomojax.core.fast_projector``).

The parallel-beam ray transform factorizes into three 1-D affine
resamples of lines of the volume — z, then y, then x — and a sum over the
march step j. Sample points are affine in the detector and step indices,
``p(u, v, j) = B + u·EU + v·EV + j·ED`` (:func:`view_affine`), so every
pass is the batched row lerp of ``kernels.resample`` (K7 forward, K8
transpose). The march direction is ±y for y-dominant views; x-dominant
views run the same code on the x/y-transposed volume with the x/y rows of
the affine map swapped; :func:`marching_x` decides, from the affine map.

Everything is batched over views: an affine map ``E`` (V, 3, 3), ``B``
(V, 3) gives one slope per view and pass, as tomojax has under ``vmap``.
Views are processed in chunks sized by device memory
(:func:`views_per_chunk`). :func:`project` is linear in the volume and
:func:`backproject` is its exact transpose, written as the explicit K8
chain (no forward pass is run for it). θ-gradients flow by autograd
through :func:`view_affine`, ``torch.linalg.inv`` and the resample
Function.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.rotations import ray_rotation, rot_x, rot_y, rot_z
from tomojax_torch.kernels.resample import (resample_rows,
                                            resample_rows_transpose)
from tomojax_torch.utils import profiling

# Transient bytes one chunk of views may take (forward intermediates, or
# with a θ-gradient also the saved rows and the position cotangents).
CHUNK_BYTES = 8 << 30
_XY = [1, 0, 2]   # row order of the x/y swap (tomojax's perm matrix)


def view_affine(geom: Geometry, phi, alpha, beta, t, cor, dtype=None):
    """Affine map (u, v, j) → sample position, origin-relative.

    ``p = R (s0 + u·du·x̂ + v·dv·ẑ + cor_x·x̂) + R_pa t − origin + j·step·R ŷ``
    with R = R_z R_x R_y (ray path) and R_pa = R_z R_x. Angles may carry
    leading batch dimensions ``S`` (``t`` and ``cor`` then ``S + (3,)``).

    :returns: ``(E, B)``: E of shape ``S + (3, 3)`` with columns
        EU = du·R[:, 0], EV = dv·R[:, 2], ED = step·R[:, 1], and B of
        shape ``S + (3,)``.
    """
    phi = torch.as_tensor(phi, dtype=dtype)
    kw = dict(dtype=phi.dtype, device=phi.device)
    alpha = torch.as_tensor(alpha, **kw)
    beta = torch.as_tensor(beta, **kw)
    t = torch.as_tensor(t, **kw)
    cor = torch.as_tensor(cor, **kw)

    r_pa = rot_z(phi) @ rot_x(alpha)
    R = r_pa @ rot_y(beta)

    su, sv = geom.det_size
    du, dv = geom.det_pix
    sy = geom.vox_size[1]
    # three copies from pageable host memory: on a card the host waits
    profiling.count("host_sync.geometry.affine", 3)
    s0 = (torch.tensor([-su / 2.0 + 0.5, -sy, -sv / 2.0 + 0.5], **kw)
          + cor[..., :1] * torch.tensor([1.0, 0.0, 0.0], **kw))
    origin = torch.as_tensor(geom.vox_origin_np(), **kw)
    B = ((R @ s0.unsqueeze(-1)).squeeze(-1)
         + (r_pa @ t.unsqueeze(-1)).squeeze(-1) - origin)
    E = torch.stack([du * R[..., :, 0], dv * R[..., :, 2],
                     geom.step_size * R[..., :, 1]], dim=-1)
    return E, B


def views_per_chunk(geom: Geometry, grad: bool = False,
                    itemsize: int = 4) -> int:
    """Views per chunk within :data:`CHUNK_BYTES`: the forward holds i1
    (nx·ny·nv), i2 (nx·nv·nj) and pass 3's output (nj·nv·nu), each written
    by K7 in the row order the next pass reads (all three stay alive under
    autograd, which saves the rows); the adjoint's K8 chain holds less at
    its peak (a3 and a2; its last pass adds into the volume). A θ-gradient
    adds the position cotangents' temporaries (about six pass-3-sized
    tensors, two of them int64)."""
    nx, ny, _ = geom.vox_shape
    nu, nv = geom.det_shape
    nj = geom.n_steps
    per_view = nx * ny * nv + nx * nv * nj + nj * nv * nu
    if grad:
        per_view += 8 * nj * nv * nu
    return max(1, CHUNK_BYTES // (itemsize * per_view))


def marching_x(E) -> np.ndarray:
    """The octant decision per view, made here only: True → march along x
    (swap x/y), iff ``|ED_x| > |ED_y|`` at the view's affine map ``E`` (V,
    3, 3), in E's own dtype (tomojax's in-graph ``swapped=None``)."""
    return (E[:, 0, 2].abs() > E[:, 1, 2].abs()).cpu().numpy()


def swap_flags(views: Views) -> np.ndarray:
    """Each view's octant decision on the host (tomojax's ``swap_flags``):
    :func:`marching_x` at the view's affine map for unit pixels and step,
    in float64. True → march along x (swap x/y)."""
    R = ray_rotation(*(getattr(views, f).detach().cpu().to(torch.float64)
                       for f in ("phi", "alpha", "beta")))
    return marching_x(R[..., [0, 2, 1]])


def _octant_chunks(E, chunk: int):
    """(view indices on E's device, swapped) per chunk of at most ``chunk``
    views of each marching octant."""
    flags = marching_x(E)
    for sw in (False, True):
        idx = np.nonzero(flags == sw)[0]
        for c0 in range(0, idx.size, chunk):
            yield torch.as_tensor(idx[c0:c0 + chunk], device=E.device), sw


def _passes(E, B, geom: Geometry, vol_shape):
    """The three passes' (offsets, slope, max_slope) of y-marching views.

    Pass 1 resamples z (v-consistency ``G[1]·(p − B) = v``), pass 2 y
    along the march, pass 3 x; the static slope bounds are tomojax's
    (1.2·dv, 1.6·step, 1.2·du: ±10° jitter)."""
    nx, ny, _ = vol_shape
    nv = geom.det_shape[1]
    kw = dict(dtype=E.dtype, device=E.device)
    EU, EV, ED = E[..., 0], E[..., 1], E[..., 2]
    G = torch.linalg.inv(E)
    x = torch.arange(nx, **kw)[None, :, None]
    y = torch.arange(ny, **kw)[None, None, :]
    v = torch.arange(nv, **kw)[None, None, :]
    j = torch.arange(geom.n_steps, **kw)[None, :, None]

    def col(a):
        return a[:, None, None]

    bx, by, bz = col(B[:, 0]), col(B[:, 1]), col(B[:, 2])
    inv_g12 = 1.0 / G[:, 1, 2]
    zeta0 = bz + (-col(G[:, 1, 0]) * (x - bx)
                  - col(G[:, 1, 1]) * (y - by)) * col(inv_g12)
    cu = EU[:, 1] * (1.0 / E[:, 0, 0])
    y0 = (by + col(cu) * (x - bx - col(EV[:, 0]) * v)
          + col(EV[:, 1]) * v)
    yj = ED[:, 1] - cu * ED[:, 0]
    x0 = bx + col(EV[:, 0]) * v + col(ED[:, 0]) * j
    return ((zeta0, inv_g12, 1.2 * geom.det_pix[1]),
            (y0, yj, 1.6 * geom.step_size),
            (x0, EU[:, 0], 1.2 * geom.det_pix[0]))


def _forward_marching_y(vol, E, B, geom: Geometry):
    """y-marching fast forward of V views → (V, n_det), u-major.

    ``vol`` (nx, ny, nz) may be a strided view (the x/y transpose): pass 1
    reads its rows in place, once per call for all views. On the card each
    pass's output is stored in the row order the next pass reads ((V, nx,
    nv, ny) and (V, nj, nv, nx)), so the transposes below are views of
    contiguous storage, not copies."""
    V = E.shape[0]
    nu, nv = geom.det_shape
    p1, p2, p3 = _passes(E, B, geom, vol.shape)
    i1 = resample_rows(vol.expand(V, *vol.shape), *p1[:2], nv, p1[2],
                       out_order=(0, 1, 3, 2))    # (V, nx, ny, nv), stored
    i2 = resample_rows(i1.transpose(2, 3), *p2[:2], geom.n_steps, p2[2],
                       out_order=(0, 3, 2, 1))    # (V, nx, nv, nj), stored
    del i1
    out = resample_rows(i2.permute(0, 3, 2, 1), *p3[:2], nu,
                        p3[2])                            # (V, nj, nv, nu)
    return out.sum(1).transpose(1, 2).reshape(V, -1)


def _backproject_marching_y(g, E, B, geom: Geometry, acc):
    """Exact transpose of :func:`_forward_marching_y`: adds the
    backprojection of ``g`` (V, n_det), summed over the views, into
    ``acc`` (nx, ny, nz; a strided view for x-marching views). K8 on the
    rows only. The sinogram is read in place as rows broadcast over j, and
    on the card each pass's output is stored in the row order the next
    pass reads (a3 as (V, nx, nv, nj), a2 as (V, nx, ny, nv)); the last
    pass sums the views into ``acc`` itself."""
    V = E.shape[0]
    nu, nv = geom.det_shape
    nx, ny, nz = acc.shape
    p1, p2, p3 = _passes(E, B, geom, acc.shape)
    g3 = g.reshape(V, nu, nv).transpose(1, 2)[:, None].expand(
        V, geom.n_steps, nv, nu)                          # sum over j
    a3 = resample_rows_transpose(g3, *p3[:2], nx, p3[2],
                                 out_order=(0, 3, 2, 1))  # (V, nj, nv, nx)
    a2 = resample_rows_transpose(a3.permute(0, 3, 2, 1), *p2[:2], ny, p2[2],
                                 out_order=(0, 1, 3, 2))  # (V, nx, nv, ny)
    del a3
    resample_rows_transpose(a2.transpose(2, 3), *p1[:2], nz, p1[2],
                            add_into=acc)


def _oriented(vol, E, B, swapped: bool):
    """The volume and affine maps of y-marching: x-marching views see the
    x/y-transposed volume (a view, no copy) with E, B's x/y rows swapped."""
    if swapped:
        return vol.transpose(0, 1), E[:, _XY], B[:, _XY]
    return vol, E, B


def _require_square(geom: Geometry):
    nx, ny, _ = geom.vox_shape
    if nx != ny:
        raise ValueError(f"the fast family needs nx == ny (got {nx} != "
                         f"{ny}); use the exact ray family")


def forward_views(vol, geom: Geometry, E, B):
    """Forward of V views, each marching in the octant of its own affine
    map (:func:`marching_x`) → (V, n_det). Differentiable in ``E``, ``B``
    and ``vol``."""
    _require_square(geom)
    parts, order = [], []
    for sel, sw in _octant_chunks(E, E.shape[0]):
        parts.append(_forward_marching_y(*_oriented(vol, E[sel], B[sel], sw),
                                         geom))
        order.append(sel)
    out = torch.cat(parts)
    if len(parts) == 1:
        return out
    return out[torch.argsort(torch.cat(order))]


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                 dtype=torch.float32, swapped: bool | None = None):
    """Fast forward projection of one view → ``(n_det,)`` (u-major).

    ``swapped`` selects the x-marching path; None decides at this view's
    affine map, as :func:`forward_views` does."""
    vol = vol.reshape(geom.vox_shape).to(dtype)
    E, B = view_affine(geom, phi, alpha, beta, t, cor, dtype)
    E, B = E[None].to(vol.device), B[None].to(vol.device)
    if swapped is None:
        return forward_views(vol, geom, E, B)[0]
    if swapped:
        _require_square(geom)
    return _forward_marching_y(*_oriented(vol, E, B, swapped), geom)[0]


def _affine(geom: Geometry, views: Views, dtype, device):
    """(E, B) of every view, on ``device``."""
    E, B = view_affine(geom, views.phi, views.alpha, views.beta, views.t,
                       views.cor, dtype)
    return E.to(device), B.to(device)


def _chunk(geom: Geometry, views_chunk: int | None, itemsize: int) -> int:
    """Views per chunk: the memory-sized :func:`views_per_chunk`, at most
    ``views_chunk``."""
    chunk = views_per_chunk(geom, itemsize=itemsize)
    return min(chunk, max(1, int(views_chunk))) if views_chunk else chunk


def project(vol, geom: Geometry, views: Views, *, dtype=torch.float32,
            views_chunk: int | None = None):
    """Multi-view fast forward → ``(n_proj, n_det)``. Views are grouped by
    marching octant (:func:`marching_x`) and chunked by memory, in chunks
    of at most ``views_chunk`` views (the result does not depend on it);
    requires nx == ny."""
    _require_square(geom)
    vol = vol.reshape(geom.vox_shape).to(dtype)
    E, B = _affine(geom, views, dtype, vol.device)
    chunk = _chunk(geom, views_chunk, vol.element_size())
    out = torch.zeros((views.n_proj, geom.n_det), dtype=dtype,
                      device=vol.device)
    for sel, sw in _octant_chunks(E, chunk):
        out[sel] = _forward_marching_y(*_oriented(vol, E[sel], B[sel], sw),
                                       geom)
    return out


def backproject(sino, geom: Geometry, views: Views, *, dtype=torch.float32,
                views_chunk: int | None = None):
    """Exact adjoint of :func:`project` → ``vox_shape``: per chunk (at most
    ``views_chunk`` views), the K8 chain of
    :func:`_backproject_marching_y`, which adds the chunk into the volume
    (through its x/y-transposed view for x-marching chunks). The sum runs
    over the views in order within a chunk and over the chunks in
    :func:`_octant_chunks` order."""
    _require_square(geom)
    sino = sino.reshape(views.n_proj, geom.n_det).to(dtype)
    E, B = _affine(geom, views, dtype, sino.device)
    chunk = _chunk(geom, views_chunk, sino.element_size())
    acc = torch.zeros(geom.vox_shape, dtype=dtype, device=sino.device)
    for sel, sw in _octant_chunks(E, chunk):
        vol_o, E_o, B_o = _oriented(acc, E[sel], B[sel], sw)
        _backproject_marching_y(sino[sel], E_o, B_o, geom, vol_o)
    return acc

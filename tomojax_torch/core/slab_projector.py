"""Slab-marching projector family, plane quadrature.

Counterpart of ``tomojax.core.slab_projector``. The parallel-beam transform
is a scan over volume slabs perpendicular to the dominant march axis; for
each slab every ray's intersection is affine in the detector indices, so
the per-slab work is two 1-D interpolation passes:

- pass A z-lerps slab row ``r`` at ``ζ_r(x, v) = cz_r + gzx·(x − cx_r) +
  zav·v`` on the voxel-x grid;
- pass B x-lerps that result at ``X_r(u, v) = cx_r + eux·u + evx·v``;
- the sum over slabs is scaled by ``1/edy`` (plane quadrature: one sample
  per slab plane).

The spec is tomojax's XLA path (``_forward_oriented_xla``, plane branch),
not its Pallas kernel. :func:`forward_oriented` is that spec in PyTorch; it
is the plain version of the CUDA kernels in ``tomojax_torch.kernels.slab``.

Views are grouped host-side by orientation ``(swap x/y, flip y, flip u)``
so that ``edy > 0`` and ``eux > 0`` in each group's oriented frame. The
per-view scalars are computed in float64 numpy (:func:`slab_scalars_np`).
Arc quadrature is not ported yet (ROADMAP Queue 2 K3/K4).
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.core.geometry import Geometry, Views

# ---- per-view scalar layout (the kernels read the same columns) ----------
NS = 21
(S_EDY, S_EDX, S_EDZ, S_RX, S_RZ, S_EUX, S_EVX, S_EVZ, S_CXB, S_CZB,
 S_GZX, S_B1, S_EUY, S_EVY, S_INV_EDY, S_WAX, S_WAV, S_SCALE, S_INV_EUX,
 S_EUYIEUX, S_ZAV) = range(NS)

_PERM_SWAP = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)

ARC_NOT_PORTED = "arc quadrature: ROADMAP Queue 2 K3/K4"


def _check_quad(quad: str):
    if quad == "arc":
        raise NotImplementedError(ARC_NOT_PORTED)
    if quad != "plane":
        raise ValueError(f"unknown quadrature {quad!r}")


# ----------------------------------------------------------------------
# Host side (numpy float64)
# ----------------------------------------------------------------------


def _np_rot(phi, alpha, beta):
    """(n, 3, 3) rotation R = R_z(phi) R_x(alpha) R_y(beta), numpy f64."""
    cp, sp = np.cos(phi), np.sin(phi)
    ca, sa = np.cos(alpha), np.sin(alpha)
    cb, sb = np.cos(beta), np.sin(beta)
    z = np.zeros(np.shape(cp))
    o = np.ones(np.shape(cp))
    Rz = np.stack([np.stack([cp, -sp, z], -1), np.stack([sp, cp, z], -1),
                   np.stack([z, z, o], -1)], -2)
    Rx = np.stack([np.stack([o, z, z], -1), np.stack([z, ca, -sa], -1),
                   np.stack([z, sa, ca], -1)], -2)
    Ry = np.stack([np.stack([cb, z, sb], -1), np.stack([z, o, z], -1),
                   np.stack([-sb, z, cb], -1)], -2)
    return Rz @ Rx @ Ry


def _views_np(views) -> dict:
    return views.numpy() if isinstance(views, Views) else {
        k: np.asarray(v, np.float64) for k, v in views.items()}


def _np_oriented_E(geom: Geometry, views):
    """Per-view oriented affine columns: ``(E (n,3,3), swap, yflip,
    uflip)`` with EDy > 0 and EUx' > 0 in the oriented frame. E columns
    are (EU, EV, ED)."""
    vw = _views_np(views)
    R = _np_rot(vw["phi"], vw["alpha"], vw["beta"])
    du, dv = geom.det_pix
    E = np.stack([du * R[:, :, 0], dv * R[:, :, 2],
                  geom.step_size * R[:, :, 1]], axis=-1)
    swap = np.abs(E[:, 0, 2]) > np.abs(E[:, 1, 2])
    Eo = E.copy()
    Eo[swap] = Eo[swap][:, [1, 0, 2], :]
    yflip = Eo[:, 1, 2] < 0.0
    Eo[yflip, 1, :] *= -1.0
    rx = Eo[:, 0, 2] / Eo[:, 1, 2]
    eux = Eo[:, 0, 0] - rx * Eo[:, 1, 0]
    uflip = eux < 0.0
    Eo[uflip, :, 0] *= -1.0
    return Eo, swap, yflip, uflip


def orient_flags(views, geom: Geometry):
    """Per-view orientation flags ``(swap, yflip, uflip)`` (numpy bools).

    Swap iff ``|ED_x| > |ED_y|``; y-flip makes the march direction +y of
    the oriented volume; u-flip makes the in-plane x per detector-u slope
    positive (an exact detector-row permutation)."""
    _, swap, yflip, uflip = _np_oriented_E(geom, views)
    return swap, yflip, uflip


def orient_volume(vol, geom: Geometry, swap: bool, yflip: bool):
    """Volume variant of an orientation group (a view, not a copy)."""
    v = vol.reshape(geom.vox_shape)
    if swap:
        v = v.transpose(0, 1)
    if yflip:
        v = v.flip(1)
    return v


def unorient_volume(vol_or, swap: bool, yflip: bool):
    """Inverse of :func:`orient_volume` (a view, not a copy)."""
    if yflip:
        vol_or = vol_or.flip(1)
    if swap:
        vol_or = vol_or.transpose(0, 1)
    return vol_or


def slab_scalars_np(geom: Geometry, views, swap: bool, yflip: bool,
                    uflip: bool, quad: str = "plane") -> np.ndarray:
    """(V, NS) kernel scalar vectors in float64 numpy."""
    vw = _views_np(views)
    phi, alpha, beta = vw["phi"], vw["alpha"], vw["beta"]
    t, cor = vw["t"], vw["cor"]
    R = _np_rot(phi, alpha, beta)
    Rpa = _np_rot(phi, alpha, np.zeros_like(beta))
    du, dv = geom.det_pix
    E = np.stack([du * R[:, :, 0], dv * R[:, :, 2],
                  geom.step_size * R[:, :, 1]], axis=-1)
    nu, nv = geom.det_shape
    su, sv = geom.det_size
    s0 = np.stack([np.full_like(phi, -su / 2.0 + 0.5) + cor[:, 0],
                   np.full_like(phi, -geom.vox_size[1]),
                   np.full_like(phi, -sv / 2.0 + 0.5)], axis=-1)
    origin = geom.vox_origin_np()
    B = (np.einsum("nij,nj->ni", R, s0)
         + np.einsum("nij,nj->ni", Rpa, t) - origin[None, :])

    nx, ny, nz = geom.vox_shape
    ny_o = ny
    if swap:
        E = np.einsum("ij,njk->nik", _PERM_SWAP, E)
        B = np.einsum("ij,nj->ni", _PERM_SWAP, B)
        ny_o = nx
    if yflip:
        B[:, 1] = (ny_o - 1.0) - B[:, 1]
        E[:, 1, :] *= -1.0
    if uflip:
        B = B + (nu - 1.0) * E[:, :, 0]
        E[:, :, 0] *= -1.0

    EU, EV, ED = E[:, :, 0], E[:, :, 1], E[:, :, 2]
    edy = ED[:, 1]
    rx = ED[:, 0] / edy
    rz = ED[:, 2] / edy
    eux = EU[:, 0] - rx * EU[:, 1]
    evx = EV[:, 0] - rx * EV[:, 1]
    euz = EU[:, 2] - rz * EU[:, 1]
    evz = EV[:, 2] - rz * EV[:, 1]
    gzx = euz / eux
    inv_edy = 1.0 / edy
    inv_eux = 1.0 / eux
    euy_ieux = EU[:, 1] * inv_eux
    sc = np.zeros((len(phi), NS), np.float64)
    sc[:, S_EDY] = edy
    sc[:, S_EDX] = ED[:, 0]
    sc[:, S_EDZ] = ED[:, 2]
    sc[:, S_RX] = rx
    sc[:, S_RZ] = rz
    sc[:, S_EUX] = eux
    sc[:, S_EVX] = evx
    sc[:, S_EVZ] = evz
    sc[:, S_CXB] = B[:, 0] - rx * B[:, 1]
    sc[:, S_CZB] = B[:, 2] - rz * B[:, 1]
    sc[:, S_GZX] = gzx
    sc[:, S_B1] = B[:, 1]
    sc[:, S_EUY] = EU[:, 1]
    sc[:, S_EVY] = EV[:, 1]
    sc[:, S_INV_EDY] = inv_edy
    sc[:, S_WAX] = -euy_ieux * inv_edy
    sc[:, S_WAV] = (euy_ieux * evx - EV[:, 1]) * inv_edy
    sc[:, S_SCALE] = (inv_edy if quad == "plane" else 1.0)
    sc[:, S_INV_EUX] = inv_eux
    sc[:, S_EUYIEUX] = euy_ieux
    sc[:, S_ZAV] = evz - gzx * evx
    return sc


def params_from_scalars(sc) -> dict:
    """Named per-view scalars from ``(..., NS)`` rows (the names of
    tomojax's ``SlabParams``)."""
    return dict(edy=sc[..., S_EDY], edx=sc[..., S_EDX], edz=sc[..., S_EDZ],
                rx=sc[..., S_RX], rz=sc[..., S_RZ], eux=sc[..., S_EUX],
                evx=sc[..., S_EVX], euz=sc[..., S_GZX] * sc[..., S_EUX],
                evz=sc[..., S_EVZ], cxb=sc[..., S_CXB], czb=sc[..., S_CZB],
                gzx=sc[..., S_GZX], b1=sc[..., S_B1], euy=sc[..., S_EUY],
                evy=sc[..., S_EVY])


def _orient_groups(views, geom: Geometry):
    swaps, yflips, uflips = orient_flags(views, geom)
    for sw in (False, True):
        for yf in (False, True):
            for uf in (False, True):
                idx = np.nonzero((swaps == sw) & (yflips == yf)
                                 & (uflips == uf))[0]
                if idx.size:
                    yield idx, sw, yf, uf


def _take(views_np: dict, idx) -> dict:
    return {k: v[idx] for k, v in views_np.items()}


def scalar_groups(geom: Geometry, views, quad: str = "plane", *,
                  dtype=torch.float32, device=None):
    """Host-side split of views into orientation groups.

    :returns: ``(gstruct, scalars)``: ``gstruct`` is a tuple of per-group
        ``(view_indices, swap, yflip, uflip)`` and ``scalars`` a matching
        tuple of ``(V_g, NS)`` tensors of ``dtype`` on ``device``."""
    _check_quad(quad)
    vw = _views_np(views)
    gstruct, scalars = [], []
    for idx, sw, yf, uf in _orient_groups(vw, geom):
        sc = slab_scalars_np(geom, _take(vw, idx), sw, yf, uf, quad)
        gstruct.append((tuple(int(i) for i in idx), bool(sw), bool(yf),
                        bool(uf)))
        scalars.append(torch.as_tensor(sc, dtype=dtype, device=device))
    return tuple(gstruct), tuple(scalars)


def group_scalars_for(geom: Geometry, views, gstruct, quad: str = "plane",
                      *, dtype=torch.float32, device=None):
    """Recompute the scalars for a FIXED group structure. Returns ``None``
    when a view leaves its group's valid frame (``edy > 0``, ``eux > 0``);
    the caller then regroups with :func:`scalar_groups`."""
    _check_quad(quad)
    vw = _views_np(views)
    scalars = []
    for idx, sw, yf, uf in gstruct:
        sc = slab_scalars_np(geom, _take(vw, np.asarray(idx)), sw, yf, uf,
                             quad)
        if not (np.all(sc[:, S_EDY] > 0.0) and np.all(sc[:, S_EUX] > 0.0)):
            return None
        scalars.append(torch.as_tensor(sc, dtype=dtype, device=device))
    return tuple(gstruct), tuple(scalars)


# ----------------------------------------------------------------------
# Plain path (the spec; runs on any device in float32 or float64)
# ----------------------------------------------------------------------


def _lerp_rows(arr, pos):
    """``out[..., i] = lerp(arr[..., :], pos[..., i])``, zero outside
    ``[0, N)`` with per-tap bounds guards: tap ``k = floor(pos)`` gets
    weight ``1 − w`` and tap ``k + 1`` weight ``w``."""
    N = arr.shape[-1]
    arr = arr.expand(*pos.shape[:-1], N)
    f = torch.floor(pos)
    k = f.long()
    w = pos - f
    out = torch.zeros_like(pos)
    for o in (0, 1):
        kk = k + o
        inb = (kk >= 0) & (kk < N)
        wgt = w if o else 1.0 - w
        v = torch.gather(arr, -1, kk.clamp(0, N - 1))
        out = out + torch.where(inb, wgt * v, 0.0)
    return out


def _forward_chunk(vol_or, sc, nu: int, nv: int):
    """Plane forward of ``c`` views: ``vol_or`` (nx, ny, nz), ``sc``
    (c, NS) → (c, nu, nv). All slabs at once: intermediates are
    (c, ny, nx, nv) and (c, ny, nv, nu)."""
    nx, ny, nz = vol_or.shape
    c = sc.shape[0]
    kw = dict(dtype=vol_or.dtype, device=vol_or.device)
    sc = sc.to(vol_or.dtype)

    def p(i):
        return sc[:, i].reshape(c, 1, 1, 1)

    s = torch.arange(ny, **kw).reshape(1, ny, 1, 1)
    cx = p(S_CXB) + p(S_RX) * s                                # (c, ny, 1, 1)
    cz = p(S_CZB) + p(S_RZ) * s
    x = torch.arange(nx, **kw).reshape(1, 1, nx, 1)
    vz = torch.arange(nv, **kw).reshape(1, 1, 1, nv)
    zeta = cz + p(S_GZX) * (x - cx) + vz * p(S_ZAV)           # (c, ny, nx, nv)
    tA = _lerp_rows(vol_or.permute(1, 0, 2), zeta)            # (c, ny, nx, nv)
    v = torch.arange(nv, **kw).reshape(1, 1, nv, 1)
    u = torch.arange(nu, **kw).reshape(1, 1, 1, nu)
    X = cx + p(S_EVX) * v + p(S_EUX) * u                      # (c, ny, nv, nu)
    out = _lerp_rows(tA.transpose(-1, -2), X)                 # (c, ny, nv, nu)
    return out.sum(1).transpose(1, 2) * sc[:, S_SCALE].reshape(c, 1, 1)


def _view_chunk(vol_shape, det_shape) -> int:
    nx, ny, nz = vol_shape
    return max(1, (1 << 24) // (nx * ny * max(det_shape + (nz,))))


def forward_oriented(vol_or, scalars, geom: Geometry):
    """Plain plane forward of one orientation group: ``vol_or`` (nx, ny,
    nz), ``scalars`` (V, NS) → (V, nu, nv), chunked over views."""
    nu, nv = geom.det_shape
    c = _view_chunk(vol_or.shape, geom.det_shape)
    return torch.cat([_forward_chunk(vol_or, scalars[i:i + c], nu, nv)
                      for i in range(0, scalars.shape[0], c)])


def adjoint_oriented(g, scalars, geom: Geometry):
    """Plain adjoint of :func:`forward_oriented`: autograd's vjp of the
    linear forward, chunked over views → oriented volume (nx, ny, nz)."""
    nu, nv = geom.det_shape
    c = _view_chunk(geom.vox_shape, geom.det_shape)
    out = torch.zeros(geom.vox_shape, dtype=g.dtype, device=g.device)
    for i in range(0, scalars.shape[0], c):
        with torch.enable_grad():
            x = torch.zeros(geom.vox_shape, dtype=g.dtype, device=g.device,
                            requires_grad=True)
            y = _forward_chunk(x, scalars[i:i + c], nu, nv)
            (gx,) = torch.autograd.grad(y, x, g[i:i + c])
        out += gx
    return out


# ----------------------------------------------------------------------
# Multi-view apply
# ----------------------------------------------------------------------


def _check_square(geom: Geometry):
    nx, ny, _ = geom.vox_shape
    if nx != ny:
        raise ValueError("slab family requires nx == ny (square x-y "
                         f"footprint); got {geom.vox_shape}")


def project_scalars(vol, geom: Geometry, gstruct, scalars):
    """Multi-view plane forward → ``(n_proj, n_det)``; each group goes
    through :class:`tomojax_torch.kernels.slab.SlabPlane` (K1 forward, K2
    backward)."""
    from tomojax_torch.kernels import slab as slabk
    _check_square(geom)
    n = sum(len(g[0]) for g in gstruct)
    nu, nv = geom.det_shape
    vol = vol.reshape(geom.vox_shape)
    out = vol.new_zeros((n, nu, nv))
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        vol_or = orient_volume(vol, geom, sw, yf).contiguous()
        sino = slabk.SlabPlane.apply(vol_or, sc, geom)
        if uf:
            sino = sino.flip(1)
        out[torch.as_tensor(idx, device=out.device)] = sino
    return out.reshape(n, geom.n_det)


def backproject_scalars(sino, geom: Geometry, gstruct, scalars):
    """Exact adjoint of :func:`project_scalars` → volume ``vox_shape``;
    each group goes through K2 (``slab_backproject``)."""
    from tomojax_torch.kernels import slab as slabk
    _check_square(geom)
    nu, nv = geom.det_shape
    sino = sino.reshape(-1, nu, nv)
    vol = sino.new_zeros(geom.vox_shape)
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        g = sino[torch.as_tensor(idx, device=sino.device)]
        if uf:
            g = g.flip(1)
        vb = slabk.slab_backproject(g.contiguous(), sc, geom)
        vol += unorient_volume(vb, sw, yf)
    return vol


def project(vol, geom: Geometry, views, *, dtype=torch.float32,
            quad: str = "plane", device=None):
    """Multi-view slab forward → ``(n_proj, n_det)``."""
    device = vol.device if device is None else device
    gstruct, scalars = scalar_groups(geom, views, quad, dtype=dtype,
                                     device=device)
    return project_scalars(vol.to(device=device, dtype=dtype), geom,
                           gstruct, scalars)


def backproject(sino, geom: Geometry, views, *, dtype=torch.float32,
                quad: str = "plane", device=None):
    """Exact adjoint of :func:`project` → volume ``vox_shape``."""
    device = sino.device if device is None else device
    gstruct, scalars = scalar_groups(geom, views, quad, dtype=dtype,
                                     device=device)
    return backproject_scalars(sino.to(device=device, dtype=dtype), geom,
                               gstruct, scalars)

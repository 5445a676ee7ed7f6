"""The plain reference of the arc-quadrature slab operator (tomojax's
``quad="arc"``, ``tomojax/core/slab_projector.py``) for views with all six
rigid parameters, as PyTorch gathers in blocks of views.

Geometry (unit voxels, detector pixels and march step): detector pixel
``(u, v)`` of a view ``θ = (tx, ty, tz, φ, α, β)`` casts the ray ``p(j) = B
+ u·EU + v·EV + j·ED`` (``j`` = 0 … n_steps − 1, n_steps = 2·ny) through
voxel-index space, with ``R = R_z(φ) R_x(α) R_y(β)``, ``EU = R x̂``, ``EV =
R ẑ``, ``ED = R ŷ`` and ``B = R s0 + R_z(φ) R_x(α) t − origin``, ``s0 =
(−nu/2 + ½, −ny, −nv/2 + ½)``, ``origin = (−nx/2 + ½, −ny/2 + ½, −nz/2 +
½)``.

Each view is marched in an oriented frame: x and y swapped where |ED_x| >
|ED_y|, y flipped where ED_y < 0 (after the swap) and detector u reversed
where the in-plane slope ``eux`` would be negative; the flags are a view's
own (:func:`flags`), or frozen ones handed in, as the alternating driver
freezes them at its first outer. In that frame, per source slab ``r = −1 …
ny − 1`` and branch ``b = 0, 1``, the march index is ``j = ceil((r −
y0(u, v))/edy) + b``, ``y0 = b1 + u·euy + v·evy``; the sample blends the
slab pair as ``(1 − fy)·s_r + fy·s_{r+1}``, ``fy = edy·cfb`` with the ceil
sawtooth ``cfb = j − (r − y0)/edy``, masked to ``0 ≤ j < n_steps`` and
``fy < 1``. Slab ``s`` is read in two passes: pass A lerps each voxel row
along z at ``ζ = cz_r + gzx·(x − cx_r − v·evx) + v·evz + edz·(cf_xv + b)``
on the voxel-x grid (``cf_xv`` the sawtooth at the affine inversion
``u_aff(x, v)``), pass B lerps that table along x at ``X = cx_r + u·eux +
v·evx + edx·cfb``. Taps outside the volume read 0; there is no scale.

Everything is float32 by default (``dtype=torch.float64`` on demand). The
adjoint is the transpose of the same gathers, as scatter-adds (the vjp of
the forward); the Jacobian of the forward in the refined parameters is its
forward-mode derivative (``torch.func.jvp``), which the CPU tests hold to
tomojax's analytic ``forward_view_jac``. This file imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK_VIEWS = 8
# the names of the per-view scalars of the oriented frame
FIELDS = ("edy", "edx", "edz", "rx", "rz", "eux", "evx", "evz", "cxb",
          "czb", "gzx", "b1", "euy", "evy")


def _rot(phi, alpha, beta):
    """``(R_z(φ) R_x(α), R)`` as ``(..., 3, 3)`` tensors."""
    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    o, z = torch.ones_like(phi), torch.zeros_like(phi)
    cp, sp = torch.cos(phi), torch.sin(phi)
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    cb, sb = torch.cos(beta), torch.sin(beta)
    rz = mat([[cp, -sp, z], [sp, cp, z], [z, z, o]])
    rx = mat([[o, z, z], [z, ca, -sa], [z, sa, ca]])
    ry = mat([[cb, z, sb], [z, o, z], [-sb, z, cb]])
    rpa = rz @ rx
    return rpa, rpa @ ry


def affine(theta, vox_shape, det_shape):
    """``(E (V, 3, 3), B (V, 3))`` of views ``theta (V, 6)``: E's columns
    are EU, EV, ED."""
    nx, ny, nz = vox_shape
    nu, nv = det_shape
    rpa, R = _rot(theta[:, 3], theta[:, 4], theta[:, 5])
    s0 = theta.new_tensor([-nu / 2 + 0.5, -ny, -nv / 2 + 0.5])
    origin = theta.new_tensor([-nx / 2 + 0.5, -ny / 2 + 0.5, -nz / 2 + 0.5])
    B = R @ s0 + (rpa @ theta[:, :3, None])[..., 0] - origin
    E = torch.stack([R[..., 0], R[..., 2], R[..., 1]], -1)
    return E, B


def flags(theta, vox_shape, det_shape) -> np.ndarray:
    """Each view's own orientation ``(V, 3)`` booleans (swap, yflip,
    uflip), from float64 ``theta``."""
    E, _ = affine(torch.as_tensor(theta, dtype=torch.float64).cpu(),
                  vox_shape, det_shape)
    E = E.numpy()
    swap = np.abs(E[:, 0, 2]) > np.abs(E[:, 1, 2])
    E[swap] = E[swap][:, [1, 0, 2], :]
    yflip = E[:, 1, 2] < 0.0
    E[yflip, 1, :] *= -1.0
    eux = E[:, 0, 0] - E[:, 0, 2] / E[:, 1, 2] * E[:, 1, 0]
    return np.stack([swap, yflip, eux < 0.0], 1)


def scalars(theta, flg, vox_shape, det_shape) -> dict:
    """The oriented per-view scalars (:data:`FIELDS`, each ``(V,)``) of
    views ``theta (V, 6)`` under orientation flags ``flg (V, 3)``;
    differentiable in ``theta``."""
    ny = vox_shape[1]
    nu = det_shape[0]
    E, B = affine(theta, vox_shape, det_shape)
    f = torch.as_tensor(np.asarray(flg), device=theta.device)
    sw, yf, uf = f[:, 0, None], f[:, 1, None], f[:, 2, None]
    E = torch.where(sw[..., None], E[:, [1, 0, 2], :], E)
    B = torch.where(sw, B[:, [1, 0, 2]], B)
    sy = torch.where(yf, -1.0, 1.0).to(theta.dtype)
    E = torch.stack([E[:, 0], E[:, 1] * sy, E[:, 2]], 1)
    B = torch.stack([B[:, 0], torch.where(yf[:, 0], (ny - 1.0) - B[:, 1],
                                          B[:, 1]), B[:, 2]], 1)
    B = torch.where(uf, B + (nu - 1.0) * E[..., 0], B)
    su = torch.where(uf, -1.0, 1.0).to(theta.dtype)
    E = torch.stack([E[..., 0] * su, E[..., 1], E[..., 2]], -1)
    EU, EV, ED = E[..., 0], E[..., 1], E[..., 2]
    edy = ED[:, 1]
    rx, rz = ED[:, 0] / edy, ED[:, 2] / edy
    eux = EU[:, 0] - rx * EU[:, 1]
    return dict(edy=edy, edx=ED[:, 0], edz=ED[:, 2], rx=rx, rz=rz, eux=eux,
                evx=EV[:, 0] - rx * EV[:, 1], evz=EV[:, 2] - rz * EV[:, 1],
                cxb=B[:, 0] - rx * B[:, 1], czb=B[:, 2] - rz * B[:, 1],
                gzx=(EU[:, 2] - rz * EU[:, 1]) / eux, b1=B[:, 1],
                euy=EU[:, 1], evy=EV[:, 1])


def _taps(pos, n: int):
    """The lerp at ``pos`` on a grid of ``n`` points padded by a zero at
    each end: ``(k0, k1, w)``, the padded indices of the taps ``floor(pos)``
    and ``floor(pos) + 1`` (clamped onto the pads outside the grid) and
    the weight of the second."""
    f = torch.floor(pos)
    k = f.long()
    return (k + 1).clamp_(0, n + 1), (k + 2).clamp_(0, n + 1), pos - f


class _Block:
    """Positions and weights of a block of views sharing (swap, yflip), in
    the oriented frame, for each branch; ``p`` holds ``(c, 1, 1, 1)``
    scalars."""

    def __init__(self, p, shape, det, n_steps, dtype):
        nx, ny, nz = shape
        nu, nv = det
        dev = p["edy"].device
        self.shape, self.det = shape, det
        r = torch.arange(-1, ny, dtype=dtype, device=dev).reshape(1, -1, 1, 1)
        x = torch.arange(-1, nx + 1, dtype=dtype, device=dev
                         ).reshape(1, 1, -1, 1)
        u = torch.arange(nu, dtype=dtype, device=dev).reshape(1, 1, -1, 1)
        v = torch.arange(nv, dtype=dtype, device=dev).reshape(1, 1, 1, -1)
        cx = p["cxb"] + p["rx"] * r
        cz = p["czb"] + p["rz"] * r
        # pass A on the grid x = -1 … nx (the ends read zero rows)
        xr = x - cx - v * p["evx"]
        jr = (r - (p["b1"] + xr / p["eux"] * p["euy"] + v * p["evy"])
              ) / p["edy"]
        self.cf_xv = torch.ceil(jr) - jr
        self.zeta_aff = cz + p["gzx"] * xr + v * p["evz"]
        # pass B at each detector pixel
        jreal = (r - (p["b1"] + u * p["euy"] + v * p["evy"])) / p["edy"]
        self.jreal = jreal
        self.jb = torch.ceil(jreal)
        self.x0 = cx + u * p["eux"] + v * p["evx"]
        self.p, self.n_steps = p, n_steps

    def branch(self, b: int):
        """``(zeta, X, fy, ok)`` of branch ``b``."""
        p = self.p
        j = self.jb + b
        cfb = j - self.jreal
        fy = p["edy"] * cfb
        ok = (j >= 0) & (j < self.n_steps) & (fy < 1.0)
        return (self.zeta_aff + p["edz"] * (self.cf_xv + b),
                self.x0 + p["edx"] * cfb, fy, ok)


def _pad_slabs(vol_or):
    """``(ny + 2, nx + 2, nz + 2)``: the slabs (oriented y first) with a
    zero slab at r = −1 and r = ny and zero borders in x and z."""
    return torch.nn.functional.pad(vol_or.permute(1, 0, 2), (1, 1, 1, 1, 1, 1))


def _block_forward(slabs, blk, n_branch: int):
    """The forward of one block → ``(c, nu, nv)`` in the oriented u."""
    nx, ny, nz = blk.shape
    c = blk.p["edy"].shape[0]
    src = [slabs[s:s + ny + 1].expand(c, -1, -1, -1) for s in (0, 1)]
    out = 0.0
    for b in range(n_branch):
        zeta, X, fy, ok = blk.branch(b)
        kz0, kz1, wz = _taps(zeta, nz)
        kx0, kx1, wx = _taps(X, nx)
        vals = []
        for s in (0, 1):
            t = torch.lerp(torch.gather(src[s], 3, kz0),
                           torch.gather(src[s], 3, kz1), wz)
            vals.append(torch.lerp(torch.gather(t, 2, kx0),
                                   torch.gather(t, 2, kx1), wx))
        out = out + torch.where(ok, torch.lerp(vals[0], vals[1], fy),
                                0.0).sum(1)
    return out


def _block_adjoint(g, slabs_bar, blk, n_branch: int):
    """Add the transpose of :func:`_block_forward` applied to ``g (c, nu,
    nv)`` (oriented u) into ``slabs_bar`` (the padded slabs' shape)."""
    nx, ny, nz = blk.shape
    c = g.shape[0]
    g = g[:, None]
    for b in range(n_branch):
        zeta, X, fy, ok = blk.branch(b)
        kz0, kz1, wz = _taps(zeta, nz)
        kx0, kx1, wx = _taps(X, nx)
        gb = torch.where(ok, g, 0.0)
        v1 = fy * gb
        for s, vs in ((0, gb - v1), (1, v1)):
            t = g.new_zeros(c, ny + 1, nx + 2, blk.det[1])
            t.scatter_add_(2, kx0, vs - wx * vs)
            t.scatter_add_(2, kx1, wx * vs)
            dst = slabs_bar[s:s + ny + 1]
            for i in range(c):
                dst.scatter_add_(2, kz0[i], t[i] - wz[i] * t[i])
                dst.scatter_add_(2, kz1[i], wz[i] * t[i])


class ArcOperator:
    """``A`` (volume ``(nx, ny, nz)`` → sinogram ``(V, nu, nv)``), ``AT``
    and ``value_jac`` of the arc operator at views ``theta (V, 6)``, each
    view marched in the frame of ``flg`` (default: its own,
    :func:`flags`)."""

    def __init__(self, cfg: dict, theta, device, flg=None,
                 dtype=torch.float32, block: int = BLOCK_VIEWS):
        nx, ny, nz = self.shape = tuple(cfg["vox_shape"])
        self.cfg = cfg
        self.det = tuple(cfg["det_shape"])
        if nx != ny:
            raise ValueError("the slab operator needs nx == ny")
        theta = torch.as_tensor(theta, dtype=torch.float64).to(device)
        self.dtype = dtype
        self.flg = (flags(theta, self.shape, self.det) if flg is None
                    else np.asarray(flg, bool))
        self.n_views = theta.shape[0]
        self.n_steps = 2 * ny
        self.n_branch = int(math.ceil(math.sqrt(2.0) + 0.01))
        self.block = block
        sc = scalars(theta, self.flg, self.shape, self.det)
        self.sc = {k: v.to(dtype) for k, v in sc.items()}
        # views by their oriented volume, in blocks
        self.groups = []
        for sw in (False, True):
            for yf in (False, True):
                idx = np.nonzero((self.flg[:, 0] == sw)
                                 & (self.flg[:, 1] == yf))[0]
                for i in range(0, len(idx), block):
                    self.groups.append((sw, yf, idx[i:i + block]))

    def _orient(self, vol, sw, yf):
        v = vol.transpose(0, 1) if sw else vol
        return v.flip(1) if yf else v

    def _blk(self, sc, ix):
        p = {k: sc[k][ix].reshape(-1, 1, 1, 1) for k in FIELDS}
        return _Block(p, self.shape, self.det, self.n_steps, self.dtype)

    def _uflip(self, out, ix):
        uf = torch.as_tensor(self.flg[ix, 2], device=out.device)
        return torch.where(uf[:, None, None], out.flip(1), out)

    @torch.no_grad()
    def A(self, vol):
        vol = vol.reshape(self.shape).to(self.dtype)
        out = vol.new_empty(self.n_views, *self.det)
        for sw, yf, ix in self.groups:
            slabs = _pad_slabs(self._orient(vol, sw, yf))
            t = torch.as_tensor(ix, device=vol.device)
            out[t] = self._uflip(_block_forward(slabs, self._blk(self.sc, ix),
                                                self.n_branch), ix)
        return out

    @torch.no_grad()
    def AT(self, y):
        y = y.reshape(self.n_views, *self.det).to(self.dtype)
        vol = y.new_zeros(self.shape)
        nx, ny, nz = self.shape
        for sw, yf, ix in self.groups:
            t = torch.as_tensor(ix, device=y.device)
            bar = y.new_zeros(ny + 2, nx + 2, nz + 2)
            _block_adjoint(self._uflip(y[t], ix), bar,
                           self._blk(self.sc, ix), self.n_branch)
            s = bar[1:ny + 1, 1:nx + 1, 1:nz + 1].permute(1, 0, 2)
            s = s.flip(1) if yf else s
            vol += s.transpose(0, 1) if sw else s
        return vol

    def value_jac(self, vol, theta, cols):
        """``(value (V, nu, nv), jac (V, len(cols), nu, nv))``: the forward
        at views ``theta (V, 6)`` (this operator's frames) and its
        derivative in the parameters ``cols``."""
        vol = vol.reshape(self.shape).to(self.dtype)
        theta = torch.as_tensor(theta, dtype=torch.float64).to(vol.device)
        val = vol.new_empty(self.n_views, *self.det)
        jac = vol.new_empty(self.n_views, len(cols), *self.det)
        eye = torch.eye(6, dtype=theta.dtype, device=vol.device)[list(cols)]
        for sw, yf, ix in self.groups:
            slabs = _pad_slabs(self._orient(vol, sw, yf))
            t = torch.as_tensor(ix, device=vol.device)
            th = theta[t]

            def fwd(th):
                sc = scalars(th, self.flg[ix], self.shape, self.det)
                blk = self._blk({k: v.to(self.dtype) for k, v in sc.items()},
                                slice(None))
                return _block_forward(slabs, blk, self.n_branch)

            def tangent(e):
                return torch.func.jvp(fwd, (th,), (e.expand_as(th),))

            v, d = torch.func.vmap(tangent, out_dims=(None, 0))(eye)
            val[t] = self._uflip(v, ix)
            jac[t] = self._uflip(d.transpose(0, 1).flatten(0, 1),
                                 np.repeat(ix, len(cols))).reshape(
                len(ix), len(cols), *self.det)
        return val, jac

"""The plain reference of the plane-quadrature slab operator, for views
that turn about the z axis only (α = β = 0), as configuration 5's do.

Geometry (unit voxels and detector pixels, a square x-y footprint):
detector pixel ``(u, v)`` of a view at angle φ with shift ``t`` casts the
ray ``p(j) = B + u·EU + v·EV + j·ED`` through voxel-index space, with
``EU = (cos φ, sin φ, 0)``, ``EV = (0, 0, 1)``, ``ED = (−sin φ, cos φ,
0)`` and ``B = R_z(φ)·(s0 + t) − origin``, ``s0 = (−nu/2 + ½, −ny, −nv/2 +
½)``, ``origin = (−nx/2 + ½, −ny/2 + ½, −nz/2 + ½)``. The ray marches the
slabs across its dominant axis (y where |cos φ| ≥ |sin φ|, else x); in
slab ``m`` its sample sits at ``pos(u, m) = a0 + u·du + m·dm`` along the
other in-plane axis and at ``ζ(v) = B_z + v`` in z. Plane quadrature
reads each sample by the 2 × 2 lerp of its slab (taps outside the volume
read 0) and scales the sum over slabs by ``1 / |ED_major|``.

Because ``ζ`` does not depend on the slab or on ``u``, the z-lerp is the
same for the whole view: the forward is ``scale · Z_v(W_v · vol)``, with
``W_v`` the sparse in-plane lerp matrix (``nu × nx·ny``, two weights per
ray and slab) and ``Z_v`` the z-lerp; the adjoint is the transpose. The
sparse products are ``torch.sparse.mm``.

``tier`` gives the rounding of a tier that rounds each pass's input:
``"bf16"`` rounds the volume before the z-lerp and its result before the
in-plane lerp (the adjoint: the cotangent before the in-plane transpose
and its result before the z transpose), ``"fp8"`` does the same in
float8 (e4m3, each rounded tensor scaled by a power of two to the format's
range). ``"f32"`` rounds nothing. This file imports nothing of the
program.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

TIERS = {"f32": None, "bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
BLOCK_VIEWS = 32


def _round(t, dtype):
    """``t`` rounded to ``dtype``; float8 with a per-tensor power-of-two
    scale that puts the largest magnitude at the top of its range, as
    float8 pipelines scale (unscaled, a volume's values overflow it)."""
    if dtype is None:
        return t
    if dtype.itemsize > 1:
        return t.to(dtype).to(t.dtype)
    amax = float(t.abs().max())
    if amax == 0.0:
        return t
    scale = 2.0 ** math.floor(math.log2(torch.finfo(dtype).max / amax))
    return (t * scale).to(dtype).to(t.dtype) / scale


class PlaneOperator:
    """``A`` (volume → sinogram ``(V, nu, nv)``) and ``AT`` of the plane
    slab operator for views ``phi (V,)``, ``t (V, 3)`` (float64)."""

    def __init__(self, cfg: dict, phi, t, device, tier: str = "f32"):
        nx, ny, nz = cfg["vox_shape"]
        nu, nv = cfg["det_shape"]
        if nx != ny:
            raise ValueError("the slab operator needs nx == ny")
        self.shape = (nx, ny, nz)
        self.det = (nu, nv)
        self.device = device
        self.rnd = TIERS[tier]
        phi = np.asarray(phi, np.float64)
        t = np.asarray(t, np.float64)
        c, s = np.cos(phi), np.sin(phi)
        q = t + np.array([-nu / 2 + 0.5, -ny, -nv / 2 + 0.5])
        bx = c * q[:, 0] - s * q[:, 1] + (nx / 2 - 0.5)
        by = s * q[:, 0] + c * q[:, 1] + (ny / 2 - 0.5)
        bz = q[:, 2] + (nz / 2 - 0.5)
        xm = np.abs(s) > np.abs(c)
        with np.errstate(divide="ignore", invalid="ignore"):
            a0 = np.where(xm, by + (c / s) * bx, bx + (s / c) * by)
            du = np.where(xm, 1.0 / s, 1.0 / c)
            dm = np.where(xm, -c / s, -s / c)
        scale = 1.0 / np.maximum(np.abs(c), np.abs(s))
        f64 = dict(dtype=torch.float64, device=device)
        self.xm = torch.as_tensor(xm, device=device)
        self.a0 = torch.as_tensor(a0, **f64)
        self.du = torch.as_tensor(du, **f64)
        self.dm = torch.as_tensor(dm, **f64)
        self.scale = torch.as_tensor(scale, dtype=torch.float32,
                                     device=device)
        zeta = (torch.as_tensor(bz, dtype=torch.float32, device=device)[:, None]
                + torch.arange(nv, dtype=torch.float32, device=device))
        fz = torch.floor(zeta)
        self.kz = fz.long()
        self.wz = zeta - fz
        self.n_views = len(phi)
        self._csr = {}

    # ---- the in-plane lerp as a sparse matrix ---------------------------
    def _matrix(self, i0: int, i1: int, transpose: bool):
        key = (i0, i1, transpose)
        if key in self._csr:
            return self._csr[key]
        nx, ny, _ = self.shape
        nu, _ = self.det
        b = i1 - i0
        f64 = dict(dtype=torch.float64, device=self.device)
        u = torch.arange(nu, **f64).reshape(1, nu, 1)
        m = torch.arange(nx, **f64).reshape(1, 1, nx)
        pos = (self.a0[i0:i1, None, None] + self.du[i0:i1, None, None] * u
               + self.dm[i0:i1, None, None] * m)
        k = torch.floor(pos)
        w = pos - k
        k = k.long()
        mi = m.long().expand(b, nu, nx)
        row = (torch.arange(b, device=self.device).reshape(b, 1, 1) * nu
               + torch.arange(nu, device=self.device).reshape(1, nu, 1)
               ).expand(b, nu, nx)
        xm = self.xm[i0:i1].reshape(b, 1, 1)
        rows, cols, vals = [], [], []
        for tap, wt in ((k, 1.0 - w), (k + 1, w)):
            ok = (tap >= 0) & (tap < nx)
            col = torch.where(xm, mi * ny + tap, tap * ny + mi)
            rows.append(row[ok])
            cols.append(col[ok])
            vals.append(wt[ok].float())
        idx = torch.stack([torch.cat(rows), torch.cat(cols)])
        size = (b * nu, nx * ny)
        if transpose:
            idx, size = idx.flip(0), size[::-1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # CSR is "beta"
            mat = torch.sparse_coo_tensor(idx, torch.cat(vals), size,
                                          check_invariants=False
                                          ).coalesce().to_sparse_csr()
        self._csr[key] = mat
        return mat

    def _blocks(self, per_view: bool):
        step = 1 if per_view else BLOCK_VIEWS
        return [(i, min(i + step, self.n_views))
                for i in range(0, self.n_views, step)]

    # ---- the z-lerp and its transpose -----------------------------------
    def _taps(self, i0, i1, nz):
        k, w = self.kz[i0:i1], self.wz[i0:i1]
        return [(kk.clamp(0, nz - 1), torch.where((kk >= 0) & (kk < nz),
                                                  ww, 0.0))
                for kk, ww in ((k, 1.0 - w), (k + 1, w))]

    def _zlerp(self, P, i0, i1):
        """``P (b, rows, nz)`` lerped along z at each view's ζ → ``(b,
        rows, nv)``."""
        out = 0.0
        for k, w in self._taps(i0, i1, P.shape[-1]):
            idx = k[:, None, :].expand(P.shape[0], P.shape[1], -1)
            out = out + w[:, None, :] * torch.gather(P, 2, idx)
        return out

    def _zlerp_t(self, Y, i0, i1, nz):
        """Transpose of :meth:`_zlerp`: ``Y (b, rows, nv)`` → ``(b, rows,
        nz)``."""
        out = Y.new_zeros(Y.shape[0], Y.shape[1], nz)
        for k, w in self._taps(i0, i1, nz):
            idx = k[:, None, :].expand_as(Y)
            out.scatter_add_(2, idx, w[:, None, :] * Y)
        return out

    # ---- the operator ---------------------------------------------------
    @torch.no_grad()
    def A(self, vol):
        nx, ny, nz = self.shape
        nu, nv = self.det
        vol = vol.reshape(nx * ny, nz).float()
        out = vol.new_empty(self.n_views, nu, nv)
        if self.rnd is None:
            for i0, i1 in self._blocks(False):
                P = torch.sparse.mm(self._matrix(i0, i1, False), vol)
                out[i0:i1] = (self._zlerp(P.reshape(i1 - i0, nu, nz), i0, i1)
                              * self.scale[i0:i1, None, None])
            return out
        vr = _round(vol, self.rnd)[None]
        for i0, i1 in self._blocks(True):
            T = _round(self._zlerp(vr, i0, i1)[0], self.rnd)
            P = torch.sparse.mm(self._matrix(i0, i1, False), T)
            out[i0] = P * self.scale[i0]
        return out

    @torch.no_grad()
    def AT(self, y):
        nx, ny, nz = self.shape
        nu, nv = self.det
        y = y.reshape(self.n_views, nu, nv).float()
        vol = y.new_zeros(nx * ny, nz)
        if self.rnd is None:
            for i0, i1 in self._blocks(False):
                Q = self._zlerp_t(y[i0:i1] * self.scale[i0:i1, None, None],
                                  i0, i1, nz)
                vol += torch.sparse.mm(self._matrix(i0, i1, True),
                                       Q.reshape((i1 - i0) * nu, nz))
            return vol.reshape(nx, ny, nz)
        for i0, i1 in self._blocks(True):
            R = _round(y[i0], self.rnd) * self.scale[i0]
            T = _round(torch.sparse.mm(self._matrix(i0, i1, True), R),
                       self.rnd)
            vol += self._zlerp_t(T[None], i0, i1, nz)[0]
        return vol.reshape(nx, ny, nz)

"""The plain reference of the exact ray-driven projector (the reference
project's ray–voxel trilinear projector and its 6-DoF Jacobian), written
from its published definition with ``torch.nn.functional.grid_sample``.

Geometry (unit voxel and detector pitch): the voxel centres of an axis of
``n`` voxels lie at ``i − n/2 + ½``; detector pixel ``(u, v)`` of an ``nu ×
nv`` detector at ``(u − nu/2 + ½, v − nv/2 + ½)`` in (x, z). Its ray runs
from the source point ``s = (x_u, −ny, z_v)`` along ``(0, 2·ny, 0)``
(length ``L = 2·ny``). A view ``θ = (tx, ty, tz, φ, α, β)`` moves the ray
rigidly, ``p ↦ R_z(φ) R_x(α) (R_y(β) p + t)``, so the ray starts at ``p0 =
R_z R_x (R_y s + t)`` and runs along ``d̂ = R_z R_x R_y (0, 2·ny, 0) / L``.
It marches ``n_steps = int(L / step)`` samples ``p0 + j·step·d̂``, ``j = 0 …
n_steps − 1``, in voxel-index coordinates (``p`` less the first voxel's
centre), and sums the volume's trilinear interpolation at them: the 8
corners of each sample with ``floor``/``1 − frac`` weights, a corner kept
only where all three of its indices lie inside the volume.

``grid_sample`` (5-D, ``align_corners=True``, zero padding) is that
interpolation: index ``i`` of an axis of ``n`` is the normalized coordinate
``2i/(n − 1) − 1``, and a corner outside the volume reads 0. The forward
``A`` sums the samples; ``AT`` is the forward's vector-Jacobian product in
the volume (exact by construction); the Jacobian of each pixel's value in
the view's parameters is the gradient of the forward through a copy of θ
per ray (a pixel depends on its own copy alone, so one reverse pass gives
every entry). Everything runs in blocks of views, in float64 by default,
with TF32 off. This file imports nothing of the program.

Departures from the published definition: unit voxel and detector pitch,
and no centre-of-rotation shift (the benchmark's configurations have
neither).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_VIEWS = 8


def _rot(angle, axis: str):
    """``(..., 3, 3)`` rotations about ``axis`` by ``angle (...)``."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rows = {"x": [[o, z, z], [z, c, -s], [z, s, c]],
            "y": [[c, z, s], [z, o, z], [-s, z, c]],
            "z": [[c, -s, z], [s, c, z], [z, z, o]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


class RayOperator:
    """``A``, ``AT`` and ``value_jac`` of the exact ray projector of a
    configuration (``vox_shape``, ``det_shape``), at views given per call
    as ``theta (V, 6)``."""

    def __init__(self, cfg: dict, device, dtype=torch.float64,
                 block: int = BLOCK_VIEWS, step: float = 1.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.shape = tuple(cfg["vox_shape"])
        self.det = tuple(cfg["det_shape"])
        self.device, self.dtype, self.block = device, dtype, block
        nx, ny, nz = self.shape
        nu, nv = self.det
        kw = dict(dtype=dtype, device=device)
        length = 2.0 * ny
        self.n_steps = int(length / step)
        xu = torch.arange(nu, **kw) - nu / 2 + 0.5
        zv = torch.arange(nv, **kw) - nv / 2 + 0.5
        # (R, 3) source points, u-major
        self.src = torch.stack([xu[:, None].expand(nu, nv),
                                torch.full((nu, nv), -float(ny), **kw),
                                zv[None, :].expand(nu, nv)], -1).reshape(-1, 3)
        self.ray = torch.tensor([0.0, length, 0.0], **kw)
        self.c = torch.arange(self.n_steps, **kw) * step / length
        self.first = torch.tensor([-n / 2 + 0.5 for n in self.shape], **kw)
        # index i of an axis of n ↦ 2i/(n − 1) − 1; grid_sample's last axis
        # is (W, H, D) = (z, y, x)
        self.scale = torch.tensor([2.0 / (n - 1) for n in self.shape], **kw)

    def _samples(self, theta):
        """Normalized sample coordinates ``(..., R, S, 3)`` of views
        ``theta (..., 6)`` (a leading axis of rays, ``(V, R, 6)``, gives
        each ray its own copy)."""
        th = theta.to(self.dtype)
        rpa = _rot(th[..., 3], "z") @ _rot(th[..., 4], "x")
        rb = _rot(th[..., 5], "y")
        p0 = (rpa @ (rb @ self.src[..., None] + th[..., :3, None]))[..., 0]
        d = (rpa @ rb @ self.ray)                       # (..., 3)
        p = p0[..., None, :] + self.c[:, None] * d[..., None, :]
        return ((p - self.first) * self.scale - 1.0).flip(-1)

    def _sample_sum(self, vol, grid):
        """``Σ_j`` of the trilinear samples at ``grid (V, R, S, 3)`` →
        ``(V, R)``."""
        out = F.grid_sample(vol.reshape(1, 1, *self.shape), grid[None],
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        return out[0, 0].sum(-1)

    def _blocks(self, n: int):
        return [slice(i, min(n, i + self.block))
                for i in range(0, n, self.block)]

    def _views(self, theta):
        return torch.as_tensor(theta).to(device=self.device,
                                         dtype=self.dtype)

    @torch.no_grad()
    def A(self, vol, theta):
        """The sinogram ``(V, nu, nv)`` of ``vol`` at views ``theta``."""
        theta = self._views(theta)
        vol = vol.to(device=self.device, dtype=self.dtype)
        out = torch.cat([self._sample_sum(vol, self._samples(theta[sl,
                                                                   None]))
                         for sl in self._blocks(theta.shape[0])])
        return out.reshape(-1, *self.det)

    def AT(self, y, theta):
        """The adjoint: ``Σ_v A_vᵀ y_v`` → volume, as the forward's
        vector-Jacobian product."""
        theta = self._views(theta)
        y = y.to(device=self.device, dtype=self.dtype).reshape(
            theta.shape[0], -1)
        vol = torch.zeros(self.shape, dtype=self.dtype, device=self.device,
                          requires_grad=True)
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        with torch.enable_grad():
            for sl in self._blocks(theta.shape[0]):
                with torch.no_grad():
                    grid = self._samples(theta[sl, None])
                val = self._sample_sum(vol, grid)
                out += torch.autograd.grad(val, vol, y[sl])[0]
        return out

    def value_jac(self, vol, theta, cols):
        """``(value (V, nu, nv), jac (V, len(cols), nu, nv))``: the forward
        at ``theta`` and its derivative in the parameters ``cols``."""
        theta = self._views(theta)
        vol = vol.to(device=self.device, dtype=self.dtype).detach()
        R = self.src.shape[0]
        vals, jacs = [], []
        with torch.enable_grad():
            for sl in self._blocks(theta.shape[0]):
                th = theta[sl, None].expand(-1, R, -1).clone()
                th.requires_grad_(True)
                val = self._sample_sum(vol, self._samples(th))
                g = torch.autograd.grad(val.sum(), th)[0]
                vals.append(val.detach())
                jacs.append(g[..., list(cols)].transpose(1, 2))
        V = theta.shape[0]
        return (torch.cat(vals).reshape(V, *self.det),
                torch.cat(jacs).reshape(V, len(cols), *self.det))

"""The 3-D modified Shepp-Logan phantom, made on the device.

The public ellipsoid table (tomopy's, as in the reference project's
``generate_phantom.py``) evaluated on the ``linspace(-1, 1, n)`` grid of
each axis: a voxel inside ellipsoid ``k`` (rotated by the ZXZ Euler angles
φ, θ, ψ in degrees) gains its amplitude ``A``, and the sum is clipped at
0. Coordinates are float64 and each ellipsoid is evaluated a block of x
planes at a time, so a 512³ volume takes a fraction of a second on the
card.
"""

from __future__ import annotations

import math

import torch

# A, a, b, c, x0, y0, z0, phi, theta, psi (degrees)
SHEPP = (
    (1.0, 0.6900, 0.920, 0.810, 0.0, 0.0, 0.0, 90.0, 90.0, 90.0),
    (-0.8, 0.6624, 0.874, 0.780, 0.0, -0.0184, 0.0, 90.0, 90.0, 90.0),
    (-0.2, 0.1100, 0.310, 0.220, 0.22, 0.0, 0.0, -108.0, 90.0, 100.0),
    (-0.2, 0.1600, 0.410, 0.280, -0.22, 0.0, 0.0, 108.0, 90.0, 100.0),
    (0.1, 0.2100, 0.250, 0.410, 0.0, 0.35, -0.15, 90.0, 90.0, 90.0),
    (0.1, 0.0460, 0.046, 0.050, 0.0, 0.1, 0.25, 90.0, 90.0, 90.0),
    (0.1, 0.0460, 0.046, 0.050, 0.0, -0.1, 0.25, 90.0, 90.0, 90.0),
    (0.1, 0.0460, 0.023, 0.050, -0.08, -0.605, 0.0, 90.0, 90.0, 90.0),
    (0.1, 0.0230, 0.023, 0.020, 0.0, -0.606, 0.0, 90.0, 90.0, 90.0),
    (0.1, 0.0230, 0.046, 0.020, 0.06, -0.605, 0.0, 90.0, 90.0, 90.0),
)
BLOCK_VOXELS = 1 << 24


def _euler_zxz(phi, theta, psi):
    cf, sf = math.cos(math.radians(phi)), math.sin(math.radians(phi))
    ct, st = math.cos(math.radians(theta)), math.sin(math.radians(theta))
    cp, sp = math.cos(math.radians(psi)), math.sin(math.radians(psi))
    return ((cp * cf - ct * sf * sp, cp * sf + ct * cf * sp, sp * st),
            (-sp * cf - ct * sf * cp, -sp * sf + ct * cf * cp, cp * st),
            (st * sf, -st * cf, ct))


def shepp3d(shape, device, dtype=torch.float32) -> torch.Tensor:
    """The phantom of ``shape`` (nx, ny, nz) on ``device``."""
    nx, ny, nz = shape
    kw = dict(dtype=torch.float64, device=device)
    gx = torch.linspace(-1.0, 1.0, nx, **kw)
    gy = torch.linspace(-1.0, 1.0, ny, **kw)
    gz = torch.linspace(-1.0, 1.0, nz, **kw)
    out = torch.zeros(shape, dtype=dtype, device=device)
    step = max(1, BLOCK_VOXELS // (ny * nz))
    for A, a, b, c, x0, y0, z0, phi, theta, psi in SHEPP:
        R = _euler_zxz(phi, theta, psi)
        for i0 in range(0, nx, step):
            x = gx[i0:i0 + step, None, None]
            y, z = gy[None, :, None], gz[None, None, :]
            r = 0.0
            for row, t, s in zip(R, (x0, y0, z0), (a, b, c)):
                p = (row[0] * x + row[1] * y + row[2] * z - t) / s
                r = r + p * p
            out[i0:i0 + step] += torch.where(r <= 1.0, A, 0.0).to(dtype)
    return out.clamp_min_(0.0)

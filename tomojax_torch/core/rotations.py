"""Rotation matrices and their analytic angle-derivatives.

Counterpart of ``tomojax.core.rotations``, on tensors: each function takes
an angle tensor of any shape ``S`` and returns ``S + (3, 3)`` matrices in
the angle's dtype and device.

- ``rot_z(phi)``   : tomographic rotation about the Z axis.
- ``rot_x(alpha)`` : jitter rotation about the X axis.
- ``rot_y(beta)``  : jitter rotation about the Y axis.
- ``der_rot_*``    : elementwise d/d(angle) of the corresponding matrix.
"""

from __future__ import annotations

import torch


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _cos_sin(angle):
    angle = torch.as_tensor(angle)
    return torch.cos(angle), torch.sin(angle)


def rot_z(angle):
    c, s = _cos_sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[c, -s, zero], [s, c, zero], [zero, zero, one]])


def der_rot_z(angle):
    c, s = _cos_sin(angle)
    zero = torch.zeros_like(c)
    return _mat([[-s, -c, zero], [c, -s, zero], [zero, zero, zero]])


def rot_x(angle):
    c, s = _cos_sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[one, zero, zero], [zero, c, -s], [zero, s, c]])


def der_rot_x(angle):
    c, s = _cos_sin(angle)
    zero = torch.zeros_like(c)
    return _mat([[zero, zero, zero], [zero, -s, -c], [zero, c, -s]])


def rot_y(angle):
    c, s = _cos_sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return _mat([[c, zero, s], [zero, one, zero], [-s, zero, c]])


def der_rot_y(angle):
    c, s = _cos_sin(angle)
    zero = torch.zeros_like(c)
    return _mat([[-s, zero, c], [zero, zero, zero], [-c, zero, -s]])


def ray_rotation(phi, alpha, beta):
    """Rotation of the ray path: ``R_z(phi) @ R_x(alpha) @ R_y(beta)``."""
    return rot_z(phi) @ rot_x(alpha) @ rot_y(beta)


def voxel_rotation(phi, alpha, beta):
    """Rotation of the voxel path: ``R_y(beta) @ R_x(alpha) @ R_z(phi)``
    (the composition order differs from the ray path)."""
    return rot_y(beta) @ rot_x(alpha) @ rot_z(phi)

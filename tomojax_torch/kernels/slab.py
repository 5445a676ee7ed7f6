"""Plane-quadrature slab kernels: wrappers, plain versions, autograd.

- K1 :func:`slab_project` — forward of one orientation group,
  ``vol_or`` (nx, ny, nz) → (V, nu, nv). Replaces tomojax's Pallas
  ``_fwd_kernel`` (quad="plane", ``tomojax/kernels/slab.py:293``).
- K2 :func:`slab_backproject` — its exact transpose, (V, nu, nv) → the
  oriented volume, summed over views. Replaces ``_adj_kernel``
  (quad="plane", ``tomojax/kernels/slab.py:605``).

Both are hand-written CUDA C++ for ``sm_90a`` (``csrc/slab_plane.cu``),
built by ``_build.py`` at first use. A tensor on the CPU takes the plain
PyTorch version beside each wrapper (``core.slab_projector``'s spec); a
CUDA tensor launches the kernel or raises. Each wrapper counts its kernel
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry


# The plain versions: tomojax's XLA plane forward in PyTorch (K1), and
# autograd's vjp of it (K2).
slab_project_plain = sp.forward_oriented
slab_backproject_plain = sp.adjoint_oriented


def _check(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launch(fn, inp, scalars, out, geom: Geometry):
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    V = scalars.shape[0]
    if max(V * nu * nv, nx * ny * nz) >= 2 ** 31:
        raise ValueError("problem too large for 32-bit thread indices")
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        rc = fn(ctypes.c_void_p(inp.data_ptr()),
                ctypes.c_void_p(scalars.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                V, nx, ny, nz, nu, nv, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")


def slab_project(vol_or, scalars, geom: Geometry):
    """K1: plane forward of one orientation group → (V, nu, nv).

    ``vol_or`` is the oriented volume (nx, ny, nz) and ``scalars`` the
    group's (V, NS) rows (:func:`~tomojax_torch.core.slab_projector.
    slab_scalars_np`)."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom)
    from tomojax_torch.kernels import _build
    nu, nv = geom.det_shape
    V = scalars.shape[0]
    _check("vol_or", vol_or, geom.vox_shape)
    _check("scalars", scalars, (V, sp.NS))
    out = torch.empty((V, nu, nv), dtype=torch.float32, device=vol_or.device)
    _launch(_build.load().slab_plane_fwd, vol_or, scalars, out, geom)
    slab_project.launches += 1
    return out


def slab_backproject(g, scalars, geom: Geometry):
    """K2: exact transpose of :func:`slab_project`, (V, nu, nv) → oriented
    volume (nx, ny, nz), summed over the group's views."""
    if g.device.type == "cpu":
        return slab_backproject_plain(g, scalars, geom)
    from tomojax_torch.kernels import _build
    nu, nv = geom.det_shape
    V = scalars.shape[0]
    _check("g", g, (V, nu, nv))
    _check("scalars", scalars, (V, sp.NS))
    out = torch.empty(geom.vox_shape, dtype=torch.float32, device=g.device)
    _launch(_build.load().slab_plane_adj, g, scalars, out, geom)
    slab_backproject.launches += 1
    return out


slab_project.launches = 0
slab_backproject.launches = 0


class SlabPlane(torch.autograd.Function):
    """The kernel pair as one differentiable op: forward = K1, backward =
    K2 (tomojax's ``_apply_kernel`` custom_vjp). Gradients flow to the
    volume only."""

    @staticmethod
    def forward(ctx, vol_or, scalars, geom):
        ctx.save_for_backward(scalars)
        ctx.geom = geom
        return slab_project(vol_or, scalars, geom)

    @staticmethod
    def backward(ctx, g):
        (scalars,) = ctx.saved_tensors
        return slab_backproject(g.contiguous(), scalars, ctx.geom), None, None

"""The exact ray family's kernels: wrappers and the adjoint's candidate map.

One wrapper per hand-written kernel, each counting its launches in
``.launches``:

- R1 :func:`ray_fwd` — the forward march of V views, (nx, ny, nz) →
  (V, R) for a block of R detector rays.
- R2 :func:`ray_adj` — its exact transpose as a gather over voxels, (V,
  R) → added into the volume, summed over the views; no atomics, so two
  applies give the same bits.

They replace no TPU kernel (tomojax's ray family is a ``lax.scan``,
ROADMAP P8). Both are in ``csrc/ray.cu``, built by ``_build.py`` at first
use; their plain version is ``core.projector``'s march, which
:func:`~tomojax_torch.core.projector.forward_views` and
:func:`~tomojax_torch.core.projector.backproject_views` take on the CPU.
A CUDA tensor launches the kernel or raises.

Both take the views' sample origins ``p0`` (V, 3, R) and directions
``d_hat`` (V, 3) as ``core.projector._ray_setup`` makes them, so each
sample's position is the plain version's to the bit. :func:`gather_map`
gives R2, per view, the affine map from (detector u, detector w, step j)
to the sample position and its inverse, with the margins of its candidate
search (R2 computes it on the card in a prologue of its own, with no
host copy).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tomojax_torch.core.geometry import Geometry
from tomojax_torch.core.rotations import ray_rotation
from tomojax_torch.utils import profiling

# one view's row of the map (csrc/ray.cu reads the same layout): p0 of the
# block's first ray (3), the sample steps per detector u and w (3 + 3),
# the u and w rows of the inverse map (3 + 3), 1 / (step · d̂) per axis
# (3; 0 where |step · d̂| < 1e-30), the half-widths of a corner box's u and
# w ranges, and the corner box's half-side
NM = 21
M_P, M_AU, M_AW, M_IU, M_IW, M_ISD, M_HU, M_HW, M_BOX = (0, 3, 6, 9, 12, 15,
                                                        18, 19, 20)
# the position margin per unit of the problem's extent (float32 puts a
# sample within a few of its ulps of the affine map, ~1e-7 of the extent),
# and the allowance of R2's step intervals for their own rounding
MARGIN = 1e-5
STEP_SLACK = 0.01


def ray_block(geom: Geometry, rays: slice) -> tuple[int, int]:
    """``(r_off, R)``: the first detector ray and the count of the
    contiguous block ``rays``."""
    start, stop, stride = rays.indices(geom.n_det)
    if stride != 1:
        raise ValueError("rays: expected a contiguous block of rays")
    return start, max(0, stop - start)


def gather_map(p0, d_hat, phi, alpha, beta, geom: Geometry,
               rays: slice = slice(None)):
    """R2's per-view map → (V, :data:`NM`) float32 on ``p0``'s device: the
    plain version of the map that R2's entry computes on the card before
    its gather (``csrc/ray.cu``: ``ray_map_kernel``).

    The sample of ray (u, w) at step j lies near ``P + (u − u₀)·a_u + (w −
    w₀)·a_w + j·s``, with ``P`` the block's first ray's origin (detector
    ray (u₀, w₀)), ``a_u``, ``a_w`` the rotated detector steps and ``s =
    step·d̂``; the inverse's u and w rows give a point's ray. The samples
    that reach voxel q as a corner lie in (q − 1, q + 1)³: widened by the
    margin ``m`` (``box = 1 + m``), its image bounds q's candidate rays
    (``± h_u``, ``± h_w`` about the image of q) and, per candidate, its
    steps (``1 / s`` per axis). ``m`` is :data:`MARGIN` times the
    problem's extent (the origin's size, the detector's and the ray's
    length), some 70 times the distance float32 puts between the affine
    map and the samples.
    """
    kw = dict(dtype=torch.float64, device=p0.device)
    rot = ray_rotation(*(torch.as_tensor(a).to(**kw)
                         for a in (phi, alpha, beta)))
    (nu, nv), (du, dv) = geom.det_shape, geom.det_pix
    step = float(np.float32(geom.step_size))
    a_u, a_w = rot[:, :, 0] * du, rot[:, :, 2] * dv
    s = d_hat.to(torch.float64) * step
    origin = p0[:, :, 0].to(torch.float64)
    cross_ws = torch.linalg.cross(a_w, s, dim=-1)
    det = (a_u * cross_ws).sum(-1, keepdim=True)
    i_u = cross_ws / det
    i_w = torch.linalg.cross(s, a_u, dim=-1) / det
    i_s = torch.where(s.abs() >= 1e-30, 1.0 / s, 0.0)
    extent = (1.0 + origin.abs().amax(-1, keepdim=True) + nu * abs(du)
              + nv * abs(dv) + geom.n_steps * step)
    m = MARGIN * extent
    box = 1.0 + m
    h_u = box * i_u.abs().sum(-1, keepdim=True) + m
    h_w = box * i_w.abs().sum(-1, keepdim=True) + m
    return torch.cat([origin, a_u, a_w, i_u, i_w, i_s, h_u, h_w, box],
                     dim=-1).float().contiguous()


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


def _launch(entry, dev, *args):
    """Launch ``entry`` of the kernel library on ``dev``'s current stream:
    pointers for tensors, C ints and floats as given."""
    from tomojax_torch.kernels import _build
    with torch.cuda.device(dev), profiling.span(f"kernel.{entry}"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_build.load(), entry)(
            *(ctypes.c_void_p(a.data_ptr()) if torch.is_tensor(a) else a
              for a in args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def _check_rays(p0, d_hat, geom: Geometry, rays: slice):
    """The checks both kernels make on the rays; returns ``(V, R,
    r_off)``."""
    r_off, R = ray_block(geom, rays)
    V = p0.shape[0]
    _check("p0", p0, (V, 3, R))
    _check("d_hat", d_hat, (V, 3))
    if max(V * 3 * R, geom.n_vox) >= 2 ** 31:
        raise ValueError("problem too large for 32-bit indices")
    return V, R, r_off


def ray_fwd(vol, p0, d_hat, geom: Geometry, rays: slice = slice(None)):
    """R1: the forward march of V views → (V, R), for the block ``rays``
    of R detector rays whose origins ``p0`` (V, 3, R) holds."""
    V, R, _ = _check_rays(p0, d_hat, geom, rays)
    _check("vol", vol, geom.vox_shape)
    out = torch.empty((V, R), dtype=torch.float32, device=vol.device)
    _launch("ray_fwd", vol.device, vol, p0, d_hat, out, V, R,
            *geom.vox_shape, geom.n_steps,
            ctypes.c_float(geom.step_size))
    ray_fwd.launches += 1
    return out


def _adj_launch(y, p0, d_hat, phi, alpha, beta, geom: Geometry, out,
                rays: slice = slice(None)):
    """Launch R2 (its map, then its gather) → the map it computed,
    :func:`gather_map`'s rows; ``out`` is added into."""
    V, R, r_off = _check_rays(p0, d_hat, geom, rays)
    _check("y", y, (V, R))
    _check("out", out, out.shape)
    if out.numel() != geom.n_vox:
        raise ValueError(f"out: expected {geom.n_vox} elements, got "
                         f"{out.numel()}")
    angles = [torch.as_tensor(a).reshape(-1).to(torch.float32).contiguous()
              for a in (phi, alpha, beta)]
    for name, a in zip(("phi", "alpha", "beta"), angles):
        _check(name, a, (V,))
    gmap = torch.empty((V, NM), dtype=torch.float32, device=y.device)
    _launch("ray_adj", y.device, y, p0, d_hat, *angles, gmap, out, V, R,
            *geom.det_shape, r_off, *geom.vox_shape, geom.n_steps,
            ctypes.c_float(geom.step_size), *map(ctypes.c_double,
                                                 geom.det_pix))
    return gmap


def ray_adj(y, p0, d_hat, phi, alpha, beta, geom: Geometry, out,
            rays: slice = slice(None)):
    """R2: the exact transpose of :func:`ray_fwd`, ``y`` (V, R) summed over
    the views and added into ``out`` (the flat or shaped volume); the
    views' angles (V,) give its map (computed on the card by the kernel's
    own prologue; :func:`gather_map` is its plain version). Returns
    ``out``."""
    _adj_launch(y, p0, d_hat, phi, alpha, beta, geom, out, rays)
    ray_adj.launches += 1
    return out


ray_fwd.launches = 0
ray_adj.launches = 0

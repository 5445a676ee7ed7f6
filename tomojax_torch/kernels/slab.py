"""Slab projector kernels: wrappers, plain versions, autograd.

One wrapper per hand-written kernel, each counting its launches in
``.launches``:

- K1 :func:`slab_plane_fwd` — plane forward of one orientation group,
  ``vol_or`` (nx, ny, nz) → (V, nu, nv). Replaces tomojax's Pallas
  ``_fwd_kernel`` (quad="plane", ``tomojax/kernels/slab.py:293``).
- K2 :func:`slab_plane_adj` — its exact transpose, (V, nu, nv) → the
  oriented volume, summed over views. Replaces ``_adj_kernel``
  (quad="plane", ``tomojax/kernels/slab.py:605``).
- K3 :func:`slab_arc_fwd` — arc forward. Replaces ``_fwd_kernel``
  (quad="arc").
- K4 :func:`slab_arc_adj` — its exact transpose. Replaces ``_adj_kernel``
  (quad="arc").
- K5 :func:`slab_project_jac` — arc forward plus the 11 other Jacobian
  building blocks in one pass → (V, 12, nu, nv), :data:`JAC_PASSES`
  order. Replaces ``_fwd_jac_kernel`` (``tomojax/kernels/slab.py:446``).
- K1b-K4b :func:`slab_plane_fwd_bf16`, :func:`slab_plane_adj_bf16`,
  :func:`slab_arc_fwd_bf16`, :func:`slab_arc_adj_bf16` — the bf16 tier of
  K1-K4 (:func:`resolve_prec`). Replace the ``bf16=True`` variants of
  ``_fwd_kernel`` and ``_adj_kernel`` (chosen at
  ``tomojax/kernels/slab.py:904`` and ``:1015``).

The public entries dispatch on the quadrature and the tier, as tomojax's
``slab_project_pallas``/``slab_backproject_pallas`` do:
:func:`slab_project` (K1, K3, their bf16 variants, and with ``deriv``/
``jweight``/``rweight`` the single-field entry :func:`slab_project_field`,
which tomojax served with K6 — here it launches K5 and returns one field)
and :func:`slab_backproject` (K2, K4 and their bf16 variants).

K1/K2 are in ``csrc/slab_plane.cu``, K3/K4/K5 in ``csrc/slab_arc.cu``
(K3 and K5 are one kernel, ``arc_march_kernel``, templated on the
Jacobian; the bf16 tier's four are kernels of their own,
``fwd_bf16_kernel`` and ``adj_bf16_kernel`` (K1b, K2b),
``arc_fwd_bf16_kernel`` and ``arc_adj_bf16_kernel`` (K3b, K4b)):
hand-written CUDA C++ for ``sm_90a``, built by ``_build.py`` at first
use.
A tensor on the CPU takes the plain PyTorch version beside each wrapper
(``core.slab_projector``'s spec); a CUDA tensor launches the kernel or
raises.

:func:`resolve_prec` reads the precision tier as tomojax's does; the
per-view scalar layout (:data:`NS`, ``S_*``) is
``core.slab_projector``'s, re-exported here where tomojax defines it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry
from tomojax_torch.core.slab_projector import (  # noqa: F401 (re-exports)
    NS, S_B1, S_CXB, S_CZB, S_EDX, S_EDY, S_EDZ, S_EUX, S_EUY, S_EUYIEUX,
    S_EVX, S_EVY, S_EVZ, S_GZX, S_INV_EDY, S_INV_EUX, S_RX, S_RZ, S_SCALE,
    S_WAV, S_WAX, S_ZAV)
from tomojax_torch.utils import profiling

JAC_PASSES = tuple(name for name, *_ in sp.JAC_PASSES)
NJP = len(JAC_PASSES)
PRECS = ("f32x2", "bf16")


def resolve_prec(prec: str | None = None, *, name: str = "prec") -> str:
    """The slab kernels' precision tier (tomojax's ``resolve_prec``):
    ``prec``, else ``TOMOJAX_SLAB_PREC``, else ``"f32x2"``.

    ``"f32x2"`` is plain fp32 here (tomojax's two bf16 MXU passes exist to
    reach fp32 on the TPU). ``"bf16"`` is tomojax's bulk tier: each pass
    of the two-pass transform reads its input rounded to bf16 (nearest
    even) — the forward the volume's rows and the pass-A table T, the
    adjoint the cotangent and each view's pass-B transpose — with fp32
    positions, weights and sums. Its contract is tomojax's: each apply
    within 3e-3 relative of the fp32 operator, the A/Aᵀ mismatch
    |⟨Ax, y⟩ − ⟨x, Aᵀy⟩|/|⟨Ax, y⟩| within 5e-3 (held with numerator and
    denominator pooled over standard-normal cotangents:
    ``tools/bf16_gate.py``). The Jacobian kernel (K5)
    and the single-field entry have no tier, as in tomojax. Any other
    value raises ``ValueError``, as in tomojax. ``name`` is the caller's
    name for the setting, in the error message."""
    p = prec or os.environ.get("TOMOJAX_SLAB_PREC", "f32x2")
    if p not in PRECS:
        raise ValueError(f"{name}: unknown slab kernel precision tier {p!r}")
    return p


# The plain versions: tomojax's XLA forward in PyTorch (K1, K3, and the
# single fields), autograd's vjp of it (K2, K4), and the 12 plain passes
# stacked (K5). The bf16 tier rounds the forward's volume and pass-A table,
# and the adjoint's cotangent and pass-B transpose (the vjp of pass B,
# rounded, then the vjp of pass A: the output volume is never rounded).
def slab_project_plain(vol_or, scalars, geom: Geometry, quad="plane",
                       deriv=None, jweight=False, rweight=False,
                       prec: str = "f32x2"):
    if resolve_prec(prec) == "f32x2":
        return sp.forward_oriented(vol_or, scalars, geom, quad, deriv,
                                   jweight, rweight)
    if deriv is not None or jweight or rweight:
        raise ValueError("the Jacobian building blocks have no bf16 tier")
    return sp.forward_oriented(sp.bf16_round(vol_or), scalars, geom, quad,
                               table_hook=sp.bf16_round)


def slab_backproject_plain(g, scalars, geom: Geometry, quad="plane",
                           prec: str = "f32x2"):
    if resolve_prec(prec) == "f32x2":
        return sp.adjoint_oriented(g, scalars, geom, quad)
    return sp.adjoint_oriented(sp.bf16_round(g), scalars, geom, quad,
                               table_hook=sp.round_cotangent)


slab_project_jac_plain = sp.jac_passes_oriented


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


def _operand(name, t, shape, entry: str):
    """The checked fp32 operand, as the entry reads it: a bf16 entry
    (``*_bf16``) reads a bf16 copy, made by one elementwise cast."""
    _check(name, t, shape)
    return t.to(torch.bfloat16) if entry.endswith("_bf16") else t


def _launch(fn, inp, scalars, outs, geom: Geometry, *arc_args):
    """Check the operands and launch ``fn`` on the current stream with the
    output pointers ``outs``; arc kernels take ``(n_steps, n_branch)``
    after the shape arguments."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    V = scalars.shape[0]
    _check("scalars", scalars, (V, sp.NS))
    if max(V * nu * nv, nx * ny * nz, *(o.numel() for o in outs)) >= 2 ** 31:
        raise ValueError("problem too large for 32-bit thread indices")
    with torch.cuda.device(inp.device), \
            profiling.span(f"kernel.{fn.__name__}"):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        rc = fn(ctypes.c_void_p(inp.data_ptr()),
                ctypes.c_void_p(scalars.data_ptr()),
                *(ctypes.c_void_p(o.data_ptr()) for o in outs),
                V, nx, ny, nz, nu, nv, *arc_args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")


def _arc_args(geom: Geometry):
    return geom.n_steps, sp._n_branch(geom.step_size)


def _fwd(entry, vol_or, scalars, geom: Geometry, nfields=None, *arc_args):
    from tomojax_torch.kernels import _build
    nu, nv = geom.det_shape
    V = scalars.shape[0]
    inp = _operand("vol_or", vol_or, geom.vox_shape, entry)
    shape = (V, nu, nv) if nfields is None else (V, nfields, nu, nv)
    out = torch.empty(shape, dtype=torch.float32, device=vol_or.device)
    _launch(getattr(_build.load(), entry), inp, scalars, (out,), geom,
            *arc_args)
    return out


def _adj(entry, g, scalars, geom: Geometry, *arc_args, scratch=0):
    """Launch an adjoint entry → the oriented volume; ``scratch`` more
    volumes of its shape are passed after it (K4's side-1 partial)."""
    from tomojax_torch.kernels import _build
    nu, nv = geom.det_shape
    inp = _operand("g", g, (scalars.shape[0], nu, nv), entry)
    outs = [torch.empty(geom.vox_shape, dtype=torch.float32, device=g.device)
            for _ in range(1 + scratch)]
    _launch(getattr(_build.load(), entry), inp, scalars, outs, geom,
            *arc_args)
    return outs[0]


def slab_plane_fwd(vol_or, scalars, geom: Geometry):
    """K1: plane forward of one orientation group → (V, nu, nv).

    ``vol_or`` is the oriented volume (nx, ny, nz) and ``scalars`` the
    group's (V, NS) rows (:func:`~tomojax_torch.core.slab_projector.
    scalar_groups`)."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom)
    out = _fwd("slab_plane_fwd", vol_or, scalars, geom)
    slab_plane_fwd.launches += 1
    return out


def slab_plane_adj(g, scalars, geom: Geometry):
    """K2: exact transpose of :func:`slab_plane_fwd`, (V, nu, nv) →
    oriented volume (nx, ny, nz), summed over the group's views."""
    if g.device.type == "cpu":
        return slab_backproject_plain(g, scalars, geom)
    out = _adj("slab_plane_adj", g, scalars, geom)
    slab_plane_adj.launches += 1
    return out


def slab_arc_fwd(vol_or, scalars, geom: Geometry):
    """K3: arc forward of one orientation group → (V, nu, nv)."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom, "arc")
    out = _fwd("slab_arc_fwd", vol_or, scalars, geom, None,
               *_arc_args(geom))
    slab_arc_fwd.launches += 1
    return out


def slab_arc_adj(g, scalars, geom: Geometry):
    """K4: exact transpose of :func:`slab_arc_fwd` → oriented volume.

    The kernel writes the slab-r side of each source slab r into the
    output and the slab-(r + 1) side into a scratch volume, then adds the
    two (no atomics: two applies give the same bits)."""
    if g.device.type == "cpu":
        return slab_backproject_plain(g, scalars, geom, "arc")
    out = _adj("slab_arc_adj", g, scalars, geom, *_arc_args(geom),
               scratch=1)
    slab_arc_adj.launches += 1
    return out


def slab_plane_fwd_bf16(vol_or, scalars, geom: Geometry):
    """K1b: :func:`slab_plane_fwd` in the bf16 tier — its own kernel
    stages a bf16 copy of ``vol_or`` and holds T in bf16 (pairs of
    neighbouring columns in one word); fp32 in and out."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom, prec="bf16")
    out = _fwd("slab_plane_fwd_bf16", vol_or, scalars, geom)
    slab_plane_fwd_bf16.launches += 1
    return out


def slab_plane_adj_bf16(g, scalars, geom: Geometry):
    """K2b: :func:`slab_plane_adj` in the bf16 tier — its own kernel
    stages a bf16 copy of ``g`` and rounds each view's pass-B transpose
    once."""
    if g.device.type == "cpu":
        return slab_backproject_plain(g, scalars, geom, prec="bf16")
    out = _adj("slab_plane_adj_bf16", g, scalars, geom)
    slab_plane_adj_bf16.launches += 1
    return out


def slab_arc_fwd_bf16(vol_or, scalars, geom: Geometry):
    """K3b: :func:`slab_arc_fwd` in the bf16 tier — its own kernel, with
    bf16 rows and tables and K3's samples to the bit."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom, "arc", prec="bf16")
    out = _fwd("slab_arc_fwd_bf16", vol_or, scalars, geom, None,
               *_arc_args(geom))
    slab_arc_fwd_bf16.launches += 1
    return out


def slab_arc_adj_bf16(g, scalars, geom: Geometry):
    """K4b: :func:`slab_arc_adj` in the bf16 tier — its own kernel reads
    ``g`` in bf16 and rounds each side's pass-B transpose once; the
    scratch volume and the add stay fp32."""
    if g.device.type == "cpu":
        return slab_backproject_plain(g, scalars, geom, "arc", prec="bf16")
    out = _adj("slab_arc_adj_bf16", g, scalars, geom, *_arc_args(geom),
               scratch=1)
    slab_arc_adj_bf16.launches += 1
    return out


def slab_project_jac(vol_or, scalars, geom: Geometry):
    """K5: arc forward + the Jacobian building blocks in one pass →
    (V, 12, nu, nv), fields in :data:`JAC_PASSES` order."""
    if vol_or.device.type == "cpu":
        return slab_project_jac_plain(vol_or, scalars, geom)
    out = _fwd("slab_arc_jac", vol_or, scalars, geom, NJP,
               *_arc_args(geom))
    slab_project_jac.launches += 1
    return out


def _field_index(deriv, jweight, rweight) -> int:
    for i, (_, dv, jw, rw) in enumerate(sp.JAC_PASSES):
        if (dv, jw, rw) == (deriv, bool(jweight), bool(rweight)):
            return i
    raise ValueError(f"no Jacobian building block deriv={deriv!r}, "
                     f"jweight={jweight}, rweight={rweight}")


def slab_project_field(vol_or, scalars, geom: Geometry, deriv=None,
                       jweight: bool = False, rweight: bool = False):
    """One arc Jacobian building block → (V, nu, nv): the single-field
    entry that tomojax served with K6. It launches the K5 kernel and
    returns field :func:`_field_index` of its output, so it equals that
    field bit for bit."""
    if vol_or.device.type == "cpu":
        return slab_project_plain(vol_or, scalars, geom, "arc", deriv,
                                  jweight, rweight)
    i = _field_index(deriv, jweight, rweight)
    out = _fwd("slab_arc_jac", vol_or, scalars, geom, NJP,
               *_arc_args(geom))[:, i]
    slab_project_field.launches += 1
    return out


_FWD = {("plane", "f32x2"): slab_plane_fwd, ("plane", "bf16"):
        slab_plane_fwd_bf16, ("arc", "f32x2"): slab_arc_fwd,
        ("arc", "bf16"): slab_arc_fwd_bf16}
_ADJ = {("plane", "f32x2"): slab_plane_adj, ("plane", "bf16"):
        slab_plane_adj_bf16, ("arc", "f32x2"): slab_arc_adj,
        ("arc", "bf16"): slab_arc_adj_bf16}


def slab_project(vol_or, scalars, geom: Geometry, quad: str = "plane",
                 deriv=None, jweight: bool = False, rweight: bool = False,
                 prec: str | None = None):
    """Forward of one orientation group → (V, nu, nv): K1 (plane), K3
    (arc) or their bf16 variants (``prec``, :func:`resolve_prec`), or one
    Jacobian building block (arc with ``deriv``/``jweight``/``rweight``,
    fp32 only), which is field :func:`_field_index` of K5's output."""
    sp._check_quad(quad)
    p = resolve_prec(prec)
    if deriv is None and not jweight and not rweight:
        return _FWD[quad, p](vol_or, scalars, geom)
    if quad == "plane":
        raise ValueError("derivative variants are arc-mode only")
    if p == "bf16":
        raise ValueError("the Jacobian building blocks have no bf16 tier")
    return slab_project_field(vol_or, scalars, geom, deriv, jweight, rweight)


def slab_backproject(g, scalars, geom: Geometry, quad: str = "plane",
                     prec: str | None = None):
    """Exact transpose of :func:`slab_project`: K2 (plane) or K4 (arc), or
    their bf16 variants."""
    sp._check_quad(quad)
    return _ADJ[quad, resolve_prec(prec)](g, scalars, geom)


for _fn in (slab_plane_fwd, slab_plane_adj, slab_arc_fwd, slab_arc_adj,
            slab_plane_fwd_bf16, slab_plane_adj_bf16, slab_arc_fwd_bf16,
            slab_arc_adj_bf16, slab_project_jac, slab_project_field):
    _fn.launches = 0


class SlabPlane(torch.autograd.Function):
    """The plane kernel pair as one differentiable op: forward = K1,
    backward = K2, or K1b/K2b with ``prec="bf16"`` (tomojax's
    ``_apply_kernel`` custom_vjp). Gradients flow to the volume only."""

    @staticmethod
    def forward(ctx, vol_or, scalars, geom, prec=None):
        ctx.save_for_backward(scalars)
        ctx.geom, ctx.prec = geom, resolve_prec(prec)
        return _FWD["plane", ctx.prec](vol_or, scalars, geom)

    @staticmethod
    def backward(ctx, g):
        (scalars,) = ctx.saved_tensors
        return (_ADJ["plane", ctx.prec](g.contiguous(), scalars, ctx.geom),
                None, None, None)


class SlabArc(torch.autograd.Function):
    """The arc kernel pair as one differentiable op: forward = K3,
    backward = K4, or K3b/K4b with ``prec="bf16"``. Gradients flow to the
    volume only."""

    @staticmethod
    def forward(ctx, vol_or, scalars, geom, prec=None):
        ctx.save_for_backward(scalars)
        ctx.geom, ctx.prec = geom, resolve_prec(prec)
        return _FWD["arc", ctx.prec](vol_or, scalars, geom)

    @staticmethod
    def backward(ctx, g):
        (scalars,) = ctx.saved_tensors
        return (_ADJ["arc", ctx.prec](g.contiguous(), scalars, ctx.geom),
                None, None, None)

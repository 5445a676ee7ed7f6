"""Slab-marching projector family, plane and arc quadrature.

Counterpart of ``tomojax.core.slab_projector``. The parallel-beam transform
is a scan over volume slabs perpendicular to the dominant march axis; for
each slab every ray's intersection is affine in the detector indices, so
the per-slab work is two 1-D interpolation passes:

- pass A z-lerps slab row ``r`` at ``ζ_r(x, v)`` on the voxel-x grid;
- pass B x-lerps that result at ``X_r(u, v)``.

Two quadratures:

- ``quad="plane"``: one sample per slab plane, ``ζ_r = cz_r + gzx·(x −
  cx_r) + zav·v`` and ``X_r = cx_r + eux·u + evx·v``; the sum over slabs
  is scaled by ``1/edy``.
- ``quad="arc"``: the samples of the exact ray march, ``p_j = B + u·EU +
  v·EV + j·ED``. Per source slab ``r = −1 … ny−1`` and branch ``b <
  n_branch`` the march index is ``j = ceil((r − y0(u, v))/edy) + b``; the
  sample sits at ``X = cx_r + eux·u + evx·v + edx·cfb`` (``cfb = j − (r −
  y0)/edy``, the ceil sawtooth) and blends the slab pair as ``(1 − fy)·s_r
  + fy·s_{r+1}`` with ``fy = edy·cfb``, masked to ``0 ≤ j < n_steps`` and
  ``fy < 1``. Pass A takes ζ at each grid x through the affine inversion
  ``u_aff(x, v)``, with the grid sawtooth ``cf_xv`` (the separable
  two-pass spec, not a trilinear read at the sample).

The spec is tomojax's XLA path (``_forward_oriented_xla``), not its Pallas
kernel. :func:`forward_oriented` is that spec in PyTorch, including the
arc-only Jacobian building blocks (``deriv``, ``jweight``, ``rweight``); it
is the plain version of the CUDA kernels in ``tomojax_torch.kernels.slab``.
:func:`forward_view_jac` assembles the analytic 6-DoF Jacobian from those
building blocks and the per-view scalars' θ-derivatives.

Views are grouped host-side by orientation ``(swap x/y, flip y, flip u)``
so that ``edy > 0`` and ``eux > 0`` in each group's oriented frame. The
per-view kernel scalars come from one function, :func:`slab_scalars_t`,
differentiable in θ: the operator evaluates it in float64 on the host,
refinement on its own θ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tomojax_torch.core.fast_projector import view_affine
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.utils import profiling

# ---- per-view scalar layout (the kernels read the same columns) ----------
NS = 21
(S_EDY, S_EDX, S_EDZ, S_RX, S_RZ, S_EUX, S_EVX, S_EVZ, S_CXB, S_CZB,
 S_GZX, S_B1, S_EUY, S_EVY, S_INV_EDY, S_WAX, S_WAV, S_SCALE, S_INV_EUX,
 S_EUYIEUX, S_ZAV) = range(NS)

# The 12 Jacobian building blocks, in the order the fused Jacobian kernel
# emits them: (name, deriv, jweight, rweight) of forward_oriented.
JAC_PASSES = (("val", None, False, False),
              ("px", "x", False, False), ("py", "y", False, False),
              ("pz", "z", False, False),
              ("jx", "x", True, False), ("jy", "y", True, False),
              ("jz", "z", True, False),
              ("rx", "x", False, True), ("ry", "y", False, True),
              ("rz", "z", False, True),
              ("zm", "zm", False, False), ("zc", "zc", False, False))

_PERM_SWAP = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)


def _check_quad(quad: str):
    if quad not in ("plane", "arc"):
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


def orient_flags(views, geom: Geometry | None = None):
    """Per-view orientation flags ``(swap, yflip, uflip)`` (numpy bools).

    Swap iff ``|ED_x| > |ED_y|``; y-flip makes the march direction +y of
    the oriented volume; u-flip makes the in-plane x per detector-u slope
    positive (an exact detector-row permutation). Without ``geom`` the
    flags are those of unit pixels and step, as tomojax's."""
    if geom is None:
        geom = Geometry(n_proj=len(_views_np(views)["phi"]),
                        vox_shape=(8, 8, 8), det_shape=(8, 8))
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


def params_from_scalars(sc) -> dict:
    """Named per-view scalars from ``(..., NS)`` rows (the names of
    tomojax's ``SlabParams``, in its order)."""
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


def _theta_cor(vw: dict):
    """``(θ (n, 6), cor (n, 3))`` float64 CPU tensors of host views, θ in
    :meth:`Views.theta6` order."""
    theta = np.concatenate(
        [vw["t"], np.stack([vw["phi"], vw["alpha"], vw["beta"]], -1)], -1)
    return torch.as_tensor(theta), torch.as_tensor(vw["cor"])


def scalar_groups(geom: Geometry, views, quad: str = "arc",
                  dtype=torch.float32, strict_bounds: bool = False, *,
                  device=None):
    """Host-side split of views into orientation groups.

    ``strict_bounds`` is accepted for tomojax's calls and does nothing:
    it chooses what tomojax does past its TPU kernel's band budget, and
    the Hopper kernels have no band budget.

    :returns: ``(gstruct, scalars)``: ``gstruct`` is a tuple of per-group
        ``(view_indices, swap, yflip, uflip)`` and ``scalars`` a matching
        tuple of ``(V_g, NS)`` tensors of ``dtype`` on ``device``."""
    _check_quad(quad)
    vw = _views_np(views)
    theta, cor = _theta_cor(vw)
    gstruct, scalars = [], []
    for idx, sw, yf, uf in _orient_groups(vw, geom):
        sc = slab_scalars_t(geom, theta[idx], cor[idx], sw, yf, uf, quad)
        gstruct.append((tuple(int(i) for i in idx), bool(sw), bool(yf),
                        bool(uf)))
        scalars.append(sc.to(dtype=dtype, device=device))
    return tuple(gstruct), tuple(scalars)


def group_scalars_for(geom: Geometry, views, gstruct, quad: str = "arc",
                      dtype=torch.float32, *, device=None):
    """Recompute the scalars for a FIXED group structure. Returns ``None``
    when a view leaves its group's valid frame (``edy > 0``, ``eux > 0``);
    the caller then regroups with :func:`scalar_groups`."""
    _check_quad(quad)
    theta, cor = _theta_cor(_views_np(views))
    scalars = []
    for idx, sw, yf, uf in gstruct:
        idx = list(idx)
        sc = slab_scalars_t(geom, theta[idx], cor[idx], sw, yf, uf, quad)
        if not (bool(torch.all(sc[:, S_EDY] > 0.0))
                and bool(torch.all(sc[:, S_EUX] > 0.0))):
            return None
        scalars.append(sc.to(dtype=dtype, device=device))
    return tuple(gstruct), tuple(scalars)


# ----------------------------------------------------------------------
# Per-view scalars as a differentiable function of θ (refinement path)
# ----------------------------------------------------------------------


def orient_affine(E, B, ny_oriented: int, swap: bool, yflip: bool,
                  dtype=None, uflip: bool = False, nu: int = 0):
    """Transform the (u, v, j) → volume affine map (batched ``E (..., 3,
    3)``, ``B (..., 3)``) into the oriented frame, in ``dtype`` (None: E's
    own). ``uflip`` reverses the detector-u index (u → nu−1−u)."""
    if dtype is not None:
        E, B = torch.as_tensor(E, dtype=dtype), torch.as_tensor(B, dtype=dtype)
    if swap:
        # a copy from pageable host memory: on a card the host waits
        profiling.count("host_sync.geometry.perm")
        perm = torch.as_tensor(_PERM_SWAP, dtype=E.dtype, device=E.device)
        E = perm @ E
        B = (perm @ B.unsqueeze(-1)).squeeze(-1)
    if yflip:
        B = torch.stack([B[..., 0], (ny_oriented - 1.0) - B[..., 1],
                         B[..., 2]], dim=-1)
        E = torch.stack([E[..., 0, :], -E[..., 1, :], E[..., 2, :]], dim=-2)
    if uflip:
        B = B + (nu - 1.0) * E[..., :, 0]
        E = torch.stack([-E[..., :, 0], E[..., :, 1], E[..., :, 2]], dim=-1)
    return E, B


def _oriented_affine_theta(geom: Geometry, theta6, cor, swap: bool,
                           yflip: bool, uflip: bool):
    """Oriented ``(E, B)`` as a differentiable function of ``theta6 (...,
    6)`` for static orientation flags (valid within one octant group)."""
    E, B = view_affine(geom, theta6[..., 3], theta6[..., 4], theta6[..., 5],
                       theta6[..., :3], cor)
    ny_o = geom.vox_shape[0] if swap else geom.vox_shape[1]
    return orient_affine(E, B, ny_o, swap, yflip, None, uflip,
                         geom.det_shape[0])


class SlabParams(NamedTuple):
    """Per-view scalars of the oriented slab decomposition (tomojax's
    fields, in its order), each a tensor with the views' batch shape."""

    edy: torch.Tensor     # y-advance per march step (> 0 oriented)
    edx: torch.Tensor     # x-advance per march step
    edz: torch.Tensor     # z-advance per march step
    rx: torch.Tensor      # EDx / EDy
    rz: torch.Tensor      # EDz / EDy
    eux: torch.Tensor     # in-plane x per detector-u (EUx − rx·EUy)
    evx: torch.Tensor     # in-plane x per detector-v
    euz: torch.Tensor     # in-plane z per detector-u
    evz: torch.Tensor     # in-plane z per detector-v
    cxb: torch.Tensor     # in-plane x offset (add rx·s per slab)
    czb: torch.Tensor     # in-plane z offset (add rz·s per slab)
    gzx: torch.Tensor     # dz/dx along constant (v, slab): EUz/EUx
    b1: torch.Tensor      # B[1] (for the march-index map)
    euy: torch.Tensor     # EU[1]
    evy: torch.Tensor     # EV[1]


#: The fields of :class:`SlabParams`, in order.
PARAM_FIELDS = SlabParams._fields


def slab_params(E, B, dtype=None) -> SlabParams:
    """The :class:`SlabParams` of oriented affine maps ``E (..., 3, 3)``,
    ``B (..., 3)`` (batched over leading dimensions), in ``dtype`` (None:
    E's own)."""
    if dtype is not None:
        E, B = torch.as_tensor(E, dtype=dtype), torch.as_tensor(B, dtype=dtype)
    EU, EV, ED = E[..., :, 0], E[..., :, 1], E[..., :, 2]
    edy = ED[..., 1]
    rx = ED[..., 0] / edy
    rz = ED[..., 2] / edy
    eux = EU[..., 0] - rx * EU[..., 1]
    evx = EV[..., 0] - rx * EV[..., 1]
    euz = EU[..., 2] - rz * EU[..., 1]
    evz = EV[..., 2] - rz * EV[..., 1]
    return SlabParams(
        edy=edy, edx=ED[..., 0], edz=ED[..., 2], rx=rx, rz=rz,
        eux=eux, evx=evx, euz=euz, evz=evz,
        cxb=B[..., 0] - rx * B[..., 1], czb=B[..., 2] - rz * B[..., 1],
        gzx=euz / eux, b1=B[..., 1], euy=EU[..., 1], evy=EV[..., 1])


def slab_scalars_t(geom: Geometry, theta6, cor, swap: bool, yflip: bool,
                   uflip: bool, quad: str = "arc"):
    """``(..., NS)`` kernel scalars as a differentiable function of
    ``theta6 (..., 6)`` (the counterpart of tomojax's ``slab_scalars_jnp``,
    batched over leading dimensions); ``cor`` is ``(..., 3)``."""
    E, B = _oriented_affine_theta(geom, theta6, cor, swap, yflip, uflip)
    p = slab_params(E, B)
    inv_edy = 1.0 / p.edy
    inv_eux = 1.0 / p.eux
    euy_ieux = p.euy * inv_eux
    cols = {
        S_EDY: p.edy, S_EDX: p.edx, S_EDZ: p.edz, S_RX: p.rx, S_RZ: p.rz,
        S_EUX: p.eux, S_EVX: p.evx, S_EVZ: p.evz, S_CXB: p.cxb,
        S_CZB: p.czb, S_GZX: p.gzx, S_B1: p.b1, S_EUY: p.euy, S_EVY: p.evy,
        S_INV_EDY: inv_edy, S_WAX: -euy_ieux * inv_edy,
        S_WAV: (euy_ieux * p.evx - p.evy) * inv_edy,
        S_SCALE: inv_edy if quad == "plane" else torch.ones_like(inv_edy),
        S_INV_EUX: inv_eux, S_EUYIEUX: euy_ieux,
        S_ZAV: p.evz - p.gzx * p.evx,
    }
    return torch.stack([cols[i] for i in range(NS)], dim=-1)


def slab_scalars_np(geom: Geometry, views, swap: bool, yflip: bool,
                    uflip: bool, quad: str) -> np.ndarray:
    """``(V, NS)`` kernel scalars of host views in float64 numpy
    (tomojax's signature): :func:`slab_scalars_t` at the views' θ."""
    theta, cor = _theta_cor(_views_np(views))
    return slab_scalars_t(geom, theta, cor, swap, yflip, uflip,
                          quad).numpy()


def param_jacobian(geom: Geometry, theta6, cor, swap: bool, yflip: bool,
                   uflip: bool):
    """Per-view ``d(SlabParams)/dθ``: ``theta6 (V, 6)`` → ``(V, 15, 6)``,
    fields in :data:`PARAM_FIELDS` order (forward-mode, one tangent per
    parameter; views are independent rows)."""
    theta6 = theta6.detach()

    def fields(th):
        E, B = _oriented_affine_theta(geom, th, cor, swap, yflip, uflip)
        return torch.stack(slab_params(E, B), dim=-1)

    eye = torch.eye(6, dtype=theta6.dtype, device=theta6.device)
    tangents = eye[:, None, :].expand(6, *theta6.shape)

    def jvp(tan):
        return torch.func.jvp(fields, (theta6,), (tan,))[1]

    return torch.func.vmap(jvp)(tangents).permute(1, 2, 0)


# ----------------------------------------------------------------------
# Plain path (the spec; runs on any device in float32 or float64)
# ----------------------------------------------------------------------


def _n_branch(step_size: float) -> int:
    """Arc samples per unit slab interval: ceil(√2/step), +0.01 of slack
    at the octant boundary (step 1 → 2)."""
    return int(np.ceil(np.sqrt(2.0) / step_size + 0.01))


def _taps(arr, pos):
    """``(k, w, tap(o))`` for the two taps ``k``, ``k + 1`` of ``pos``:
    ``tap(o)`` reads ``arr`` there, zero outside ``[0, N)``."""
    N = arr.shape[-1]
    arr = arr.expand(*pos.shape[:-1], N)
    f = torch.floor(pos)
    k = f.long()

    def tap(o):
        kk = k + o
        inb = (kk >= 0) & (kk < N)
        return torch.where(inb, torch.gather(arr, -1, kk.clamp(0, N - 1)),
                           0.0)

    return pos - f, tap


def _lerp_rows(arr, pos):
    """``out[..., i] = lerp(arr[..., :], pos[..., i])``, zero outside
    ``[0, N)`` with per-tap bounds guards: tap ``k = floor(pos)`` gets
    weight ``1 − w`` and tap ``k + 1`` weight ``w``."""
    w, tap = _taps(arr, pos)
    return (1.0 - w) * tap(0) + w * tap(1)


def _dlerp_rows(arr, pos):
    """``d/dpos`` of :func:`_lerp_rows`: tap weights −1 and +1 (same
    guards; floors are piecewise constant)."""
    _, tap = _taps(arr, pos)
    return -tap(0) + tap(1)


def _mlerp_rows(arr, pos):
    """First-moment interp ``Σ_tap hat(pos − tap)·(tap − pos)·arr[tap]``:
    tap weights −w(1−w) and +w(1−w) (same guards)."""
    w, tap = _taps(arr, pos)
    m = w * (1.0 - w)
    return -m * tap(0) + m * tap(1)


def bf16_round(t):
    """``t`` rounded to bfloat16 (nearest even) and back to its dtype: the
    bf16 tier's rounding."""
    return t.to(torch.bfloat16).to(t.dtype)


class _RoundCotangent(torch.autograd.Function):
    """The identity, whose vjp rounds the cotangent to bfloat16: the bf16
    tier's rounding of the pass-B transpose in the adjoint."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return bf16_round(g)


round_cotangent = _RoundCotangent.apply


def _forward_chunk(vol_or, sc, nu: int, nv: int, table_hook=None):
    """Plane forward of ``c`` views: ``vol_or`` (nx, ny, nz), ``sc``
    (c, NS) → (c, nu, nv). All slabs at once: intermediates are
    (c, ny, nx, nv) and (c, ny, nv, nu). ``table_hook`` (if not None)
    maps the pass-A table before pass B reads it."""
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
    if table_hook is not None:
        tA = table_hook(tA)
    v = torch.arange(nv, **kw).reshape(1, 1, nv, 1)
    u = torch.arange(nu, **kw).reshape(1, 1, 1, nu)
    X = cx + p(S_EVX) * v + p(S_EUX) * u                      # (c, ny, nv, nu)
    out = _lerp_rows(tA.transpose(-1, -2), X)                 # (c, ny, nv, nu)
    return out.sum(1).transpose(1, 2) * sc[:, S_SCALE].reshape(c, 1, 1)


def _forward_chunk_arc(vol_or, sc, geom: Geometry, deriv, jweight, rweight,
                       table_hook=None):
    """Arc forward of ``c`` views (tomojax's ``_forward_oriented_xla`` arc
    branch, in its operation order): ``vol_or`` (nx, ny, nz), ``sc`` (c,
    NS) → (c, nu, nv). All source slabs r = −1 … ny−1 at once:
    intermediates are (c, ny+1, nx, nv) and (c, ny+1, nu, nv).
    ``table_hook`` (if not None) maps each branch's and side's pass-A
    table before pass B reads it."""
    nx, ny, nz = vol_or.shape
    nu, nv = geom.det_shape
    n_steps = geom.n_steps
    c = sc.shape[0]
    kw = dict(dtype=vol_or.dtype, device=vol_or.device)
    sc = sc.to(vol_or.dtype)
    lerp_a = _dlerp_rows if deriv in ("z", "zm", "zc") else _lerp_rows
    lerp_b = (_dlerp_rows if deriv == "x"
              else _mlerp_rows if deriv == "zm" else _lerp_rows)

    def p(i):
        return sc[:, i].reshape(c, 1, 1, 1)

    edy = p(S_EDY)
    u = torch.arange(nu, **kw).reshape(1, 1, nu, 1)
    v = torch.arange(nv, **kw).reshape(1, 1, 1, nv)
    x = torch.arange(nx, **kw).reshape(1, 1, nx, 1)
    r = torch.arange(-1, ny, **kw).reshape(1, ny + 1, 1, 1)
    cx = p(S_CXB) + p(S_RX) * r                          # (c, ny+1, 1, 1)
    cz = p(S_CZB) + p(S_RZ) * r
    y0_uv = p(S_B1) + u * p(S_EUY) + v * p(S_EVY)       # (c, 1, nu, nv)
    jreal = (r - y0_uv) / edy                           # (c, ny+1, nu, nv)
    jb = torch.ceil(jreal)
    # pass-A sample coordinates via the affine inversion u_aff(x, v)
    inv_eux = 1.0 / p(S_EUX)
    u_aff = (x - cx - v * p(S_EVX)) * inv_eux           # (c, ny+1, nx, nv)
    y0_xv = p(S_B1) + u_aff * p(S_EUY) + v * p(S_EVY)
    jreal_xv = (r - y0_xv) / edy
    cf_xv = torch.ceil(jreal_xv) - jreal_xv             # [0, 1)
    zeta_aff = cz + p(S_GZX) * (x - cx - v * p(S_EVX)) + v * p(S_EVZ)
    # slab pair (r, r + 1), zero slabs padded at r = −1 and r + 1 = ny
    volp = torch.nn.functional.pad(vol_or.permute(1, 0, 2),
                                   (0, 0, 0, 0, 1, 1))  # (ny+2, nx, nz)
    rows = (volp[:-1], volp[1:])                        # each (ny+1, nx, nz)

    out = torch.zeros((c, nu, nv), **kw)
    for b in range(_n_branch(geom.step_size)):
        j = jb + b
        cfb = j - jreal
        fy = edy * cfb
        ok = (j >= 0) & (j < n_steps) & (fy < 1.0)
        X = cx + u * p(S_EUX) + v * p(S_EVX) + p(S_EDX) * cfb
        zeta = zeta_aff + p(S_EDZ) * (cf_xv + b)
        vals = []
        for side in rows:
            tA = lerp_a(side, zeta)                     # (c, ny+1, nx, nv)
            if table_hook is not None:
                tA = table_hook(tA)
            if deriv == "zc":
                # dζ/dedz weighting, evaluated ON the grid (cf_xv wraps
                # mod 1, so no sample-level expansion is exact)
                tA = tA * (cf_xv + b)
            vals.append(lerp_b(tA.transpose(-1, -2), X.transpose(-1, -2))
                        .transpose(-1, -2))             # (c, ny+1, nu, nv)
        if deriv == "y":
            contrib = vals[1] - vals[0]
        else:
            contrib = (1.0 - fy) * vals[0] + fy * vals[1]
        if jweight:
            contrib = contrib * j
        if rweight:
            contrib = contrib * r
        out = out + torch.where(ok, contrib, 0.0).sum(1)
    return out


def _view_chunk(vol_shape, det_shape) -> int:
    nx, ny, nz = vol_shape
    return max(1, (1 << 24) // (nx * ny * max(det_shape + (nz,))))


def forward_oriented(vol_or, scalars, geom: Geometry, quad: str = "plane",
                     deriv: str | None = None, jweight: bool = False,
                     rweight: bool = False, *, table_hook=None):
    """Plain forward of one orientation group: ``vol_or`` (nx, ny, nz),
    ``scalars`` (V, NS) → (V, nu, nv), chunked over views. ``table_hook``
    maps each pass-A table before pass B reads it (the bf16 tier's
    rounding: :func:`bf16_round`, or :func:`round_cotangent` in the
    adjoint).

    ``deriv`` (``"x"``, ``"y"``, ``"z"``, ``"zm"``, ``"zc"``), ``jweight``
    and ``rweight`` select the arc-only Jacobian building blocks: hat′ in
    pass B (x), the slab-pair difference (y), hat′ in pass A (z), hat′ in
    pass A with pass-B first-moment weights (zm) or with the grid sawtooth
    weight cf + b (zc); j/r weights multiply each sample by its march /
    source-slab index."""
    _check_quad(quad)
    if quad == "plane" and (deriv is not None or jweight or rweight):
        raise ValueError("derivative variants are arc-mode only")
    nu, nv = geom.det_shape
    c = _view_chunk(vol_or.shape, geom.det_shape)
    if quad == "plane":
        def run(sc):
            return _forward_chunk(vol_or, sc, nu, nv, table_hook)
    else:
        def run(sc):
            return _forward_chunk_arc(vol_or, sc, geom, deriv, jweight,
                                      rweight, table_hook)
    return torch.cat([run(scalars[i:i + c])
                      for i in range(0, scalars.shape[0], c)])


def adjoint_oriented(g, scalars, geom: Geometry, quad: str = "plane", *,
                     table_hook=None):
    """Plain adjoint of :func:`forward_oriented`: autograd's vjp of the
    linear forward, chunked over views → oriented volume (nx, ny, nz).
    ``table_hook`` goes to the forward (:func:`round_cotangent` rounds the
    pass-B transpose before the vjp of pass A reads it)."""
    c = _view_chunk(geom.vox_shape, geom.det_shape)
    out = torch.zeros(geom.vox_shape, dtype=g.dtype, device=g.device)
    for i in range(0, scalars.shape[0], c):
        with torch.enable_grad():
            x = torch.zeros(geom.vox_shape, dtype=g.dtype, device=g.device,
                            requires_grad=True)
            y = forward_oriented(x, scalars[i:i + c], geom, quad,
                                 table_hook=table_hook)
            (gx,) = torch.autograd.grad(y, x, g[i:i + c])
        out += gx
    return out


def jac_passes_oriented(vol_or, scalars, geom: Geometry):
    """The 12 building blocks of :data:`JAC_PASSES` as plain passes,
    stacked → (V, 12, nu, nv)."""
    return torch.stack([forward_oriented(vol_or, scalars, geom, "arc", dv,
                                         jw, rw)
                        for _, dv, jw, rw in JAC_PASSES], dim=1)


def _theta_one(phi, alpha, beta, t, cor):
    """One view's ``(θ (1, 6), cor (1, 3))`` as float64 CPU tensors, from
    numbers, arrays or tensors on any device."""
    def host(a):
        if torch.is_tensor(a):
            a = a.detach().cpu()
        return torch.as_tensor(np.asarray(a, np.float64)).reshape(-1)

    th = torch.cat([host(t), host(phi), host(alpha), host(beta)])[None]
    return th, host(cor).reshape(1, 3)


def forward_view(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                 dtype=torch.float32, quad: str = "arc",
                 swap: bool | None = None, yflip: bool | None = None):
    """Slab forward projection of one view → ``(n_det,)`` u-major, on
    ``vol``'s device: K1 (plane) or K3 (arc) for a CUDA tensor, their
    plain version on the CPU.

    ``swap``/``yflip`` are the orientation flags (:func:`orient_flags`);
    None computes them on the host from the given parameters. The u-flip
    that the kernels need follows from the oriented scalars."""
    _check_quad(quad)
    from tomojax_torch.kernels import slab as slabk
    vol = torch.as_tensor(vol).reshape(geom.vox_shape).to(dtype)
    th, cor = _theta_one(phi, alpha, beta, t, cor)
    if swap is None or yflip is None:
        sw, yf, _ = orient_flags(Views.from_theta6(th), geom)
        swap, yflip = bool(sw[0]), bool(yf[0])
    sc = slab_scalars_t(geom, th, cor, swap, yflip, False, quad)
    uflip = bool(sc[0, S_EUX] < 0.0)
    if uflip:
        sc = slab_scalars_t(geom, th, cor, swap, yflip, True, quad)
    vol_or = orient_volume(vol, geom, swap, yflip).contiguous()
    out = slabk.slab_project(vol_or, sc.to(dtype=dtype, device=vol.device),
                             geom, quad)[0]
    return (out.flip(0) if uflip else out).reshape(-1)


# ----------------------------------------------------------------------
# Analytic 6-DoF Jacobian (slab analogue of the reference's fused
# projection + gradient, ray_wt_grad.f90:95-223)
# ----------------------------------------------------------------------
#
# Every sample's position is affine in the parameters through the oriented
# view map, so the 6-DoF Jacobian is a detector-space combination of the
# building blocks {∂/∂x, ∂/∂y, ∂/∂z} × {1, j, r} (+ the moment and grid
# sawtooth passes), weighted by the per-view scalars' θ-derivatives.


def _scalar_responses(p: dict, P, PJ, PR, PM, ZC, geom: Geometry):
    """Detector-space response fields ∂out/∂(scalar) for each field of
    :data:`PARAM_FIELDS` (tomojax's ``_scalar_responses``, batched).

    ``p`` holds per-view scalars broadcastable against the ``(V, nu, nv)``
    building blocks: ``P/PJ/PR[axis]`` are the plain / march-index- /
    slab-index-weighted derivative projections for axis ∈ {x, y, z},
    ``PM`` the (x − px)-moment z-derivative and ``ZC`` the grid-sawtooth
    weighted z-derivative projection."""
    nu, nv = geom.det_shape
    u = torch.arange(nu, dtype=PM.dtype, device=PM.device)[:, None]
    v = torch.arange(nv, dtype=PM.dtype, device=PM.device)[None, :]
    inv = 1.0 / p["edy"]
    euy_ieux = p["euy"] / p["eux"]
    g2 = p["gzx"] + p["rz"] * euy_ieux

    def D(axis, w):
        """Response to a per-sample perturbation with weight w."""
        if w == "1":
            return P[axis]
        if w == "u":
            return u * P[axis]
        if w == "v":
            return v * P[axis]
        if w == "r":
            return PR[axis]
        if w == "cfb":   # cfb = j - (r - b1 - u·euy - v·evy)/edy
            return (PJ[axis] - inv * PR[axis]
                    + inv * (p["b1"] * P[axis] + p["euy"] * u * P[axis]
                             + p["evy"] * v * P[axis]))
        if w == "w":     # w = j - cfb
            return (inv * PR[axis]
                    - inv * (p["b1"] * P[axis] + p["euy"] * u * P[axis]
                             + p["evy"] * v * P[axis]))
        raise ValueError(w)

    rx, rz, eux, edx = p["rx"], p["rz"], p["eux"], p["edx"]
    return dict(
        edy=(PJ["y"] + rx * D("x", "w")
             + rz * (D("z", "w") - euy_ieux * rx * D("z", "cfb"))
             - rz * euy_ieux * inv * PM),
        edx=D("x", "cfb"),
        # dζ/dedz = cf_xv + b, computed by the grid-weighted pass ZC
        edz=ZC,
        rx=D("x", "r") - g2 * D("z", "r"),
        rz=D("z", "r"),
        eux=(D("x", "u")
             - rz * euy_ieux * (D("z", "u") + (edx / eux) * D("z", "cfb")
                                + PM / eux)),
        evx=D("x", "v") - g2 * D("z", "v"),
        euz=torch.zeros_like(PM),   # the forward uses gzx, not euz
        evz=D("z", "v"),
        cxb=D("x", "1") - g2 * D("z", "1"),
        czb=D("z", "1"),
        # dζ/dgzx = x - cx_r - v·evx = eux·u + edx·cfb + (x - px)
        gzx=eux * D("z", "u") + edx * D("z", "cfb") + PM,
        b1=rx * D("x", "1") + D("y", "1") + rz * D("z", "1"),
        euy=rx * D("x", "u") + D("y", "u") + rz * D("z", "u"),
        evy=rx * D("x", "v") + D("y", "v") + rz * D("z", "v"),
    )


def assemble_jacobian(stacked, scalars, dparams, geom: Geometry):
    """6-DoF Jacobian ``(V, 6, nu, nv)`` from the 12 building blocks
    ``stacked (V, 12, nu, nv)`` (:data:`JAC_PASSES` order), the group's
    scalars ``(V, NS)`` and ``dparams = d(SlabParams)/dθ (V, 15, 6)``."""
    f = {name: stacked[:, i] for i, (name, *_) in enumerate(JAC_PASSES)}
    p = {k: val.reshape(-1, 1, 1)
         for k, val in params_from_scalars(scalars.to(stacked.dtype))
         .items()}
    resp = _scalar_responses(
        p, {"x": f["px"], "y": f["py"], "z": f["pz"]},
        {"x": f["jx"], "y": f["jy"], "z": f["jz"]},
        {"x": f["rx"], "y": f["ry"], "z": f["rz"]}, f["zm"], f["zc"], geom)
    resp = torch.stack([resp[k] for k in PARAM_FIELDS], dim=1)
    return torch.einsum("vfuw,vfk->vkuw", resp, dparams.to(stacked.dtype))


def forward_view_jac(vol, geom: Geometry, phi, alpha, beta, t, cor, *,
                     dtype=torch.float32, swap: bool | None = None,
                     yflip: bool | None = None):
    """Slab projection + analytic 6-DoF Jacobian of one view, arc mode.

    Returns ``(det_img (n_det,), jac (6, n_det))``, parameter order
    ``(tx, ty, tz, phi, alpha, beta)``. The building blocks go through
    :func:`jac_passes_oriented` (the plain version of the fused Jacobian
    kernel). ``swap``/``yflip`` default to the flags of the given
    parameters."""
    vol = torch.as_tensor(vol).reshape(geom.vox_shape).to(dtype)
    th, cor = (a.to(dtype=dtype, device=vol.device)
               for a in _theta_one(phi, alpha, beta, t, cor))
    if swap is None or yflip is None:
        sw, yf, _ = orient_flags(Views.from_theta6(th.cpu()), geom)
        swap, yflip = bool(sw[0]), bool(yf[0])
    vol_or = orient_volume(vol, geom, swap, yflip)
    sc = slab_scalars_t(geom, th, cor, swap, yflip, False)
    stacked = jac_passes_oriented(vol_or, sc, geom)
    dp = param_jacobian(geom, th, cor, swap, yflip, False)
    jac = assemble_jacobian(stacked, sc, dp, geom)
    return stacked[0, 0].reshape(-1), jac[0].reshape(6, -1)


# ----------------------------------------------------------------------
# Multi-view apply
# ----------------------------------------------------------------------


def _check_square(geom: Geometry):
    nx, ny, _ = geom.vox_shape
    if nx != ny:
        raise ValueError("slab family requires nx == ny (square x-y "
                         f"footprint); got {geom.vox_shape}")


def _row_chunks(n: int, views_chunk: int | None):
    """Row slices of at most ``views_chunk`` rows (all rows if None)."""
    c = n if not views_chunk else max(1, int(views_chunk))
    return [slice(i, i + c) for i in range(0, n, c)]


def project_scalars(vol, geom: Geometry, gstruct, scalars,
                    quad: str = "arc", dtype=torch.float32,
                    views_chunk: int | None = None,
                    prec: str | None = None):
    """Multi-view forward → ``(n_proj, n_det)`` in ``dtype``; each group
    goes through :class:`~tomojax_torch.kernels.slab.SlabPlane` (K1
    forward, K2 backward) or :class:`~tomojax_torch.kernels.slab.SlabArc`
    (K3, K4), in calls of at most ``views_chunk`` views (the result does
    not depend on it), in the tier
    :func:`~tomojax_torch.kernels.slab.resolve_prec` gives ``prec``
    (``"bf16"``: K1b-K4b)."""
    from tomojax_torch.kernels import slab as slabk
    _check_square(geom)
    _check_quad(quad)
    prec = slabk.resolve_prec(prec)
    fn = slabk.SlabPlane if quad == "plane" else slabk.SlabArc
    n = sum(len(g[0]) for g in gstruct)
    nu, nv = geom.det_shape
    with profiling.span("op.A"):
        vol = vol.reshape(geom.vox_shape).to(dtype)
        out = vol.new_zeros((n, nu, nv))
        for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
            with profiling.span("op.group"):
                vol_or = orient_volume(vol, geom, sw, yf).contiguous()
                # a copy from pageable host memory: the host waits
                profiling.count("host_sync.op.rows")
                rows = torch.as_tensor(idx, device=out.device)
                for part in _row_chunks(len(idx), views_chunk):
                    sino = fn.apply(vol_or, sc[part], geom, prec)
                    if uf:
                        sino = sino.flip(1)
                    out[rows[part]] = sino
        return out.reshape(n, geom.n_det)


def backproject_scalars(sino, geom: Geometry, gstruct, scalars,
                        quad: str = "arc", dtype=torch.float32,
                        views_chunk: int | None = None,
                        prec: str | None = None):
    """Exact adjoint of :func:`project_scalars` → volume ``vox_shape`` in
    ``dtype``; each group goes through K2 (plane) or K4 (arc), or K2b/K4b
    in the bf16 tier, in calls of at most ``views_chunk`` views."""
    from tomojax_torch.kernels import slab as slabk
    _check_square(geom)
    prec = slabk.resolve_prec(prec)
    nu, nv = geom.det_shape
    with profiling.span("op.AT"):
        sino = sino.reshape(-1, nu, nv).to(dtype)
        vol = sino.new_zeros(geom.vox_shape)
        for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
            with profiling.span("op.group"):
                profiling.count("host_sync.op.rows")
                rows = torch.as_tensor(idx, device=sino.device)
                for part in _row_chunks(len(idx), views_chunk):
                    g = sino[rows[part]]
                    if uf:
                        g = g.flip(1)
                    vb = slabk.slab_backproject(g.contiguous(), sc[part],
                                                geom, quad, prec)
                    vol += unorient_volume(vb, sw, yf)
        return vol


def project(vol, geom: Geometry, views, *, dtype=torch.float32,
            quad: str = "arc", views_chunk: int | None = None,
            prec: str | None = None, strict_bounds: bool = True,
            device=None):
    """Multi-view slab forward → ``(n_proj, n_det)``, on ``vol``'s device
    unless ``device`` is given. ``views_chunk`` and ``prec`` as in
    :func:`project_scalars`; ``strict_bounds`` does nothing (see
    :func:`scalar_groups`)."""
    device = vol.device if device is None else device
    gstruct, scalars = scalar_groups(geom, views, quad, dtype,
                                     device=device)
    return project_scalars(vol.to(device=device), geom, gstruct, scalars,
                           quad, dtype, views_chunk, prec)


def backproject(sino, geom: Geometry, views, *, dtype=torch.float32,
                quad: str = "arc", views_chunk: int | None = None,
                prec: str | None = None, strict_bounds: bool = True,
                device=None):
    """Exact adjoint of :func:`project` → volume ``vox_shape``."""
    device = sino.device if device is None else device
    gstruct, scalars = scalar_groups(geom, views, quad, dtype,
                                     device=device)
    return backproject_scalars(sino.to(device=device), geom, gstruct,
                               scalars, quad, dtype, views_chunk, prec)

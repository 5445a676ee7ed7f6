"""Shift pre-alignment and moment matching (counterpart of
``tomojax.align.cc``; :func:`com_align` and :func:`moment_match` are
ported, the cross-correlation functions are ROADMAP Queue 1 item 9)."""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.core.operators import resolve_device


def com_align(projections, geom, phi, *, dtype=torch.float32, device=None):
    """Per-view (tx, tz) from the sinogram center-of-mass (Helgason–Ludwig
    first-moment) consistency condition.

    In detector coordinates ``u_com_i = Cx cos(phi_i) + Cy sin(phi_i) −
    tx_i`` and ``v_com_i = Cz − tz_i``: tx is observable up to its
    projection onto span{1, cos φ, sin φ}, so u_com is regressed on that
    span and the negated residual returned; v_com keeps plain mean
    removal (assuming zero-mean jitter).

    :param device: torch device (default: the projections' device if they
        are a tensor, else ``cuda``).
    :returns: (n_proj, 2) tensor of per-view (tx, tz) estimates.
    """
    if device is None and torch.is_tensor(projections):
        device = projections.device
    device = resolve_device(device)
    phi = np.asarray(phi, np.float64)
    n = len(phi)
    nu, nv = geom.det_shape
    p = torch.as_tensor(projections, device=device).to(dtype).reshape(
        n, nu, nv).clamp_min(0.0)
    kw = dict(dtype=dtype, device=p.device)
    mass = p.sum(dim=(1, 2))
    u = torch.arange(nu, **kw).reshape(1, nu, 1)
    v = torch.arange(nv, **kw).reshape(1, 1, nv)
    u_com = (p * u).sum(dim=(1, 2)) / mass
    v_com = (p * v).sum(dim=(1, 2)) / mass
    # least-squares projector onto span{1, cos, sin}, in float64 on the host
    basis = np.stack([np.ones_like(phi), np.cos(phi), np.sin(phi)], 1)
    proj_mat = torch.as_tensor(basis @ np.linalg.pinv(basis), **kw)
    tx = proj_mat @ u_com - u_com
    tz = v_com.mean() - v_com
    return torch.stack([tx, tz], dim=1)


def moment_match(meas, synth, det_shape):
    """Per-view (Δtx, Δtz) additive corrections from sinogram first-moment
    (center-of-mass) matching against reprojections.

    For any volume the reprojection's detector center of mass moves
    rigidly by −t in the co-rotating detector frame, so ``Δt = com(synth)
    − com(meas)`` measures each view's translation error up to the gauge
    (tx: {cos φ, sin φ}, tz: {const}), however much misalignment the
    reconstruction absorbed. Coordinates are centred on the detector and
    the sums taken in float64 on the tensors' device.

    :param meas: measured sinogram ``(n_proj, n_det)`` or ``(n_proj, nu,
        nv)``.
    :param synth: reprojection of the current (volume, θ), same shape.
    :returns: ``(n_proj, 2)`` float64 tensor of (Δtx, Δtz) to ADD to the
        current (tx, tz) estimates; zero for views with no mass.
    """
    nu, nv = det_shape
    m = torch.as_tensor(meas).to(torch.float64).reshape(-1, nu, nv)
    s = torch.as_tensor(synth).to(torch.float64).reshape(-1, nu, nv)
    kw = dict(dtype=torch.float64, device=m.device)
    u = (torch.arange(nu, **kw) - (nu - 1) / 2.0)[None, :, None]
    v = (torch.arange(nv, **kw) - (nv - 1) / 2.0)[None, None, :]

    def com(p):
        mass = p.sum(dim=(1, 2))
        mass = torch.where(mass.abs() > 1e-12, mass, 1.0)
        return (p * u).sum(dim=(1, 2)) / mass, (p * v).sum(dim=(1, 2)) / mass

    mu, mv = com(m)
    su, sv = com(s)
    ok = (m.sum(dim=(1, 2)) > 1e-12) & (s.sum(dim=(1, 2)) > 1e-12)
    return torch.stack([torch.where(ok, su - mu, 0.0),
                        torch.where(ok, sv - mv, 0.0)], dim=1)

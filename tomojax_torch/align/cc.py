"""Shift pre-alignment (counterpart of ``tomojax.align.cc``; only
:func:`com_align` is ported so far, the rest is ROADMAP Queue 1 item 9)."""

from __future__ import annotations

import numpy as np
import torch


def com_align(projections, geom, phi, *, dtype=torch.float32, device=None):
    """Per-view (tx, tz) from the sinogram center-of-mass (Helgason–Ludwig
    first-moment) consistency condition.

    In detector coordinates ``u_com_i = Cx cos(phi_i) + Cy sin(phi_i) −
    tx_i`` and ``v_com_i = Cz − tz_i``: tx is observable up to its
    projection onto span{1, cos φ, sin φ}, so u_com is regressed on that
    span and the negated residual returned; v_com keeps plain mean
    removal (assuming zero-mean jitter).

    :returns: (n_proj, 2) tensor of per-view (tx, tz) estimates.
    """
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

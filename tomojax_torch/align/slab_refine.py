"""Batched slab-family 6-DoF refinement (counterpart of
``tomojax.align.slab_refine``).

Same-orientation views refine together:

1. each step rebuilds the per-view kernel scalars from the θ batch
   (:func:`~tomojax_torch.core.slab_projector.slab_scalars_t`);
2. ONE fused kernel call (K5, :func:`~tomojax_torch.kernels.slab.
   slab_project_jac`) gives the forward value and the 11 other Jacobian
   building blocks of the whole group;
3. the 6-DoF Jacobian assembles in detector space from those blocks and
   the scalars' θ-derivatives (:func:`~tomojax_torch.core.slab_projector.
   assemble_jacobian`);
4. the step is a batched box-projected Levenberg–Marquardt: every view
   carries its own damping, and the trial costs of the whole group are
   one K3 forward.

The loop is eager torch: the per-view accept/reject is a ``torch.where``
and the 6×6 systems go to one batched ``torch.linalg.solve``. On a card
the host still waits, per group and step, at the solve's error check
(``host_sync.lm.solve``) and at each scalar build's copies of host
constants (``host_sync.geometry.*``); the spans ``lm.step`` (``lm.jac``,
``lm.solve``, ``lm.cost``) time a step.
"""

from __future__ import annotations

import numpy as np
import torch

from tomojax_torch.align.refine import (PARAM_SETS, RefineResult, _box,
                                        _mask)
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.utils import profiling


def _batched_forward(vol_or, scalars, geom: Geometry):
    """(V, NS) scalars → (V, nu, nv) arc forward (K3 on a card)."""
    return slabk.slab_project(vol_or, scalars, geom, "arc")


def _group_value_jac(vol_or, theta, cor, geom: Geometry, flags):
    """Batched ``(value (V, nu, nv), jac (V, 6, nu, nv))`` for one octant
    group."""
    sw, yf, uf = flags
    scalars = sp.slab_scalars_t(geom, theta, cor, sw, yf, uf, "arc")
    stacked = slabk.slab_project_jac(vol_or, scalars, geom)
    dp = sp.param_jacobian(geom, theta, cor, sw, yf, uf)
    return stacked[:, 0], sp.assemble_jacobian(stacked, scalars, dp, geom)


@torch.no_grad()
def _lm_group(vol_or, meas, cor, mask_f, lo, hi, theta, lam, steps: int,
              geom: Geometry, flags):
    """Box-constrained batched LM over one group → (θ, cost)."""
    sw, yf, uf = flags

    def costs(th):
        sc = sp.slab_scalars_t(geom, th, cor, sw, yf, uf, "arc")
        r = _batched_forward(vol_or, sc, geom) - meas
        return 0.5 * torch.sum(r * r, dim=(1, 2))

    eye = torch.eye(6, dtype=theta.dtype, device=theta.device)
    with profiling.span("lm.cost"):
        cost = costs(theta)
    for _ in range(steps):
        with profiling.span("lm.step"):
            with profiling.span("lm.jac"):
                val, jac = _group_value_jac(vol_or, theta, cor, geom, flags)
            with profiling.span("lm.solve"):
                r = val - meas
                jm = jac * mask_f[None, :, None, None]
                g = torch.einsum("vkuw,vuw->vk", jm, r)
                H = torch.einsum("vkuw,vluw->vkl", jm, jm)
                damp = lam[:, None] * torch.clamp_min(
                    torch.diagonal(H, dim1=1, dim2=2), 1e-12)
                Hd = (H + eye[None] * (1.0 - mask_f)[None]
                      + torch.diag_embed(damp))
                # the solve's error check reads its status on the host
                profiling.count("host_sync.lm.solve")
                delta = -torch.linalg.solve(
                    Hd, (g * mask_f[None])[..., None])[..., 0]
                theta_new = torch.minimum(
                    torch.maximum(theta + delta * mask_f[None], lo), hi)
            with profiling.span("lm.cost"):
                cost_new = costs(theta_new)
                improved = cost_new < cost
                theta = torch.where(improved[:, None], theta_new, theta)
                lam = torch.where(improved, torch.clamp_min(lam / 3.0, 1e-12),
                                  lam * 10.0)
                cost = torch.where(improved, cost_new, cost)
    return theta, cost


def refine_views_slab(vol, projections, geom: Geometry, views: Views, *,
                      param_set: str = "xzab", mask=None, lower=None,
                      upper=None, max_iter: int = 12,
                      lm_lambda0: float = 1e-3, groups=None,
                      dtype=torch.float32) -> RefineResult:
    """Refine all views' masked 6-DoF on the slab family (batched LM).

    Runs on ``vol``'s device. Views are grouped host-side by orientation
    octant; each group runs the batched box-LM for ``max_iter`` steps
    (per-view damping λ with accept/reject). Bounds are absolute
    6-vector boxes, ``(6,)`` or ``(n, 6)``.

    :param groups: optional FROZEN group structure, a tuple of
        ``(view_indices, swap, yflip, uflip)`` as returned by
        :func:`~tomojax_torch.core.slab_projector.scalar_groups`; the
        alternating driver freezes it at its first outer iteration, so
        small θ drift never reshuffles octant membership.
    """
    if mask is None:
        mask = PARAM_SETS[param_set]
    vol = torch.as_tensor(vol)
    kw = dict(dtype=dtype, device=vol.device)
    n = views.n_proj
    nu, nv = geom.det_shape
    meas_all = torch.as_tensor(projections).to(**kw).reshape(n, nu, nv)
    theta_all = views.theta6().to(**kw)
    cor_all = views.cor.to(**kw)

    lo, hi = _box(lower, -np.inf, n, **kw), _box(upper, np.inf, n, **kw)
    mask_f = _mask(mask, **kw)
    if groups is None:
        profiling.count("host_sync.lm.groups")
        groups = [g for g in sp._orient_groups(views.numpy(), geom)]
    vol = vol.reshape(geom.vox_shape).to(**kw)
    theta_out = torch.zeros((n, 6), **kw)
    cost_out = torch.zeros((n,), **kw)
    for idx, sw, yf, uf in groups:
        # a copy from pageable host memory: the host waits
        profiling.count("host_sync.lm.rows")
        ix = torch.as_tensor(np.asarray(idx), device=vol.device)
        vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
        meas = meas_all[ix]
        if uf:   # the group forward emits u-flipped rows; flip the data
            meas = meas.flip(1)
        theta, cost = _lm_group(
            vol_or, meas, cor_all[ix], mask_f, lo[ix], hi[ix],
            theta_all[ix], torch.full((len(ix),), lm_lambda0, **kw),
            max_iter, geom, (sw, yf, uf))
        theta_out[ix] = theta
        cost_out[ix] = cost
    return RefineResult(theta6=theta_out, cost=cost_out,
                        n_iter=torch.full((n,), max_iter, dtype=torch.int32,
                                          device=vol.device),
                        converged=torch.ones((n,), dtype=torch.bool,
                                             device=vol.device))

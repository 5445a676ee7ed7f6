"""The plain reference of one outer's refinement and moment hook in the
alternating alignment (tomojax's ``lm_slab`` refinement and its moment
hook): a batched box-constrained Levenberg–Marquardt on the arc operator's
Jacobian, then each view's (tx, tz) corrected by first-moment matching
against the support-masked reprojection, with the rigid gauge projected
out.

LM, per view, for ``steps`` steps from ``θ`` with damping ``λ`` (start
``lam0``): ``r = A_θ x − b``, ``J = ∂(A_θ x)/∂θ`` over the masked
parameters, ``g = Jᵀ r``, ``H = JᵀJ``; ``δ = −(H + λ·diag(max(diag H,
1e-12)))⁻¹ g``; the trial ``θ' = clip(θ + δ, lo, hi)`` is taken where its
cost ``½‖A_θ' x − b‖²`` is below the current one, and then ``λ ← max(λ/3,
1e-12)``, else ``λ ← 10 λ``. The small systems are solved in float64.

The moment hook: ``Δ = com(A_θ (x·mask)) − com(b)`` per view (detector
centres of mass, float64), ``Δtx`` less its least-squares fit on ``{cos φ,
sin φ}`` and ``Δtz`` less its mean, added to (tx, tz) and clipped to the
box. The support mask is a cylinder and slab just outside the object's
extent in the data.

This file imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.arc import ArcOperator

# the columns of θ = (tx, ty, tz, φ, α, β) that each parameter set refines
PARAM_SETS = {"xzab": (0, 2, 4, 5)}


def _cost(A, b):
    r = (A - b).double()
    return 0.5 * (r * r).sum(dim=(1, 2))


@torch.no_grad()
def refine(op: ArcOperator, vol, b, theta, lo, hi, cols, steps: int,
           lam0: float = 1e-3):
    """``steps`` LM steps of every view of ``op`` (whose frames it keeps)
    from ``theta (V, 6)`` on the volume ``vol`` against the data ``b (V,
    nu, nv)``, in the box ``[lo, hi]``: the views' final θ (float64)."""
    dev = vol.device
    theta = torch.as_tensor(theta, dtype=torch.float64).to(dev).clone()
    lo, hi = (torch.as_tensor(a, dtype=torch.float64).to(dev)
              for a in (lo, hi))
    b = b.reshape(op.n_views, *op.det)
    cols = list(cols)
    lam = torch.full((op.n_views,), lam0, dtype=torch.float64, device=dev)

    def cost_at(th):
        return _cost(ArcOperator(op.cfg, th, dev, op.flg, op.dtype,
                                 op.block).A(vol), b)

    cost = cost_at(theta)
    for _ in range(steps):
        val, jac = op.value_jac(vol, theta, cols)
        r = (val - b).double()
        jac = jac.double()
        g = torch.einsum("vkuw,vuw->vk", jac, r)
        H = torch.einsum("vkuw,vluw->vkl", jac, jac)
        damp = lam[:, None] * torch.diagonal(H, dim1=1, dim2=2).clamp_min(1e-12)
        delta = -torch.linalg.solve(H + torch.diag_embed(damp),
                                    g[..., None])[..., 0]
        trial = theta.clone()
        trial[:, cols] += delta
        trial = torch.minimum(torch.maximum(trial, lo), hi)
        cost_new = cost_at(trial)
        better = cost_new < cost
        theta = torch.where(better[:, None], trial, theta)
        lam = torch.where(better, (lam / 3.0).clamp_min(1e-12), lam * 10.0)
        cost = torch.where(better, cost_new, cost)
    return theta


def support_mask(b, vox_shape, margin: float = 1.5, thresh_rel: float = 1e-3):
    """The object's support from the data ``b (V, nu, nv)``: a boolean
    volume, a cylinder in x-y and a slab in z whose radii are half the
    widest extent of mass over the views, along u and along v, plus
    ``margin``."""
    p = np.abs(np.asarray(b.cpu(), np.float64))
    radii = []
    for prof in (p.sum(axis=2), p.sum(axis=1)):
        on = prof > thresh_rel * prof.max(axis=1, keepdims=True)
        idx = np.arange(prof.shape[1], dtype=np.float64)
        widths = [(idx[row].max() - idx[row].min()) / 2.0 if row.any()
                  else 0.0 for row in on]
        radii.append(max(widths) + margin)
    nx, ny, nz = vox_shape
    x = np.arange(nx) - (nx - 1) / 2.0
    y = np.arange(ny) - (ny - 1) / 2.0
    z = np.arange(nz) - (nz - 1) / 2.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    return ((r2 <= radii[0] ** 2)[:, :, None]
            & (np.abs(z) <= radii[1])[None, None, :])


def _com(p):
    """``(u, v, mass)`` of each view's centre of mass, detector-centred."""
    nu, nv = p.shape[1:]
    u = (torch.arange(nu, dtype=p.dtype, device=p.device) - (nu - 1) / 2.0)
    v = (torch.arange(nv, dtype=p.dtype, device=p.device) - (nv - 1) / 2.0)
    mass = p.sum(dim=(1, 2))
    m = torch.where(mass.abs() > 1e-12, mass, 1.0)
    return ((p * u[:, None]).sum(dim=(1, 2)) / m,
            (p * v[None, :]).sum(dim=(1, 2)) / m, mass)


@torch.no_grad()
def moment_hook(op: ArcOperator, vol, b, theta, mask, lo, hi):
    """Views ``theta (V, 6)`` with (tx, tz) moved by the moment match of
    the reprojection of ``vol · mask`` (``op``'s frames) against ``b``,
    clipped to ``[lo, hi]`` (float64)."""
    dev = vol.device
    theta = torch.as_tensor(theta, dtype=torch.float64).to(dev)
    synth = ArcOperator(op.cfg, theta, dev, op.flg, op.dtype, op.block).A(
        vol * torch.as_tensor(mask, device=dev))
    su, sv, sm = _com(synth.double())
    mu, mv, mm = _com(b.reshape(synth.shape).double())
    ok = (mm > 1e-12) & (sm > 1e-12)
    du = torch.where(ok, su - mu, 0.0)
    dv = torch.where(ok, sv - mv, 0.0)
    phi = theta[:, 3]
    basis = torch.stack([torch.cos(phi), torch.sin(phi)], 1)
    du = du - basis @ (torch.linalg.pinv(basis) @ du)
    dv = dv - dv.mean()
    out = theta.clone()
    out[:, 0] += du
    out[:, 2] += dv
    lo, hi = (torch.as_tensor(a, dtype=torch.float64).to(dev)
              for a in (lo, hi))
    return torch.minimum(torch.maximum(out, lo), hi)

"""The plain reference of one outer's exact refinement and moment hook (the
alternating driver's ``refine_method="lm"`` on the ray projector): each
view's box-constrained Levenberg–Marquardt on the projector's Jacobian,
then its (tx, tz) moved by first-moment matching.

LM, per view, from ``θ`` clipped into the box ``[lo, hi]``, with damping
``λ`` (start ``lam0`` = 1e-3), for at most ``steps`` steps: ``r = A_θ x −
b``, ``J = ∂(A_θ x)/∂θ`` over the refined parameters, ``g = Jᵀ r``, ``H =
JᵀJ``, ``δ = −(H + λ·diag(max(diag H, 1e-12)))⁻¹ g``; the trial ``θ' =
clip(θ + δ, lo, hi)`` is taken where its cost ``½‖A_θ' x − b‖²`` is below
``c``, the cost at ``θ``; then ``λ ← max(λ/3, 1e-12)``, else ``λ ← 10 λ``.
A view stops, and keeps its θ from then on, once a taken step changed its
cost by ``|c − c'| / max(c, c', 1) ≤ eps`` (1e-8), or once ``λ > 1e8``.
Scalars and the small systems are float64.

The hook: the reprojection of ``x · mask`` at the refined views against
``b``, each view's (Δtx, Δtz) the difference of their detector centres of
mass (``reference/lm.py``'s ``_com``), Δtx less its least-squares fit on
{cos φ, sin φ}, Δtz less its mean, added to (tx, tz) and clipped to the
box.

Why not ``reference/lm.py``: its LM runs every view a fixed number of
steps (no per-view stop) without first clipping the start, and it builds
the arc operator itself; here the operator is any object with ``A(vol,
theta)`` and ``value_jac(vol, theta, cols)``. The support mask is
``reference/lm.py``'s. This file imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference.lm import _com

LAM0 = 1e-3
EPS = 1e-8


def _cost(pred, b):
    r = (pred - b).double()
    return 0.5 * (r * r).sum(dim=(1, 2))


def _f64(a, device):
    return torch.as_tensor(a).to(device=device, dtype=torch.float64)


@torch.no_grad()
def refine(op, vol, b, theta, lo, hi, cols, steps: int, eps: float = EPS,
           lam0: float = LAM0):
    """The refined views ``(V, 6)`` (float64) of ``theta`` on the volume
    ``vol`` against the data ``b (V, nu, nv)``."""
    dev = vol.device
    lo, hi = _f64(lo, dev), _f64(hi, dev)
    theta = torch.minimum(torch.maximum(_f64(theta, dev), lo), hi)
    n = theta.shape[0]
    b = _f64(b, dev).reshape(n, *op.det)
    cols = list(cols)
    lam = torch.full((n,), lam0, dtype=torch.float64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(steps):
        act = torch.nonzero(~done).flatten()
        if act.numel() == 0:
            break
        th, ba = theta[act], b[act]
        val, jac = op.value_jac(vol, th, cols)
        r = val.double() - ba
        c = 0.5 * (r * r).sum(dim=(1, 2))
        jac = jac.double()
        g = torch.einsum("vkuw,vuw->vk", jac, r)
        H = torch.einsum("vkuw,vluw->vkl", jac, jac)
        damp = lam[act, None] * torch.diagonal(H, dim1=1, dim2=2
                                               ).clamp_min(1e-12)
        delta = -torch.linalg.solve(H + torch.diag_embed(damp),
                                    g[..., None])[..., 0]
        trial = th.clone()
        trial[:, cols] += delta
        trial = torch.minimum(torch.maximum(trial, lo[act]), hi[act])
        c_new = _cost(op.A(vol, trial), ba)
        improved = c_new < c
        lam2 = torch.where(improved, (lam[act] / 3.0).clamp_min(1e-12),
                           lam[act] * 10.0)
        rel = (c - c_new).abs() / torch.maximum(c, c_new).clamp_min(1.0)
        theta[act] = torch.where(improved[:, None], trial, th)
        lam[act] = lam2
        done[act] = (improved & (rel <= eps)) | (lam2 > 1e8)
    return theta


@torch.no_grad()
def moment_hook(op, vol, b, theta, mask, lo, hi):
    """Views ``theta (V, 6)`` with (tx, tz) moved by the moment match of
    the reprojection of ``vol · mask`` against ``b``, clipped to ``[lo,
    hi]`` (float64)."""
    dev = vol.device
    theta = _f64(theta, dev)
    synth = op.A(vol * torch.as_tensor(mask, device=dev), theta).double()
    su, sv, sm = _com(synth)
    mu, mv, mm = _com(_f64(b, dev).reshape(synth.shape))
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
    return torch.minimum(torch.maximum(out, _f64(lo, dev)), _f64(hi, dev))

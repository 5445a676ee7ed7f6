"""Per-view refinement (counterpart of ``tomojax.align.refine``).

Ported: the parameter-subset masks, the result type, the alignment cost
on the fast and the exact ray family, and fast-family gradient descent
with Armijo (or Wolfe) backtracking and the brute 10×-backoff fallback
(:func:`gradient_descent_view`, and :func:`gradient_descent_views`, its
batch over views — tomojax's ``jax.vmap`` of it). The exact-family
gradient, finite differences and LM of that module are ROADMAP Queue 1
item 14.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import projector
from tomojax_torch.core.geometry import Geometry
from tomojax_torch.recon.linesearch import armijo, brute_backoff, wolfe

# Boolean masks over (tx, ty, tz, phi, alpha, beta), one per reference
# cost/gradient wrapper pair (tomojax/align/refine.py:38).
PARAM_SETS = {
    "xzpab": (True, False, True, True, True, True),
    "xzab": (True, False, True, False, True, True),
    "xz": (True, False, True, False, False, False),
    "x": (True, False, False, False, False, False),
    "z": (False, False, True, False, False, False),
    "ab": (False, False, False, False, True, True),
    "a": (False, False, False, False, True, False),
    "b": (False, False, False, False, False, True),
    "xzb": (True, False, True, False, False, True),
    "all": (True, True, True, True, True, True),
}


class RefineResult(NamedTuple):
    theta6: torch.Tensor     # refined absolute 6-DoF parameters (n, 6)
    cost: torch.Tensor       # final ½‖residual‖² per view (n,)
    n_iter: torch.Tensor     # iterations run per view
    converged: torch.Tensor  # per-view flag


def alignment_costs(vol, projections, geom: Geometry, theta, cor, *,
                    dtype=torch.float32, family: str = "ray"):
    """½‖P(θ_v)x − p_v‖² of each of V views → (V,). ``family="fast"``
    projects with the fast family (each view deciding its octant at its
    own θ); any other family, as in tomojax, with the exact ray family
    (the default, as tomojax's).
    θ (V, 6) may require grad: the gradient flows through the fast
    family's affine map, its inverse and the resample kernels, or through
    the ray family's analytic Jacobian."""
    if family == "fast":
        E, B = fastp.view_affine(geom, theta[:, 3], theta[:, 4],
                                 theta[:, 5], theta[:, :3], cor, dtype)
        pred = fastp.forward_views(vol.reshape(geom.vox_shape).to(dtype),
                                   geom, E, B)
    else:
        pred = projector.project_views_t(vol.reshape(geom.vox_shape), theta,
                                         geom, cor, dtype)
    r = pred - projections.reshape(pred.shape).to(pred.dtype)
    return 0.5 * (r * r).sum(-1)


def alignment_cost(vol, proj_meas, geom: Geometry, theta6, cor,
                   dtype=torch.float32, family: str = "ray"):
    """½‖P(θ)x − p‖² for one view (tomojax's ``alignment_cost``, with its
    default family, the exact ray family)."""
    return alignment_costs(vol, proj_meas[None], geom, theta6[None],
                           torch.as_tensor(cor)[None], dtype=dtype,
                           family=family)[0]


def gradient_descent_views(vol, projections, geom: Geometry, theta_init,
                           cor, *, mask=None, max_iter: int = 100,
                           eps: float = 1e-6, step_search: str = "armijo",
                           family: str = "fast", param_scale=None,
                           dtype=torch.float32) -> RefineResult:
    """Gradient descent of every view at once; each view's result is
    :func:`gradient_descent_view`'s for that view alone.

    Per view: preconditioned direction ``d = −g·param_scale²``, first
    trial step ``min(1, 1/‖d‖)``, Armijo (or Wolfe) backtracking; where it
    fails, the brute 10×-backoff, and two brute searches (or a failed one)
    stop the view; a relative cost change ≤ ``eps`` converges it. The
    volume is a constant (detached); θ-gradients come from autograd,
    evaluated in chunks of views sized by memory
    (:func:`~tomojax_torch.core.fast_projector.views_per_chunk`).

    :param theta_init: (V, 6) starting parameters; ``cor`` (V, 3).
    :param mask: 6 booleans (default "xzab"); frozen parameters get a zero
        gradient.
    :param param_scale: diagonal preconditioner (default (1, 1, 1, 0.01,
        0.01, 0.01): angles have ~100× the gradient of translations).
    """
    if family != "fast":
        raise NotImplementedError(
            f"gradient descent on family {family!r} (the exact ray family's "
            "gradient): ROADMAP Queue 1 item 14")
    dev = vol.device
    kw = dict(dtype=dtype, device=dev)
    vol = vol.detach().reshape(geom.vox_shape).to(dtype)
    th = torch.as_tensor(theta_init).detach().to(**kw).clone()
    n = th.shape[0]
    meas = torch.as_tensor(projections).detach().to(**kw).reshape(n, -1)
    cor = torch.as_tensor(cor).detach().to(**kw).reshape(n, 3)
    mask_f = torch.tensor(PARAM_SETS["xzab"] if mask is None else
                          tuple(bool(m) for m in mask), **kw)
    scale = torch.tensor((1.0, 1.0, 1.0, 0.01, 0.01, 0.01)
                         if param_scale is None else param_scale, **kw)
    precond = scale * scale
    size = vol.element_size()
    ch_f = fastp.views_per_chunk(geom, itemsize=size)
    ch_g = fastp.views_per_chunk(geom, grad=True, itemsize=size)

    def cost(x, idx):
        with torch.no_grad():
            return torch.cat([
                alignment_costs(vol, meas[idx[c:c + ch_f]], geom,
                                x[c:c + ch_f], cor[idx[c:c + ch_f]],
                                dtype=dtype, family=family)
                for c in range(0, len(idx), ch_f)])

    def grad(x, idx):
        out = []
        with torch.enable_grad():
            for c in range(0, len(idx), ch_g):
                xs = x[c:c + ch_g].detach().requires_grad_(True)
                f = alignment_costs(vol, meas[idx[c:c + ch_g]], geom, xs,
                                    cor[idx[c:c + ch_g]], dtype=dtype,
                                    family=family)
                out.append(torch.autograd.grad(f.sum(), xs)[0])
        return torch.cat(out) * mask_f

    zeros = dict(dtype=torch.int32, device=dev)
    f = cost(th, torch.arange(n, device=dev))
    it, stop, brute = (torch.zeros(n, **zeros) for _ in range(3))
    while True:
        act = torch.nonzero((it < max_iter) & (stop == 0)).flatten()
        if act.numel() == 0:
            break
        x, f0 = th[act], f[act]
        g = grad(x, act)
        d = -g * precond
        a0 = torch.clamp(1.0 / (1e-12 + torch.linalg.norm(d, dim=-1)),
                         max=1.0)

        def f_act(xx, j):
            return cost(xx, act[j])

        if step_search == "wolfe":
            ls = wolfe(f_act, lambda xx, j: grad(xx, act[j]), x, d, g, f0,
                       alpha0=a0)
        else:
            ls = armijo(f_act, x, d, g, f0, alpha0=a0)
        th_new = x + ls.alpha[:, None] * d
        f_new = ls.f_new.clone()
        st = torch.zeros(len(act), **zeros)
        br = brute[act].clone()
        fail = torch.nonzero(~ls.success).flatten()
        if fail.numel():
            # brute backoff only where Armijo failed (tomojax's lax.cond)
            bb = brute_backoff(lambda xx, j: cost(xx, act[fail[j]]),
                               x[fail], d[fail], f0[fail], alpha0=1.0)
            th_new[fail] = torch.where(
                bb.success[:, None], x[fail] + bb.alpha[:, None] * d[fail],
                x[fail])
            f_new[fail] = torch.where(bb.success, bb.f_new, f0[fail])
            br[fail] += 1
            st[fail] = torch.where(~bb.success | (br[fail] >= 2), 2,
                                   0).to(torch.int32)
        rel = (f_new - f0).abs() / torch.maximum(f_new, f0).clamp_min(1.0)
        st = torch.maximum(st, (rel <= eps).to(torch.int32))
        th[act], f[act], stop[act], brute[act] = th_new, f_new, st, br
        it[act] += 1
    return RefineResult(theta6=th, cost=f, n_iter=it, converged=stop > 0)


def gradient_descent_view(vol, proj_meas, geom: Geometry, theta6_init, cor,
                          **kw) -> RefineResult:
    """Gradient descent of one view (tomojax's ``gradient_descent_view``);
    keywords as :func:`gradient_descent_views`."""
    r = gradient_descent_views(vol, torch.as_tensor(proj_meas)[None], geom,
                               torch.as_tensor(theta6_init)[None],
                               torch.as_tensor(cor)[None], **kw)
    return RefineResult(*(a[0] for a in r))

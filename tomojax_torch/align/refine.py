"""Per-view refinement (counterpart of ``tomojax.align.refine``).

- the parameter-subset masks and the result type;
- the alignment cost on the fast and the exact ray family, and on the ray
  family its analytic gradient (:func:`alignment_cost_grad`, from the
  fused projection + Jacobian) and a central-difference check of it
  (:func:`fd_gradient`);
- box-constrained Levenberg–Marquardt on the ray family's exact Jacobian
  (:func:`refine_view`, and :func:`refine_views`, tomojax's ``jax.vmap``
  of it as one batched loop);
- gradient descent with Armijo (or Wolfe) backtracking and the brute
  10×-backoff fallback on either family (:func:`gradient_descent_view`,
  and :func:`gradient_descent_views`, its batch over views).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import projector
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.recon.linesearch import armijo, brute_backoff, wolfe
from tomojax_torch.utils import profiling

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


def alignment_costs_grad(vol, projections, geom: Geometry, theta, cor, *,
                         dtype=torch.float32):
    """Cost, gradient, residual and Jacobian of V views on the exact ray
    family from one fused projection + Jacobian apply
    (:func:`~tomojax_torch.core.projector.forward_views_jac`): ``(cost
    (V,), grad (V, 6), r (V, n_det), J (V, 6, n_det))`` with ``grad =
    J·r``, ``r = P(θ)x − p``; θ (V, 6), ``cor`` (V, 3)."""
    pred, jac = projector.forward_views_jac(
        vol.reshape(geom.vox_shape), geom, theta[:, 3], theta[:, 4],
        theta[:, 5], theta[:, :3], cor, dtype=dtype)
    r = pred - projections.reshape(pred.shape).to(pred.dtype)
    return (0.5 * (r * r).sum(-1), torch.einsum("vpr,vr->vp", jac, r), r,
            jac)


def alignment_cost_grad(vol, proj_meas, geom: Geometry, theta6, cor,
                        dtype=torch.float32):
    """(cost, 6-gradient, residual, J) of one view on the exact ray family
    (tomojax's ``alignment_cost_grad``: grad = J·(P(θ)x − p))."""
    out = alignment_costs_grad(vol, torch.as_tensor(proj_meas)[None], geom,
                               torch.as_tensor(theta6)[None],
                               torch.as_tensor(cor)[None], dtype=dtype)
    return tuple(a[0] for a in out)


def _mask(mask, **kw):
    """Float 0/1 tensor of a 6-bool mask (default "xzab"); on a card the
    copy from host memory makes the host wait."""
    profiling.count("host_sync.lm.mask")
    return torch.tensor([float(bool(m)) for m in (
        PARAM_SETS["xzab"] if mask is None else mask)], **kw)


def fd_gradient(vol, proj_meas, geom: Geometry, theta6, cor, *, mask=None,
                eps: float = 1e-4, dtype=torch.float32):
    """Central-difference gradient of the ray-family alignment cost over
    the masked parameters (zero elsewhere), for checking the analytic
    Jacobian (tomojax's ``fd_gradient``). The 2k probes of the k masked
    parameters are one batch of views."""
    vol = torch.as_tensor(vol)
    kw = dict(dtype=dtype, device=vol.device)
    theta6 = torch.as_tensor(theta6).to(**kw)
    on = torch.nonzero(_mask(mask, **kw)).flatten()
    grad = torch.zeros(6, **kw)
    if on.numel():
        dp = torch.eye(6, **kw)[on] * eps
        th = torch.cat([theta6 + dp, theta6 - dp])
        m = len(on)
        c = alignment_costs(
            vol, torch.as_tensor(proj_meas).to(**kw).reshape(1, -1).expand(
                2 * m, -1), geom, th,
            torch.as_tensor(cor).to(**kw).reshape(1, 3).expand(2 * m, -1),
            dtype=dtype)
        grad[on] = (c[:m] - c[m:]) / (2 * eps)
    return grad


def _lm_step(jac, r, lam, mask_f):
    """The LM step δ (V, 6) of V views from their Jacobians ``jac`` (V, 6,
    n_det), residuals ``r`` (V, n_det) and dampings ``lam`` (V,): the
    damped normal equations on the masked subspace, with the identity on
    the frozen coordinates, which keeps the solve well-posed and their
    step zero."""
    jm = jac * mask_f[:, None]
    g = torch.einsum("vpr,vr->vp", jm, r)
    H = torch.einsum("vpr,vqr->vpq", jm, jm)
    damp = lam[:, None] * torch.clamp_min(
        torch.diagonal(H, dim1=1, dim2=2), 1e-12)
    Hd = H + torch.diag_embed(damp) + torch.diag(1.0 - mask_f)
    # the solve's error check reads its status on the host
    profiling.count("host_sync.lm.solve")
    return -torch.linalg.solve(Hd, (g * mask_f)[..., None])[..., 0]


@torch.no_grad()
def _lm_views(vol, meas, geom: Geometry, theta0, cor, mask_f, lo, hi,
              max_iter: int, eps: float, lm_lambda0: float, dtype):
    """tomojax's per-view box LM (``refine_view``) of V views as one
    batched loop. A view stops once it converges; its θ, λ, cost and
    ``n_iter`` then stay frozen while the others step, as under tomojax's
    ``vmap`` of a ``while_loop``. One host sync per step: the indices of
    the views still running (the loop ends when there are none)."""
    kw = dict(dtype=dtype, device=vol.device)
    n = theta0.shape[0]
    theta = torch.minimum(torch.maximum(theta0, lo), hi)
    lam = torch.full((n,), lm_lambda0, **kw)
    it = torch.zeros(n, dtype=torch.int32, device=vol.device)
    done = torch.zeros(n, dtype=torch.bool, device=vol.device)
    with profiling.span("lm.cost"):
        cost = alignment_costs(vol, meas, geom, theta, cor, dtype=dtype)
    for _ in range(max_iter):
        # the indices of the views still running are read on the host
        profiling.count("host_sync.lm.active")
        act = torch.nonzero(~done).flatten()
        if act.numel() == 0:
            break
        with profiling.span("lm.step"):
            th, m, c_act = theta[act], meas[act], cor[act]
            with profiling.span("lm.jac"):
                c, _, r, jac = alignment_costs_grad(vol, m, geom, th, c_act,
                                                    dtype=dtype)
            with profiling.span("lm.solve"):
                delta = _lm_step(jac, r, lam[act], mask_f)
                th_new = torch.minimum(
                    torch.maximum(th + delta * mask_f, lo[act]), hi[act])
            with profiling.span("lm.cost"):
                c_new = alignment_costs(vol, m, geom, th_new, c_act,
                                        dtype=dtype)
                improved = c_new < c
                lam2 = torch.where(improved,
                                   torch.clamp_min(lam[act] / 3.0, 1e-12),
                                   lam[act] * 10.0)
                rel = ((c - c_new).abs()
                       / torch.maximum(c, c_new).clamp_min(1.0))
                theta[act] = torch.where(improved[:, None], th_new, th)
                cost[act] = torch.where(improved, c_new, c)
                lam[act] = lam2
                done[act] = (improved & (rel <= eps)) | (lam2 > 1e8)
                it[act] += 1
    return RefineResult(theta6=theta, cost=cost, n_iter=it, converged=done)


def _box(bound, fill, n, **kw):
    """An absolute bound, ``(6,)`` or ``(n, 6)`` (None: ``fill``) → (n, 6)."""
    if bound is None:
        return torch.full((n, 6), fill, **kw)
    return torch.as_tensor(bound).to(**kw).broadcast_to((n, 6))


def refine_views(vol, projections, geom: Geometry, views: Views, *,
                 mask=None, lower=None, upper=None, max_iter: int = 20,
                 eps: float = 1e-8, dtype=torch.float32) -> RefineResult:
    """Box-constrained Levenberg–Marquardt of every view's masked 6-DoF
    on the exact ray family's analytic Jacobian (tomojax's ``vmap`` of
    :func:`refine_view`), on ``vol``'s device.

    Per view and step: the damped normal equations ``(H + λ·max(diag H,
    1e-12) + I_frozen) δ = −g`` on the masked parameters, the step clipped
    to ``[lower, upper]``, accepted iff the cost falls (then λ/3, else
    λ·10); a view stops at a relative cost change ≤ ``eps`` after an
    accepted step, or at λ > 1e8 (``converged``), or after ``max_iter``
    steps.

    :param mask: 6 booleans (default "xzab"); frozen parameters never move.
    :param lower, upper: absolute bounds, ``(6,)`` or ``(n, 6)`` (default
        unbounded).
    """
    vol = torch.as_tensor(vol)
    kw = dict(dtype=dtype, device=vol.device)
    n = views.n_proj
    return _lm_views(
        vol.reshape(geom.vox_shape).to(dtype),
        torch.as_tensor(projections).to(**kw).reshape(n, -1), geom,
        views.theta6().to(**kw), views.cor.to(**kw), _mask(mask, **kw),
        _box(lower, -np.inf, n, **kw), _box(upper, np.inf, n, **kw),
        max_iter, eps, 1e-3, dtype)


def refine_view(vol, proj_meas, geom: Geometry, theta6_init, cor, *,
                mask=None, lower=None, upper=None, max_iter: int = 20,
                eps: float = 1e-8, lm_lambda0: float = 1e-3,
                dtype=torch.float32) -> RefineResult:
    """Box-constrained LM of one view (tomojax's ``refine_view``);
    arguments as :func:`refine_views`, with ``lm_lambda0`` the starting
    damping."""
    vol = torch.as_tensor(vol)
    kw = dict(dtype=dtype, device=vol.device)
    r = _lm_views(vol.reshape(geom.vox_shape).to(dtype),
                  torch.as_tensor(proj_meas).to(**kw).reshape(1, -1), geom,
                  torch.as_tensor(theta6_init).to(**kw).reshape(1, 6),
                  torch.as_tensor(cor).to(**kw).reshape(1, 3),
                  _mask(mask, **kw), _box(lower, -np.inf, 1, **kw),
                  _box(upper, np.inf, 1, **kw), max_iter, eps, lm_lambda0,
                  dtype)
    return RefineResult(*(a[0] for a in r))


def gradient_descent_views(vol, projections, geom: Geometry, theta_init,
                           cor, *, mask=None, max_iter: int = 100,
                           eps: float = 1e-6, step_search: str = "armijo",
                           family: str = "ray", param_scale=None,
                           dtype=torch.float32) -> RefineResult:
    """Gradient descent of every view at once; each view's result is
    :func:`gradient_descent_view`'s for that view alone.

    Per view: preconditioned direction ``d = −g·param_scale²``, first
    trial step ``min(1, 1/‖d‖)``, Armijo (or Wolfe) backtracking; where it
    fails, the brute 10×-backoff, and two brute searches (or a failed one)
    stop the view; a relative cost change ≤ ``eps`` converges it. The
    volume is a constant (detached). θ-gradients: on the fast family by
    autograd through its resample kernels, on the exact ray family (the
    default, as tomojax's) from the analytic Jacobian
    (:func:`alignment_costs_grad`); both evaluated in chunks of views
    sized by memory (:func:`~tomojax_torch.core.fast_projector.
    views_per_chunk`).

    :param theta_init: (V, 6) starting parameters; ``cor`` (V, 3).
    :param mask: 6 booleans (default "xzab"); frozen parameters get a zero
        gradient.
    :param param_scale: diagonal preconditioner (default (1, 1, 1, 0.01,
        0.01, 0.01): angles have ~100× the gradient of translations).
    """
    dev = vol.device
    kw = dict(dtype=dtype, device=dev)
    vol = vol.detach().reshape(geom.vox_shape).to(dtype)
    th = torch.as_tensor(theta_init).detach().to(**kw).clone()
    n = th.shape[0]
    meas = torch.as_tensor(projections).detach().to(**kw).reshape(n, -1)
    cor = torch.as_tensor(cor).detach().to(**kw).reshape(n, 3)
    mask_f = _mask(mask, **kw)
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
        if family != "fast":
            with torch.no_grad():
                for c in range(0, len(idx), ch_g):
                    ix = idx[c:c + ch_g]
                    out.append(alignment_costs_grad(
                        vol, meas[ix], geom, x[c:c + ch_g], cor[ix],
                        dtype=dtype)[1])
            return torch.cat(out) * mask_f
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
                          *, mask=None, max_iter: int = 100,
                          eps: float = 1e-6, step_search: str = "armijo",
                          family: str = "ray", param_scale=None,
                          dtype=torch.float32) -> RefineResult:
    """Gradient descent of one view (tomojax's ``gradient_descent_view``);
    keywords as :func:`gradient_descent_views`."""
    r = gradient_descent_views(vol, torch.as_tensor(proj_meas)[None], geom,
                               torch.as_tensor(theta6_init)[None],
                               torch.as_tensor(cor)[None], mask=mask,
                               max_iter=max_iter, eps=eps,
                               step_search=step_search, family=family,
                               param_scale=param_scale, dtype=dtype)
    return RefineResult(*(a[0] for a in r))

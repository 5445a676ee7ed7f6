"""Alternating reconstruction ↔ alignment driver with checkpoint/resume.

Counterpart of ``tomojax.align.pipeline.align_reconstruct`` for the slab
and fast families: alternate

1. reconstruct (CGLS or SIRT, warm-started from the previous outer) with
   the current per-view rigid estimates, then
2. refine every view's masked 6-DoF parameters against the measured
   projections with the batched slab LM (``refine_method="lm_slab"``) or
   Armijo gradient descent through the fast family
   (``refine_method="gd_fast"``),
3. optionally correct (tx, tz) by first-moment matching against the
   reprojection (the moment hook) and extrapolate the θ sequence
   (Aitken Δ², with a corner escape and a tilt-sign flip rescue).

Each outer iteration can checkpoint (volume, per-view θ, history and the
extrapolation state) and a restart resumes from the latest checkpoint.
The slab families' octant groups of the solver and of the refinement are
frozen across outers, as in tomojax; the fast family regroups its views
at every apply, as tomojax's does. What tomojax needs only against its
TPU runtime (compiled-program caches, per-chunk partial refinement files)
has no counterpart here.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tomojax_torch.align.cc import moment_match
from tomojax_torch.align.refine import (PARAM_SETS, RefineResult,
                                        gradient_descent_views)
from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import (NOT_PORTED, QUADS, make_operator,
                                          operator_from_scalars,
                                          resolve_device)
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.recon.sirt import sirt

REFINE_NOT_PORTED = {
    "lm": "refine_method='lm' (exact-family LM): ROADMAP Queue 1 item 14",
}


class AlignState(NamedTuple):
    views: Views                # current per-view parameter estimates
    volume: torch.Tensor        # current reconstruction
    residuals: torch.Tensor     # (n_proj,) final per-view ½‖r‖²
    history: dict               # per-outer-iteration metric lists


def _support_mask(geom: Geometry, projections, margin: float = 1.5,
                  thresh_rel: float = 1e-3) -> np.ndarray:
    """Object-support mask for the moment hook, estimated FROM THE DATA.

    The per-view mass-bearing u/v width of the sinogram is shift-invariant,
    so ``max_views(width/2) + margin`` bounds the object's projected radius
    with no knowledge of t: the mask sits just outside the object support
    (detector-edge truncation then cancels between data and reprojection)
    and well inside the volume corners (where a reconstruction absorbs the
    moment signal). Returns a boolean ``vox_shape`` mask (cylinder in
    x–y, slab in z)."""
    nu, nv = geom.det_shape
    p = np.abs(np.asarray(projections, np.float64)).reshape(-1, nu, nv)
    radii = []
    for prof, nn in ((p.sum(axis=2), nu), (p.sum(axis=1), nv)):
        on = prof > thresh_rel * prof.max(axis=1, keepdims=True)
        idx = np.arange(nn, dtype=np.float64)
        w = np.array([(idx[row].max() - idx[row].min()) / 2.0
                      if row.any() else 0.0 for row in on])
        radii.append(float(w.max()) + margin)
    ru, rv = radii
    nx, ny, nz = geom.vox_shape
    x = np.arange(nx, dtype=np.float64) - (nx - 1) / 2.0
    y = np.arange(ny, dtype=np.float64) - (ny - 1) / 2.0
    z = np.arange(nz, dtype=np.float64) - (nz - 1) / 2.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    return (r2 <= ru * ru)[:, :, None] & (np.abs(z) <= rv)[None, None, :]


def _project_out_gauge(dmom, phi):
    """Remove the rigid-gauge component from per-view (Δtx, Δtz) moment
    corrections: tx loses its least-squares fit on {cos φ, sin φ} (a
    global volume shift), tz its mean. The fit is the min-norm solution
    (pseudo-inverse), so a single view or all-equal φ stays finite."""
    dmom = torch.as_tensor(dmom)
    phi = torch.as_tensor(phi).to(dtype=dmom.dtype, device=dmom.device)
    A = torch.stack([torch.cos(phi), torch.sin(phi)], 1)
    du = dmom[:, 0] - A @ (torch.linalg.pinv(A) @ dmom[:, 0])
    dv = dmom[:, 1] - dmom[:, 1].mean()
    return torch.stack([du, dv], 1)


def aitken_extrapolate(th0, th1, th2, lo, hi, mask, gain_cap=100.0):
    """Elementwise Aitken Δ² extrapolation of the alternation map (numpy).

    From three consecutive iterates the limit of a geometric sequence is
    ``θ2 + d1·r/(1 − r)`` (``d1 = θ2 − θ1``, ``r = d1/d0``); it is applied
    only where the sequence contracts in a consistent direction (``d1·d0
    > 0``, ``|r| < 0.995``) for masked parameters, with the jump capped at
    ``gain_cap``·|d1| and clipped into the box."""
    th0, th1, th2 = (np.asarray(a, np.float64) for a in (th0, th1, th2))
    d0, d1 = th1 - th0, th2 - th1
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(np.abs(d0) > 0, d1 / np.where(d0 == 0, 1.0, d0), 0.0)
    ok = (d1 * d0 > 0) & (np.abs(r) < 0.995) & np.asarray(mask)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        gain = np.clip(r / np.where(r == 1.0, np.inf, 1.0 - r),
                       -gain_cap, gain_cap)
    out = np.where(ok, th2 + d1 * gain, th2)
    return np.clip(out, np.asarray(lo, np.float64),
                   np.asarray(hi, np.float64))


def _default_bounds(dtype=torch.float32, device=None):
    """The reference's box: ±3 px translations, ±0.02 rad tilts, phi
    unconstrained."""
    lo = torch.tensor([-3.0, -3.0, -3.0, -np.inf, -0.02, -0.02], dtype=dtype,
                      device=device)
    return lo, -lo


def _check_supported(family, recon, refine_method, debias_period,
                     recon_prec):
    if family in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[family])
    if family == "ray":
        raise NotImplementedError(
            "align_reconstruct on the exact ray family: ROADMAP Queue 1 "
            "item 10")
    if family not in QUADS and family != "fast":
        raise ValueError(f"unknown projector family: {family!r}")
    if refine_method in REFINE_NOT_PORTED:
        raise NotImplementedError(REFINE_NOT_PORTED[refine_method])
    if refine_method not in ("lm_slab", "gd_fast"):
        raise ValueError(f"unknown refine_method {refine_method!r}")
    if debias_period:
        raise NotImplementedError(
            "debias_period (the exact-family debias stage): ROADMAP Queue 1 "
            "item 10")
    if recon_prec != "f32x2":
        raise NotImplementedError(
            f"recon_prec={recon_prec!r}: a reduced-precision tier needs its "
            "own contract (ROADMAP Queue 3)")
    if recon not in ("sirt", "cgls"):
        raise ValueError(f"unknown recon {recon!r}")


def _views_on(views: Views, dtype, device) -> Views:
    return Views(**{f: getattr(views, f).to(dtype=dtype, device=device)
                    for f in ("phi", "alpha", "beta", "t", "cor")})


@torch.no_grad()
def align_reconstruct(projections, geom: Geometry, views0: Views, *,
                      outer_iters: int = 10, recon: str = "sirt",
                      recon_iters: int = 100, positivity: bool = True,
                      recon_chunk: int | None = None,
                      refine_chunk: int | None = None,
                      param_set: str = "xzab", refine_iters: int = 12,
                      refine_method: str = "lm",
                      accel_period: int | None = None,
                      moment_period: int | None = 1,
                      debias_period: int | None = None,
                      debias_chunk: int = 15,
                      bounds=None, ground_truth=None, dtype=torch.float32,
                      family: str = "ray", recon_prec: str = "f32x2",
                      reinit_tol=None, volume0=None,
                      checkpoint_dir: str | None = None,
                      resume: bool = True, verbose: bool = False,
                      progress: bool = False, callback=None,
                      device=None) -> AlignState:
    """Run the alternating alignment + reconstruction loop.

    Arguments and defaults are tomojax's; the port runs ``family`` "slab"
    (arc), "slab_plane" or "fast" with ``refine_method`` "lm_slab" or
    "gd_fast", and raises ``NotImplementedError`` naming the ROADMAP item
    for the rest.

    :param projections: measured sinogram ``(n_proj, n_det)`` or
        ``(n_proj, nu, nv)``.
    :param views0: initial per-view parameters; the refinement box
        (``bounds``, default ±3 px / ±0.02 rad) is centred on them.
    :param recon: "cgls" (state-carrying, chunked by ``recon_chunk``) or
        "sirt" (chunks stop at the semi-convergence stop).
    :param refine_chunk: views per refinement call (lm_slab: chunked
        within the frozen octant groups, default bounded by detector size;
        gd_fast: default all views, whose cost and gradient evaluations
        are chunked by memory).
    :param accel_period: Aitken-extrapolate θ every this many outers (with
        a one-shot corner escape and a tilt-sign flip rescue).
    :param moment_period: every this many outers, correct (tx, tz) by
        first-moment matching against the support-masked reprojection
        (gauge projected out).
    :param debias_period: tomojax's exact-family debias stage every this
        many outers; a nonzero value raises (ROADMAP Queue 1 item 10).
    :param debias_chunk: views per call of that stage (tomojax's
        argument, accepted and unused until the stage is ported).
    :param ground_truth: optional volume; the per-outer ``recon_rms`` then
        is ‖x − gt‖/‖gt‖.
    :param checkpoint_dir: write ``align_ckpt_####.npz`` per outer (through
        a temporary file and ``os.replace``) and resume from the latest.
    :param callback: ``callback(it, views, volume, history)`` after each
        outer.
    :param device: torch device (default: the projections' device if they
        are a tensor, else ``cuda``).
    :returns: the final :class:`AlignState`.
    """
    _check_supported(family, recon, refine_method, debias_period,
                     recon_prec)
    if device is None and torch.is_tensor(projections):
        device = projections.device
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    n = geom.n_proj
    projections = torch.as_tensor(projections).to(**kw).reshape(n, -1)
    mask = PARAM_SETS[param_set]
    if bounds is None:
        lo_off, hi_off = _default_bounds(**kw)
    else:
        lo_off, hi_off = (torch.as_tensor(np.asarray(bounds[0])).to(**kw),
                          torch.as_tensor(np.asarray(bounds[1])).to(**kw))

    views = _views_on(views0, dtype, device)
    volume = (torch.zeros(geom.vox_shape, **kw) if volume0 is None
              else torch.as_tensor(volume0).to(**kw).reshape(geom.vox_shape))
    history = {"recon_rms": [], "refine_cost": []}
    start_iter = 0
    th_hist: list = []     # last 3 θ iterates for aitken_extrapolate
    last_jump = -1
    escaped = np.zeros((n, 6), bool)

    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpts = sorted(f for f in os.listdir(checkpoint_dir)
                       if f.startswith("align_ckpt_") and f.endswith(".npz"))
        if resume and ckpts:
            state = load_checkpoint(os.path.join(checkpoint_dir, ckpts[-1]),
                                    device=device)
            views = _views_on(state["views"], dtype, device)
            volume = torch.as_tensor(state["volume"]).to(**kw)
            history = state["history"]
            start_iter = state["iteration"] + 1
            th_hist = list(state["th_hist"])
            escaped = state["escaped"]
            last_jump = state["last_jump"]

    theta_init = _views_on(views0, dtype, device).theta6()
    lo, hi = theta_init + lo_off, theta_init + hi_off
    lo_np = lo.cpu().numpy().astype(np.float64)
    hi_np = hi.cpu().numpy().astype(np.float64)
    quad = QUADS.get(family)
    gt = (None if ground_truth is None
          else torch.as_tensor(np.asarray(ground_truth)).to(**kw))
    rtol = 0.0 if reinit_tol is None else float(reinit_tol)
    gstruct = None      # frozen octant groups of the solver
    refine_gs = None    # frozen octant groups of the refinement
    mom_mask = None     # data-driven moment-hook support mask
    vchunk = refine_chunk or max(1, min(n, (1 << 28)
                                        // max(1, 20 * geom.n_det)))
    t_hb = time.perf_counter()

    def hb(msg):
        if progress or verbose:
            print(f"[pipeline] {msg} (t={time.perf_counter() - t_hb:.0f}s)",
                  flush=True)

    def lm_refine(vws, quiet=False):
        nonlocal refine_gs
        if refine_gs is None:
            refine_gs, _ = sp.scalar_groups(geom, vws, "arc")
        if vchunk >= n:
            out = refine_views_slab(volume, projections, geom, vws,
                                    mask=mask, lower=lo, upper=hi,
                                    max_iter=refine_iters, groups=refine_gs,
                                    dtype=dtype)
            if not quiet:
                hb(f"outer {it}: refine {n}/{n}")
            return out
        # chunk WITHIN the frozen octant groups: each chunk is one octant
        th_out = torch.zeros((n, 6), **kw)
        cost_out = torch.zeros((n,), **kw)
        done_ct = 0
        for idx, sw, yf, uf in refine_gs:
            idx = np.asarray(idx)
            for j0 in range(0, len(idx), vchunk):
                sl = idx[j0:j0 + vchunk]
                r = refine_views_slab(
                    volume, projections[sl], geom, vws.take(sl), mask=mask,
                    lower=lo[sl], upper=hi[sl], max_iter=refine_iters,
                    groups=((tuple(range(len(sl))), sw, yf, uf),),
                    dtype=dtype)
                th_out[sl] = r.theta6
                cost_out[sl] = r.cost
                done_ct += len(sl)
                if not quiet:
                    hb(f"outer {it}: refine {done_ct}/{n}")
        return RefineResult(
            theta6=th_out, cost=cost_out,
            n_iter=torch.full((n,), refine_iters, dtype=torch.int32,
                              device=device),
            converged=torch.ones((n,), dtype=torch.bool, device=device))

    def gd_refine(vws):
        # tomojax's jax.vmap of gradient_descent_view, host-chunked by
        # refine_chunk; the volume is a constant of the θ-gradient (so no
        # K8 launch is spent on pass 1's rows), and the refinement enables
        # autograd for its own gradients
        th_all = vws.theta6()
        step = refine_chunk or n
        parts = []
        for i0 in range(0, n, step):
            sl = slice(i0, min(i0 + step, n))
            parts.append(gradient_descent_views(
                volume.detach(), projections[sl], geom, th_all[sl],
                vws.cor[sl], mask=mask, max_iter=refine_iters,
                family="fast", dtype=dtype))
        hb(f"outer {it}: refine {n}/{n}")
        return RefineResult(*(torch.cat(x) for x in zip(*parts)))

    for it in range(start_iter, outer_iters):
        if family == "fast":
            op = make_operator(geom, views, family=family, **kw)
        else:
            # ---- reconstruction on frozen octant groups ----------------
            res = (sp.group_scalars_for(geom, views, gstruct, quad, **kw)
                   if gstruct is not None else None)
            if res is None:
                gstruct, scalars = sp.scalar_groups(geom, views, quad, **kw)
            else:
                gstruct, scalars = res
            op = operator_from_scalars(geom, gstruct, scalars,
                                       family=family, **kw)
        chunk = recon_chunk or recon_iters
        rms = 0.0
        if recon == "cgls":
            state = cgls_init(op, projections, volume)
            while state.k < recon_iters and state.stop == 0:
                prev_k = state.k
                state, _, rms_arr = cgls_steps(
                    op, projections, state, nsteps=chunk, niter=recon_iters,
                    ground_truth=gt, reinit_tol=rtol)
                if state.k > prev_k:
                    rms = float(rms_arr[state.k - prev_k - 1])
                hb(f"outer {it}: recon {state.k}/{recon_iters}")
            if state.stop != 0:
                hb(f"outer {it}: CGLS double-reinit quit at k={state.k}")
            volume = state.x
        else:
            done = 0
            while done < recon_iters:
                nit = min(chunk, recon_iters - done)
                r = sirt(op, projections, niter=nit, positivity=positivity,
                         x0=volume, ground_truth=gt)
                volume = r.x
                done += nit
                rms = float(r.rms_error[max(0, r.n_iter - 1)])
                hb(f"outer {it}: recon {done}/{recon_iters}")
                if r.stop_reason != 0:   # semi-convergence: stop here
                    break
        history["recon_rms"].append(rms)

        # ---- batched refinement ----------------------------------------
        if refine_method == "gd_fast":
            ref = gd_refine(views)
            ref = ref._replace(theta6=torch.minimum(
                torch.maximum(ref.theta6, lo), hi))
        else:
            ref = lm_refine(views)
        if (refine_method == "lm_slab" and accel_period
                and (it + 1) % accel_period == 0):
            # flip rescue: re-run LM from sign-flipped tilt inits for every
            # view; keep a view's flip only where it cuts the cost by 2%
            # (near-equal basins must not flip on operator noise)
            flip_rel = 0.02
            cost_np = ref.cost.cpu().numpy().astype(np.float64)
            th = ref.theta6.cpu().numpy().astype(np.float64)
            best = cost_np.copy()
            n_take = 0
            all_combos = (((4, 5),) if n * geom.n_det > (1 << 26)
                          else ((4,), (5,), (4, 5)))
            for cols in [c for c in all_combos if all(mask[i] for i in c)]:
                th_alt = th.copy()
                th_alt[:, list(cols)] *= -1.0
                th_alt = np.clip(th_alt, lo_np, hi_np)
                alt = Views.from_theta6(torch.as_tensor(th_alt).to(**kw),
                                        cor=views.cor)
                c2 = lm_refine(alt, quiet=True)
                cost2 = c2.cost.cpu().numpy().astype(np.float64)
                take = cost2 < best * (1.0 - flip_rel)
                if take.any():
                    th[take] = c2.theta6.cpu().numpy().astype(
                        np.float64)[take]
                    best[take] = cost2[take]
                    n_take += int(take.sum())
            if n_take:
                hb(f"outer {it}: flip-rescue improved "
                   f"{int((best < cost_np * (1 - flip_rel)).sum())}/{n} "
                   "views")
                ref = ref._replace(theta6=torch.as_tensor(th).to(**kw),
                                   cost=torch.as_tensor(best).to(**kw))
        theta = ref.theta6
        views = Views.from_theta6(theta, cor=views.cor)
        cost = float(ref.cost.sum())
        history["refine_cost"].append(cost)

        # ---- moment hook ------------------------------------------------
        if (moment_period and (mask[0] or mask[2])
                and (it + 1) % moment_period == 0
                and bool(torch.any(volume != 0))):
            if mom_mask is None:
                mom_mask = torch.as_tensor(
                    _support_mask(geom, projections.cpu().numpy())).to(**kw)
            if family == "fast":
                synth = make_operator(geom, views, family=family, **kw).A(
                    volume * mom_mask)
            else:
                # reuse the solver's frozen octant groups for the synth apply
                res = sp.group_scalars_for(geom, views, gstruct, quad, **kw)
                synth = (sp.project(volume * mom_mask, geom, views,
                                    quad=quad, **kw) if res is None else
                         sp.project_scalars(volume * mom_mask, geom, *res,
                                            quad))
            dmom = _project_out_gauge(
                moment_match(projections, synth, geom.det_shape), views.phi)
            th = theta.to(dmom.dtype).clone()
            if mask[0]:
                th[:, 0] += dmom[:, 0]
            if mask[2]:
                th[:, 2] += dmom[:, 1]
            th = torch.minimum(torch.maximum(th, lo.to(th.dtype)),
                               hi.to(th.dtype))
            theta = th.to(dtype)
            views = Views.from_theta6(theta, cor=views.cor)
            hb(f"outer {it}: moment match "
               f"|dtx|={float(dmom[:, 0].abs().mean()):.2e} "
               f"|dtz|={float(dmom[:, 1].abs().mean()):.2e}")

        # ---- Aitken extrapolation --------------------------------------
        if accel_period:
            th_hist.append(theta.cpu().numpy().astype(np.float64))
            if len(th_hist) > 3:
                th_hist.pop(0)
            # never extrapolate on the final outer: the next refinement
            # is what accepts or rejects the jump against the true cost
            if (len(th_hist) == 3 and (it - last_jump) >= accel_period
                    and it < outer_iters - 1):
                th_acc = aitken_extrapolate(*th_hist, lo_np, hi_np, mask)
                # one-shot corner escape: a masked parameter pinned at its
                # bound is re-centred once
                at_edge = ((np.abs(th_acc - lo_np) < 1e-9)
                           | (np.abs(th_acc - hi_np) < 1e-9)) \
                    & np.asarray(mask)[None, :] & ~escaped
                th_acc = np.where(
                    at_edge, theta_init.cpu().numpy().astype(np.float64),
                    th_acc)
                escaped |= at_edge
                hb(f"outer {it}: aitken jump on "
                   f"{int(np.sum(np.abs(th_acc - th_hist[-1]) > 1e-12))} "
                   f"params ({int(at_edge.sum())} corner escapes)")
                views = Views.from_theta6(torch.as_tensor(th_acc).to(**kw),
                                          cor=views.cor)
                th_hist.clear()
                last_jump = it

        if verbose:
            print(f"[align] outer {it:3d}: recon rms={rms:.5f} "
                  f"refine cost={cost:.5f}", flush=True)
        if checkpoint_dir:
            save_checkpoint(
                os.path.join(checkpoint_dir, f"align_ckpt_{it:04d}.npz"),
                views=views, volume=volume, history=history, iteration=it,
                th_hist=th_hist, escaped=escaped, last_jump=last_jump)
        if callback is not None:
            callback(it, views, volume, history)

    residuals = (ref.cost if start_iter < outer_iters
                 else torch.zeros((n,), **kw))
    return AlignState(views=views, volume=volume, residuals=residuals,
                      history=history)


def save_checkpoint(path, *, views: Views, volume, history, iteration,
                    th_hist, escaped, last_jump):
    """npz checkpoint of (per-view θ, volume, metrics, extrapolation
    state), written to a temporary file and renamed into place, so a
    crash mid-write never leaves a truncated checkpoint."""
    vw = views.numpy()
    n = len(vw["phi"])
    arrays = dict(
        phi=vw["phi"], alpha=vw["alpha"], beta=vw["beta"], t=vw["t"],
        cor=vw["cor"], volume=torch.as_tensor(volume).detach().cpu().numpy(),
        iteration=iteration,
        recon_rms=np.asarray(history["recon_rms"], np.float64),
        refine_cost=np.asarray(history["refine_cost"], np.float64),
        th_hist=np.asarray(th_hist, np.float64).reshape(-1, n, 6),
        escaped=np.asarray(escaped, bool), last_jump=last_jump)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path, *, device=None) -> dict:
    """Read a checkpoint of :func:`save_checkpoint` → dict with ``views``
    (float64 tensors on ``device``), ``volume`` (numpy), ``history``,
    ``iteration`` and the extrapolation state."""
    with np.load(path) as z:
        views = Views(**{k: torch.as_tensor(z[k], device=device)
                         for k in ("phi", "alpha", "beta", "t", "cor")})
        return {"views": views, "volume": z["volume"],
                "history": {"recon_rms": [float(v) for v in z["recon_rms"]],
                            "refine_cost": [float(v)
                                            for v in z["refine_cost"]]},
                "iteration": int(z["iteration"]),
                "th_hist": list(z["th_hist"]), "escaped": z["escaped"],
                "last_jump": int(z["last_jump"])}

"""Alternating reconstruction ↔ alignment driver with checkpoint/resume
(counterpart of ``tomojax.align.pipeline``).

:func:`align_reconstruct` alternates

1. reconstruct (CGLS or SIRT, warm-started from the previous outer) with
   the current per-view rigid estimates, on the exact ray family, the
   slab families, the fast family or the voxel family, then
2. refine every view's masked 6-DoF parameters against the measured
   projections: box Levenberg–Marquardt on the ray family's exact
   Jacobian (``refine_method="lm"``, tomojax's default), the batched slab
   LM (``"lm_slab"``) or Armijo gradient descent through the fast family
   (``"gd_fast"``),
3. optionally correct (tx, tz) by first-moment matching against the
   reprojection (the moment hook) and extrapolate the θ sequence
   (Aitken Δ², with a corner escape and a tilt-sign flip rescue);

on the slab families it can re-centre the data on the exact ray family
every few outers (the debias stage). :func:`frozen_polish` refines every
view deeply against one frozen volume; :func:`align_reconstruct_cv`
refines each of K interleaved folds against a reconstruction of the other
folds' data.

Each outer iteration can checkpoint (volume, per-view θ, history and the
extrapolation state) and a restart resumes from the latest checkpoint.
The slab families' octant groups of the solver and of the refinement are
frozen across outers, as in tomojax; the fast family regroups its views
at every apply, as tomojax's does. What tomojax needs only against its
TPU runtime (compiled-program caches, per-chunk partial refinement files)
has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from tomojax_torch.align.cc import moment_match
from tomojax_torch.align.refine import (PARAM_SETS, RefineResult,
                                        gradient_descent_views, refine_views)
from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import projector
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import (QUADS, make_operator,
                                          operator_from_scalars,
                                          resolve_device)
from tomojax_torch.kernels.slab import resolve_prec
from tomojax_torch.recon.cgls import cgls, cgls_init, cgls_steps
from tomojax_torch.recon.sirt import sirt
from tomojax_torch.utils import profiling


class AlignState(NamedTuple):
    views: Views                # current per-view parameter estimates
    volume: torch.Tensor        # current reconstruction
    residuals: torch.Tensor     # (n_proj,) final per-view ½‖r‖²
    history: dict               # per-outer-iteration metric lists


def _exact_forward(volume, geom: Geometry, views: Views, dtype,
                   chunk: int) -> torch.Tensor:
    """Exact ray-family forward ``(n_proj, n_det)`` of ``views``, in host
    chunks of ``chunk`` views (the debias stage's ``debias_chunk``)."""
    n = views.n_proj
    return torch.cat([projector.project(volume, geom,
                                        views.take(slice(i, i + chunk)),
                                        dtype=dtype)
                      for i in range(0, n, chunk)]).reshape(n, -1)


def _fov_mask(geom: Geometry, margin_u: float, margin_v: float
              ) -> np.ndarray:
    """In-FOV support mask: voxels whose trilinear footprint projects onto
    the detector for EVERY view (x–y radius within the detector half-width
    minus ``margin_u``; |z| within the v half-height minus ``margin_v``),
    a boolean ``vox_shape`` array."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    x = np.arange(nx, dtype=np.float64) - (nx - 1) / 2.0
    y = np.arange(ny, dtype=np.float64) - (ny - 1) / 2.0
    z = np.arange(nz, dtype=np.float64) - (nz - 1) / 2.0
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    ru = max(nu / 2.0 - margin_u, 1.0)
    rv = max(nv / 2.0 - margin_v, 1.0)
    return (r2 <= ru * ru)[:, :, None] & (np.abs(z) <= rv)[None, None, :]


def _family_synth(volume, geom: Geometry, views: Views, family: str,
                  quad: str, dtype, chunk: int) -> torch.Tensor:
    """One forward apply of ``family`` at the current (volume, θ) — the
    moment hook's reprojection, ``(n_proj, n_det)``: the slab families
    with fresh orientation groups, the ray family in chunks of ``chunk``
    views (:func:`_exact_forward`), the fast and voxel families through
    their operators."""
    if family in QUADS:
        return sp.project(volume, geom, views, quad=quad, dtype=dtype)
    if family == "ray":
        return _exact_forward(volume, geom, views, dtype, chunk)
    return make_operator(geom, views, family=family, dtype=dtype,
                         device=volume.device).A(volume)


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


def _resolve_reinit_tol(reinit_tol, prec: str) -> float:
    """CGLS divergence-guard slack for a kernel precision tier (tomojax's
    ``_resolve_reinit_tol``): ``reinit_tol`` if given, else 1e-3 for the
    bf16 tier, whose A/Aᵀ pair is a mutual transpose only to its ~1e-3
    rounding (the strict guard would end the solve on rounding noise with
    the double-reinit quit), else 0 — the reference's strict guard."""
    if reinit_tol is not None:
        return float(reinit_tol)
    return 1e-3 if prec == "bf16" else 0.0


def _check_supported(family, recon, refine_method, recon_prec) -> str:
    """Check the driver's options; returns the resolved ``recon_prec``."""
    if family not in QUADS and family not in ("ray", "fast", "voxel"):
        raise ValueError(f"unknown projector family: {family!r}")
    if refine_method not in ("lm", "lm_slab", "gd_fast"):
        raise ValueError(f"unknown refine_method {refine_method!r}")
    if recon not in ("sirt", "cgls"):
        raise ValueError(f"unknown recon {recon!r}")
    return resolve_prec(recon_prec, name="recon_prec")


def _views_on(views: Views, dtype, device) -> Views:
    return Views(**{f: getattr(views, f).to(dtype=dtype, device=device)
                    for f in ("phi", "alpha", "beta", "t", "cor")})


def _bounds(bounds, **kw):
    """Offsets of the refinement box (default ±3 px / ±0.02 rad)."""
    if bounds is None:
        return _default_bounds(**kw)
    return (torch.as_tensor(np.asarray(bounds[0])).to(**kw),
            torch.as_tensor(np.asarray(bounds[1])).to(**kw))


def _default_device(device, *tensors):
    """``device``, else the first tensor's device, else ``cuda``."""
    if device is None:
        device = next((t.device for t in tensors if torch.is_tensor(t)),
                      None)
    return resolve_device(device)


def _synced(site: str, x):
    """``x``, where the caller's ``float``, ``bool`` or ``.cpu()`` makes
    the host wait on the card: counted as ``host_sync.align.<site>``."""
    profiling.count(f"host_sync.align.{site}")
    return x


def _host64(site: str, t):
    """``t`` as a float64 numpy array, the copy counted as
    ``host_sync.align.<site>``."""
    return _synced(site, t.cpu()).numpy().astype(np.float64)


#: the stages of an outer, as the heartbeat prints them
_STAGES = ("align.debias", "align.recon", "align.refine", "align.hook")


def _stage_seconds(outer, syncs0: int) -> str:
    """The seconds of each stage of the recorded outer span ``outer``
    (:data:`_STAGES`) and of the whole outer, and its host syncs (the
    ``host_sync.*`` counters less ``syncs0``, their sum at its start)."""
    spans, counters = profiling.records()
    split = profiling.child_seconds(spans, outer)
    s = spans[outer]
    return " ".join([f"{k.split('.')[1]} {split.get(k, 0.0):.2f}s"
                     for k in _STAGES] + [
        f"of {s.t1 - s.t0:.2f}s,",
        f"{profiling.host_syncs(counters) - syncs0} host syncs"])


def _refine_exact(volume, projections, geom: Geometry, views: Views, lo, hi,
                  mask, refine_iters, refine_chunk, dtype, hb=None):
    """Exact-family box LM of all views in chunks of ``refine_chunk``
    views (default tomojax's ``2^23 // n_vox``)."""
    n = geom.n_proj
    vchunk = refine_chunk or max(1, min(n, (1 << 23) // max(1, geom.n_vox)))
    parts = []
    for i0 in range(0, n, vchunk):
        sl = slice(i0, min(i0 + vchunk, n))
        parts.append(refine_views(volume, projections[sl], geom,
                                  views.take(sl), mask=mask, lower=lo[sl],
                                  upper=hi[sl], max_iter=refine_iters,
                                  dtype=dtype))
        if hb is not None and vchunk < n:
            hb(f"refine {sl.stop}/{n}")
    return RefineResult(*(torch.cat(x) for x in zip(*parts)))


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

    Arguments and defaults are tomojax's: ``family`` "ray" (exact),
    "slab" (arc), "slab_plane", "fast" or "voxel"; ``refine_method`` "lm",
    "lm_slab" or "gd_fast".

    :param recon_prec: the slab kernels' tier of the reconstruction stage:
        "f32x2" (fp32) or "bf16", the bulk tier (each pass's input rounded
        to bf16, each apply within 3e-3 of fp32:
        :func:`~tomojax_torch.kernels.slab.resolve_prec`). Refinement,
        the debias stage and the moment hook stay in the default tier.
        The other families ignore it but for ``reinit_tol``.
    :param reinit_tol: CGLS divergence-guard slack; None resolves per
        ``recon_prec`` (:func:`_resolve_reinit_tol`: 1e-3 for bf16, else
        0).

    :param projections: measured sinogram ``(n_proj, n_det)`` or
        ``(n_proj, nu, nv)``.
    :param views0: initial per-view parameters; the refinement box
        (``bounds``, default ±3 px / ±0.02 rad) is centred on them.
    :param recon: "cgls" (state-carrying, chunked by ``recon_chunk``) or
        "sirt" (chunks stop at the semi-convergence stop).
    :param refine_chunk: views per refinement call (lm: default
        ``2^23 // n_vox``; lm_slab: chunked within the frozen octant
        groups, default bounded by detector size; gd_fast: default all
        views, whose cost and gradient evaluations are chunked by memory).
    :param accel_period: Aitken-extrapolate θ every this many outers (with
        a one-shot corner escape and a tilt-sign flip rescue).
    :param moment_period: every this many outers, correct (tx, tz) by
        first-moment matching against the support-masked reprojection
        (gauge projected out).
    :param debias_period: on the slab families, every this many outers
        (and at the first outer with a nonzero volume) re-centre the
        working data on the exact ray family, ``b_work = b − (P_exact −
        P_slab)(x, θ)``, so the slab solver and refiner converge to where
        the exact operator explains the data (defect correction).
    :param debias_chunk: views per exact-family forward call of that
        stage and of the ray family's moment-hook reprojection.
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
    recon_prec = _check_supported(family, recon, refine_method, recon_prec)
    device = _default_device(device, projections)
    kw = dict(dtype=dtype, device=device)
    n = geom.n_proj
    projections = torch.as_tensor(projections).to(**kw).reshape(n, -1)
    mask = PARAM_SETS[param_set]
    lo_off, hi_off = _bounds(bounds, **kw)

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
    lo_np = _host64("bounds", lo)
    hi_np = _host64("bounds", hi)
    quad = QUADS.get(family)
    gt = (None if ground_truth is None
          else torch.as_tensor(np.asarray(ground_truth)).to(**kw))
    rtol = _resolve_reinit_tol(reinit_tol, recon_prec)
    gstruct = None      # frozen octant groups of the solver
    refine_gs = None    # frozen octant groups of the refinement
    mom_mask = None     # data-driven moment-hook support mask
    proj_work = projections   # the debias stage re-centres this
    defect_done = -1          # outer of the last defect recompute
    vchunk = refine_chunk or max(1, min(n, (1 << 28)
                                        // max(1, 20 * geom.n_det)))
    heartbeat = progress or verbose

    def hb(msg):
        if heartbeat:
            print(f"[pipeline] {msg}", flush=True)

    def lm_refine(vws, quiet=False):
        nonlocal refine_gs
        if refine_gs is None:
            refine_gs, _ = sp.scalar_groups(geom, vws, "arc")
        if vchunk >= n:
            out = refine_views_slab(volume, proj_work, geom, vws,
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
                    volume, proj_work[sl], geom, vws.take(sl), mask=mask,
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
                volume.detach(), proj_work[sl], geom, th_all[sl],
                vws.cor[sl], mask=mask, max_iter=refine_iters,
                family="fast", dtype=dtype))
        hb(f"outer {it}: refine {n}/{n}")
        return RefineResult(*(torch.cat(x) for x in zip(*parts)))

    for it in range(start_iter, outer_iters):
        with (profiling.tracing() if heartbeat
              else contextlib.nullcontext()), \
                profiling.span("align.outer") as outer:
            if heartbeat:
                syncs0 = profiling.host_syncs(profiling.records()[1])
            with profiling.span("align.debias"):
                if (debias_period and family in QUADS
                        and (defect_done < 0
                             or (it - start_iter) % debias_period == 0)
                        and bool(_synced("debias_nonzero",
                                         torch.any(volume != 0)))):
                    d = (_exact_forward(volume, geom, views, dtype,
                                        debias_chunk)
                         - sp.project(volume, geom, views, quad=quad, **kw))
                    proj_work = projections - d
                    defect_done = it
                    rel = (torch.linalg.norm(d)
                           / torch.linalg.norm(projections))
                    hb(f"outer {it}: debias defect "
                       f"rel={float(_synced('debias_rel', rel)):.2e}")
            with profiling.span("align.recon"):
                if family not in QUADS:
                    op = make_operator(geom, views, family=family, **kw)
                else:
                    # ---- reconstruction on frozen octant groups --------
                    res = (sp.group_scalars_for(geom, views, gstruct, quad,
                                                **kw)
                           if gstruct is not None else None)
                    if res is None:
                        gstruct, scalars = sp.scalar_groups(geom, views,
                                                            quad, **kw)
                    else:
                        gstruct, scalars = res
                    op = operator_from_scalars(geom, gstruct, scalars,
                                               family=family,
                                               prec=recon_prec, **kw)
                chunk = recon_chunk or recon_iters
                rms = 0.0
                if recon == "cgls":
                    state = cgls_init(op, proj_work, volume)
                    while state.k < recon_iters and state.stop == 0:
                        prev_k = state.k
                        state, _, rms_arr = cgls_steps(
                            op, proj_work, state, nsteps=chunk,
                            niter=recon_iters, ground_truth=gt,
                            reinit_tol=rtol)
                        if state.k > prev_k:
                            rms = float(_synced(
                                "recon_rms", rms_arr[state.k - prev_k - 1]))
                        hb(f"outer {it}: recon {state.k}/{recon_iters}")
                    if state.stop != 0:
                        hb(f"outer {it}: CGLS double-reinit quit at "
                           f"k={state.k}")
                    volume = state.x
                else:
                    done = 0
                    while done < recon_iters:
                        nit = min(chunk, recon_iters - done)
                        r = sirt(op, proj_work, niter=nit,
                                 positivity=positivity, x0=volume,
                                 ground_truth=gt)
                        volume = r.x
                        done += nit
                        rms = float(_synced(
                            "recon_rms", r.rms_error[max(0, r.n_iter - 1)]))
                        hb(f"outer {it}: recon {done}/{recon_iters}")
                        if r.stop_reason != 0:   # semi-convergence: stop
                            break
                history["recon_rms"].append(rms)

            # ---- batched refinement ------------------------------------
            with profiling.span("align.refine"):
                if refine_method == "gd_fast":
                    ref = gd_refine(views)
                    ref = ref._replace(theta6=torch.minimum(
                        torch.maximum(ref.theta6, lo), hi))
                elif refine_method == "lm":
                    ref = _refine_exact(volume, proj_work, geom, views, lo,
                                        hi, mask, refine_iters, refine_chunk,
                                        dtype,
                                        lambda msg: hb(f"outer {it}: {msg}"))
                else:
                    ref = lm_refine(views)
                if (refine_method == "lm_slab" and accel_period
                        and (it + 1) % accel_period == 0):
                    # flip rescue: re-run LM from sign-flipped tilt inits
                    # for every view; keep a view's flip only where it cuts
                    # the cost by 2% (near-equal basins must not flip on
                    # operator noise)
                    flip_rel = 0.02
                    cost_np = _host64("flip", ref.cost)
                    th = _host64("flip", ref.theta6)
                    best = cost_np.copy()
                    n_take = 0
                    all_combos = (((4, 5),) if n * geom.n_det > (1 << 26)
                                  else ((4,), (5,), (4, 5)))
                    for cols in [c for c in all_combos
                                 if all(mask[i] for i in c)]:
                        th_alt = th.copy()
                        th_alt[:, list(cols)] *= -1.0
                        th_alt = np.clip(th_alt, lo_np, hi_np)
                        alt = Views.from_theta6(
                            torch.as_tensor(th_alt).to(**kw), cor=views.cor)
                        c2 = lm_refine(alt, quiet=True)
                        cost2 = _host64("flip", c2.cost)
                        take = cost2 < best * (1.0 - flip_rel)
                        if take.any():
                            th[take] = _host64("flip", c2.theta6)[take]
                            best[take] = cost2[take]
                            n_take += int(take.sum())
                    if n_take:
                        hb(f"outer {it}: flip-rescue improved "
                           f"{int((best < cost_np * (1 - flip_rel)).sum())}"
                           f"/{n} views")
                        ref = ref._replace(
                            theta6=torch.as_tensor(th).to(**kw),
                            cost=torch.as_tensor(best).to(**kw))
                theta = ref.theta6
                views = Views.from_theta6(theta, cor=views.cor)
                cost = float(_synced("refine_cost", ref.cost.sum()))
                history["refine_cost"].append(cost)

            # ---- moment hook, Aitken extrapolation ---------------------
            with profiling.span("align.hook"):
                if (moment_period and (mask[0] or mask[2])
                        and (it + 1) % moment_period == 0
                        and bool(_synced("hook_nonzero",
                                         torch.any(volume != 0)))):
                    if mom_mask is None:
                        mom_mask = torch.as_tensor(_support_mask(
                            geom, _synced("support",
                                          projections.cpu()).numpy())
                        ).to(**kw)
                    # the slab families reuse the solver's frozen octant
                    # groups
                    res = (sp.group_scalars_for(geom, views, gstruct, quad,
                                                **kw)
                           if family in QUADS else None)
                    synth = (sp.project_scalars(volume * mom_mask, geom,
                                                *res, quad, dtype)
                             if res is not None else
                             _family_synth(volume * mom_mask, geom, views,
                                           family, quad, dtype,
                                           debias_chunk))
                    dmom = _project_out_gauge(
                        moment_match(proj_work, synth, geom.det_shape),
                        views.phi)
                    th = theta.to(dmom.dtype).clone()
                    if mask[0]:
                        th[:, 0] += dmom[:, 0]
                    if mask[2]:
                        th[:, 2] += dmom[:, 1]
                    th = torch.minimum(torch.maximum(th, lo.to(th.dtype)),
                                       hi.to(th.dtype))
                    theta = th.to(dtype)
                    views = Views.from_theta6(theta, cor=views.cor)
                    dtx = float(_synced("moment", dmom[:, 0].abs().mean()))
                    dtz = float(_synced("moment", dmom[:, 1].abs().mean()))
                    hb(f"outer {it}: moment match |dtx|={dtx:.2e} "
                       f"|dtz|={dtz:.2e}")

                # ---- Aitken extrapolation ------------------------------
                if accel_period:
                    th_hist.append(_host64("aitken", theta))
                    if len(th_hist) > 3:
                        th_hist.pop(0)
                    # never extrapolate on the final outer: the next
                    # refinement is what accepts or rejects the jump
                    # against the true cost
                    if (len(th_hist) == 3
                            and (it - last_jump) >= accel_period
                            and it < outer_iters - 1):
                        th_acc = aitken_extrapolate(*th_hist, lo_np, hi_np,
                                                    mask)
                        # one-shot corner escape: a masked parameter pinned
                        # at its bound is re-centred once
                        at_edge = ((np.abs(th_acc - lo_np) < 1e-9)
                                   | (np.abs(th_acc - hi_np) < 1e-9)) \
                            & np.asarray(mask)[None, :] & ~escaped
                        th_acc = np.where(
                            at_edge, _host64("aitken", theta_init), th_acc)
                        escaped |= at_edge
                        jumped = np.abs(th_acc - th_hist[-1]) > 1e-12
                        hb(f"outer {it}: aitken jump on "
                           f"{int(np.sum(jumped))} params "
                           f"({int(at_edge.sum())} corner escapes)")
                        views = Views.from_theta6(
                            torch.as_tensor(th_acc).to(**kw), cor=views.cor)
                        th_hist.clear()
                        last_jump = it

            if verbose:
                print(f"[align] outer {it:3d}: recon rms={rms:.5f} "
                      f"refine cost={cost:.5f}", flush=True)
            if checkpoint_dir:
                save_checkpoint(
                    os.path.join(checkpoint_dir, f"align_ckpt_{it:04d}.npz"),
                    views=views, volume=volume, history=history,
                    iteration=it, th_hist=th_hist, escaped=escaped,
                    last_jump=last_jump)
            if callback is not None:
                with profiling.span("align.callback"):
                    callback(it, views, volume, history)
        if heartbeat:
            hb(f"outer {it}: {_stage_seconds(outer, syncs0)}")

    residuals = (ref.cost if start_iter < outer_iters
                 else torch.zeros((n,), **kw))
    return AlignState(views=views, volume=volume, residuals=residuals,
                      history=history)


@torch.no_grad()
def frozen_polish(projections, geom: Geometry, views: Views, volume, *,
                  param_set: str = "xzab", refine_iters: int = 60,
                  refine_chunk: int | None = None, bounds=None,
                  theta_ref: Views | None = None, family: str = "ray",
                  moment: bool = True, dtype=torch.float32,
                  device=None) -> AlignState:
    """Per-view refinement against a FROZEN reconstruction (tomojax's
    ``frozen_polish``): every view runs a deep box-LM against ``volume``
    with no reconstruction update and no extrapolation, then (``moment``)
    one moment match of (tx, tz) against the volume's reprojection, so θ
    lands at the per-view cost minimum of one fixed operator.

    :param family: "ray" — the exact Jacobian (:func:`~tomojax_torch.align.
        refine.refine_views`, in chunks of ``2^23 // n_vox`` views);
        "slab"/"slab_plane" — the batched slab LM (K5 on a card, in chunks
        bounded by detector size). ``refine_chunk`` overrides the chunk.
    :param theta_ref: views whose θ centres the box (default ``views``).
    :param device: default: the volume's device if it is a tensor, else
        the projections', else ``cuda``.
    :returns: AlignState with the unchanged volume and the polished views.
    """
    device = _default_device(device, volume, projections)
    kw = dict(dtype=dtype, device=device)
    n = geom.n_proj
    projections = torch.as_tensor(projections).to(**kw).reshape(n, -1)
    volume = torch.as_tensor(volume).to(**kw).reshape(geom.vox_shape)
    mask = PARAM_SETS[param_set]
    lo_off, hi_off = _bounds(bounds, **kw)
    views = _views_on(views, dtype, device)
    theta_init = (views if theta_ref is None
                  else _views_on(theta_ref, dtype, device)).theta6()
    lo, hi = theta_init + lo_off, theta_init + hi_off
    if family in QUADS:
        vchunk = refine_chunk or max(1, min(n, (1 << 28)
                                            // max(1, 20 * geom.n_det)))
        parts = [refine_views_slab(
            volume, projections[i0:i0 + vchunk], geom,
            views.take(slice(i0, i0 + vchunk)), mask=mask,
            lower=lo[i0:i0 + vchunk], upper=hi[i0:i0 + vchunk],
            max_iter=refine_iters, dtype=dtype)
            for i0 in range(0, n, vchunk)]
        ref = RefineResult(*(torch.cat(x) for x in zip(*parts)))
    else:
        ref = _refine_exact(volume, projections, geom, views, lo, hi, mask,
                            refine_iters, refine_chunk, dtype)
    theta = ref.theta6
    views_out = Views.from_theta6(theta, cor=views.cor)
    if moment and (mask[0] or mask[2]):
        mom_mask = torch.as_tensor(
            _support_mask(geom, projections.cpu().numpy())).to(**kw)
        synth = _family_synth(volume * mom_mask, geom, views_out, family,
                              "arc" if family == "slab" else "plane", dtype,
                              15)
        dmom = _project_out_gauge(
            moment_match(projections, synth, geom.det_shape), views_out.phi)
        th = theta.to(dmom.dtype).clone()
        if mask[0]:
            th[:, 0] += dmom[:, 0]
        if mask[2]:
            th[:, 2] += dmom[:, 1]
        theta = torch.minimum(torch.maximum(th, lo.to(th.dtype)),
                              hi.to(th.dtype)).to(dtype)
        views_out = Views.from_theta6(theta, cor=views.cor)
    return AlignState(views=views_out, volume=volume, residuals=ref.cost,
                      history={"recon_rms": [],
                               "refine_cost": [float(ref.cost.sum())]})


@torch.no_grad()
def align_reconstruct_cv(projections, geom: Geometry, views0: Views, *,
                         outer_iters: int = 10, recon: str = "cgls",
                         recon_iters: int = 120,
                         recon_chunk: int | None = None,
                         param_set: str = "xzab", refine_iters: int = 40,
                         moment_period: int | None = 1,
                         recon_prec: str = "f32x2", bounds=None,
                         theta_ref: Views | None = None,
                         dtype=torch.float32, volume0=None,
                         checkpoint_dir: str | None = None,
                         resume: bool = True, folds: int = 2,
                         progress: bool = False, callback=None,
                         device=None) -> AlignState:
    """Cross-validated alternation (tomojax's ``align_reconstruct_cv``):
    refine each view against a reconstruction built WITHOUT that view's
    data, so the reconstruction's fit to the view's own misalignment
    cannot bias its refinement.

    Views split into ``folds`` interleaved folds (``k, k + K, …``). Per
    outer: each fold's COMPLEMENT is reconstructed with arc CGLS (or SIRT)
    on its own frozen orientation groups, warm-started from its previous
    outer (a restart per ``recon_chunk`` iterations, as tomojax's); each
    fold's views are refined with the batched slab LM against their
    complement's volume (frozen per-fold groups); then each fold's (tx,
    tz) is moment-matched against its complement volume's reprojection
    (gauge projected out over all views).

    :param folds: K, in ``[2, n_proj // 2]``.
    :param theta_ref: views whose θ centres the box (default ``views0``).
    :param checkpoint_dir: write ``cv_ckpt_####.npz`` per outer (the K
        complement volumes stacked as ``vols``; written through a
        temporary file and ``os.replace``) and resume from the latest; a
        checkpoint of tomojax's 2-fold layout (``vol_a``/``vol_b``) is
        read too, and one of another fold count re-warms every fold from
        its mean volume.
    :returns: the final state; ``volume`` is the mean of the complement
        volumes.
    """
    recon_prec = _check_supported("slab", recon, "lm_slab", recon_prec)
    rtol = _resolve_reinit_tol(None, recon_prec)
    device = _default_device(device, projections)
    kw = dict(dtype=dtype, device=device)
    n = geom.n_proj
    projections = torch.as_tensor(projections).to(**kw).reshape(n, -1)
    mask = PARAM_SETS[param_set]
    lo_off, hi_off = _bounds(bounds, **kw)
    theta_init = _views_on(views0 if theta_ref is None else theta_ref,
                           dtype, device).theta6()
    lo_all = (theta_init + lo_off).cpu().numpy().astype(np.float64)
    hi_all = (theta_init + hi_off).cpu().numpy().astype(np.float64)
    K = int(folds)
    if not 2 <= K <= n // 2:
        raise ValueError(f"folds={folds} must be in [2, n_proj//2]")
    fold_ix = [np.arange(k, n, K) for k in range(K)]
    comp_ix = [np.setdiff1d(np.arange(n), ix) for ix in fold_ix]
    fgeoms = [dataclasses.replace(geom, n_proj=len(ix)) for ix in fold_ix]
    cgeoms = [dataclasses.replace(geom, n_proj=len(ix)) for ix in comp_ix]
    quad = "arc"

    views = _views_on(views0, dtype, device)
    vols = [None] * K      # vols[k]: the volume of fold k's complement
    if volume0 is not None:
        vols = [torch.as_tensor(volume0).to(**kw).reshape(geom.vox_shape)
                ] * K
    history = {"recon_rms": [], "refine_cost": []}
    start_iter = 0
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpts = sorted(f for f in os.listdir(checkpoint_dir)
                       if f.startswith("cv_ckpt_") and f.endswith(".npz"))
        if resume and ckpts:
            with np.load(os.path.join(checkpoint_dir, ckpts[-1])) as z:
                views = _views_on(Views(**{f: torch.as_tensor(z[f]) for f in
                                           ("phi", "alpha", "beta", "t",
                                            "cor")}), dtype, device)
                if "vols" in z and z["vols"].shape[0] == K:
                    vols = [torch.as_tensor(v).to(**kw) for v in z["vols"]]
                elif "vol_a" in z and K == 2:
                    # vol_a = recon(fold-0 data) = complement of fold 1
                    vols = [torch.as_tensor(z["vol_b"]).to(**kw),
                            torch.as_tensor(z["vol_a"]).to(**kw)]
                else:
                    # the fold count changed: keep θ, re-warm every fold
                    # from the checkpoint's mean volume
                    vm = (np.mean(z["vols"], axis=0) if "vols" in z
                          else 0.5 * (z["vol_a"] + z["vol_b"]))
                    vols = [torch.as_tensor(vm).to(**kw)] * K
                history = {"recon_rms": [float(v) for v in z["recon_rms"]],
                           "refine_cost": [float(v)
                                           for v in z["refine_cost"]]}
                start_iter = int(z["iteration"]) + 1

    gstructs = [None] * K  # frozen per-complement octant groups (solver)
    rgroups = [None] * K   # frozen per-fold groups (refinement)
    mom_mask = None
    refs = {}
    t_hb = time.perf_counter()

    def hb(msg):
        if progress:
            print(f"[cv] {msg} (t={time.perf_counter() - t_hb:.0f}s)",
                  flush=True)

    for it in range(start_iter, outer_iters):
        # 1) each fold's complement reconstruction (it excludes exactly
        #    the fold it will be used to refine)
        rms_folds = []
        for k in range(K):
            ix, gh = comp_ix[k], cgeoms[k]
            sub = views.take(ix)
            res = (sp.group_scalars_for(gh, sub, gstructs[k], quad, **kw)
                   if gstructs[k] is not None else None)
            gstructs[k], scalars = (sp.scalar_groups(gh, sub, quad, **kw)
                                    if res is None else res)
            op = operator_from_scalars(gh, gstructs[k], scalars,
                                       family="slab", prec=recon_prec, **kw)
            x = (torch.zeros(geom.vox_shape, **kw) if vols[k] is None
                 else vols[k])
            done = 0
            chunk = recon_chunk or recon_iters
            while done < recon_iters:
                nit = min(chunk, recon_iters - done)
                r = (sirt(op, projections[ix], niter=nit, x0=x)
                     if recon == "sirt" else
                     cgls(op, projections[ix], niter=nit, x0=x,
                          reinit_tol=rtol))
                x = r.x
                done += nit
            vols[k] = x
            rms_folds.append(float(r.rms_error[max(0, r.n_iter - 1)]))
            hb(f"outer {it}: recon complement {k} ({len(ix)} views)")
        history["recon_rms"].append(float(np.mean(rms_folds)))

        # 2) each fold's views refined against its complement's volume
        theta = views.theta6().cpu().numpy().astype(np.float64)
        cost_total = 0.0
        for k in range(K):
            ix = fold_ix[k]
            sub = views.take(ix)
            if rgroups[k] is None:
                rgroups[k], _ = sp.scalar_groups(fgeoms[k], sub, quad)
            ref = refine_views_slab(vols[k], projections[ix], fgeoms[k], sub,
                                    mask=mask, lower=lo_all[ix],
                                    upper=hi_all[ix], max_iter=refine_iters,
                                    groups=rgroups[k], dtype=dtype)
            theta[ix] = ref.theta6.cpu().numpy().astype(np.float64)
            cost_total += float(ref.cost.sum())
            refs[k] = ref
            hb(f"outer {it}: refine fold {k} vs complement recon")
        history["refine_cost"].append(cost_total)
        views = Views.from_theta6(torch.as_tensor(theta).to(**kw),
                                  cor=views.cor)

        # 3) each fold's moment error against its complement volume
        if (moment_period and (mask[0] or mask[2])
                and (it + 1) % moment_period == 0):
            if mom_mask is None:
                mom_mask = torch.as_tensor(_support_mask(
                    geom, projections.cpu().numpy())).to(**kw)
            dmom = torch.zeros((n, 2), dtype=torch.float64, device=device)
            for k in range(K):
                ix = fold_ix[k]
                synth = sp.project(vols[k] * mom_mask, fgeoms[k],
                                   views.take(ix), quad=quad, **kw)
                dmom[torch.as_tensor(ix, device=device)] = moment_match(
                    projections[ix], synth, geom.det_shape)
            dmom = _project_out_gauge(dmom, views.phi).cpu().numpy()
            th = views.theta6().cpu().numpy().astype(np.float64)
            if mask[0]:
                th[:, 0] += dmom[:, 0]
            if mask[2]:
                th[:, 2] += dmom[:, 1]
            views = Views.from_theta6(
                torch.as_tensor(np.clip(th, lo_all, hi_all)).to(**kw),
                cor=views.cor)
            hb(f"outer {it}: cv moment |dtx|={np.abs(dmom[:, 0]).mean():.2e}"
               f" |dtz|={np.abs(dmom[:, 1]).mean():.2e}")

        volume = sum(vols) / K
        if checkpoint_dir:
            vw = views.numpy()
            _atomic_savez(
                os.path.join(checkpoint_dir, f"cv_ckpt_{it:04d}.npz"),
                **{f: vw[f] for f in ("phi", "alpha", "beta", "t", "cor")},
                vols=torch.stack(vols).cpu().numpy(), iteration=it,
                recon_rms=np.asarray(history["recon_rms"], np.float64),
                refine_cost=np.asarray(history["refine_cost"], np.float64))
        if callback is not None:
            callback(it, views, volume, history)

    residuals = torch.zeros((n,), **kw)
    if start_iter < outer_iters:
        residuals[torch.as_tensor(np.concatenate(fold_ix),
                                  device=device)] = torch.cat(
            [refs[k].cost for k in range(K)])
    volume = (sum(vols) / K if vols[0] is not None
              else torch.zeros(geom.vox_shape, **kw))
    return AlignState(views=views, volume=volume, residuals=residuals,
                      history=history)


def _atomic_savez(path, **arrays):
    """``np.savez`` to a temporary file renamed into place, so a crash
    mid-write never leaves a truncated checkpoint."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(path, *, views: Views, volume, history, iteration,
                    th_hist, escaped, last_jump):
    """npz checkpoint of (per-view θ, volume, metrics, extrapolation
    state), written to a temporary file and renamed into place, so a
    crash mid-write never leaves a truncated checkpoint."""
    vw = views.numpy()
    n = len(vw["phi"])
    _atomic_savez(
        path, phi=vw["phi"], alpha=vw["alpha"], beta=vw["beta"], t=vw["t"],
        cor=vw["cor"], volume=torch.as_tensor(volume).detach().cpu().numpy(),
        iteration=iteration,
        recon_rms=np.asarray(history["recon_rms"], np.float64),
        refine_cost=np.asarray(history["refine_cost"], np.float64),
        th_hist=np.asarray(th_hist, np.float64).reshape(-1, n, 6),
        escaped=np.asarray(escaped, bool), last_jump=last_jump)


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

"""Accuracy north-star convergence study (the port's counterpart of
``examples/convergence_study.py``).

    python -m tomojax_torch.tools.convergence_study [--device cuda]
        [--size 64] [--views 90] [--outers-fast 8] [--outers-exact 30]
        [--outers-polish 0] [--outers-cv 0] [--cv-folds 2]
        [--outers-debias 0] [--final-recon-iters 0] [--out c64.json] ...

Projects the Shepp phantom at jittered views (±``--jitter-px`` in tx, tz,
±``--jitter-deg`` in α, β from ``default_rng(seed)``) with
``--data-family`` (default the exact ray family), starts from COM
pre-alignment, and runs the staged alternation, each stage warm-started
from the last:

- **fast**: the bulk outers (slab_plane + lm_slab at ≥ 64³, else ray + lm;
  ``--recon-bulk`` SIRT);
- **exact**: slab arc + lm_slab at ≥ 64³ (else ray + lm), ``--recon``;
- **polish**: deep recon + deep refinement;
- **cv**: ``align_reconstruct_cv`` with ``--cv-folds`` folds;
- **debias**: the polish families with the exact-family defect
  correction every ``--debias-period`` outers;
- **final**: a deep chunked plane CGLS at the final θ, defect-corrected
  to the data's family over two rounds (the better round's volume kept).

``--prec-exact``, ``--prec-polish`` and ``--final-prec`` set the slab
kernels' tier of the exact and polish stages' reconstructions and of the
final CGLS (``bf16``: the bulk tier, its CGLS guard slack 1e-3);
refinement, debias and CV stay fp32, as in tomojax.

The record (``--out``; ``<out>.partial`` after every outer) holds
``config``, ``iters`` (per stage outer: ``raw`` and ``gauge_corrected``
(mean, max) |error| of tx, tz, α, β, the fitted ``gauge``, ``vol_rel_l2``,
``recon_rms``, ``wall_s``), ``start`` (the COM start's errors),
``final_recon``, ``total_wall_s`` and ``final``. The joint problem is invariant under a rigid motion of the
volume, which maps to per-view offsets (tx: cos φ·dx + sin φ·dy, tz: dz,
α/β: a rotation (wx, wy)); ``gauge_corrected`` errors remove the
least-squares fit of those 5 parameters. Each stage checkpoints under
``--ckpt-dir`` (default ``<out>.ckpt``) and resumes from it. tomojax's
defences against its TPU worker (``--platform``, ``--restart-slowdown``,
the compilation cache, the cached projections) have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tomojax_torch.align import com_align
from tomojax_torch.align.pipeline import (_exact_forward,
                                          _resolve_reinit_tol,
                                          align_reconstruct,
                                          align_reconstruct_cv)
from tomojax_torch.cli import print_param_table
from tomojax_torch.core import phantom, projector
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import operator_from_scalars, resolve_device
from tomojax_torch.kernels.slab import resolve_prec
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.tools._baseline import device_record


def gauge_fit(phi, tx_err, tz_err, a_err, b_err):
    """Least-squares fit of the 5 gauge parameters to per-view parameter
    errors → ``(gauge dict, corrected (tx, tz, α, β) error arrays)``."""
    c, s = np.cos(phi), np.sin(phi)
    Atx = np.stack([c, s], 1)
    dxy, *_ = np.linalg.lstsq(Atx, tx_err, rcond=None)
    tz_off = float(tz_err.mean())
    # angle block: α ~ [c s] w, β ~ [-s c] w (joint fit)
    Aab = np.concatenate([np.stack([c, s], 1), np.stack([-s, c], 1)], 0)
    w, *_ = np.linalg.lstsq(Aab, np.concatenate([a_err, b_err]), rcond=None)
    gauge = {"dx": float(dxy[0]), "dy": float(dxy[1]), "dz": tz_off,
             "wx": float(w[0]), "wy": float(w[1])}
    return gauge, (tx_err - Atx @ dxy, tz_err - tz_off,
                   a_err - np.stack([c, s], 1) @ w,
                   b_err - np.stack([-s, c], 1) @ w)


def param_errors(views: Views, truth: dict, phi) -> dict:
    """Raw and gauge-corrected (mean, max) |error| of tx, tz, α, β."""
    vw = views.numpy()
    errs = (vw["t"][:, 0] - truth["tx"], vw["t"][:, 2] - truth["tz"],
            vw["alpha"] - truth["alpha"], vw["beta"] - truth["beta"])
    gauge, corrected = gauge_fit(np.asarray(phi, np.float64), *errs)

    def stats(es):
        return {k: {"mean": float(np.abs(e).mean()),
                    "max": float(np.abs(e).max())}
                for k, e in zip(("tx", "tz", "alpha", "beta"), es)}

    return {"raw": stats(errs), "gauge_corrected": stats(corrected),
            "gauge": gauge}


def vol_error(volume, ref) -> float:
    """‖x − ref‖ / ‖ref‖ in float64 on the host."""
    v = np.asarray(torch.as_tensor(volume).detach().cpu(), np.float64)
    p = np.asarray(ref, np.float64)
    return float(np.linalg.norm(v.reshape(p.shape) - p) / np.linalg.norm(p))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--outers-fast", type=int, default=8)
    ap.add_argument("--outers-exact", type=int, default=30)
    ap.add_argument("--recon-iters", type=int, default=40)
    ap.add_argument("--recon-chunk", type=int, default=None,
                    help="solver iterations per call")
    ap.add_argument("--refine-iters", type=int, default=12)
    ap.add_argument("--refine-chunk", type=int, default=None,
                    help="views per refinement call")
    ap.add_argument("--jitter-px", type=float, default=2.0)
    ap.add_argument("--jitter-deg", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param-set", default="xzab")
    ap.add_argument("--recon", default="cgls", choices=["cgls", "sirt"])
    ap.add_argument("--outers-polish", type=int, default=0,
                    help="deep recon + deep LM once the parameters are "
                         "close")
    ap.add_argument("--recon-iters-polish", type=int, default=120)
    ap.add_argument("--refine-iters-polish", type=int, default=40)
    ap.add_argument("--outers-cv", type=int, default=0,
                    help="cross-validated stage: each view refined against "
                         "a recon without its own data")
    ap.add_argument("--cv-folds", type=int, default=2,
                    help="K of the CV stage (pick K | n_views)")
    ap.add_argument("--outers-debias", type=int, default=0,
                    help="defect-correction stage: slab solver on "
                         "exact-family-recentred data")
    ap.add_argument("--debias-period", type=int, default=1,
                    help="outers between exact-family defect recomputes")
    ap.add_argument("--data-family", default="ray",
                    choices=["ray", "slab", "slab_plane"],
                    help="projector family of the data")
    ap.add_argument("--fam-exact", default=None,
                    choices=["ray", "slab", "slab_plane"],
                    help="recon family of the exact stage (default slab "
                         "at >= 64^3, else ray)")
    ap.add_argument("--fam-polish", default=None,
                    choices=["ray", "slab", "slab_plane"],
                    help="recon family of the polish and debias stages")
    ap.add_argument("--prec-exact", default="f32x2",
                    choices=["f32x2", "bf16"])
    ap.add_argument("--prec-polish", default="f32x2",
                    choices=["f32x2", "bf16"])
    ap.add_argument("--recon-bulk", default="sirt", choices=["sirt", "cgls"],
                    help="solver of the fast stage")
    ap.add_argument("--final-recon-iters", type=int, default=0,
                    help="after all stages: one deep chunked plane CGLS "
                         "at the final θ")
    ap.add_argument("--final-prec", default="f32x2",
                    choices=["f32x2", "bf16"])
    ap.add_argument("--refine-bulk", default=None,
                    choices=["lm", "gd_fast", "lm_slab"],
                    help="refinement of the fast stage (default lm_slab "
                         "at >= 64^3, else lm)")
    ap.add_argument("--refine-polish", default=None,
                    choices=["lm", "lm_slab"],
                    help="refinement of the later stages (default lm_slab "
                         "at >= 64^3, else lm)")
    ap.add_argument("--accel", type=int, default=4,
                    help="Aitken-extrapolate every N outers (0: off)")
    ap.add_argument("--moment-period", type=int, default=1,
                    help="moment hook every N outers (0: off)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="per-stage checkpoint/resume directory (default "
                         "<out>.ckpt when --out is set)")
    return ap.parse_args(argv)


def study(args) -> dict:
    """Run the study → ``{"record", "states" (stage → final AlignState,
    "final" with the final volume), "geom", "projections", "phantom",
    "truth", "phi"}``."""
    resolve_prec(args.final_prec, name="--final-prec")
    device = resolve_device(args.device)
    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    vol_np = phantom.shepp3d(n).astype(np.float32)
    vol = torch.as_tensor(vol_np, device=device)
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(args.jitter_deg)
    truth = {"tx": rng.uniform(-args.jitter_px, args.jitter_px, n_proj),
             "tz": rng.uniform(-args.jitter_px, args.jitter_px, n_proj),
             "alpha": rng.uniform(-amax, amax, n_proj),
             "beta": rng.uniform(-amax, amax, n_proj)}
    t_true = np.zeros((n_proj, 3))
    t_true[:, 0], t_true[:, 2] = truth["tx"], truth["tz"]
    views_true = Views.create(n_proj, phi=phi, alpha=truth["alpha"],
                              beta=truth["beta"], t=t_true, device=device)
    print(f"[gen] projecting {n}^3 phantom, {n_proj} jittered views "
          f"(±{args.jitter_px} px, ±{args.jitter_deg} deg, "
          f"family={args.data_family})", flush=True)
    with torch.no_grad():
        proj_meas = (projector.project(vol, geom, views_true)
                     if args.data_family == "ray" else
                     sp.project(vol, geom, views_true,
                                quad="arc" if args.data_family == "slab"
                                else "plane"))

    record = {"config": vars(args), "device": device_record(device),
              "iters": []}
    t_start = time.perf_counter()

    def cb(stage):
        def callback(it, views, volume, history):
            e = param_errors(views, truth, phi)
            e["stage"], e["outer"] = stage, it
            e["vol_rel_l2"] = vol_error(volume, vol_np)
            e["recon_rms"] = history["recon_rms"][-1]
            e["wall_s"] = time.perf_counter() - t_start
            record["iters"].append(e)
            gc = e["gauge_corrected"]
            print(f"[{stage}] outer {it:3d} t={e['wall_s']:7.1f}s "
                  f"vol={e['vol_rel_l2']:.2e} "
                  f"tx(raw/gc)={e['raw']['tx']['max']:.2e}/"
                  f"{gc['tx']['max']:.2e} "
                  f"alpha(gc)={gc['alpha']['max']:.2e} "
                  f"beta(gc)={gc['beta']['max']:.2e}", flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out + ".partial", "w") as f:
                    json.dump(record, f, indent=1)
        return callback

    # COM-consistency pre-alignment: drift-free per-view (tx, tz)
    est = com_align(proj_meas, geom, phi, device=device).cpu().numpy()
    t0_init = np.zeros((n_proj, 3), np.float32)
    t0_init[:, 0], t0_init[:, 2] = est[:, 0], est[:, 1]
    views0 = Views.create(n_proj, phi=phi, t=t0_init, device=device)
    e0 = param_errors(views0, truth, phi)
    record["start"] = e0
    print(f"[com] tx(raw/gc)={e0['raw']['tx']['max']:.2e}/"
          f"{e0['gauge_corrected']['tx']['max']:.2e}", flush=True)

    # recon families by scale: the slab kernels from 64^3 up, below that
    # the exact ray family (the data's own operator)
    big = n >= 64
    fam_bulk = "slab_plane" if big else "ray"
    fam_exact = args.fam_exact or ("slab" if big else "ray")
    fam_polish = args.fam_polish or ("slab" if big else "ray")
    refine_bulk = args.refine_bulk or ("lm_slab" if big else "lm")
    refine_polish = args.refine_polish or ("lm_slab" if big else "lm")
    ckpt = args.ckpt_dir or (args.out + ".ckpt" if args.out else None)

    def stage_ckpt(stage):
        if not ckpt:
            return None
        d = os.path.join(ckpt, stage)
        os.makedirs(d, exist_ok=True)
        return d

    common = dict(recon_chunk=args.recon_chunk, param_set=args.param_set,
                  moment_period=args.moment_period or None, device=device)
    alt = dict(common, refine_chunk=args.refine_chunk,
               accel_period=args.accel or None, progress=True)
    states = {}
    state = None
    if args.outers_fast > 0:
        state = align_reconstruct(
            proj_meas, geom, views0, outer_iters=args.outers_fast,
            checkpoint_dir=stage_ckpt("fast"), recon=args.recon_bulk,
            recon_iters=args.recon_iters, refine_iters=args.refine_iters,
            refine_method=refine_bulk, family=fam_bulk, callback=cb("fast"),
            **alt)
        views0 = state.views
        states["fast"] = state
    if args.outers_exact > 0:
        state = align_reconstruct(
            proj_meas, geom, views0, outer_iters=args.outers_exact,
            recon=args.recon, recon_iters=args.recon_iters,
            refine_iters=args.refine_iters, refine_method=refine_polish,
            family=fam_exact, recon_prec=args.prec_exact,
            checkpoint_dir=stage_ckpt("exact"),
            volume0=None if state is None else state.volume,
            callback=cb("exact"), **alt)
        states["exact"] = state
    polish = dict(recon=args.recon, recon_iters=args.recon_iters_polish,
                  refine_iters=args.refine_iters_polish)
    if args.outers_polish > 0:
        state = align_reconstruct(
            proj_meas, geom, state.views, outer_iters=args.outers_polish,
            refine_method=refine_polish, family=fam_polish,
            recon_prec=args.prec_polish, checkpoint_dir=stage_ckpt("polish"),
            volume0=state.volume, callback=cb("polish"), **polish, **alt)
        states["polish"] = state
    if args.outers_cv > 0:
        state = align_reconstruct_cv(
            proj_meas, geom, state.views, outer_iters=args.outers_cv,
            checkpoint_dir=stage_ckpt("cv"), folds=args.cv_folds,
            volume0=state.volume, progress=True, callback=cb("cv"),
            **polish, **common)
        states["cv"] = state
    if args.outers_debias > 0:
        # slab solver and refiner on exact-family-recentred data: removes
        # the slab↔exact operator-mismatch bias
        state = align_reconstruct(
            proj_meas, geom, state.views, outer_iters=args.outers_debias,
            refine_method=refine_polish, family=fam_polish,
            debias_period=args.debias_period,
            checkpoint_dir=stage_ckpt("debias"), volume0=state.volume,
            callback=cb("debias"), **polish, **alt)
        states["debias"] = state

    if args.final_recon_iters > 0:
        state = state._replace(volume=_final_recon(args, geom, state,
                                                   proj_meas, vol_np, record,
                                                   device))
    states["final"] = state

    record["total_wall_s"] = time.perf_counter() - t_start
    record["final"] = record["iters"][-1] if record["iters"] else {}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        if os.path.exists(args.out + ".partial"):
            os.remove(args.out + ".partial")
        print(f"wrote {args.out}")
    if state is not None:
        print_param_table(state.views, {"xyz": t_true,
                                        "alpha": truth["alpha"],
                                        "beta": truth["beta"]})
    return {"record": record, "states": states, "geom": geom,
            "projections": proj_meas, "phantom": vol_np, "truth": truth,
            "phi": phi}


@torch.no_grad()
def _final_recon(args, geom, state, proj_meas, vol_np, record, device):
    """The headline volume: a deep state-carrying plane CGLS at the final
    θ, DEFECT-CORRECTED to the data's operator, ``b_work = b − (P_src −
    P_plane)(x, θ)`` (two rounds; one for plane data); the better round's
    volume is kept."""
    n_proj = geom.n_proj
    t0 = time.perf_counter()
    kw = dict(dtype=torch.float32, device=device)
    gstruct, scalars = sp.scalar_groups(geom, state.views, "plane", **kw)
    op = operator_from_scalars(geom, gstruct, scalars, family="slab_plane",
                               prec=args.final_prec, **kw)
    rtol = _resolve_reinit_tol(None, args.final_prec)
    iters = args.final_recon_iters
    chunk = min(args.recon_chunk or iters, iters)
    b = proj_meas.to(torch.float32).reshape(n_proj, -1)
    x = state.volume.to(torch.float32).reshape(geom.vox_shape)
    rounds_rel, best = [], (np.inf, None)
    n_debias = 2 if args.data_family != "slab_plane" else 1
    for round_i in range(n_debias):
        b_work = b
        if args.data_family != "slab_plane" and bool(torch.any(x != 0)):
            p_src = (sp.project(x, geom, state.views, quad="arc", **kw)
                     if args.data_family == "slab" else
                     _exact_forward(x, geom, state.views, torch.float32, 15))
            p_pl = sp.project(x, geom, state.views, quad="plane", **kw)
            b_work = b - (p_src - p_pl)
            rel = torch.linalg.norm(p_src - p_pl) / torch.linalg.norm(b)
            print(f"[final] defect round {round_i} rel={float(rel):.2e}",
                  flush=True)
        st = cgls_init(op, b_work, x)
        while st.k < iters and st.stop == 0:
            st, _, _ = cgls_steps(op, b_work, st, nsteps=chunk, niter=iters,
                                  reinit_tol=rtol)
            print(f"[final] cgls {st.k}/{iters} "
                  f"t={time.perf_counter() - t0:.0f}s", flush=True)
        x = st.x.reshape(geom.vox_shape)
        rel_l2 = vol_error(x, vol_np)
        rounds_rel.append(rel_l2)
        if rel_l2 < best[0]:
            best = (rel_l2, x)
        print(f"[final] round {round_i}: vol rel-L2 {rel_l2:.4f}",
              flush=True)
    rel_l2, x = best
    record["final_recon"] = {
        "iters": st.k, "stop": st.stop, "prec": args.final_prec,
        "debias_rounds": n_debias, "rounds_rel_l2": rounds_rel,
        "wall_s": time.perf_counter() - t0, "vol_rel_l2": rel_l2}
    print(f"[final] deep CGLS vol rel-L2 {rel_l2:.4f} "
          f"({record['final_recon']['wall_s']:.0f}s)", flush=True)
    return x


def main(argv=None) -> dict:
    """Parse ``argv``, run the study and return its record."""
    return study(parse_args(argv))["record"]


if __name__ == "__main__":
    main()

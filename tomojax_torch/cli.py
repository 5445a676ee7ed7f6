"""Command-line entry point: ``python -m tomojax_torch.cli <cmd> [...]``.

The same subcommands, flags and ``--set`` overrides as ``tomojax.cli``,
plus ``--device`` (default ``cuda``; asking for CUDA without a card
raises):

- ``simulate``    with ``simulate.family`` ``slab`` (arc) or
  ``slab_plane``; every other family (``voxel`` too) projects with the
  exact ray family, as tomojax's does;
- ``reconstruct`` with ``solver.method`` ``sirt``, ``cgls``,
  ``tikhonov``, ``lasso`` or ``fista_tv`` on ``solver.family`` ``ray``,
  ``slab``, ``slab_plane``, ``fast`` or ``voxel``, and ``--pre-align
  none|com|cc``;
- ``align`` with ``align.family`` ``ray`` (the default), ``slab``,
  ``slab_plane``, ``fast`` or ``voxel``, ``align.refine_method`` ``lm`` (the
  default), ``lm_slab`` or ``gd_fast`` and ``align.debias_period`` (COM
  pre-alignment with ``align.pre_align_cc=true``).

``reconstruct --shard`` angle-shards the ray family over the process
group when it has more than one rank (``torchrun --nproc-per-node N -m
tomojax_torch.cli reconstruct --shard ...``: NCCL between cards, gloo
between CPU processes; rank 0 writes the output), as tomojax does over
its devices; with one rank it builds the plain operator.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist


SOLVERS = ("sirt", "cgls", "tikhonov", "lasso", "fista_tv")


def _add_common(p):
    p.add_argument("--config", help="ExperimentConfig json", default=None)
    p.add_argument("--size", type=int, default=None, help="cubic volume size")
    p.add_argument("--views", type=int, default=None)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="SECTION.FIELD=VALUE",
                   help="override any config field, e.g. "
                        "--set solver.family=slab_plane --set solver.niter=40 "
                        "(repeatable; typed from the dataclass default)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; no CPU fallback)")


def _coerce(value: str, ref):
    """Parse a --set VALUE string to the type of the dataclass default."""
    import json as _json
    if value.lower() in ("none", "null"):
        return None
    if isinstance(ref, bool):
        return value.lower() in ("1", "true", "yes", "on")
    for t in (int, float):
        if isinstance(ref, t):
            return t(value)
    if isinstance(ref, (tuple, list)) or ref is None:
        try:
            v = _json.loads(value)
            return tuple(v) if isinstance(v, list) else v
        except _json.JSONDecodeError:
            return value
    return value


def _load_config(args):
    from tomojax_torch.utils.config import ExperimentConfig
    cfg = (ExperimentConfig.from_json(args.config) if args.config
           else ExperimentConfig())
    if args.size:
        n = args.size
        cfg.geometry.vox_shape = (n, n, n)
        cfg.geometry.det_shape = (n, n)
    if args.views:
        cfg.geometry.n_proj = args.views
    for ov in getattr(args, "overrides", []):
        key, _, value = ov.partition("=")
        section, _, field = key.partition(".")
        if not (value and field and hasattr(cfg, section)):
            sys.exit(f"--set wants SECTION.FIELD=VALUE; got {ov!r}")
        sec = getattr(cfg, section)
        if not hasattr(sec, field):
            sys.exit(f"unknown config field {key!r}")
        setattr(sec, field, _coerce(value, getattr(sec, field)))
    return cfg


def _infer_vox_shape(args, d, nu, nv):
    """Volume shape for a loaded dataset: explicit --vox-shape wins, then
    the stored phantom's shape, then the cubic (nu, nu, nv) guess."""
    if getattr(args, "vox_shape", None):
        parts = [int(v) for v in args.vox_shape.split(",")]
        if len(parts) == 1:
            parts = parts * 3
        if len(parts) != 3:
            sys.exit(f"--vox-shape wants nx,ny,nz; got {parts}")
        return tuple(parts)
    gt = d.get("phantom")
    if gt is not None:
        return gt.shape
    print(f"warning: no phantom in dataset and no --vox-shape given; "
          f"assuming cubic ({nu}, {nu}, {nv})", file=sys.stderr)
    return (nu, nu, nv)


def cmd_simulate(args):
    """Phantom → jittered slab projections → HDF5 (or ``.npz``) dataset."""
    from tomojax_torch.core import phantom as ph
    from tomojax_torch.core import projector
    from tomojax_torch.core import slab_projector as sp
    from tomojax_torch.core.geometry import Views
    from tomojax_torch.core.operators import QUADS, resolve_device
    from tomojax_torch.utils import io

    cfg = _load_config(args)
    fam = cfg.simulate.family
    device = resolve_device(args.device)
    geom = cfg.geometry.build()
    rng = np.random.default_rng(cfg.simulate.seed)
    vol = (ph.shepp3d(geom.vox_shape) if cfg.simulate.phantom == "shepp"
           else ph.arbitrary_phantom(geom.vox_shape, seed=cfg.simulate.seed))

    n_proj = geom.n_proj
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(cfg.simulate.max_angle_deg)
    alpha = rng.uniform(-amax, amax, n_proj)
    beta = rng.uniform(-amax, amax, n_proj)
    xyz = np.zeros((n_proj, 3))
    # motion along the beam (y) does not affect parallel projections
    xyz[:, 0] = rng.uniform(-cfg.simulate.max_shift_px,
                            cfg.simulate.max_shift_px, n_proj)
    xyz[:, 2] = rng.uniform(-cfg.simulate.max_shift_px,
                            cfg.simulate.max_shift_px, n_proj)

    views = Views.create(n_proj, phi=phi, alpha=alpha, beta=beta, t=xyz,
                         device=device)
    with torch.no_grad():
        x = torch.as_tensor(vol, device=device)
        # tomojax simulates every other family with the exact ray projector
        proj = (sp.project(x, geom, views, quad=QUADS[fam]) if fam in QUADS
                else projector.project(x, geom, views))
    io.save_dataset(args.output, projections=proj.reshape(
        n_proj, *geom.det_shape).cpu().numpy(), phi=phi, alpha=alpha,
        beta=beta, xyz=xyz, phantom=vol)
    print(f"wrote {args.output}: {n_proj} views of {geom.det_shape}, "
          f"volume {geom.vox_shape}")
    return {"output": args.output}


def cmd_reconstruct(args):
    """Iterative reconstruction of a dataset; returns a dict with the
    solver result (``result``) and, with ``--pre-align com|cc``, the
    per-axis mean/max pre-alignment residuals in px when the dataset
    holds the true shifts (``pre_align_residual``)."""
    from tomojax_torch import recon
    from tomojax_torch.align import com_align, cross_correlation_chain
    from tomojax_torch.core.geometry import Geometry, Views
    from tomojax_torch.core.operators import make_operator, resolve_device
    from tomojax_torch.dist import (init_from_env, make_mesh,
                                    make_sharded_operator)
    from tomojax_torch.utils import io

    cfg = _load_config(args)
    m = cfg.solver.method
    if m not in SOLVERS:
        sys.exit(f"unknown solver {m}")
    device = resolve_device(args.device)
    # tomojax angle-shards only over more than one device; on one it
    # builds the plain operator
    sharded = args.shard and init_from_env(device) and (
        dist.get_world_size() > 1)
    dtype = getattr(torch, cfg.solver.dtype)
    d = io.load_dataset(args.input)
    n_proj, nu, nv = d["projections"].shape
    gt = d.get("phantom")
    if gt is not None:
        gt = torch.as_tensor(gt, dtype=dtype, device=device)
    geom = Geometry(n_proj=n_proj, vox_shape=_infer_vox_shape(args, d, nu,
                                                              nv),
                    det_shape=(nu, nv))
    views = io.views_from_dataset(d, device=device)
    proj = torch.as_tensor(d["projections"], device=device)
    b = proj.reshape(n_proj, -1).to(dtype)

    out = {}
    if args.pre_align != "none":
        # BASELINE config 3 flow: consistency pre-alignment then recon;
        # shifts only (tilt jitter stays unknown)
        if args.pre_align == "com":
            est = com_align(proj, geom, d["phi"], dtype=torch.float32,
                            device=device).cpu().numpy()
        else:
            offsets, _ = cross_correlation_chain(proj.to(torch.float32))
            # chain offsets are cumulative content displacements (u, v) =
            # (tx, tz); remove the per-axis mean (volume-shift gauge)
            est = offsets.cpu().numpy()
            est -= est.mean(axis=0, keepdims=True)
        t0 = np.zeros((n_proj, 3), np.float32)
        t0[:, 0] = est[:, 0]
        t0[:, 2] = est[:, 1]
        views = Views.create(n_proj, phi=d["phi"], t=t0, device=device)
        if "xyz" in d:
            ex = np.abs(t0[:, 0] - d["xyz"][:, 0])
            ez = np.abs(t0[:, 2] - d["xyz"][:, 2])
            out["pre_align_residual"] = {
                "tx": (float(ex.mean()), float(ex.max())),
                "tz": (float(ez.mean()), float(ez.max()))}
            print(f"pre-align ({args.pre_align}) residual: "
                  f"tx {ex.mean():.3f}/{ex.max():.3f} px "
                  f"tz {ez.mean():.3f}/{ez.max():.3f} px (mean/max)")

    if sharded:
        mesh = make_mesh()
        op = make_sharded_operator(geom, views, mesh, dtype=dtype,
                                   device=device)
        print(f"angle-sharded over {mesh.shape}")
    else:
        op = make_operator(geom, views, family=cfg.solver.family,
                           dtype=dtype, device=device)
    sv = cfg.solver
    if m == "sirt":
        res = recon.sirt(op, b, niter=sv.niter, positivity=sv.positivity,
                         ground_truth=gt)
    elif m == "cgls":
        res = recon.cgls(op, b, niter=sv.niter, ground_truth=gt)
    elif m == "tikhonov":
        res = recon.tikhonov_gd(op, b, niter=sv.niter,
                                reg_param=sv.reg_param,
                                positivity=sv.positivity, ground_truth=gt)
    elif m == "lasso":
        res = recon.lasso_fista(op, b, niter=sv.niter,
                                reg_param=sv.reg_param, ground_truth=gt)
    else:
        res = recon.fista_tv(op, b, niter=sv.niter, hyper=sv.hyper,
                             beta_tv=sv.beta_tv, niter_tv=sv.niter_tv,
                             ground_truth=gt)

    k = int(res.n_iter)
    print(f"{m}: {k} iterations, final rms {float(res.rms_error[k-1]):.5f}")
    if not sharded or dist.get_rank() == 0:
        io.save_volume(args.output, res.x)
        print(f"wrote {args.output}")
    out["result"] = res
    return out


def cmd_align(args):
    """Joint alignment + reconstruction of a dataset (tomojax's ``align``).

    :returns: dict with the final :class:`~tomojax_torch.align.pipeline.
        AlignState` (``state``, whose ``history`` holds the per-outer
        ``recon_rms`` and ``refine_cost``) and the per-view θ after each
        outer (``theta_per_outer``, (n_proj, 6) numpy arrays)."""
    from tomojax_torch.align import align_reconstruct, com_align
    from tomojax_torch.align.pipeline import _check_supported
    from tomojax_torch.core.geometry import Geometry, Views
    from tomojax_torch.core.operators import resolve_device
    from tomojax_torch.utils import io

    cfg = _load_config(args)
    a = cfg.align
    if args.recon_prec is not None:
        a.recon_prec = args.recon_prec
    _check_supported(a.family, a.recon, a.refine_method, a.recon_prec)
    device = resolve_device(args.device)
    d = io.load_dataset(args.input)
    n_proj, nu, nv = d["projections"].shape
    gt = d.get("phantom")
    geom = Geometry(n_proj=n_proj, vox_shape=_infer_vox_shape(args, d, nu,
                                                              nv),
                    det_shape=(nu, nv))
    proj = torch.as_tensor(d["projections"], dtype=torch.float32,
                           device=device)
    # phi known, jitter unknown
    views0 = Views.create(n_proj, phi=d["phi"], device=device)
    if cfg.align.pre_align_cc:
        # center-of-mass consistency pre-alignment: per-view (tx, tz)
        est = com_align(proj, geom, d["phi"], device=device).cpu().numpy()
        t0 = np.zeros((n_proj, 3), np.float32)
        t0[:, 0] = est[:, 0]
        t0[:, 2] = est[:, 1]
        views0 = Views.create(n_proj, phi=d["phi"], t=t0, device=device)
        print("COM pre-alignment applied "
              f"(mean |t| = {np.abs(est).mean():.2f} px)")

    # phi is unbounded: the mask decides whether phi is refined at all
    bounds_lo = np.array([-a.bound_trans, -a.bound_trans, -a.bound_trans,
                          -np.inf, -a.bound_angle, -a.bound_angle],
                         np.float32)
    thetas = []
    state = align_reconstruct(
        proj.reshape(n_proj, -1), geom, views0, outer_iters=a.outer_iters,
        recon=a.recon, recon_iters=a.recon_iters, positivity=a.positivity,
        param_set=a.param_set, refine_iters=a.refine_iters,
        family=a.family, refine_method=a.refine_method,
        recon_chunk=a.recon_chunk, refine_chunk=a.refine_chunk,
        accel_period=a.accel_period, moment_period=a.moment_period,
        debias_period=a.debias_period, recon_prec=a.recon_prec,
        bounds=(bounds_lo, -bounds_lo), ground_truth=gt,
        checkpoint_dir=a.checkpoint_dir, verbose=True, progress=True,
        device=device,
        callback=lambda it, views, volume, history: thetas.append(
            views.theta6().cpu().numpy()))

    io.save_volume(args.output, state.volume)
    if "xyz" in d:
        print_param_table(state.views, d)
    print(f"wrote {args.output}")
    return {"state": state, "theta_per_outer": thetas}


def print_param_table(views, d, file=None):
    """Per-view recovered-vs-true table and the mean/max errors."""
    t = views.t.cpu().numpy()
    al = views.alpha.cpu().numpy()
    be = views.beta.cpu().numpy()
    print("view |   tx (true)      tz (true)    | alpha (true)    "
          "beta (true)", file=file)
    for i in range(t.shape[0]):
        print(f"{i:4d} | {t[i, 0]:+8.4f} ({d['xyz'][i, 0]:+7.4f}) "
              f"{t[i, 2]:+8.4f} ({d['xyz'][i, 2]:+7.4f}) | "
              f"{al[i]:+8.5f} ({d['alpha'][i]:+8.5f}) "
              f"{be[i]:+8.5f} ({d['beta'][i]:+8.5f})", file=file)
    tx_err = np.abs(t[:, 0] - d["xyz"][:, 0])
    tz_err = np.abs(t[:, 2] - d["xyz"][:, 2])
    a_err = np.abs(al - d["alpha"])
    b_err = np.abs(be - d["beta"])
    print(f"param errors (mean/max): tx {tx_err.mean():.5f}/{tx_err.max():.5f}"
          f" tz {tz_err.mean():.5f}/{tz_err.max():.5f}"
          f" alpha {a_err.mean():.6f}/{a_err.max():.6f}"
          f" beta {b_err.mean():.6f}/{b_err.max():.6f}", file=file)


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns."""
    ap = argparse.ArgumentParser(prog="tomojax_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="phantom → jittered projections")
    _add_common(p)
    p.add_argument("--output", "-o", required=True)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("reconstruct", help="iterative reconstruction")
    _add_common(p)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--shard", action="store_true",
                   help="angle-shard over the process group's ranks "
                        "(torchrun; one rank: unsharded, as tomojax)")
    p.add_argument("--pre-align", default="none",
                   choices=["none", "com", "cc"],
                   help="shift pre-alignment before reconstruction "
                        "(BASELINE config 3: com or cc + cgls)")
    p.add_argument("--vox-shape", default=None,
                   help="volume shape 'nx,ny,nz' (required for phantom-free "
                        "datasets with non-cubic volumes)")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("align", help="joint alignment + reconstruction")
    _add_common(p)
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--vox-shape", default=None)
    p.add_argument("--recon-prec", default=None, choices=["f32x2", "bf16"],
                   help="the slab kernels' tier of the reconstruction "
                        "stage (align.recon_prec; bf16: the bulk tier, "
                        "refinement stays fp32)")
    p.set_defaults(fn=cmd_align)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

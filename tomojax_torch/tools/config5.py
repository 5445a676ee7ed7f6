"""BASELINE config 5: 512³ volume, 1024 views, an aligned CGLS
reconstruction (counterpart of ``examples/baseline_config5.py``).

    python -m tomojax_torch.tools.config5 [--prealign cc] [--out rec.json]
    torchrun --nproc-per-node 4 -m tomojax_torch.tools.config5 --mode mesh

Two modes:

- ``--mode device`` (default; tomojax's ``tpu`` mode): the 512³ Shepp
  phantom, 1024 views over [0, π] with tx, tz uniform in ±2 px from
  ``default_rng(0)``, data made with the slab forward (``--quad``, K1 for
  the default plane); ``--prealign none|cc|com`` estimates (tx, tz) from
  the jittered sinogram (the CC chain's offsets mean-removed); then
  ``--niter`` CGLS iterations on the slab family with the estimated views
  (``none``: the true views), on the operator of tier ``--prec`` (the
  bf16 bulk tier: K1b/K2b, CGLS's guard slack 1e-3; the data and the
  pre-alignment stay fp32, as tomojax's). The record has tomojax's fields
  (``t_datagen_s``, ``datagen_proj_per_s``, ``t_prealign_s``,
  ``prealign_t{x,z}_gc_mean``, ``t_cgls_s``, ``cgls_iters_run``,
  ``cgls_conv``, ``cgls_proj_per_s``, ``vol_rel_l2``,
  ``wall_to_aligned_recon_s``), the phantom's time on the host and the
  device's name and power limit.
- ``--mode mesh`` (tomojax's ``cpu-mesh``): over the current process group
  (``torchrun``, or a group the caller initialized; else a world of one),
  at 512³ shapes with at most 16 views and a random volume, one A and one
  Aᵀ of the unsharded slab_plane operator, the angle-sharded slab_plane
  operator (world × 1) and the volume-sharded slab operators in plane and
  arc quadrature (z blocks over 2 ranks where the world is even, with
  the operator's default 32-plane halo), each against the unsharded
  operator; it checks the volume-sharded plane forward against the angle-sharded one (rel ≤ 1e-5,
  as tomojax asserts). Rank 0 writes the record.

tomojax's ``--chunk`` (iterations per device program, against its TPU
runtime's program-kill limit) has no counterpart.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tomojax_torch.align.cc import com_align, cross_correlation_chain
from tomojax_torch.align.pipeline import _resolve_reinit_tol
from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator, resolve_device
from tomojax_torch.kernels.slab import resolve_prec
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.tools._baseline import device_record, rel_l2, write
from tomojax_torch.utils.profiling import timed

MESH_VIEWS = 16
MESH_FWD_REL = 1e-5      # volume- against angle-sharded forward


def problem(n: int, n_proj: int):
    """``(geom, phi, t, rng)``: the config's geometry and jitter; ``rng``
    continues the jitter's generator (the mesh mode's volume)."""
    geom = Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    rng = np.random.default_rng(0)
    phi = np.linspace(0.0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-2, 2, n_proj)
    t[:, 2] = rng.uniform(-2, 2, n_proj)
    return geom, phi, t, rng


def gauge_corrected_means(est_tx, est_tz, t, phi) -> dict:
    """Mean |error| of (tx, tz) estimates after removing what the data
    cannot see: tx's projection on (cos φ, sin φ), tz's mean."""
    err_tx = est_tx - t[:, 0]
    A = np.stack([np.cos(phi), np.sin(phi)], 1)
    coef, *_ = np.linalg.lstsq(A, err_tx, rcond=None)
    err_tz = est_tz - t[:, 2]
    return {"prealign_tx_gc_mean": float(np.abs(err_tx - A @ coef).mean()),
            "prealign_tz_gc_mean": float(np.abs(err_tz - err_tz.mean())
                                         .mean())}


def cgls_stage(geom: Geometry, phi, t_rec, b, niter: int, prec: str, fam,
               dev) -> tuple:
    """``niter`` CGLS iterations on the ``fam`` operator of the views
    (``phi``, ``t_rec``) in tier ``prec`` from zero, one iteration per
    step: ``(state, record)``, the record with ``t_cgls_s``,
    ``cgls_stop``, ``cgls_iters_run``, ``cgls_conv`` and
    ``cgls_proj_per_s``."""
    n_proj = geom.n_proj
    rec = {}
    op = make_operator(geom, Views.create(n_proj, phi=phi, t=t_rec),
                       family=fam, prec=prec, device=dev)
    rtol = _resolve_reinit_tol(None, prec)
    t0 = time.perf_counter()
    state = cgls_init(op, b)
    convs = []
    while state.k < niter and state.stop == 0:
        state, conv, _ = cgls_steps(op, b, state, nsteps=1, niter=niter,
                                    reinit_tol=rtol)
        convs.append(float(conv[0]))
        print(f"[cgls {prec}] {state.k}/{niter} "
              f"t={time.perf_counter() - t0:.2f}s conv={convs[-1]:.4e}",
              flush=True)
    rec["t_cgls_s"] = time.perf_counter() - t0
    rec["cgls_stop"] = state.stop
    rec["cgls_iters_run"] = state.k
    rec["cgls_conv"] = convs[:state.k]
    # CGLS does a forward and an adjoint per iteration
    rec["cgls_proj_per_s"] = (n_proj * state.k / rec["t_cgls_s"]
                              if state.k else 0.0)
    return state, rec


def run_device(args, dev, vol_np=None, keep: dict | None = None) -> dict:
    """The device mode; ``keep`` (a dict) receives the sinogram
    (``proj``) and the views' estimated shifts (``t_rec``), for a caller
    that runs the CGLS stage again."""
    n, n_proj = args.size, args.views
    geom, phi, t, _ = problem(n, n_proj)
    rec = {}
    fam = "slab" if args.quad == "arc" else "slab_plane"
    if vol_np is None:
        t0 = time.perf_counter()
        vol_np = phantom.shepp3d(n).astype(np.float32)
        rec["t_phantom_s"] = time.perf_counter() - t0
    vol = torch.as_tensor(vol_np, device=dev)
    views = Views.create(n_proj, phi=phi, t=t, device=dev)
    with torch.no_grad():
        proj, rec["t_datagen_s"] = timed(
            lambda: sp.project(vol, geom, views, quad=args.quad), reps=1,
            warmup=0)
        rec["datagen_proj_per_s"] = n_proj / rec["t_datagen_s"]
        print(f"[gen] {n_proj} views in {rec['t_datagen_s']:.3f} s "
              f"({rec['datagen_proj_per_s']:.1f} proj/s)", flush=True)
        t_rec = t
        if args.prealign != "none":
            if args.prealign == "com":
                est, rec["t_prealign_s"] = timed(
                    lambda: com_align(proj, geom, phi).cpu().numpy(), reps=1,
                    warmup=0)
                est_tx, est_tz = est[:, 0], est[:, 1]
            else:
                off, rec["t_prealign_s"] = timed(
                    lambda: cross_correlation_chain(
                        proj.reshape(n_proj, n, n))[0].cpu().numpy(),
                    reps=1, warmup=0)
                # the chain's offsets are relative to view 0: the mean is a
                # pure gauge/COR component
                est_tx = off[:, 0] - off[:, 0].mean()
                est_tz = off[:, 1] - off[:, 1].mean()
            rec.update(gauge_corrected_means(est_tx, est_tz, t, phi))
            t_rec = np.zeros((n_proj, 3), np.float32)
            t_rec[:, 0], t_rec[:, 2] = est_tx, est_tz
            print(f"[{args.prealign}] {rec['t_prealign_s']:.3f} s, "
                  f"gauge-corrected mean |tx| "
                  f"{rec['prealign_tx_gc_mean']:.4f} px, |tz| "
                  f"{rec['prealign_tz_gc_mean']:.4f} px", flush=True)
        if keep is not None:
            keep.update(proj=proj, t_rec=t_rec)
        state, cg = cgls_stage(geom, phi, t_rec, proj.reshape(n_proj, -1),
                               args.niter, args.prec, fam, dev)
    rec.update(cg)
    rec["prec"] = args.prec
    rec["vol_rel_l2"] = rel_l2(state.x, vol_np)
    if args.prealign != "none":
        rec["wall_to_aligned_recon_s"] = rec["t_prealign_s"] + rec["t_cgls_s"]
        print(f"[north-star] aligned {n}^3 CGLS recon in "
              f"{rec['wall_to_aligned_recon_s']:.2f} s ({args.prealign} "
              f"pre-align + {args.niter} CGLS)", flush=True)
    print(f"[done] cgls {rec['t_cgls_s']:.2f} s "
          f"({rec['cgls_proj_per_s']:.1f} proj/s fwd+adj), rel-L2 "
          f"{rec['vol_rel_l2']:.4f}", flush=True)
    return rec


def run_mesh(args, dev) -> dict:
    import torch.distributed as dist

    from tomojax_torch.dist import (make_mesh, make_sharded_operator,
                                    make_volume_sharded_slab_operator)

    n, n_proj = args.size, min(args.views, MESH_VIEWS)
    geom, phi, t, rng = problem(n, n_proj)
    views = Views.create(n_proj, phi=phi, t=t)
    # a random volume: the 512^3 phantom takes a while on the host, and
    # the shapes are what this mode proves
    vol = torch.as_tensor(rng.standard_normal((n, n, n)).astype(np.float32),
                          device=dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_vol = 2 if world % 2 == 0 else 1
    rec = {"world": world, "angle_mesh": [world, 1],
           "volume_mesh": [world // n_vol, n_vol]}

    def apply(name, op, x, y=None):
        a, rec[f"{name}_fwd_s"] = timed(lambda: op.A(x), reps=1, warmup=0)
        b, rec[f"{name}_adj_s"] = timed(lambda: op.AT(a if y is None else y),
                                        reps=1, warmup=0)
        return a, b

    if dist.is_initialized():
        dist.barrier()     # the communicator's setup stays out of the times
    with torch.no_grad():
        ref = {}
        for quad, fam in (("plane", "slab_plane"), ("arc", "slab")):
            ref[quad] = apply(f"plain_{quad}", make_operator(
                geom, views, family=fam, device=dev), vol)
        y = ref["plane"][0]
        ya, ba = apply("angle_sharded", make_sharded_operator(
            geom, views, make_mesh(world, 1), family="slab_plane",
            device=dev), vol)
        for k, got, want in (("fwd", ya, y), ("adj", ba, ref["plane"][1])):
            rec[f"angle_sharded_{k}_equal"] = bool(torch.equal(got, want))
            rec[f"angle_sharded_{k}_rel"] = rel_l2(got, want)
        vmesh = make_mesh(world // n_vol, n_vol)
        for quad in ("plane", "arc"):
            yv, bv = apply(f"vol_sharded_{quad}",
                           make_volume_sharded_slab_operator(
                               geom, views, vmesh, quad=quad,
                               device=dev), vol,
                           ref[quad][0])
            rec[f"vol_sharded_{quad}_fwd_rel"] = rel_l2(yv, ref[quad][0])
            rec[f"vol_sharded_{quad}_adj_rel"] = rel_l2(bv, ref[quad][1])
            if quad == "plane":
                rec["vol_vs_angle_fwd_rel"] = rel_l2(yv, ya)
    print(f"[mesh world {world}] angle-sharded fwd {rec['angle_sharded_fwd_s']:.3f}"
          f" s adj {rec['angle_sharded_adj_s']:.3f} s; vs the unsharded "
          f"operator: fwd bit-equal {rec['angle_sharded_fwd_equal']}, adj "
          f"bit-equal {rec['angle_sharded_adj_equal']} (rel "
          f"{rec['angle_sharded_adj_rel']:.2e})", flush=True)
    for quad in ("plane", "arc"):
        print(f"[mesh world {world}] volume-sharded {quad} "
              f"{rec['volume_mesh']} fwd {rec[f'vol_sharded_{quad}_fwd_s']:.3f}"
              f" s adj {rec[f'vol_sharded_{quad}_adj_s']:.3f} s, rel vs "
              f"unsharded fwd {rec[f'vol_sharded_{quad}_fwd_rel']:.2e} adj "
              f"{rec[f'vol_sharded_{quad}_adj_rel']:.2e}", flush=True)
    rel = rec["vol_vs_angle_fwd_rel"]
    if not rel <= MESH_FWD_REL:
        raise RuntimeError(f"volume- vs angle-sharded forward rel {rel}")
    return rec


def main(argv=None, volume=None, keep: dict | None = None) -> dict:
    """Run config 5; ``volume`` is the device mode's phantom as a numpy
    array, if the caller has made it (512³ takes ~10 s on the host);
    ``keep`` as in :func:`run_device`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="device", choices=["device", "mesh"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=1024)
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--quad", default="plane", choices=["arc", "plane"])
    ap.add_argument("--prec", default="f32x2", choices=["f32x2", "bf16"])
    ap.add_argument("--prealign", default="none",
                    choices=["none", "cc", "com"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    resolve_prec(args.prec)
    dev = resolve_device(args.device)
    if args.mode == "mesh":
        import torch.distributed as dist

        from tomojax_torch.dist import init_from_env
        init_from_env(dev)
        rec = run_mesh(args, dev)
        first = not dist.is_initialized() or dist.get_rank() == 0
    else:
        rec = run_device(args, dev, volume, keep)
        first = True
    rec = {"config": vars(args), "device": device_record(dev), **rec}
    if first:
        write(rec, args.out)
    return rec


if __name__ == "__main__":
    main()

"""BASELINE config 2: 128³ phantom, 180 views over [0, π] — SIRT and
TV-regularized (FISTA) reconstruction on clean and noisy data, recorded
(the port's counterpart of ``scripts/config2_128.py``).

    python -m tomojax_torch.tools.config2 [--device cuda] [--size 128]
        [--views 180] [--seed 0] [--sirt-iters 100] [--fista-iters 60]
        [--beta-tv 2.0] [--noise 0.01] [--quad plane|arc]
        [--out config2.json]

SIRT runs with positivity, FISTA-TV with its step from the power
iteration (``hyper=None``) and 20 prox iterations; the noisy data adds
relative Gaussian noise (``noise`` × mean |proj|) from
``np.random.default_rng(seed)``. Each run records ``wall_s``,
``iters_run``, ``rel_l2_vs_phantom`` and ``final_rms``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tomojax_torch.core import phantom
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.fista_tv import fista_tv
from tomojax_torch.recon.sirt import sirt
from tomojax_torch.tools._baseline import device_record, rel_l2, write
from tomojax_torch.utils.profiling import timed


def problem(n=128, n_proj=180):
    """Config 2's geometry, float32 phantom and views (over [0, π], no
    jitter)."""
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    vol_np = phantom.shepp3d(n).astype(np.float32)
    views = Views.create(n_proj, phi=np.linspace(0.0, np.pi, n_proj))
    return geom, vol_np, views


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--views", type=int, default=180)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sirt-iters", type=int, default=100)
    ap.add_argument("--fista-iters", type=int, default=60)
    ap.add_argument("--beta-tv", type=float, default=2.0)
    ap.add_argument("--noise", type=float, default=0.01,
                    help="relative Gaussian noise on the noisy variant")
    ap.add_argument("--quad", default="plane", choices=["arc", "plane"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    geom, vol_np, views = problem(args.size, args.views)
    fam = "slab" if args.quad == "arc" else "slab_plane"
    op = make_operator(geom, views, family=fam, device=args.device)
    rec = {"config": vars(args), "device": device_record(args.device),
           "runs": {}}
    t_all = time.perf_counter()
    with torch.no_grad():
        proj, rec["gen_s"] = timed(
            lambda: op.A(torch.as_tensor(vol_np, device=op.device)),
            reps=1, warmup=0)
        rng = np.random.default_rng(args.seed)
        p = proj.cpu().numpy()
        scale = float(np.abs(p).mean())
        noisy = torch.as_tensor(
            p + (args.noise * scale * rng.standard_normal(p.shape)
                 ).astype(np.float32), device=op.device)

        def run(name, fn):
            res, wall = timed(fn, reps=1, warmup=0)
            k = int(res.n_iter)
            rec["runs"][name] = r = {
                "wall_s": wall, "iters_run": k,
                "rel_l2_vs_phantom": rel_l2(res.x, vol_np),
                "final_rms": float(res.rms_error[max(k - 1, 0)])}
            print(f"[{name}] {wall:.2f} s, {k} iters, rel-L2 "
                  f"{r['rel_l2_vs_phantom']:.4f}", flush=True)

        for label, b in (("clean", proj), ("noisy", noisy)):
            run(f"sirt_{label}", lambda: sirt(op, b, niter=args.sirt_iters,
                                              positivity=True))
        for label, b in (("clean", proj), ("noisy", noisy)):
            run(f"fista_tv_{label}",
                lambda: fista_tv(op, b, niter=args.fista_iters, hyper=None,
                                 beta_tv=args.beta_tv))
    rec["total_wall_s"] = time.perf_counter() - t_all
    write(rec, args.out)
    return rec


if __name__ == "__main__":
    main()

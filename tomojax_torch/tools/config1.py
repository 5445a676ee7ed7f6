"""BASELINE config 1: 64³ Shepp-Logan, 90 jittered parallel-beam views —
data generation and CGLS reconstruction per projector family, recorded
(the port's counterpart of ``scripts/config1_64.py``).

    python -m tomojax_torch.tools.config1 [--device cuda] [--size 64]
        [--views 90] [--jitter-px 2] [--jitter-deg 1] [--seed 0]
        [--cgls-iters 50] [--families ray slab] [--out config1.json]

Each family makes its own data with its own A at the true views, then
runs CGLS from zero. Per family it records ``gen_s``, ``gen_proj_per_s``,
``cgls_s``, ``cgls_iters_run``, ``recon_rel_l2_vs_phantom`` and
``final_rms``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tomojax_torch.core import phantom
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.cgls import cgls
from tomojax_torch.tools._baseline import device_record, rel_l2, write
from tomojax_torch.utils.profiling import timed


def problem(n=64, n_proj=90, jitter_px=2.0, jitter_deg=1.0, seed=0):
    """Config 1's geometry, float32 phantom and jittered views (shifts in
    x and z, tilts α and β, from ``np.random.default_rng(seed)``)."""
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    vol_np = phantom.shepp3d(n).astype(np.float32)
    rng = np.random.default_rng(seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    amax = np.deg2rad(jitter_deg)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-jitter_px, jitter_px, n_proj)
    t[:, 2] = rng.uniform(-jitter_px, jitter_px, n_proj)
    views = Views.create(n_proj, phi=phi,
                         alpha=rng.uniform(-amax, amax, n_proj),
                         beta=rng.uniform(-amax, amax, n_proj), t=t)
    return geom, vol_np, views


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--jitter-px", type=float, default=2.0)
    ap.add_argument("--jitter-deg", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cgls-iters", type=int, default=50)
    ap.add_argument("--families", nargs="+", default=["ray", "slab"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    n_proj = args.views
    geom, vol_np, views = problem(args.size, n_proj, args.jitter_px,
                                  args.jitter_deg, args.seed)
    rec = {"config": vars(args), "device": device_record(args.device),
           "families": {}}
    with torch.no_grad():
        for fam in args.families:
            op = make_operator(geom, views, family=fam, device=args.device)
            vol = torch.as_tensor(vol_np, device=op.device)
            proj, gen_s = timed(lambda: op.A(vol), reps=1,
                                warmup=0)
            res, cgls_s = timed(lambda: cgls(op, proj,
                                             niter=args.cgls_iters),
                                reps=1, warmup=0)
            k = int(res.n_iter)
            r = {"gen_s": gen_s, "gen_proj_per_s": n_proj / gen_s,
                 "cgls_s": cgls_s, "cgls_iters_run": k,
                 "recon_rel_l2_vs_phantom": rel_l2(res.x, vol_np),
                 "final_rms": float(res.rms_error[k - 1])}
            rec["families"][fam] = r
            print(f"[{fam}] gen {gen_s:.3f} s ({r['gen_proj_per_s']:.1f} "
                  f"proj/s), cgls({args.cgls_iters}) {cgls_s:.3f} s, "
                  f"rel-L2 {r['recon_rel_l2_vs_phantom']:.4f}", flush=True)
    write(rec, args.out)
    return rec


if __name__ == "__main__":
    main()

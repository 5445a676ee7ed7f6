"""BASELINE config 3: 256³ phantom with random translations — shift
pre-alignment (COM and the FFT cross-correlation chain) and CGLS
reconstruction, recorded (the port's counterpart of
``scripts/config3_256.py``).

    python -m tomojax_torch.tools.config3 [--device cuda] [--size 256]
        [--views 180] [--jitter-px 4] [--seed 0] [--cgls-iters 60]
        [--cgls-chunk 20] [--quad arc|plane] [--out config3.json]

The data are projected with the slab family of ``--quad`` and solved with
the same operator. Recorded stages: ``gen_s``; ``com`` and ``cc_chain``
with their (tx, tz) error tables, raw and gauge-corrected (the chain's
relative to its mean), and wall seconds; CGLS rel-L2 against the phantom
after every ``--cgls-chunk`` iterations (each chunk restarts CGLS from
the last volume) for the misaligned, COM, CC and true views, with wall
seconds; ``total_wall_s``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tomojax_torch.align.cc import com_align, cross_correlation_chain
from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator, resolve_device
from tomojax_torch.recon.cgls import cgls
from tomojax_torch.tools._baseline import device_record, rel_l2, write
from tomojax_torch.utils.profiling import timed


def err_table(est_tx, est_tz, tx, tz, phi, relative=False) -> dict:
    """Raw and gauge-corrected error stats (gauge: tx ~ {cos, sin} φ
    volume shift, tz ~ const). ``relative=True`` first removes the error
    means (a chain only aligns relative to view 0)."""
    etx = np.asarray(est_tx, np.float64) - tx
    etz = np.asarray(est_tz, np.float64) - tz
    if relative:
        etx, etz = etx - etx.mean(), etz - etz.mean()
    A = np.stack([np.cos(phi), np.sin(phi)], 1)
    coef, *_ = np.linalg.lstsq(A, etx, rcond=None)

    def st(e):
        return {"mean": float(np.abs(e).mean()),
                "max": float(np.abs(e).max())}

    return {"raw": {"tx": st(etx), "tz": st(etz)},
            "gauge_corrected": {"tx": st(etx - A @ coef),
                                "tz": st(etz - etz.mean())}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=180)
    ap.add_argument("--jitter-px", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cgls-iters", type=int, default=60)
    ap.add_argument("--cgls-chunk", type=int, default=20)
    ap.add_argument("--quad", default="arc", choices=["arc", "plane"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n, n_proj = args.size, args.views
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    vol_np = phantom.shepp3d(n).astype(np.float32)
    vol = torch.as_tensor(vol_np, device=dev)
    rng = np.random.default_rng(args.seed)
    phi = np.linspace(0.0, np.pi, n_proj)
    tx = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    tz = rng.uniform(-args.jitter_px, args.jitter_px, n_proj)
    t_true = np.zeros((n_proj, 3))
    t_true[:, 0], t_true[:, 2] = tx, tz
    fam = "slab" if args.quad == "arc" else "slab_plane"
    rec = {"config": vars(args), "device": device_record(dev), "stages": {}}
    st = rec["stages"]
    t0 = time.perf_counter()
    with torch.no_grad():
        proj, st["gen_s"] = timed(lambda: sp.project(
            vol, geom, Views.create(n_proj, phi=phi, t=t_true, device=dev),
            quad=args.quad), reps=1, warmup=0)
        print(f"[gen] slab-{args.quad} {n}^3, {n_proj} views: "
              f"{st['gen_s']:.2f} s", flush=True)

        est, com_s = timed(lambda: com_align(proj, geom, phi).cpu().numpy(),
                           reps=1, warmup=0)
        st["com"] = {**err_table(est[:, 0], est[:, 1], tx, tz, phi),
                     "wall_s": com_s}
        offsets, cc_s = timed(lambda: cross_correlation_chain(
            proj.reshape(n_proj, n, n))[0].cpu().numpy(),
            reps=1, warmup=0)
        st["cc_chain"] = {**err_table(offsets[:, 0], offsets[:, 1], tx, tz,
                                      phi, relative=True), "wall_s": cc_s}
        for name in ("com", "cc_chain"):
            gc = st[name]["gauge_corrected"]
            print(f"[{name}] {st[name]['wall_s']:.2f} s, gauge-corrected "
                  f"mean tx {gc['tx']['mean']:.3e} tz {gc['tz']['mean']:.3e}",
                  flush=True)

        def run_cgls(t_est, label):
            op = make_operator(geom, Views.create(n_proj, phi=phi,
                                                  t=np.asarray(t_est,
                                                               np.float32)),
                               family=fam, device=dev)
            x = torch.zeros(geom.vox_shape, device=dev)
            rels, t1 = [], time.perf_counter()
            for done in range(0, args.cgls_iters, args.cgls_chunk):
                k = min(args.cgls_chunk, args.cgls_iters - done)
                x = cgls(op, proj, niter=k, x0=x).x
                rels.append(rel_l2(x, vol_np))
                print(f"[{label}] cgls {done + k}/{args.cgls_iters}: rel-L2 "
                      f"{rels[-1]:.4f}", flush=True)
            return {"rel_l2": rels, "wall_s": time.perf_counter() - t1}

        t_com = np.zeros((n_proj, 3))
        t_com[:, 0], t_com[:, 2] = est[:, 0], est[:, 1]
        # the chain's offsets are relative to view 0: remove the mean (a
        # pure gauge/COR component)
        t_cc = np.zeros((n_proj, 3))
        t_cc[:, 0] = offsets[:, 0] - offsets[:, 0].mean()
        t_cc[:, 2] = offsets[:, 1] - offsets[:, 1].mean()
        for label, t_est in (("misaligned", np.zeros((n_proj, 3))),
                             ("com", t_com), ("cc", t_cc),
                             ("true", t_true)):
            st[f"cgls_{label}"] = run_cgls(t_est, label)
    rec["total_wall_s"] = time.perf_counter() - t0
    write(rec, args.out)
    return rec


if __name__ == "__main__":
    main()

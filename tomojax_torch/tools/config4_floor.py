"""The floor that config 4's alignment can reach: CGLS rel-L2 against the
phantom on config 4's dataset with the TRUE views, arc and plane
reconstruction, at 10 … 180 iterations.

    python -m tomojax_torch.tools.config4_floor [--device cuda]
        [--size 256] [--views 90] [--iters 180]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from tomojax_torch import cli
from tomojax_torch.tools.config4_profile import simulate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--iters", type=int, default=180)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        data = simulate(tmp, args.size, args.views, args.device)
        for fam in ("slab", "slab_plane"):
            t0 = time.perf_counter()
            r = cli.main(["reconstruct", "-i", data, "-o",
                          os.path.join(tmp, "x.npy"), "--device", args.device,
                          "--set", "solver.method=cgls",
                          "--set", f"solver.family={fam}",
                          "--set", f"solver.niter={args.iters}"])
            if args.device == "cuda":
                torch.cuda.synchronize()
            res = r["result"]
            rel = np.asarray(res.rms_error.cpu(), np.float64)
            ks = [k for k in (10, 20, 30, 60, 90, 120, 150, 180)
                  if k <= res.n_iter]
            print(f"true views, {fam}: "
                  + " ".join(f"@{k} {rel[k - 1]:.4f}" for k in ks)
                  + f"; {res.n_iter} iters, stop {res.stop_reason}, "
                  f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

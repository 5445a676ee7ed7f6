"""tomojax's voxel Jacobian in float32 against float64 on XLA:CPU.

An independent witness for the voxel family's fp32 Jacobian error: the
same problem as ``chip_smoke.py`` phase 12d (128³ Shepp phantom, 90 views
over [0, π) with α, β in ±0.01 rad and tx, tz in ±2 px from
``default_rng(0)``; the Jacobian on every 9th view, 10 views), computed by
``tomojax.core.voxel_projector.forward_view_jac`` in float32 and in
float64. Prints the relative L2 per (view, field) as each field's median
and maximum over the views, the statistic phase 12d prints for the port.

    python scripts/voxel_jac_fp32_witness.py [--out witness.json]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tomojax.core import phantom  # noqa: E402
from tomojax.core import voxel_projector as vox  # noqa: E402
from tomojax.core.geometry import Geometry  # noqa: E402

N, N_PROJ, N_JAC, SEED = 128, 90, 10, 0
FIELDS = ("tx", "ty", "tz", "phi", "alpha", "beta")


def problem():
    """Phase 12d's geometry, views and phantom."""
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    phi = np.linspace(0.0, np.pi, N_PROJ, endpoint=False)
    alpha = rng.uniform(-0.01, 0.01, N_PROJ)
    beta = rng.uniform(-0.01, 0.01, N_PROJ)
    t = np.stack([rng.uniform(-2, 2, N_PROJ), np.zeros(N_PROJ),
                  rng.uniform(-2, 2, N_PROJ)], -1)
    return geom, phantom.shepp3d(N), phi, alpha, beta, t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    geom, vol, phi, alpha, beta, t = problem()
    idx = np.arange(0, N_PROJ, N_PROJ // N_JAC)[:N_JAC]
    jac = {}
    t0 = time.perf_counter()
    for dt in (jnp.float32, jnp.float64):
        f = jax.jit(lambda v, p, a, b, tt, dt=dt: vox.forward_view_jac(
            v, geom, p, a, b, tt, 0.0, dtype=dt)[1])
        x = jnp.asarray(vol, dt)
        jac[dt] = np.stack([np.asarray(f(x, dt(phi[i]), dt(alpha[i]),
                                         dt(beta[i]), jnp.asarray(t[i], dt)),
                                       np.float64) for i in idx])
    j32, j64 = jac[jnp.float32], jac[jnp.float64]      # (views, 6, n_det)
    with np.errstate(invalid="ignore"):               # ty is 0/0
        rel = (np.linalg.norm(j32 - j64, axis=2)
               / np.linalg.norm(j64, axis=2))
    rec = {"n": N, "views": idx.tolist(), "seconds": time.perf_counter() - t0,
           "median": dict(zip(FIELDS, np.median(rel, 0).tolist())),
           "max": dict(zip(FIELDS, rel.max(0).tolist()))}
    for k in ("median", "max"):
        print(f"tomojax voxel Jacobian fp32 vs float64 on XLA:CPU ({N}^3, "
              f"{len(idx)} views), {k} per field: "
              + ", ".join(f"{f} {v:.3e}" for f, v in rec[k].items()))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return rec


if __name__ == "__main__":
    main()

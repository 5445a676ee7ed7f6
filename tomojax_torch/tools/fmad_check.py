"""Do K1, K2, K3 and K5 depend on nvcc contracting multiply-adds? Builds the
kernels a second time with the same flags plus ``--fmad=false`` (its own
nvcc run into ``build/kernels/fmad_check/``, so the default library is
untouched), runs both builds on the same inputs at 256³, and reports per
kernel whether the bits match and each build's time.

    python -m tomojax_torch.tools.fmad_check [--size 256] [--out fmad.json]

K1 and K2 (``slab_plane_fwd``, ``slab_plane_adj``) on 180 views over the
full circle with ±0.02 rad tilts and ±4 px shifts (as ``chip_smoke.py``
phase 3), K3 and K5 on 90
views with ±0.5° tilts and ±2 px shifts (phase 5); times are CUDA-event
means of 5 applies after a warm-up, the builds taken in turns (default,
no-fma, no-fma, default). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels import _build
from tomojax_torch.kernels import slab as slabk

OUT_DIR = _build.BUILD_DIR / "fmad_check"


def load_no_fmad() -> ctypes.CDLL:
    """Build the sources with ``--fmad=false`` besides the default flags
    into a library of their own and load it."""
    _build.compile_libraries({"no_fmad": _build.texts(*_build.SOURCES)},
                             OUT_DIR, ("--fmad=false",))
    return _build.load_library(OUT_DIR / "no_fmad.so")


def groups(n, n_proj, quad, tilt, shift, device):
    """The oriented volumes, scalars and a random cotangent per group."""
    rng = np.random.default_rng(0)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    views = Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-tilt, tilt, n_proj),
        beta=rng.uniform(-tilt, tilt, n_proj),
        t=rng.uniform(-shift, shift, (n_proj, 3)), device=device)
    gstruct, scalars = sp.scalar_groups(geom, views, quad, device=device)
    vol = torch.as_tensor(phantom.shepp3d(n), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = []
    for (idx, sw, yf, _), sc in zip(gstruct, scalars):
        y = torch.randn((len(idx), n, n), generator=gen, device=device)
        out.append((sp.orient_volume(vol, geom, sw, yf).contiguous(), sc, y))
    return geom, out


def apply(lib, entry, geom, grps):
    """One apply of ``entry`` over the groups, with ``lib``'s kernel."""
    nu, nv = geom.det_shape
    res = []
    for vol_or, sc, y in grps:
        V = sc.shape[0]
        if entry == "slab_plane_adj":
            inp, out, extra = y, torch.empty(geom.vox_shape,
                                             device=y.device), ()
        elif entry == "slab_plane_fwd":
            inp, out, extra = vol_or, torch.empty((V, nu, nv),
                                                  device=y.device), ()
        else:
            shape = (V, nu, nv) if entry == "slab_arc_fwd" else (
                V, slabk.NJP, nu, nv)
            inp, out = vol_or, torch.empty(shape, device=y.device)
            extra = slabk._arc_args(geom)
        slabk._launch(getattr(lib, entry), inp, sc, (out,), geom, *extra)
        res.append(out)
    return res


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fmad_check needs a CUDA device")
    dev = torch.device("cuda")
    libs = {"default": _build.load(), "no_fmad": load_no_fmad()}
    plane = groups(args.size, 180, "plane", 0.02, 4.0, dev)
    arc = groups(args.size, 90, "arc", np.deg2rad(0.5), 2.0, dev)
    report = {"device": torch.cuda.get_device_name(0), "kernels": {}}
    for name, entry, (geom, grps) in (
            ("K1", "slab_plane_fwd", plane), ("K2", "slab_plane_adj", plane),
            ("K3", "slab_arc_fwd", arc),
            ("K5", "slab_arc_jac", arc)):
        a = apply(libs["default"], entry, geom, grps)
        b = apply(libs["no_fmad"], entry, geom, grps)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
        t = {}
        for key in ("default", "no_fmad", "no_fmad", "default"):
            t.setdefault(key, []).append(
                ms(lambda: apply(libs[key], entry, geom, grps)))
        rec = {"bit_equal": same, "max_abs_diff": diff,
               "ms_default": t["default"], "ms_no_fmad": t["no_fmad"]}
        report["kernels"][name] = rec
        print(f"{name} ({entry}): --fmad=false bit-equal {same} (max abs "
              f"diff {diff:.3e}); ms default {t['default']}, no-fma "
              f"{t['no_fmad']}", flush=True)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

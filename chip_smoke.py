#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tomojax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of its own; any failed check raises and the
script exits non-zero:

1. Device: the card's name and power limit; TF32 off.
2. Build: the CUDA kernels from ``tomojax_torch/kernels/csrc`` (nvcc).
3. Kernels against their plain PyTorch versions, fp32, at 256³ × 180
   jittered views × 256² detector with all four orientation groups: K1
   per-view relative L2 ≤ 5e-4, K2 relative L2 ≤ 5e-4, adjoint identity
   |⟨K1 x, y⟩ − ⟨x, K2 y⟩| ≤ 1e-5·‖K1 x‖·‖y‖ (float64 dot products), and
   each one's time per 180-view apply (CUDA events, after warm-up).
4. Main path through the CLI (BASELINE config 3 on slab_plane):
   ``simulate`` 256³/180 views with ±4 px shifts, then ``reconstruct``
   with COM pre-alignment + 60 CGLS iterations, and a second CGLS run on
   the dataset's true views. rel-L2 against the phantom must not rise
   from iteration 20 to 40 to 60, the true-views run must end at ≤ 0.25,
   and both kernels' launch counters must have risen in this phase.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit, and before that the kernels' JSON.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from tomojax_torch import cli
from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.kernels import _build
from tomojax_torch.kernels import slab as slabk

N, N_PROJ, SEED = 256, 180, 0
TOL_FWD = TOL_ADJ = 5e-4
TOL_DOT = 1e-5
REL_L2_TRUE_MAX = 0.25
KERNEL_SOURCE = "tomojax_torch/kernels/csrc/slab_plane.cu"


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` runs, after one
    warm-up run (CUDA events)."""
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


def phase_kernels(dev):
    """K1/K2 against their plain versions at the main path's shapes."""
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    views = Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-4, 4, (N_PROJ, 3)), device=dev)
    gstruct, scalars = sp.scalar_groups(geom, views, device=dev)
    check(len(gstruct) == 4, f"expected 4 orientation groups: {gstruct}")
    vol = torch.as_tensor(phantom.shepp3d(N), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nu, nv = geom.det_shape
    groups = []
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
        y = torch.randn((len(idx), nu, nv), generator=gen, device=dev)
        groups.append((vol_or, sc, y))

    fwd_rel, fwd_abs, adj_rel, adj_abs, dot_rel = [], [], [], [], []
    for vol_or, sc, y in groups:
        ker = slabk.slab_project(vol_or, sc, geom)
        ref = slabk.slab_project_plain(vol_or, sc, geom)
        fwd_rel.append(float((torch.linalg.norm(ker - ref, dim=(1, 2))
                              / torch.linalg.norm(ref, dim=(1, 2))).max()))
        fwd_abs.append(float((ker - ref).abs().max()))
        kadj = slabk.slab_backproject(y, sc, geom)
        radj = slabk.slab_backproject_plain(y, sc, geom)
        adj_rel.append(float(torch.linalg.norm(kadj - radj)
                             / torch.linalg.norm(radj)))
        adj_abs.append(float((kadj - radj).abs().max()))
        lhs = torch.dot(ker.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1),
                        kadj.double().reshape(-1))
        scale = torch.linalg.norm(ker.double()) * torch.linalg.norm(
            y.double())
        dot_rel.append(float(abs(lhs - rhs) / scale))
        del ker, ref, kadj, radj
    print(f"K1 vs plain: max per-view rel L2 {max(fwd_rel):.3e} "
          f"(tol {TOL_FWD}), max abs {max(fwd_abs):.3e}")
    print(f"K2 vs plain vjp: max rel L2 {max(adj_rel):.3e} (tol {TOL_ADJ}), "
          f"max abs {max(adj_abs):.3e}")
    print(f"adjoint identity |<K1x,y>-<x,K2y>|/(|K1x||y|): max "
          f"{max(dot_rel):.3e} (tol {TOL_DOT})")

    def fwd(fn):
        return lambda: [fn(vo, sc, geom) for vo, sc, _ in groups]

    def adj(fn):
        return lambda: [fn(y, sc, geom) for _, sc, y in groups]

    t = {"fwd": cuda_ms(fwd(slabk.slab_project), 5),
         "fwd_plain": cuda_ms(fwd(slabk.slab_project_plain), 2),
         "adj": cuda_ms(adj(slabk.slab_backproject), 5),
         "adj_plain": cuda_ms(adj(slabk.slab_backproject_plain), 2)}
    print(f"K1 {t['fwd']:.3f} ms vs plain {t['fwd_plain']:.3f} ms per "
          f"{N_PROJ}-view apply ({N}^3)")
    print(f"K2 {t['adj']:.3f} ms vs plain {t['adj_plain']:.3f} ms per "
          f"{N_PROJ}-view apply ({N}^3)")

    op = make_operator(geom, views, device=dev)
    sino = op.A(vol)
    t_A = cuda_ms(lambda: op.A(vol), 5)
    t_AT = cuda_ms(lambda: op.AT(sino), 5)
    print(f"operator A {t_A:.3f} ms, AT {t_AT:.3f} ms per apply; "
          f"fwd+adjoint {N_PROJ / ((t_A + t_AT) / 1e3):.1f} proj/s "
          f"({N}^3, {N_PROJ} views, slab_plane)")

    check(max(fwd_rel) <= TOL_FWD, f"K1 rel L2 {max(fwd_rel)}")
    check(max(adj_rel) <= TOL_ADJ, f"K2 rel L2 {max(adj_rel)}")
    check(max(dot_rel) <= TOL_DOT, f"adjoint identity {max(dot_rel)}")
    return {"fwd_abs": max(fwd_abs), "adj_abs": max(adj_abs), **t}


def phase_main_path(tmp):
    """BASELINE config 3 through the CLI: simulate, COM + CGLS, and CGLS
    on the true views."""
    # .npz, not .h5: the card's machine has no h5py (tomojax_torch.utils.io
    # writes the same arrays under the same names, picking by suffix)
    data = os.path.join(tmp, "config3.npz")
    common = ["--set", "solver.method=cgls", "--set",
              "solver.family=slab_plane", "--set", "solver.niter=60"]
    slabk.slab_project.launches = 0
    slabk.slab_backproject.launches = 0
    t0 = time.perf_counter()
    cli.main(["simulate", "--size", str(N), "--views", str(N_PROJ),
              "--set", "simulate.family=slab_plane",
              "--set", "simulate.max_shift_px=4",
              "--set", "simulate.max_angle_deg=0", "-o", data])
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    runs = {}
    for name, extra in (("com", ["--pre-align", "com"]), ("true", [])):
        out = os.path.join(tmp, f"recon_{name}.npy")
        t0 = time.perf_counter()
        r = cli.main(["reconstruct", "-i", data, "-o", out, *common,
                      *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = r["result"]
        x = np.load(out)
        check(x.shape == (N, N, N) and np.isfinite(x).all(),
              f"{name}: volume shape {x.shape} or non-finite values")
        check(res.n_iter == 60 and res.stop_reason == 0,
              f"{name}: CGLS stopped at {res.n_iter} ({res.stop_reason})")
        rel = [float(res.rms_error[i - 1]) for i in (20, 40, 60)]
        runs[name] = rel
        line = (f"CGLS {name}: rel-L2 @20/40/60 "
                f"{rel[0]:.4f}/{rel[1]:.4f}/{rel[2]:.4f}, wall {wall:.2f} s")
        if "pre_align_residual" in r:
            (txm, txx), (tzm, tzx) = (r["pre_align_residual"]["tx"],
                                      r["pre_align_residual"]["tz"])
            line += (f"; COM residual tx {txm:.4f}/{txx:.4f} "
                     f"tz {tzm:.4f}/{tzx:.4f} px (mean/max)")
        print(line)
        check(rel[0] >= rel[1] >= rel[2], f"{name}: rel-L2 rose {rel}")
    print(f"simulate wall {t_sim:.2f} s")
    launches = {"fwd": slabk.slab_project.launches,
                "adj": slabk.slab_backproject.launches}
    print(f"main-path kernel launches: K1 {launches['fwd']}, "
          f"K2 {launches['adj']}")
    check(runs["true"][2] <= REL_L2_TRUE_MAX,
          f"true-views rel-L2 {runs['true'][2]} > {REL_L2_TRUE_MAX}")
    check(launches["fwd"] > 0 and launches["adj"] > 0,
          f"main path did not launch both kernels: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this needs an NVIDIA GPU")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; nvidia-smi: {smi}")
    print("tf32: matmul.allow_tf32 = False, cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.2f} s ({lib._name})")

    k = phase_kernels(dev)
    tmp = tempfile.mkdtemp(prefix="tomojax_torch_smoke_")
    try:
        launches = phase_main_path(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = [
        {"name": "slab_plane_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "tomojax/kernels/slab.py:293",
         "launches": launches["fwd"], "max_abs_err": k["fwd_abs"],
         "ms": k["fwd"], "plain_ms": k["fwd_plain"]},
        {"name": "slab_plane_adj", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "tomojax/kernels/slab.py:605",
         "launches": launches["adj"], "max_abs_err": k["adj_abs"],
         "ms": k["adj"], "plain_ms": k["adj_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

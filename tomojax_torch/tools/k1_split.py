"""Where K1's time goes, and whether it gives another build's bits. Builds
``slab_plane.cu`` again with one part of K1 disabled at a time (pass A,
pass B, the staging copies: text substitutions, each its own nvcc run into
``build/kernels/k1_split/``), times each beside the full kernel at
``chip_smoke.py`` phase 3's shapes (256³ Shepp phantom, 180 views over the
full circle with ±0.02 rad tilts and ±4 px shifts, 256² detector, four
orientation groups), and with ``--parent`` builds a ``slab_plane.cu`` of
another tree too and compares K1's output bits on those groups.

    python -m tomojax_torch.tools.k1_split [--size 256] [--parent PATH]
        [--out split.json]

A variant with a part disabled gives wrong values; only its time means
something: the full kernel's time less a variant's is what that part costs
(parts overlap, so the costs need not add up). Times are CUDA-event means
of 5 applies after a warm-up, the builds taken in turns (forward, then
backward). Needs a CUDA device.
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

SOURCE = _build.CSRC / "slab_plane.cu"
OUT_DIR = _build.BUILD_DIR / "k1_split"
# each variant: (text of slab_plane.cu, its replacement)
VARIANTS = {
    "no_pass_a": [(
        "    const float zeta =\n"
        "        zeta_at(p, cx, cz, fx + static_cast<float>(i * kFwdWarps), "
        "fv);\n"
        "    const Floor f = floor_small(zeta);\n"
        "    const float* const row = q + i * kFwdWarps * kSZ + f.k;\n"
        "    t[i * kFwdWarps * kFV] = lerp_pair(row[0], row[1], zeta - f.f);",
        "    t[i * kFwdWarps * kFV] = 0.0f;")],
    "no_pass_b": [(
        "    if (w_b.w >= 0) {\n      const float* const tab",
        "    if (w_b.w >= 0 && ri < 0) {\n      const float* const tab")],
    "no_staging": [(
        "  if (w.w >= 0) {\n    const unsigned unx",
        "  if (w.w >= 0 && s < 0) {\n    const unsigned unx")],
}


def variant_source(name: str, text: str | None = None) -> str:
    """``slab_plane.cu`` (or ``text``) with ``VARIANTS[name]`` applied;
    raises if a substitution does not match exactly once."""
    s = SOURCE.read_text() if text is None else text
    for old, new in VARIANTS[name]:
        if s.count(old) != 1:
            raise ValueError(f"{name}: the text to replace occurs "
                             f"{s.count(old)} times in slab_plane.cu")
        s = s.replace(old, new)
    return s


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One shared library per source text, all nvcc runs together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    cmds, libs = [], {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                     str(OUT_DIR / f"{name}.so"), str(cu)])
    _build._run(cmds)
    for name in sources:
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        lib.slab_plane_fwd.argtypes = _build._SIGNATURES["slab_plane_fwd"]
        lib.slab_plane_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def groups(n, device):
    """Phase 3's oriented volumes and scalars per orientation group."""
    rng = np.random.default_rng(0)
    n_proj = 180
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    views = Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, n_proj),
        beta=rng.uniform(-0.02, 0.02, n_proj),
        t=rng.uniform(-4, 4, (n_proj, 3)), device=device)
    gstruct, scalars = sp.scalar_groups(geom, views, "plane", device=device)
    vol = torch.as_tensor(phantom.shepp3d(n), device=device)
    return geom, [(sp.orient_volume(vol, geom, sw, yf).contiguous(), sc)
                  for (_, sw, yf, _), sc in zip(gstruct, scalars)]


def apply(lib, geom, grps):
    """One apply of ``lib``'s K1 over the groups → the outputs."""
    nu, nv = geom.det_shape
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for vol_or, sc in grps:
        nx, ny, nz = vol_or.shape
        out = torch.empty((sc.shape[0], nu, nv), device=vol_or.device)
        rc = lib.slab_plane_fwd(
            ctypes.c_void_p(vol_or.data_ptr()), ctypes.c_void_p(sc.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), sc.shape[0], nx, ny, nz, nu, nv,
            ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"slab_plane_fwd: CUDA error {rc}")
        outs.append(out)
    return outs


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
    ap.add_argument("--parent", default=None,
                    help="a slab_plane.cu to compare bits and time with")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_split needs a CUDA device")
    dev = torch.device("cuda")
    sources = {"k1": SOURCE.read_text(),
               **{name: variant_source(name) for name in VARIANTS}}
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    libs = build(sources)
    geom, grps = groups(args.size, dev)
    report = {"device": torch.cuda.get_device_name(0), "size": args.size,
              "views": sum(sc.shape[0] for _, sc in grps)}
    if args.parent:
        a, b = apply(libs["k1"], geom, grps), apply(libs["parent"], geom, grps)
        report["bits_equal_parent"] = [
            torch.equal(x.view(torch.int32), y.view(torch.int32))
            for x, y in zip(a, b)]
    order = list(sources)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        times[name].append(ms(lambda: apply(libs[name], geom, grps)))
    report["ms"] = times
    report["cost_ms"] = {name: float(np.mean(times["k1"])
                                     - np.mean(times[name]))
                         for name in VARIANTS}
    for name in order:
        print(f"{name}: {times[name]} ms per apply", flush=True)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Where the bf16 tier's adjoints K2b and K4b spend their time, and whether
the fp32 kernels give another build's bits. Builds ``slab_plane.cu`` and
``slab_arc.cu`` again with one part of K2b or K4b disabled at a time (text
substitutions, each its own nvcc run, all started together, into
``build/kernels/adj_split/``) and times each variant beside the full
kernel and its fp32 counterpart, in turns:

- K2b at ``chip_smoke.py`` phase 3's problem (256³ Shepp phantom, 180
  views over the full circle, ±0.02 rad tilts, ±4 px shifts) and at 32 of
  config 5's 1024 views at 512³ (phase 12b's views);
- K4b at phase 5's problem (256³, 90 views, ±0.5° tilts, ±2 px shifts).

With ``--parent`` (another tree's root, or the directory holding its
``slab_plane.cu`` and ``slab_arc.cu``) it also builds that tree's sources,
times its K2b and K4b beside this tree's, and compares the bits of the
fp32 kernels K1-K5 and of K1b and K3b on phase 3's and phase 5's groups.

    python -m tomojax_torch.tools.adj_split [--size 256] [--parent PATH]
        [--out split.json]

A variant with a part disabled gives wrong values; only its time means
something: the full kernel's time less a variant's is what that part costs
(parts overlap, so the costs need not add up). Times are CUDA-event means
of 5 applies after a warm-up, each build timed twice (the builds in
order, then in reverse). Each full build is compiled with ``-Xptxas -v``;
the report carries its registers and spills and, from the CUDA runtime,
each adjoint kernel's registers and CTAs per SM at its shared memory.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels import _build
from tomojax_torch.tools import config5
from tomojax_torch.utils.profiling import cuda_ms

PLANE = _build.CSRC / "slab_plane.cu"
ARC = _build.CSRC / "slab_arc.cu"
OUT_DIR = _build.BUILD_DIR / "adj_split"

# Each kernel: its source, its bf16 entry, its fp32 counterpart's entry,
# the template instance and dynamic shared memory that the occupancy query
# names, and its variants: {name: [(text of the source, replacement)]}.
KERNELS = {
    "k2b": {
        "source": PLANE, "entry": "slab_plane_adj_bf16",
        "fp32": "slab_plane_adj", "kernel": "adj_bf16_kernel",
        "smem": "kBSmem", "threads": "kAdjThreads",
        "variants": {
            "no_pass_b": [(
                "      if (w.nvc > 0) {\n        // pass B of chunk k",
                "      if (w.nvc > 0 && V < 0) {\n        // pass B of chunk k")],
            "no_pass_a": [(
                "      if (w.nvc > 0 && pa.uci() == w.nuc - 1) {",
                "      if (w.nvc > 0 && pa.uci() == w.nuc - 1 && V < 0) {")],
            "skeleton_only": [(
                "      if (w.nvc > 0) {\n        // pass B of chunk k",
                "      if (w.nvc > 0 && V < 0) {\n        // pass B of chunk k"), (
                "      if (w.nvc > 0 && pa.uci() == w.nuc - 1) {",
                "      if (w.nvc > 0 && pa.uci() == w.nuc - 1 && V < 0) {")],
            "ctas3": [(
                "__global__ void __launch_bounds__(kAdjThreads, 4)\n"
                "adj_bf16_kernel(",
                "__global__ void __launch_bounds__(kAdjThreads, 3)\n"
                "adj_bf16_kernel(")],
            "no_staging": [(
                "  if (w.nvc > 0) {\n    const Extent c = extent(w, s);",
                "  if (w.nvc > 0 && nu < 0) {\n"
                "    const Extent c = extent(w, s);")],
        },
    },
    "k4b": {
        "source": ARC, "entry": "slab_arc_adj_bf16", "fp32": "slab_arc_adj",
        "kernel": "arc_adj_bf16_kernel", "smem": "kBSmem",
        "threads": "kAdjThreads",
        "variants": {
            "no_grid": [(
                "              if (b0 == 0) {\n                float cf, zaff;",
                "              if (b0 == 0 && V < 0) {\n"
                "                float cf, zaff;")],
            "no_pass_b": [(
                "              switch (cu) {\n"
                "                case 1: K4B_PASS_B(1); break;",
                "              if (V < 0) switch (cu) {\n"
                "                case 1: K4B_PASS_B(1); break;")],
            "no_pass_a": [(
                "          switch (cvv) {",
                "          if (V < 0) switch (cvv) {")],
            "skeleton_only": [(
                "              if (b0 == 0) {\n                float cf, zaff;",
                "              if (b0 == 0 && V < 0) {\n"
                "                float cf, zaff;"), (
                "              switch (cu) {\n"
                "                case 1: K4B_PASS_B(1); break;",
                "              if (V < 0) switch (cu) {\n"
                "                case 1: K4B_PASS_B(1); break;"), (
                "          switch (cvv) {",
                "          if (V < 0) switch (cvv) {")],
            "ctas2": [(
                "__global__ void __launch_bounds__(kAdjThreads, 3)\n"
                "arc_adj_bf16_kernel(",
                "__global__ void __launch_bounds__(kAdjThreads, 2)\n"
                "arc_adj_bf16_kernel(")],
            "no_add": [(
                "  add_kernel<<<static_cast<int>(blocks < 8192 ? blocks : "
                "8192), 256, 0, s>>>(\n      vol, side1, n);",
                "  (void)blocks;")],
        },
    },
}
# The bf16 adjoints before their own designs (the fp32 kernels instantiated
# on bf16), for the occupancy query of a parent build of that tree.
PARENT_KERNELS = {
    "k2b": {"kernel": "adj_kernel<__nv_bfloat16>",
            "smem": "adj_smem<__nv_bfloat16>()", "threads": "kAdjThreads"},
    "k4b": {"kernel": "arc_adj_kernel<__nv_bfloat16>", "smem": "kAdjSmem",
            "threads": "kAdjThreads"}}
# The kernels whose bits the parent comparison holds: (entry, quad); the
# arc Jacobian writes 12 fields.
COMPARED = (("slab_plane_fwd", "plane"), ("slab_plane_adj", "plane"),
            ("slab_plane_fwd_bf16", "plane"), ("slab_arc_fwd", "arc"),
            ("slab_arc_adj", "arc"), ("slab_arc_jac", "arc"),
            ("slab_arc_fwd_bf16", "arc"))
_OCCUPANCY = """
extern "C" int adj_split_occupancy(int* out) {{
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, {kernel});
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = static_cast<int>({smem});
  e = cudaFuncSetAttribute({kernel},
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, {kernel},
                                                    {threads}, smem);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[3] = smem + static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(e);
}}
"""


def variant_source(kernel: str, name: str, text: str | None = None) -> str:
    """The kernel's source (or ``text``) with its variant ``name`` applied;
    raises if a substitution does not match exactly once."""
    k = KERNELS[kernel]
    s = k["source"].read_text() if text is None else text
    for old, new in k["variants"][name]:
        if s.count(old) != 1:
            raise ValueError(f"{kernel} {name}: the text to replace occurs "
                             f"{s.count(old)} times in {k['source'].name}")
        s = s.replace(old, new)
    return s


def with_occupancy(names: dict, text: str) -> str:
    """``text`` with an entry that reports the registers, local bytes,
    CTAs per SM and shared bytes per CTA of the kernel ``names`` gives
    (``kernel``, ``smem``, ``threads``)."""
    return text + _OCCUPANCY.format(**names)


def build(sources: dict[str, str]) -> tuple[dict, dict]:
    """One shared library per source text, all nvcc runs together, with
    ``-Xptxas -v`` → (libraries, ptxas lines per build)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
               str(OUT_DIR / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas, failed = {}, {}, []
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        ptxas[name] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in sources:
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        for entry, argtypes in _build._SIGNATURES.items():
            fn = getattr(lib, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs, ptxas


def ptxas_summary(text: str) -> list[dict]:
    """Per compiled function of ``-Xptxas -v``'s output: its mangled
    name, registers and spill bytes."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows


def occupancy(lib) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.adj_split_occupancy(out)
    if rc != 0:
        raise RuntimeError(f"adj_split_occupancy: CUDA error {rc}")
    return {"registers": out[0], "local_bytes": out[1],
            "ctas_per_sm": out[2], "smem_per_cta": out[3]}


def _views(n_proj, rng, tilt, shift, device):
    return Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-tilt, tilt, n_proj),
        beta=rng.uniform(-tilt, tilt, n_proj),
        t=rng.uniform(-shift, shift, (n_proj, 3)), device=device)


def _groups(geom, views, vol, quad, device):
    """Per orientation group: the oriented volume, the scalars and a
    seeded random cotangent, as ``chip_smoke.slab_groups``."""
    gstruct, scalars = sp.scalar_groups(geom, views, quad, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    nu, nv = geom.det_shape
    return [(sp.orient_volume(vol, geom, sw, yf).contiguous(), sc,
             torch.randn((len(idx), nu, nv), generator=gen, device=device))
            for (idx, sw, yf, _), sc in zip(gstruct, scalars)]


def problems(n: int, device) -> dict:
    """The three problems: {name: (quad, geom, groups)}."""
    rng = np.random.default_rng(0)
    vol = torch.as_tensor(phantom.shepp3d(n), device=device)
    plane = Geometry(n_proj=180, vox_shape=(n,) * 3, det_shape=(n, n))
    out = {f"plane_{n}": ("plane", plane, _groups(
        plane, _views(180, rng, 0.02, 4.0, device), vol, "plane", device))}
    rng = np.random.default_rng(0)
    arc = Geometry(n_proj=90, vox_shape=(n,) * 3, det_shape=(n, n))
    out[f"arc_{n}"] = ("arc", arc, _groups(
        arc, _views(90, rng, np.deg2rad(0.5), 2.0, device), vol, "arc",
        device))
    del vol
    n5 = 2 * n
    geom5, phi, t, _ = config5.problem(n5, 1024)
    sub = np.arange(0, 1024, 32)
    views5 = Views.create(1024, phi=phi, t=t, device=device).take(sub)
    vol5 = torch.as_tensor(phantom.shepp3d(n5), device=device)
    out[f"plane_{n5}"] = ("plane", geom5,
                          _groups(geom5, views5, vol5, "plane", device))
    return out


def call(lib, entry, geom, inp, sc):
    """One launch of ``lib``'s ``entry`` on one group → its output."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    V = sc.shape[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    adj = "_adj" in entry
    if adj:
        outs = [torch.empty(geom.vox_shape, device=inp.device)
                for _ in range(2 if "arc" in entry else 1)]
    else:
        fields = 12 if entry == "slab_arc_jac" else 1
        outs = [torch.empty((V, fields, nu, nv) if fields > 1 else
                            (V, nu, nv), device=inp.device)]
    args = [ctypes.c_void_p(inp.data_ptr()), ctypes.c_void_p(sc.data_ptr()),
            *(ctypes.c_void_p(o.data_ptr()) for o in outs),
            V, nx, ny, nz, nu, nv]
    if "arc" in entry:
        args += [geom.n_steps, sp._n_branch(geom.step_size)]
    rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return outs[0]


def apply(lib, entry, geom, grps):
    """One apply of ``entry`` over the groups (the bf16 entries read a
    bf16 copy of their operand, as the wrappers make it)."""
    adj = "_adj" in entry
    outs = []
    for vol_or, sc, y in grps:
        inp = y if adj else vol_or
        if entry.endswith("_bf16"):
            inp = inp.to(torch.bfloat16)
        outs.append(call(lib, entry, geom, inp, sc))
    return outs


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def errors(libs, kname, geom, grps, quad, parent) -> dict:
    """The full build's bf16 adjoint against the plain bf16 version and
    the fp32 kernel (the largest relative L2 over the groups), whether two
    applies give the same bits, and with a parent build the parent's bf16
    adjoint against the plain bf16 version."""
    from tomojax_torch.kernels import slab as slabk
    k = KERNELS[kname]
    lib = libs[kname]
    out = {"vs_plain": [], "vs_fp32": [], "repeat_equal": True}
    if parent:
        out["parent_vs_plain"] = []
    for vol_or, sc, y in grps:
        one = [(vol_or, sc, y)]
        a = apply(lib, k["entry"], geom, one)[0]
        out["repeat_equal"] &= torch.equal(
            a, apply(lib, k["entry"], geom, one)[0])
        ref = slabk.slab_backproject_plain(y, sc, geom, quad, prec="bf16")
        out["vs_plain"].append(_rel(a, ref))
        out["vs_fp32"].append(_rel(a, apply(lib, k["fp32"], geom, one)[0]))
        if parent:
            b = apply(libs[f"parent.{kname}"], k["entry"], geom, one)[0]
            out["parent_vs_plain"].append(_rel(b, ref))
        del ref
    return {key: max(val) if isinstance(val, list) else val
            for key, val in out.items()}


def parent_sources(path: str) -> dict[str, str]:
    root = Path(path)
    csrc = root / "tomojax_torch" / "kernels" / "csrc"
    d = csrc if csrc.is_dir() else root
    return {"plane": (d / "slab_plane.cu").read_text(),
            "arc": (d / "slab_arc.cu").read_text()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256,
                    help="the 256³ problems' size (config 5's is twice it)")
    ap.add_argument("--parent", default=None,
                    help="another tree (or its csrc/) to compare with")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("adj_split needs a CUDA device")
    dev = torch.device("cuda")
    sources = {}
    for kname, k in KERNELS.items():
        sources[kname] = with_occupancy(k, k["source"].read_text())
        for v in k["variants"]:
            sources[f"{kname}.{v}"] = variant_source(kname, v)
    if args.parent:
        par = parent_sources(args.parent)
        sources["parent.k2b"] = with_occupancy(PARENT_KERNELS["k2b"],
                                               par["plane"])
        sources["parent.k4b"] = with_occupancy(PARENT_KERNELS["k4b"],
                                               par["arc"])
    libs, ptxas = build(sources)
    report = {"device": torch.cuda.get_device_name(0), "size": args.size,
              "ptxas": {name: ptxas_summary(ptxas[name])
                        for name in ("k2b", "k4b", "parent.k2b",
                                     "parent.k4b") if name in ptxas},
              "occupancy": {name: occupancy(libs[name])
                            for name in ("k2b", "k4b", "parent.k2b",
                                         "parent.k4b") if name in libs}}
    print(json.dumps({"ptxas": report["ptxas"],
                      "occupancy": report["occupancy"]}), flush=True)
    probs = problems(args.size, dev)
    if args.parent:
        bits = {}
        for entry, quad in COMPARED:
            pname = f"{quad}_{args.size}"
            _, geom, grps = probs[pname]
            lib = libs["k2b" if quad == "plane" else "k4b"]
            plib = libs["parent.k2b" if quad == "plane" else "parent.k4b"]
            a, b = apply(lib, entry, geom, grps), apply(plib, entry, geom,
                                                        grps)
            bits[entry] = [torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))
                           for x, y in zip(a, b)]
        report["bits_equal_parent"] = bits
        print(json.dumps({"bits_equal_parent": bits}), flush=True)
    report["ms"], report["errors"] = {}, {}
    for kname, k in KERNELS.items():
        quad = "plane" if kname == "k2b" else "arc"
        for pname, (pq, geom, grps) in probs.items():
            if pq != quad:
                continue
            err = errors(libs, kname, geom, grps, quad, bool(args.parent))
            report["errors"][f"{kname}@{pname}"] = err
            print(f"{kname} at {pname}: " + ", ".join(
                f"{key} {val:.3e}" if isinstance(val, float) else
                f"{key} {val}" for key, val in err.items()), flush=True)
            runs = {"full": (libs[kname], k["entry"]),
                    "fp32": (libs[kname], k["fp32"]),
                    **{v: (libs[f"{kname}.{v}"], k["entry"])
                       for v in k["variants"]}}
            if args.parent:
                runs["parent"] = (libs[f"parent.{kname}"], k["entry"])
            order = list(runs)
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                lib, entry = runs[name]
                times[name].append(
                    cuda_ms(lambda: apply(lib, entry, geom, grps), 5))
            full = float(np.mean(times["full"]))
            rec = {"views": sum(sc.shape[0] for _, sc, _ in grps),
                   "ms": times, "full_ms": full,
                   "fp32_ms": float(np.mean(times["fp32"])),
                   "cost_ms": {v: full - float(np.mean(times[v]))
                               for v in k["variants"]}}
            report["ms"][f"{kname}@{pname}"] = rec
            print(f"{kname} at {pname} ({rec['views']} views): full "
                  f"{full:.3f} ms, fp32 {rec['fp32_ms']:.3f} ms; "
                  + ", ".join(f"{v} {np.mean(times[v]):.3f}"
                              for v in order[2:]), flush=True)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

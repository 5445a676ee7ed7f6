"""Where the plane kernels (K1, K2 and the bf16 tier's K1b, K2b), the bf16
arc kernels (K3b, K4b) spend their time, and whether the other kernels give
another build's bits. Builds ``slab_plane.cu`` and ``slab_arc.cu`` again
with one part of a kernel disabled at a time (text substitutions in the
source or a header it includes, each build its own nvcc runs, all started
together, through ``kernels/_build.compile_libraries`` into
``build/kernels/adj_split/``) and times each variant beside the full kernel
and the kernel of the other tier (a kernel's counterpart in the other
precision: K1 beside K1b, K2b beside K2), in turns:

- K1, K2, K1b and K2b at ``chip_smoke.py`` phase 3's problem (256³ Shepp
  phantom, 180 views over the full circle, ±0.02 rad tilts, ±4 px shifts)
  and at 32 of config 5's 1024 views at 512³ (phase 12b's views);
- K3b and K4b at phase 5's problem (256³, 90 views, ±0.5° tilts, ±2 px
  shifts).

K2 and K2b share one schedule (``adj_gather``), so a variant of its
phases disables the phase in both kernels of its build; each variant is
timed only for its own kernel. With ``--parent`` (another tree's root, or
the directory holding its ``slab_plane.cu`` and ``slab_arc.cu``) it also
builds that tree's sources (with that directory on the include path),
times its kernels beside this tree's, and
compares the bits of the fp32 kernels K1-K5 and of the kernels listed in
``SAME_BITS`` on phase 3's and phase 5's groups. A counting build
(``split_steps``, in the tool's own copy of ``slab_plane.cu`` only)
reports which share of K1's and K1b's (CTA, slab) steps runs from the
tables, the direct way or not at all, on each plane problem.

    python -m tomojax_torch.tools.adj_split [--size 256] [--parent PATH]
        [--kernels k1,k2,k1b,k2b,k3b,k4b] [--out split.json]

A variant with a part disabled gives wrong values; only its time means
something: the full kernel's time less a variant's is what that part costs
(parts overlap, so the costs need not add up). Times are CUDA-event means
of 5 applies after a warm-up, each build timed twice (the builds in
order, then in reverse); a bf16 kernel reads bf16 copies made beforehand,
and the cast that the wrappers make on each call is timed on its own. A
kernel's errors are against its plain version in its own tier. Each full
build is compiled with ``-Xptxas -v``; the report carries its registers
and spills and, from the CUDA runtime, each kernel's registers and CTAs
per SM at its shared memory. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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

# Each kernel: its source, its entry, the entry timed and compared beside
# it (the other tier's), the kernel (and the template instance, where it
# differs) and dynamic shared memory that the occupancy query names, and
# its variants: {name: [(text of the source or a header it includes,
# replacement)]}.
K1B_NO_PASS_A = ("    if (v_in) pass_a_at(ri + 1);",
                 "    if (v_in && ny < 0) pass_a_at(ri + 1);")
K1B_NO_PASS_B = ("    if (w.w >= 0) {\n      const unsigned tb = tabs_s",
                 "    if (w.w >= 0 && ri < 0) {\n"
                 "      const unsigned tb = tabs_s")
# every slab staged as a step without windows (its commit group empty)
K1B_NO_STAGING = ("win[s % kWin], nx, ny, nz, tid, copy_c,",
                  "make_int4(0, -1, 0, kEmpty), nx, ny, nz, tid, copy_c,")
K1B_CTAS = ("__global__ void __launch_bounds__(kFwdThreads, 3)\n"
            "fwd_bf16_kernel(",
            "__global__ void __launch_bounds__(kFwdThreads, {})\n"
            "fwd_bf16_kernel(")
K3B_NO_PASS_A = ("        if (v_in) {\n"
                 "          for (int xl = warp; xl < nq; xl += kFwdWarps) {\n"
                 "            const int x = qx0 + xl;\n",
                 "        if (v_in && ny < 0) {\n"
                 "          for (int xl = warp; xl < nq; xl += kFwdWarps) {\n"
                 "            const int x = qx0 + xl;\n")
K3B_NO_PASS_B = ("          if (!v_in || u >= nu) continue;\n"
                 "          const float jreal = jreal_of<true>(p, r, y0[k]);\n"
                 "          const float jb = ceil_small(jreal);",
                 "          if (!v_in || u >= nu || ny > 0) continue;\n"
                 "          const float jreal = jreal_of<true>(p, r, y0[k]);\n"
                 "          const float jb = ceil_small(jreal);")
K3B_NO_STAGING = ("    const short4 st_r2 = c_stage[(ri + 2) % kChunk];\n"
                  "    stage_slab(ring + slab_at(ri + 2), vol, ri + 2, st_r2, ny, nz, "
                  "vec, tid,\n               slot);",
                  "    const short4 st_r2 = c_stage[(ri + 2) % kChunk];\n"
                  "    if (ny < 0)\n"
                  "      stage_slab(ring + slab_at(ri + 2), vol, ri + 2, st_r2, "
                  "ny, nz,\n                 vec, tid, slot);")
# the phases of the gather schedule that K2 and K2b share (adj_gather)
ADJ_NO_PASS_B = ("      if (w.nvc > 0) {\n        // pass B of chunk k",
                 "      if (w.nvc > 0 && V < 0) {\n"
                 "        // pass B of chunk k")
ADJ_NO_PASS_A = ("      if (w.nvc > 0 && pa.uci() == w.nuc - 1) {",
                 "      if (w.nvc > 0 && pa.uci() == w.nuc - 1 &&"
                 " V < 0) {")
K2_UC40 = ("constexpr int kFUC = 64, kFVC = 72;",
           "constexpr int kFUC = 40, kFVC = 72;")
K2_BATCH16 = ("constexpr int kBBatch = 32; ", "constexpr int kBBatch = 16; ")
K2_CTAS = ("__global__ void __launch_bounds__(kAdjThreads, 3)\nadj_kernel(",
           "__global__ void __launch_bounds__(kAdjThreads, {})\nadj_kernel(")
K3B_ROWS = "\n            const unsigned short* row0 = ring16 + base0 + x * kSZ;"
K3B_GRID = ("            grid_at<true>(p, r, cx, cz, static_cast<float>(x), vt, "
            "&cf,\n                          &zaff);" + K3B_ROWS)
KERNELS = {
    "k1": {
        "source": PLANE, "entry": "slab_plane_fwd",
        "beside": "slab_plane_fwd_bf16", "kernel": "fwd_kernel",
        "instance": "fwd_kernel<true>", "smem": "kFwdSmem",
        "threads": "kFwdThreads",
        "variants": {
            "no_pass_a": [(
                "    const float zeta =\n"
                "        zeta_at(p, cx, cz, fx + static_cast<float>(i * "
                "kFwdWarps), fv);\n"
                "    const Floor f = floor_small(zeta);\n"
                "    const float* const row = q + i * kFwdWarps * kSZ + f.k;\n"
                "    t[i * kFwdWarps * kFV] = lerp_pair(row[0], row[1], "
                "zeta - f.f);",
                "    t[i * kFwdWarps * kFV] = 0.0f;")],
            "no_pass_b": [(
                "    if (w_b.w >= 0) {\n      const float* const tab",
                "    if (w_b.w >= 0 && ri < 0) {\n"
                "      const float* const tab")],
            "no_staging": [(
                "  if (w.w >= 0) {\n    const unsigned unx",
                "  if (w.w >= 0 && s < 0) {\n    const unsigned unx")],
        },
    },
    "k2": {
        "source": PLANE, "entry": "slab_plane_adj",
        "beside": "slab_plane_adj_bf16", "kernel": "adj_kernel",
        "smem": "kAdjSmem", "threads": "kAdjThreads",
        "variants": {
            "no_pass_b": [ADJ_NO_PASS_B],
            "no_pass_a": [ADJ_NO_PASS_A],
            "skeleton_only": [ADJ_NO_PASS_B, ADJ_NO_PASS_A],
            "no_staging": [(
                "  if (w.nvc > 0) {\n    const Extent c = extent<kFUC, kFVC>",
                "  if (w.nvc > 0 && nu < 0) {\n"
                "    const Extent c = extent<kFUC, kFVC>")],
            # pass A's voxels gather their candidates one by one where zav
            # = 1 too (the same bits)
            "no_unit": [("    if (w.zav == 1.0f && w.cv == 3) {",
                         "    if (w.zav == 1.0f && w.cv == 3 &&"
                         " c.nvw < 0) {")],
            # 40-column u chunks and 16-view record batches, launch bounds
            # of four CTAs an SM (64 registers)
            "ctas4": [K2_UC40, K2_BATCH16,
                      (K2_CTAS[0], K2_CTAS[1].format(4))],
            # launch bounds of two CTAs an SM (up to 128 registers)
            "ctas2": [(K2_CTAS[0], K2_CTAS[1].format(2))],
        },
    },
    "k1b": {
        "source": PLANE, "entry": "slab_plane_fwd_bf16",
        "beside": "slab_plane_fwd", "kernel": "fwd_bf16_kernel",
        "instance": "fwd_bf16_kernel<true>", "smem": "kFwdHSmem",
        "threads": "kFwdThreads",
        "variants": {
            "no_pass_a": [K1B_NO_PASS_A],
            "no_pass_b": [K1B_NO_PASS_B],
            "no_staging": [K1B_NO_STAGING],
            "skeleton_only": [K1B_NO_PASS_A, K1B_NO_PASS_B, K1B_NO_STAGING],
            # launch bounds of four CTAs per SM (64 registers)
            "ctas4": [(K1B_CTAS[0], K1B_CTAS[1].format(4))],
        },
    },
    "k2b": {
        "source": PLANE, "entry": "slab_plane_adj_bf16",
        "beside": "slab_plane_adj", "kernel": "adj_bf16_kernel",
        "smem": "kBSmem", "threads": "kAdjThreads",
        "variants": {
            "no_pass_b": [ADJ_NO_PASS_B],
            "no_pass_a": [ADJ_NO_PASS_A],
            "skeleton_only": [ADJ_NO_PASS_B, ADJ_NO_PASS_A],
            "ctas3": [(
                "__global__ void __launch_bounds__(kAdjThreads, 4)\n"
                "adj_bf16_kernel(",
                "__global__ void __launch_bounds__(kAdjThreads, 3)\n"
                "adj_bf16_kernel(")],
            "no_staging": [(
                "  if (w.nvc > 0) {\n    const Extent c = extent<kBUC, kBVC>",
                "  if (w.nvc > 0 && nu < 0) {\n"
                "    const Extent c = extent<kBUC, kBVC>")],
        },
    },
    "k3b": {
        "source": ARC, "entry": "slab_arc_fwd_bf16", "beside": "slab_arc_fwd",
        "kernel": "arc_fwd_bf16_kernel", "smem": "kArcHSmem",
        "threads": "kFwdThreads",
        "variants": {
            "no_pass_a": [K3B_NO_PASS_A],
            "no_pass_b": [K3B_NO_PASS_B],
            "no_staging": [K3B_NO_STAGING],
            "skeleton_only": [K3B_NO_PASS_A, K3B_NO_PASS_B, K3B_NO_STAGING],
            # pass A's grid (the march index's division and sawtooth) left
            # out: a position near the true one, for the time only
            "no_grid": [(K3B_GRID, "            cf = 0.0f;\n"
                         "            zaff = fmaf(p.gzx, static_cast<float>(x)"
                         " - cx, cz + vt.z);" + K3B_ROWS)],
            # the grid's ceil and pass A's floor as adds (the values of
            # ceilf and floorf here), three CTAs per SM
            "small_ops": [(K3B_GRID, """            {
              const float d = sub(sub(static_cast<float>(x), cx), vt.x);
              const float jr =
                  jreal_of<true>(p, r, y0_at(p, mul(d, p.inv_eux), vt));
              cf = sub(ceil_small(jr), jr);
              zaff = add(add(cz, mul(p.gzx, d)), vt.z);
            }""" + K3B_ROWS), (
                "              const float f = floorf(zeta);\n"
                "              const int k = static_cast<int>(f);\n"
                "              const float w = zeta - f;\n"
                "              if (b == 0 || !(live & 1u) || k != k_prev) {\n"
                "                const bool ia = static_cast<unsigned>(k) < unz;\n"
                "                const bool ic = static_cast<unsigned>(k) + 1u < "
                "unz;\n                a0 = side0 && ia ? widen_lo(",
                "              const float fs = __fadd_rd(zeta, 12582912.0f);\n"
                "              const float f = fs - 12582912.0f;\n"
                "              const int k = __float_as_int(fs) - 0x4B400000;\n"
                "              const float w = zeta - f;\n"
                "              if (b == 0 || !(live & 1u) || k != k_prev) {\n"
                "                const bool ia = static_cast<unsigned>(k) < unz;\n"
                "                const bool ic = static_cast<unsigned>(k) + 1u < "
                "unz;\n                a0 = side0 && ia ? widen_lo(")],
            "ctas3": [(
                "__global__ void __launch_bounds__(kFwdThreads, 4)\n"
                "arc_fwd_bf16_kernel(",
                "__global__ void __launch_bounds__(kFwdThreads, 3)\n"
                "arc_fwd_bf16_kernel(")],
        },
    },
    "k4b": {
        "source": ARC, "entry": "slab_arc_adj_bf16", "beside": "slab_arc_adj",
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
# The kernels whose bits the parent comparison holds: (entry, quad); the
# arc Jacobian writes 12 fields. SAME_BITS: the bf16 kernels that this
# tree leaves as the parent's.
SAME_BITS = (("slab_plane_adj_bf16", "plane"), ("slab_arc_adj_bf16", "arc"))
COMPARED = (("slab_plane_fwd", "plane"), ("slab_plane_adj", "plane"),
            ("slab_arc_fwd", "arc"), ("slab_arc_adj", "arc"),
            ("slab_arc_jac", "arc"), *SAME_BITS)
# The counting build: a device counter per (kernel, step kind) in the
# tool's copy of slab_plane.cu, bumped once per (CTA, slab) where pass B
# runs, and an entry that reads (and resets) them; kinds: from the tables,
# the direct way, nothing (no tap of the tile reaches the volume).
STEP_KINDS = ("fast", "direct", "empty")
COUNT_EDITS = [
    ("namespace {\n\nstruct Plane {",
     "__device__ unsigned long long split_steps[6];\n\nnamespace {\n\n"
     "struct Plane {"),
    ("    if (w_b.w >= 0) {\n      const float* const tab",
     "    if (tid == 0)\n"
     "      atomicAdd(&split_steps[w_b.w >= 0 ? 0 : w_b.w == kDirect ? 1 : 2],"
     " 1ull);\n"
     "    if (w_b.w >= 0) {\n      const float* const tab"),
    ("    const float xt = __fadd_rn(cx, xv);\n",
     "    const float xt = __fadd_rn(cx, xv);\n"
     "    if (tid == 0)\n"
     "      atomicAdd(&split_steps[w.w >= 0 ? 3 : w.w == kDirect ? 4 : 5],"
     " 1ull);\n")]
_COUNT_ENTRY = """
extern "C" int split_step_counts(unsigned long long* out) {
  unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, split_steps, sizeof(zero));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyToSymbol(split_steps, zero, sizeof(zero)));
}
"""
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


def _apply(edits, texts: dict[str, str], what: str) -> dict[str, str]:
    """``texts`` ({file name: text}) with each edit made in the one file
    that holds its text; raises unless the text occurs exactly once."""
    texts = dict(texts)
    for old, new in edits:
        where = [f for f, s in texts.items() if old in s]
        n = sum(s.count(old) for s in texts.values())
        if n != 1:
            raise ValueError(f"{what}: the text to replace occurs {n} times "
                             f"(in {', '.join(where) or 'no file'})")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def variant_source(kernel: str, name: str) -> dict[str, str]:
    """The kernel's source and the headers it includes, as ``{file name:
    text}``, with its variant ``name`` applied."""
    k = KERNELS[kernel]
    return _apply(k["variants"][name], _build.texts(k["source"]),
                  f"{kernel} {name}")


def count_source() -> dict[str, str]:
    """``slab_plane.cu`` and its headers with K1's and K1b's step counters
    and the entry ``split_step_counts`` that reads and resets them."""
    out = _apply(COUNT_EDITS, _build.texts(PLANE), "the counting build")
    out[PLANE.name] += _COUNT_ENTRY
    return out


def with_occupancy(names: dict, texts: dict[str, str]) -> dict[str, str]:
    """``texts`` with an entry appended to the kernel's source that reports
    the registers, local bytes, CTAs per SM and shared bytes per CTA of the
    kernel ``names`` gives (``source``, ``instance`` or ``kernel``,
    ``smem``, ``threads``)."""
    src = names["source"].name
    return {**texts, src: texts[src] + _OCCUPANCY.format(
        kernel=names.get("instance", names["kernel"]), smem=names["smem"],
        threads=names["threads"])}


def build(sources: dict[str, dict[str, str]], csrc: Path = _build.CSRC
          ) -> tuple[dict, dict]:
    """One shared library per ``{file name: text}``, all nvcc runs
    together, with ``-Xptxas -v`` and ``csrc`` on the include path →
    (libraries, ptxas lines per build)."""
    ptxas = _build.compile_libraries(sources, OUT_DIR, ("-Xptxas", "-v"),
                                     csrc)
    return ({name: _build.load_library(OUT_DIR / f"{name}.so")
             for name in sources}, ptxas)


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
    seeded random cotangent, as ``chip_smoke.slab_groups``, then the bf16
    copies of the volume and the cotangent that the bf16 entries read
    (made once here, so that a split times the kernels alone)."""
    gstruct, scalars = sp.scalar_groups(geom, views, quad, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    nu, nv = geom.det_shape
    out = []
    for (idx, sw, yf, _), sc in zip(gstruct, scalars):
        vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
        y = torch.randn((len(idx), nu, nv), generator=gen, device=device)
        out.append((vol_or, sc, y, vol_or.to(torch.bfloat16),
                    y.to(torch.bfloat16)))
    return out


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
    """One apply of ``entry`` over the groups (the bf16 entries read the
    groups' bf16 copies of their operand)."""
    adj = "_adj" in entry
    if entry.endswith("_bf16"):
        return [call(lib, entry, geom, y_b if adj else vol_b, sc)
                for _, sc, _, vol_b, y_b in grps]
    return [call(lib, entry, geom, y if adj else vol_or, sc)
            for vol_or, sc, y, _, _ in grps]


def cast(kname, grps):
    """The bf16 copies of the operand of ``kname`` over the groups, as the
    wrappers make them on each call (timed beside the kernels); none for
    an fp32 kernel."""
    adj = "_adj" in KERNELS[kname]["entry"]
    if not KERNELS[kname]["entry"].endswith("_bf16"):
        return []
    return [(y if adj else vol_or).to(torch.bfloat16)
            for vol_or, _, y, _, _ in grps]


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _view_rel(a, b):
    """The largest relative L2 over the views of (V, nu, nv) outputs."""
    return float((torch.linalg.norm(a - b, dim=(1, 2))
                  / torch.linalg.norm(b, dim=(1, 2))).max())


def quad_of(kname: str) -> str:
    return "plane" if KERNELS[kname]["source"] == PLANE else "arc"


def _identity(ax, y, vol_or, aty) -> float:
    """The adjoint identity's defect |<Ax, y> - <x, A^T y>| / (|Ax| |y|),
    in float64."""
    lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol_or.double().reshape(-1), aty.double().reshape(-1))
    return float(abs(lhs - rhs) / (torch.linalg.norm(ax.double())
                                   * torch.linalg.norm(y.double())))


def errors(libs, kname, geom, grps, parent) -> dict:
    """The full build's kernel against its plain version in its own tier (a
    forward's largest per-view relative L2, an adjoint's relative L2, the
    largest over the groups) and against the kernel beside it, whether two
    applies give the same bits, for the fp32 adjoint the adjoint identity
    with the build's fp32 forward, and with a parent build the parent's
    kernel against the plain version."""
    from tomojax_torch.kernels import slab as slabk
    k = KERNELS[kname]
    lib, quad = libs[kname], quad_of(kname)
    adj = "_adj" in k["entry"]
    prec = "bf16" if k["entry"].endswith("_bf16") else "f32x2"
    rel = _rel if adj else _view_rel
    out = {"vs_plain": [], "vs_beside": [], "repeat_equal": True}
    if adj and prec == "f32x2":
        out["identity"] = []
    if parent:
        out["parent_vs_plain"] = []
    for g in grps:
        vol_or, sc, y = g[:3]
        one = [g]
        a = apply(lib, k["entry"], geom, one)[0]
        out["repeat_equal"] &= torch.equal(
            a, apply(lib, k["entry"], geom, one)[0])
        if adj:
            ref = slabk.slab_backproject_plain(y, sc, geom, quad, prec=prec)
        else:
            ref = slabk.slab_project_plain(vol_or, sc, geom, quad, prec=prec)
        out["vs_plain"].append(rel(a, ref))
        out["vs_beside"].append(_rel(a, apply(lib, k["beside"], geom,
                                              one)[0]))
        if "identity" in out:
            fwd = "slab_plane_fwd" if quad == "plane" else "slab_arc_fwd"
            ax = call(lib, fwd, geom, vol_or, sc)
            out["identity"].append(_identity(ax, y, vol_or, a))
        if parent:
            b = apply(libs[f"parent.{kname}"], k["entry"], geom, one)[0]
            out["parent_vs_plain"].append(rel(b, ref))
        del ref
    return {key: max(val) if isinstance(val, list) else val
            for key, val in out.items()}


def step_counts(lib, geom, grps) -> dict:
    """The counting build's share of K1's and K1b's (CTA, slab) steps of
    each kind over one apply of each on the groups."""
    buf = (ctypes.c_ulonglong * 6)()
    lib.split_step_counts(buf)        # reset
    apply(lib, "slab_plane_fwd", geom, grps)
    apply(lib, "slab_plane_fwd_bf16", geom, grps)
    torch.cuda.synchronize()
    rc = lib.split_step_counts(buf)
    if rc != 0:
        raise RuntimeError(f"split_step_counts: CUDA error {rc}")
    out = {}
    for i, name in enumerate(("k1", "k1b")):
        n = [int(buf[3 * i + j]) for j in range(3)]
        out[name] = {"steps": sum(n), **{
            kind: c / max(sum(n), 1) for kind, c in zip(STEP_KINDS, n)}}
    return out


def parent_csrc(path: str) -> Path:
    """Another tree's ``csrc/`` (``path`` is its root or that directory)."""
    csrc = Path(path) / "tomojax_torch" / "kernels" / "csrc"
    return csrc if csrc.is_dir() else Path(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256,
                    help="the 256³ problems' size (config 5's is twice it)")
    ap.add_argument("--parent", default=None,
                    help="another tree (or its csrc/) to compare with")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels to build and time, comma-separated")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    names = [k for k in args.kernels.split(",") if k]
    if not names or not set(names) <= set(KERNELS):
        raise SystemExit(f"--kernels: choose among {sorted(KERNELS)}")
    if not torch.cuda.is_available():
        raise SystemExit("adj_split needs a CUDA device")
    dev = torch.device("cuda")
    sources = {}
    for kname in names:
        k = KERNELS[kname]
        sources[kname] = with_occupancy(k, _build.texts(k["source"]))
        for v in k["variants"]:
            sources[f"{kname}.{v}"] = variant_source(kname, v)
    counting = "k1b" in names
    if counting:
        sources["count"] = count_source()
    libs, ptxas = build(sources)
    if args.parent:
        par = parent_csrc(args.parent)
        plibs, pptxas = build({f"parent.{kname}": with_occupancy(
            KERNELS[kname], _build.texts(par / KERNELS[kname]["source"].name))
            for kname in names}, par)
        libs.update(plibs)
        ptxas.update(pptxas)
    full = [n for n in libs if n in KERNELS or n.startswith("parent.")]
    report = {"device": torch.cuda.get_device_name(0), "size": args.size,
              "ptxas": {name: ptxas_summary(ptxas[name]) for name in full},
              "occupancy": {name: occupancy(libs[name]) for name in full}}
    print(json.dumps({"ptxas": report["ptxas"],
                      "occupancy": report["occupancy"]}), flush=True)
    probs = problems(args.size, dev)
    if counting:
        report["steps"] = {
            pname: step_counts(libs["count"], geom, grps)
            for pname, (pq, geom, grps) in probs.items() if pq == "plane"}
        print(json.dumps({"steps": report["steps"]}), flush=True)
    if args.parent:
        bits = {}
        for entry, quad in COMPARED:
            lib = next((libs[n] for n in names if quad_of(n) == quad), None)
            if lib is None:
                continue
            plib = libs["parent." + next(n for n in names
                                         if quad_of(n) == quad)]
            _, geom, grps = probs[f"{quad}_{args.size}"]
            a, b = apply(lib, entry, geom, grps), apply(plib, entry, geom,
                                                        grps)
            bits[entry] = [torch.equal(x.view(torch.int32),
                                       y.view(torch.int32))
                           for x, y in zip(a, b)]
        report["bits_equal_parent"] = bits
        print(json.dumps({"bits_equal_parent": bits}), flush=True)
    report["ms"], report["errors"] = {}, {}
    for kname in names:
        k = KERNELS[kname]
        for pname, (pq, geom, grps) in probs.items():
            if pq != quad_of(kname):
                continue
            err = errors(libs, kname, geom, grps, bool(args.parent))
            report["errors"][f"{kname}@{pname}"] = err
            print(f"{kname} at {pname}: " + ", ".join(
                f"{key} {val:.3e}" if isinstance(val, float) else
                f"{key} {val}" for key, val in err.items()), flush=True)
            runs = {"full": (libs[kname], k["entry"]),
                    "beside": (libs[kname], k["beside"]),
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
            t_full = float(np.mean(times["full"]))
            rec = {"views": sum(g[1].shape[0] for g in grps),
                   "ms": times, "full_ms": t_full,
                   "beside_ms": float(np.mean(times["beside"])),
                   "cast_ms": cuda_ms(lambda: cast(kname, grps), 5),
                   "cost_ms": {v: t_full - float(np.mean(times[v]))
                               for v in k["variants"]}}
            report["ms"][f"{kname}@{pname}"] = rec
            print(f"{kname} at {pname} ({rec['views']} views): full "
                  f"{t_full:.3f} ms, {k['beside']} {rec['beside_ms']:.3f} "
                  f"ms, cast "
                  f"{rec['cast_ms']:.3f} ms; "
                  + ", ".join(f"{v} {np.mean(times[v]):.3f}"
                              for v in order[2:]), flush=True)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

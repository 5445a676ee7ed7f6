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
   |⟨K1 x, y⟩ − ⟨x, K2 y⟩| ≤ 1e-5·‖K1 x‖·‖y‖ (float64 dot products), two
   applies of K1 and of K2 bit-identical (no atomics), each one's time per
   180-view apply (CUDA events, after warm-up) and per orientation group,
   K1's beside its bound and the one-thread-per-ray design's 10.221 ms
   that the staged march replaced (NVIDIA H100 80GB HBM3 at 700 W).
4. Main path through the CLI (BASELINE config 3 on slab_plane):
   ``simulate`` 256³/180 views with ±4 px shifts, then ``reconstruct``
   with COM pre-alignment + 60 CGLS iterations, a second CGLS run on the
   dataset's true views and a third with the FFT cross-correlation chain
   (``--pre-align cc``). rel-L2 against the phantom must not rise from
   iteration 20 to 40 to 60 (the CC run: must fall from 20 to 60, and end
   at ≤ 0.30), the true-views run must end at ≤ 0.25, the CC residual's
   mean |tx| and |tz| must be ≤ 0.5 px, both kernels' launch counters must
   have risen in this phase and in the CC run.
5. The arc kernels K3/K4/K5 against their plain versions, fp32, at 256³ ×
   90 jittered views (full circle, ±0.5° tilts, ±2 px shifts) × 256²
   detector with at least four orientation groups: K3 per-view relative
   L2 ≤ 5e-4, K4 relative L2 ≤ 5e-4, arc adjoint identity ≤ 1e-5·‖K3 x‖·‖y‖
   (float64 dot products), each K5 field per-view relative L2 ≤ 2e-3,
   the single-field entry bit-equal to its K5 field, and two applies of
   each of K3, K4 and K5 bit-identical (no atomics); the march's division
   (K3/K5) bit-equal to __fdiv_rn on 2^24 numerators for every view's
   edy; times per 90-view apply, and K3's and K5's per orientation group
   beside their bound and the times of the one-thread-per-ray design that
   the march replaced (17.138 and 23.968 ms on an NVIDIA H100 80GB HBM3 at
   700 W).
6. Main path through the CLI (BASELINE config 4): ``simulate`` 256³/90
   views in arc quadrature with ±2 px / ±0.5° jitter, then ``align`` with
   COM pre-alignment, 6 outers of 30 CGLS iterations (arc) and 10 lm_slab
   iterations on (tx, tz, α, β), the moment hook every outer and Aitken
   every 4. Per outer it prints the volume rel-L2, the refinement cost and
   the gauge-corrected parameter errors; at outer 5 the rel-L2 must be
   below outer 0's and ≤ 0.21, the gauge-corrected max |tx|, |tz| errors
   ≤ 0.05 px, the α and β mean errors below their values at the start, and
   the K3, K4 and K5 launch counters must have risen in this phase. The
   single-field entry keeps a counter of its own; lm_slab takes the fused
   K5, so config 4 reports it as 0.
7. The resample kernels K7/K8 and the K9 entry against their plain
   versions, fp32, at 256³ × 90 jittered views over the full circle (both
   marching octants), on every call that one fast A of the Shepp phantom
   (K7, K9) and one fast Aᵀ of a random sinogram (K8) make, with the
   operands, view chunks and output layouts the path gives them. K7
   bit-equal to its plain version on every call (the plain version runs
   in slices of views, for memory), K9 bit-equal to K7, K8 per call
   relative L2 ≤ 1e-5 (the fused pass-1 calls, which sum their views and
   add them into the volume, checked adding into zeros against the plain
   vjp summed over the views), two fast Aᵀ
   bit-identical, the fast operator's adjoint identity ≤ 1e-5·‖Ax‖·‖y‖
   (float64 dot products); times per 90-view apply of each kernel, its
   plain version and the one PyTorch call that computes the same function
   (``grid_sample``'s bilinear kernel ``torch.grid_sampler_2d`` and its
   input gradient, plus ``.sum(0)`` for the fused calls, checked against
   the plain version first), summed over those calls; K8's time, bound
   and library time per pass (3, 2, 1); and the fast operator's A and
   Aᵀ. K8's bound counts the bytes each call moves: its inputs once and
   its output once (pass 1 reads and writes the volume once per chunk).
8. The fast family's joint alignment through the CLI:
   examples/joint_align_128.py's protocol at 256³ × 90 views (Shepp
   phantom projected with the port's fast family, ±2 px / ±1° jitter from
   ``default_rng(5)``), ``align`` with fast-family SIRT (40 iterations)
   and 10 ``gd_fast`` iterations on (tx, tz, α, β) from zero jitter, the
   moment hook every outer, 6 outers (the example runs 8; at this size
   those took 190 s on the H100). Per outer it prints the volume
   rel-L2, refinement cost and gauge-corrected errors; the last outer's
   rel-L2 must be below outer 0's, the gauge-corrected mean |tx| and |tz|
   at most half their start values, the α and β mean errors below their
   start values, and K7 and K8 must have launched in this phase (K9 not).

9. BASELINE config 2 (``tomojax_torch/tools/config2.py`` at its
   defaults): 128³, 180 views, slab_plane, SIRT 100 with positivity and
   FISTA-TV 60 (step by power iteration, β_tv 2, 20 prox iterations) on
   clean and 1%-noisy data: SIRT ≤ 0.235 and FISTA-TV ≤ 0.10 and below
   its SIRT, clean and noisy (the JAX record: 0.2214 / 0.2216 and
   0.0788 / 0.0795); then ``cli reconstruct`` with ``tikhonov``,
   ``lasso`` and ``fista_tv`` for 10 iterations on the clean data, each
   volume finite and its rel-L2 falling; K1 and K2 launched, then held
   against their plain versions at config 2's shapes with phase 3's
   tolerances, two applies of each bit-identical.
10. BASELINE config 1 and the exact ray family: ``cli simulate`` with the
   default family (ray) at 64³ × 90 views; ``tomojax_torch/tools/
   config1.py`` at its defaults (ray and slab, CGLS 50 each on its own
   data): each rel-L2 ≤ 0.25 (the JAX record: slab 0.185); K3 and K4
   launched, then held against their plain versions at config 1's shapes
   and jittered views with phase 5's tolerances, two applies of each
   bit-identical. The ray A on the card (fp32, kernel R1) against float64
   on the CPU (per-view relative L2 ≤ 1e-5; also the simulated dataset,
   ≤ 1e-6), its adjoint identity (≤ 1e-5), two Aᵀ (R2, a gather)
   bit-identical and the time per A and Aᵀ; R1 and R2 launched by
   ``cli simulate`` and config 1's ray CGLS, then alone: their time per
   apply beside their bound (11.268 µs at 64³ × 90) and the plain march's,
   and their distance from the march (≤ 1e-6; R2's against the march's
   samples summed in float64).

11. The exact-family alignment path at 64³ × 90 views. 11a: ``cli align``
   at its defaults (the ray family, SIRT 100, box LM on the exact
   Jacobian, the moment hook, 10 outers) on phase 10's ``cli simulate``
   dataset (shepp, seed 0, ±2 px / ±1°); per outer the volume rel-L2,
   refinement cost, gauge-corrected errors and the wall split into
   recon, LM and hook; the last outer's gauge-corrected mean |tx|, |tz|
   at most half the zero start's, the rel-L2 below outer 0's, every θ
   inside the refinement box; then the LM's time per step at its view
   chunk (Jacobian apply, cost apply, the LM's own 6×6 solves) and the
   ray Jacobian in fp32 against float64 on the CPU per (view, field) over
   30 views: each field's median over the views ≤ 1e-4 relative on the
   phantom; the medians on the reconstruction and the maxima printed
   beside those of fp32 on the CPU at the same θ and volume. 11b:
   ``tools/convergence_study`` on ray data (fast 8, exact 4, CV 2 with 10
   folds, debias 2 outers, final plane CGLS 120): each stage ends with
   gauge-corrected mean |tx|, |tz| at or below its start, the debias
   defect finite and nonzero, K1-K5 launched; then ``frozen_polish`` on
   its final state (slab 40 LM iterations, ray 10 with the moment match),
   each leaving the volume bit-equal. 11c: K1/K2 at 64³ × 90 views (the
   fast stage's final θ), K3/K4 at 64³ × 90 views (the exact stage's
   final θ) and at one CV complement (81 views), K5 at one CV fold (9
   views) against their plain versions with phase 3/5's tolerances, two
   applies bit-identical.

12. BASELINE config 5 at 512³ × 1024 views × 512² detector
   (``tomojax_torch/tools/config5.py``; the phantom made once on the
   host and timed). 12a: ``--prealign cc`` + 10 CGLS iterations on
   slab_plane, every timing of the record beside the card's name and
   power limit, K1/K2's launches; rel-L2 at iteration 10 ≤ 0.25 (the JAX
   record 0.2383), CGLS's conv falling at every iteration, the CC
   residual's gauge-corrected mean |tx| ≤ 0.35 px and |tz| ≤ 0.15 px (the
   record 0.278 / 0.103), K1 and K2 launched. 12b: K1/K2 at 512³ against
   their plain versions (one view per chunk at this size) on 32 of the
   views, covering every orientation group, with phase 3's tolerances
   and two applies bit-identical; their time per 1024-view apply beside
   ``utils/roofline``'s bound; then K1b/K2b, the kernels of 14b, on the
   same views with 14a's bars and readings (no rounding-flip reading) and
   their time per 1024-view apply beside K1/K2's. 12c: ``--mode mesh`` in a world of one over
   NCCL at 512³ × 16 views: the angle-sharded slab_plane operator
   bit-equal to the unsharded one, the volume-sharded slab operator
   (plane and arc, halo 32) within 1e-5 of it, forward and adjoint;
   the plane operator's distance at halos 8 and 32 on the white-noise
   volume and on the phantom printed (fp32 rounding or a frame offset).
   12d: the voxel family at 128³ × 90 views, fp32 on the card against
   float64 on the CPU: A per-view and Aᵀ relative L2 ≤ 1e-5, the adjoint
   identity ≤ 1e-5, the Jacobian's median per field over 10 views ≤ 1e-4
   against fp32 on the CPU at the same θ (against float64 printed, card
   and CPU: fp32's pixel-edge flips put both ~1e-3 off; ty, zero in this
   family, printed); two forwards' difference
   (float atomics) and the times printed; ``native`` (g++) forward and
   adjoint against the ray family's plain march in float64 on the card
   ≤ 1e-12 over 4 views. 12e: ``utils.profiling.trace`` around one CGLS
   iteration at 512³: the device busy share and the top kernels' shares
   of device time, K2's first; K1 and K2 must show device time.
13. tomojax's default slab calls at 256³ × 90 views over the full circle
   (phase 5's problem): ``slab_projector.project`` and ``backproject``
   with no ``quad`` must launch K3 and K4 once per orientation group and
   no other kernel (counts set to 0 just before, read just after), equal
   the explicit ``quad="arc"`` calls bit for bit and lie within phase 5's
   tolerances of the plain arc path; ``views_chunk=16`` leaves the
   forward bit-equal and the adjoint within 5e-4; the slab
   ``forward_view`` of one view per group (four) within 5e-4 of
   ``project``'s rows (bit-equal ones counted).

14. The bf16 bulk tier (``prec="bf16"``; tomojax's ``bf16=True`` variants
   of its Pallas slab kernels). 14a: K1b/K2b at phase 3's problem and
   K3b/K4b at phase 5's, launched alone first (each bf16 counter rises by
   the groups, no other), then each against its plain bf16 version (per
   view rel L2 ≤ 5e-4 forward, ≤ 5e-4 adjoint), against its fp32 kernel
   (rel L2 ≤ 3e-3 and ≥ 1e-6 in every group: tomojax's contract, and the
   rounding happened), K1b within 1e-5 and K3b within 2e-5 of their plain
   bf16 versions per view (their own designs round where the plain
   versions do), two applies bit-identical, the bf16 pair's mismatch
   (float64 dot products): tomojax's |⟨Ax, y⟩ − ⟨x, Aᵀy⟩|/max(|⟨Ax, y⟩|, 1)
   with its numerator and denominator pooled (root mean square) over 32
   standard-normal cotangents ≤ 5e-3, and the ratio on the non-negative
   |y| ≤ 5e-3; tomojax's single draw per group printed beside the plain
   bf16 pair's and the fp32 kernels' on the same y (one draw divides by a
   normal sum around 0: ``tools/bf16_gate.py``); the adjoint's rounding
   flips (``bf16_gate.rounding_flips``) beside K2/K4's fp32 distance from
   their plain versions, printed; times per apply beside the fp32
   kernels' and the bound, and each bf16 kernel's time (all four designs
   of their own) over its fp32 kernel's beside the ratio when it was the
   fp32 kernel instantiated on bf16 (12b prints K1b's and K2b's at 512³,
   K1b's within 1e-5 of plain there too). Then tomojax's gate
   problem
   (``tools/bf16_gate.py``: 8 views, its cotangent seed) at 64³ and 256³
   on the kernels: each group's forward within 3e-3 of fp32 and the pooled
   mismatch ≤ 5e-3; the single draws printed with their verdict. 14b (inside phase 12, on 12a's data and CC views in memory):
   12a's 10 CGLS iterations on the bf16 slab_plane operator, rel-L2 ≤ 0.25
   and within 2e-3 of 12a's, the residual norm falling at every iteration,
   no reinit quit, K1b/K2b launched and K1/K2 not; its CGLS wall over
   12a's printed. 14c: phase 6's dataset
   through ``cli align --recon-prec bf16`` with phase 6's settings cut to 3
   outers: outer 2's rel-L2 within 5e-3 of phase 6's, the gauge-corrected
   mean |tx|, |tz| errors below the COM start's, K3b, K4b and K5 launched.

The JSON line's launches count phases 4 and 12a for K1/K2 (all three CGLS
runs and ``simulate``, and config 5), phase 6 for K3-K6, phase 8 for
K7-K9, 14b for K1b/K2b and 14c for K3b/K4b (each entry of the bf16 tier
marked ``"tier": "bf16"`` and ``"design": "own"``); phases 9, 10, 11, 12c and 13 print their own. Bounds come from
``tomojax_torch/utils/roofline.py``, timers from
``tomojax_torch/utils/profiling.py``.

Every kernel's entry in the JSON line carries its time, its plain
version's, the time of one PyTorch call computing the same function where
there is one (``library_ms``, else null), and its bound: the larger of
the bytes it must move over 3.35 TB/s and the operations it must do over
67 TFLOP/s (the H100 SXM's published HBM and fp32 peaks).

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit, and before that the kernels' JSON.
"""

import ctypes
import dataclasses
import json
import os
import shutil
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import tomojax_torch.align as talign
from tomojax_torch import cli, native
from tomojax_torch.align import com_align
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.align import refine as trefine
from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import phantom
from tomojax_torch.core import projector as rproj
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core import voxel_projector as vox
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.kernels import _build
from tomojax_torch.kernels import ray as rayk
from tomojax_torch.kernels import resample as rs
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.tools import (bf16_gate, config1, config2, config5,
                                 convergence_study)
from tomojax_torch.tools._baseline import smi_line
from tomojax_torch.utils import io, profiling, roofline
from tomojax_torch.utils.profiling import cuda_ms, event_timed

N, N_PROJ, SEED = 256, 180, 0
N_ARC = 90                 # config 4: 90 views
TOL_FWD = TOL_ADJ = 5e-4
TOL_DOT = 1e-5
TOL_JAC = 2e-3
REL_L2_TRUE_MAX = 0.25
REL_L2_CC_MAX = 0.30       # config 3, CC-chain pre-alignment, CGLS 60
CC_RESID_MAX = 0.5         # px, mean |t - t_true| per axis after CC
C2_SIRT_MAX = 0.235        # config 2 (reference: 0.2214 / 0.2216)
C2_FISTA_MAX = 0.10        # config 2 (reference: 0.0788 / 0.0795)
C1_REL_L2_MAX = 0.25       # config 1, each family (reference: slab 0.185)
TOL_RAY = 1e-5             # ray family: per-view rel L2 vs float64, and
                           # the adjoint identity
TOL_RAY_KERNEL = 1e-6      # R1/R2 vs the plain march's samples
C4_REL_L2_MAX = 0.21       # config 4, outer 5 (reference: 0.193 plane,
                           # 0.180 arc)
C4_T_MAX = 0.05            # px, gauge-corrected max |tx|, |tz| error
N_FAST = 90                # the fast family's phases: 90 views
FAST_OUTERS = 6           # 8 (the example's) took 190 s on the H100
TOL_RESAMPLE = 1e-5
TOL_LIBRARY = 1e-3         # grid_sample rounds its normalized coordinates
PLAIN_VIEWS = 8            # views per slice of the resample plain versions
KERNEL_SOURCE = "tomojax_torch/kernels/csrc/slab_plane.cu"
ARC_SOURCE = "tomojax_torch/kernels/csrc/slab_arc.cu"
RESAMPLE_SOURCE = "tomojax_torch/kernels/csrc/resample.cu"
RAY_SOURCE = "tomojax_torch/kernels/csrc/ray.cu"
COUNTED = (slabk.slab_plane_fwd, slabk.slab_plane_adj, slabk.slab_arc_fwd,
           slabk.slab_arc_adj, slabk.slab_project_jac,
           slabk.slab_project_field, rs.resample_fwd, rs.resample_transpose,
           rs.resample_rows_raw, slabk.slab_plane_fwd_bf16,
           slabk.slab_plane_adj_bf16, slabk.slab_arc_fwd_bf16,
           slabk.slab_arc_adj_bf16, rayk.ray_fwd, rayk.ray_adj)
# phase 14: the bf16 tier's kernels and their fp32 counterparts per
# quadrature: (K1b/K3b, K2b/K4b, K1/K3, K2/K4)
BF16_KERNELS = {
    "plane": (slabk.slab_plane_fwd_bf16, slabk.slab_plane_adj_bf16,
              slabk.slab_plane_fwd, slabk.slab_plane_adj),
    "arc": (slabk.slab_arc_fwd_bf16, slabk.slab_arc_adj_bf16,
            slabk.slab_arc_fwd, slabk.slab_arc_adj)}
TOL_BF16 = 3e-3            # bf16 against fp32, per apply (tomojax's bar)
MIN_BF16 = 1e-6            # ... and moved off it: the rounding happened
TOL_MISMATCH = 5e-3        # |<Ax,y>-<x,Aᵀy>|/|<Ax,y>| of the bf16 pair
MISMATCH_DRAWS = 32        # standard-normal cotangents pooled for it
FLIP_VIEWS = 4             # views of 14a's rounding-flip reading
GATE_SIZES = (64, 256)     # tomojax's gate problem (tools/bf16_gate.py)
# each bf16 kernel's time over its fp32 kernel's in one call when it was
# the fp32 kernel instantiated on bf16 (NVIDIA H100 80GB HBM3, 700 W),
# printed beside the ratio of its own design: K2b/K2, K4b/K4 and K1b/K1,
# K3b/K3
FP32_ON_BF16_ADJ_RATIO = {"plane": 1.0166, "arc": 1.0008,
                          "plane_512": 1.0125}
FP32_ON_BF16_FWD_RATIO = {"plane": 1.0737, "arc": 1.0607,
                          "plane_512": 1.0015}
# the bf16 forwards' own designs against their plain bf16 versions, per
# view (K1b at phase 3's problem and 12b's views, K3b at phase 5's)
TOL_BF16_PLAIN = {"plane": 1e-5, "arc": 2e-5}
C5_BF16_DIFF = 2e-3        # 14b: bf16 rel-L2 within this of 12a's
C4_BF16_DIFF = 5e-3        # 14c: outer 2's rel-L2 within this of phase 6's
C4_BF16_OUTERS = 3
# K3's and K5's times per 90-view apply, and K1's per 180-view apply, in the
# one-thread-per-ray designs that the marches replaced (NVIDIA H100 80GB
# HBM3, 700 W)
EARLIER_MS = {"fwd": 17.138, "jac": 23.968, "plane_fwd": 10.221}
EXACT_N, EXACT_VIEWS = 64, 90   # phase 11: 64^3 x 90 views
EXACT_OUTERS = 10          # cli align's default outer_iters
TOL_RAY_JAC = 1e-4         # ray Jacobian, fp32 card vs float64 CPU
JAC_VIEWS = 30             # views of that check (the CPU's float64 march)
C5_N, C5_VIEWS, C5_NITER = 512, 1024, 10   # phase 12: BASELINE config 5
C5_REL_L2_MAX = 0.25       # at iteration 10 (JAX record 0.2383)
C5_TX_MAX, C5_TZ_MAX = 0.35, 0.15   # px, CC residual, gauge-corrected
#                            mean (JAX record 0.278 / 0.103)
C5_CHECK_VIEWS = 32        # views of 12b's checks against the plain path
MESH_VIEWS = config5.MESH_VIEWS
TOL_MESH = 1e-5            # volume-sharded vs unsharded, fwd and adjoint
VOX_N, VOX_VIEWS = 128, 90  # 12d: the voxel family
VOX_JAC_VIEWS = 10
TOL_VOX = 1e-5             # per-view rel L2 vs float64, adjoint identity
TOL_VOX_JAC = 1e-4         # median per field, card vs CPU fp32
NATIVE_VIEWS = 4
TOL_NATIVE = 1e-12         # native vs the ray family, float64
STUDY_ARGS = ["--outers-fast", "8", "--outers-exact", "4",
              "--outers-debias", "2", "--outers-cv", "2", "--cv-folds",
              "10", "--final-recon-iters", "120"]


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def groups_bound(geom, groups, quad, fields=1):
    """``roofline.slab_bound`` of one apply over the orientation groups
    ``(vol_or, scalars, y)`` of ``slab_groups``."""
    return roofline.slab_bound(
        geom, quad, n_views=sum(sc.shape[0] for _, sc, _ in groups),
        fields=fields, n_groups=len(groups))


def reset_counts():
    for fn in COUNTED:
        fn.launches = 0


def per_view_rel(ker, ref):
    return (torch.linalg.norm(ker - ref, dim=(-2, -1))
            / torch.linalg.norm(ref, dim=(-2, -1)))


def slab_groups(geom, views, vol, quad, dev):
    """Per orientation group of ``views``: the oriented volume, the group's
    scalars and a seeded random cotangent (V, nu, nv)."""
    gstruct, scalars = sp.scalar_groups(geom, views, quad, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nu, nv = geom.det_shape
    return [(sp.orient_volume(vol, geom, sw, yf).contiguous(), sc,
             torch.randn((len(idx), nu, nv), generator=gen, device=dev))
            for (idx, sw, yf, _), sc in zip(gstruct, scalars)]


def pair_errors(groups, geom, quad):
    """The slab forward kernel (K1 plane, K3 arc) and its transpose (K2,
    K4) against their plain versions on every group, after checking that
    two applies of each are bit-identical: max per-view rel L2 and max abs
    of the forward, max rel L2 and max abs of the transpose, and the max
    adjoint identity |<Kx,y>-<x,Kᵀy>|/(|Kx||y|) in float64."""
    fwd, adj = ((slabk.slab_plane_fwd, slabk.slab_plane_adj)
                if quad == "plane" else
                (slabk.slab_arc_fwd, slabk.slab_arc_adj))
    err = {k: [] for k in ("fwd_rel", "fwd_abs", "adj_rel", "adj_abs",
                           "dot")}
    for vol_or, sc, y in groups:
        ker = fwd(vol_or, sc, geom)
        check(torch.equal(ker, fwd(vol_or, sc, geom)),
              f"two {quad} forward applies differ")
        ref = slabk.slab_project_plain(vol_or, sc, geom, quad)
        err["fwd_rel"].append(float(per_view_rel(ker, ref).max()))
        err["fwd_abs"].append(float((ker - ref).abs().max()))
        del ref
        kadj = adj(y, sc, geom)
        check(torch.equal(kadj, adj(y, sc, geom)),
              f"two {quad} transpose applies differ")
        radj = slabk.slab_backproject_plain(y, sc, geom, quad)
        err["adj_rel"].append(float(torch.linalg.norm(kadj - radj)
                                    / torch.linalg.norm(radj)))
        err["adj_abs"].append(float((kadj - radj).abs().max()))
        lhs = torch.dot(ker.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1),
                        kadj.double().reshape(-1))
        err["dot"].append(float(abs(lhs - rhs) / (
            torch.linalg.norm(ker.double()) * torch.linalg.norm(y.double()))))
        del ker, kadj, radj
    return {k: max(v) for k, v in err.items()}


def check_pair(e, fwd_name, adj_name):
    check(e["fwd_rel"] <= TOL_FWD, f"{fwd_name} rel L2 {e['fwd_rel']}")
    check(e["adj_rel"] <= TOL_ADJ, f"{adj_name} rel L2 {e['adj_rel']}")
    check(e["dot"] <= TOL_DOT,
          f"{fwd_name}/{adj_name} adjoint identity {e['dot']}")


def plane_problem(dev):
    """Phase 3's problem: the 256³ Shepp phantom, 180 views over the full
    circle with ±0.02 rad tilts and ±4 px shifts → ``(geom, views, vol)``."""
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    views = Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-4, 4, (N_PROJ, 3)), device=dev)
    return geom, views, torch.as_tensor(phantom.shepp3d(N), device=dev)


def arc_problem(dev):
    """Phase 5's problem (config 4's shapes): 256³, 90 views over the
    full circle with ±0.5° tilts and ±2 px shifts → ``(geom, views,
    vol)``."""
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=N_ARC, vox_shape=(N,) * 3, det_shape=(N, N))
    amax = np.deg2rad(0.5)
    views = Views.create(
        N_ARC, phi=0.3 + np.linspace(0, 2 * np.pi, N_ARC, endpoint=False),
        alpha=rng.uniform(-amax, amax, N_ARC),
        beta=rng.uniform(-amax, amax, N_ARC),
        t=rng.uniform(-2, 2, (N_ARC, 3)), device=dev)
    return geom, views, torch.as_tensor(phantom.shepp3d(N), device=dev)


def phase_kernels(dev):
    """K1/K2 against their plain versions at the main path's shapes."""
    geom, views, vol = plane_problem(dev)
    groups = slab_groups(geom, views, vol, "plane", dev)
    check(len(groups) == 4, f"expected 4 orientation groups: {len(groups)}")
    e = pair_errors(groups, geom, "plane")
    print(f"K1 vs plain: max per-view rel L2 {e['fwd_rel']:.3e} "
          f"(tol {TOL_FWD}), max abs {e['fwd_abs']:.3e}")
    print(f"K2 vs plain vjp: max rel L2 {e['adj_rel']:.3e} (tol {TOL_ADJ}), "
          f"max abs {e['adj_abs']:.3e}; two applies of K1 and of K2 "
          "bit-identical")
    print(f"adjoint identity |<K1x,y>-<x,K2y>|/(|K1x||y|): max "
          f"{e['dot']:.3e} (tol {TOL_DOT})")

    def fwd(fn):
        return lambda: [fn(vo, sc, geom) for vo, sc, _ in groups]

    def adj(fn):
        return lambda: [fn(y, sc, geom) for _, sc, y in groups]

    t = {"fwd": cuda_ms(fwd(slabk.slab_plane_fwd), 5),
         "fwd_plain": cuda_ms(fwd(slabk.slab_project_plain), 2),
         "adj": cuda_ms(adj(slabk.slab_plane_adj), 5),
         "adj_plain": cuda_ms(adj(slabk.slab_backproject_plain), 2)}
    print(f"K1 {t['fwd']:.3f} ms vs plain {t['fwd_plain']:.3f} ms per "
          f"{N_PROJ}-view apply ({N}^3)")
    print(f"K2 {t['adj']:.3f} ms vs plain {t['adj_plain']:.3f} ms per "
          f"{N_PROJ}-view apply ({N}^3)")
    t["bound"] = groups_bound(geom, groups, "plane")
    for label, fn, arg in (("K1", slabk.slab_plane_fwd, 0),
                           ("K2", slabk.slab_plane_adj, 2)):
        per_group = [f"{cuda_ms(lambda: fn(g[arg], g[1], geom), 5):.3f} ms "
                     f"({g[1].shape[0]} views)" for g in groups]
        print(f"{label} per orientation group: {', '.join(per_group)}")
    print(f"K1 apply {t['fwd']:.3f} ms vs bound {t['bound'][0]:.3f} ms "
          f"({t['bound'][1]}) and the one-thread-per-ray "
          f"{EARLIER_MS['plane_fwd']:.3f} ms")

    op = make_operator(geom, views, family="slab_plane", device=dev)
    sino = op.A(vol)
    t_A = cuda_ms(lambda: op.A(vol), 5)
    t_AT = cuda_ms(lambda: op.AT(sino), 5)
    print(f"operator A {t_A:.3f} ms, AT {t_AT:.3f} ms per apply; "
          f"fwd+adjoint {N_PROJ / ((t_A + t_AT) / 1e3):.1f} proj/s "
          f"({N}^3, {N_PROJ} views, slab_plane)")

    check_pair(e, "K1", "K2")
    return {"fwd_abs": e["fwd_abs"], "adj_abs": e["adj_abs"], **t}


def phase_main_path(tmp):
    """BASELINE config 3 through the CLI: simulate, COM + CGLS, and CGLS
    on the true views."""
    # .npz, not .h5: the card's machine has no h5py (tomojax_torch.utils.io
    # writes the same arrays under the same names, picking by suffix)
    data = os.path.join(tmp, "config3.npz")
    common = ["--set", "solver.method=cgls", "--set",
              "solver.family=slab_plane", "--set", "solver.niter=60"]
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["simulate", "--size", str(N), "--views", str(N_PROJ),
              "--set", "simulate.family=slab_plane",
              "--set", "simulate.max_shift_px=4",
              "--set", "simulate.max_angle_deg=0", "-o", data])
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    runs, resid, run_launches = {}, {}, {}
    for name, extra in (("com", ["--pre-align", "com"]), ("true", []),
                        ("cc", ["--pre-align", "cc"])):
        out = os.path.join(tmp, f"recon_{name}.npy")
        before = (slabk.slab_plane_fwd.launches,
                  slabk.slab_plane_adj.launches)
        t0 = time.perf_counter()
        r = cli.main(["reconstruct", "-i", data, "-o", out, *common,
                      *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run_launches[name] = (slabk.slab_plane_fwd.launches - before[0],
                              slabk.slab_plane_adj.launches - before[1])
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
            resid[name] = (txm, txx), (tzm, tzx) = (
                r["pre_align_residual"]["tx"], r["pre_align_residual"]["tz"])
            line += (f"; {name.upper()} residual tx {txm:.4f}/{txx:.4f} "
                     f"tz {tzm:.4f}/{tzx:.4f} px (mean/max)")
        print(line)
        # with the CC chain's residual misalignment CGLS semi-converges: its
        # bar is a fall from 20 to 60 iterations
        check(rel[2] < rel[0] if name == "cc" else
              rel[0] >= rel[1] >= rel[2], f"{name}: rel-L2 rose {rel}")
    print(f"simulate wall {t_sim:.2f} s")
    launches = {"fwd": slabk.slab_plane_fwd.launches,
                "adj": slabk.slab_plane_adj.launches}
    print(f"main-path kernel launches: K1 {launches['fwd']}, "
          f"K2 {launches['adj']}")
    print(f"CC run kernel launches: K1 {run_launches['cc'][0]}, "
          f"K2 {run_launches['cc'][1]}")
    check(runs["true"][2] <= REL_L2_TRUE_MAX,
          f"true-views rel-L2 {runs['true'][2]} > {REL_L2_TRUE_MAX}")
    check(runs["cc"][2] <= REL_L2_CC_MAX,
          f"CC rel-L2 {runs['cc'][2]} > {REL_L2_CC_MAX}")
    (txm, _), (tzm, _) = resid["cc"]
    check(txm <= CC_RESID_MAX and tzm <= CC_RESID_MAX,
          f"CC mean residual tx {txm} tz {tzm} > {CC_RESID_MAX} px")
    check(min(run_launches["cc"]) > 0,
          f"the CC run did not launch K1 and K2: {run_launches['cc']}")
    check(launches["fwd"] > 0 and launches["adj"] > 0,
          f"main path did not launch both kernels: {launches}")
    return launches


def phase_arc_kernels(dev):
    """K3/K4/K5 (and the single-field entry) against their plain versions
    at config 4's shapes."""
    geom, views, vol = arc_problem(dev)
    groups = slab_groups(geom, views, vol, "arc", dev)
    check(len(groups) >= 4, f"expected >= 4 orientation groups: "
          f"{len(groups)}")
    e = pair_errors(groups, geom, "arc")
    err = {k: [] for k in ("jac_abs", "field_abs")}
    jac_rel = torch.zeros(slabk.NJP, dtype=torch.float64)
    t = {"jac_plain": 0.0}
    for vol_or, sc, y in groups:
        kj = slabk.slab_project_jac(vol_or, sc, geom)
        check(torch.equal(kj, slabk.slab_project_jac(vol_or, sc, geom)),
              "two K5 applies differ")
        rj, ms = event_timed(
            lambda: slabk.slab_project_jac_plain(vol_or, sc, geom))
        t["jac_plain"] += ms
        jac_rel = torch.maximum(jac_rel, per_view_rel(kj, rj).max(dim=0)
                                .values.double().cpu())
        err["jac_abs"].append(float((kj - rj).abs().max()))
        err["field_abs"].append(float((kj[:, 1] - rj[:, 1]).abs().max()))
        for i, (name, dv, jw, rw) in enumerate(sp.JAC_PASSES[1:], start=1):
            one = slabk.slab_project(vol_or, sc, geom, "arc", dv, jw, rw)
            check(torch.equal(one, kj[:, i]),
                  f"single-field entry {name} differs from its K5 field")
        del kj, rj
    fields = dict(zip(slabk.JAC_PASSES, (f"{v:.2e}" for v in jac_rel)))
    div_bad = march_division_mismatches(
        torch.cat([sc[:, sp.S_EDY] for _, sc, _ in groups]), dev)
    print(f"K3 vs plain: max per-view rel L2 {e['fwd_rel']:.3e} "
          f"(tol {TOL_FWD}), max abs {e['fwd_abs']:.3e}")
    print(f"K4 vs plain vjp: max rel L2 {e['adj_rel']:.3e} "
          f"(tol {TOL_ADJ}), max abs {e['adj_abs']:.3e}; two applies "
          "bit-identical")
    print(f"arc adjoint identity |<K3x,y>-<x,K4y>|/(|K3x||y|): max "
          f"{e['dot']:.3e} (tol {TOL_DOT})")
    print(f"K5 vs 12 plain passes: max per-view rel L2 per field {fields} "
          f"(tol {TOL_JAC}), max abs {max(err['jac_abs']):.3e}")
    print("single-field entry (K6): all 11 derivative fields bit-equal to "
          "their K5 fields; two applies of K3 and of K5 bit-identical")
    print(f"march division (K3/K5) vs __fdiv_rn: {div_bad} of "
          f"{N_ARC * DIV_NUMERATORS} quotients differ "
          f"({N_ARC} views' edy)")

    def fwd(fn, *a):
        return lambda: [fn(vo, sc, geom, *a) for vo, sc, _ in groups]

    def adj(fn, *a):
        return lambda: [fn(y, sc, geom, *a) for _, sc, y in groups]

    t.update({
        "fwd": cuda_ms(fwd(slabk.slab_arc_fwd), 5),
        "fwd_plain": cuda_ms(fwd(slabk.slab_project_plain, "arc"), 1),
        "adj": cuda_ms(adj(slabk.slab_arc_adj), 3),
        "adj_plain": cuda_ms(adj(slabk.slab_backproject_plain, "arc"), 1),
        "jac": cuda_ms(fwd(slabk.slab_project_jac), 3),
        "field": cuda_ms(fwd(slabk.slab_project, "arc", "x"), 3),
        "field_plain": cuda_ms(fwd(slabk.slab_project_plain, "arc", "x"), 1),
    })
    t["bound"] = groups_bound(geom, groups, "arc")
    t["bound_jac"] = groups_bound(geom, groups, "arc", fields=slabk.NJP)
    for k, label in (("fwd", "K3"), ("adj", "K4"), ("jac", "K5"),
                     ("field", "K6 entry (px)")):
        print(f"{label} {t[k]:.3f} ms vs plain {t[k + '_plain']:.3f} ms per "
              f"{N_ARC}-view apply ({N}^3)")
    for k, label, fn, bnd in (("fwd", "K3", slabk.slab_arc_fwd, t["bound"]),
                              ("jac", "K5", slabk.slab_project_jac,
                               t["bound_jac"])):
        per_group = [f"{cuda_ms(lambda: fn(vo, sc, geom), 5):.3f} ms "
                     f"({sc.shape[0]} views)" for vo, sc, _ in groups]
        print(f"{label} per orientation group: {', '.join(per_group)}; "
              f"apply {t[k]:.3f} ms vs bound {bnd[0]:.3f} ms ({bnd[1]}) and "
              f"the one-thread-per-ray {EARLIER_MS[k]:.3f} ms")
    check_pair(e, "K3", "K4")
    check(float(jac_rel.max()) <= TOL_JAC, f"K5 fields {fields}")
    check(div_bad == 0, f"march division differs on {div_bad} quotients")
    return {"fwd_abs": e["fwd_abs"], "adj_abs": e["adj_abs"],
            "jac_abs": max(err["jac_abs"]),
            "field_abs": max(err["field_abs"]), **t}


DIV_NUMERATORS = 1 << 24


def march_division_mismatches(edys, dev) -> int:
    """Quotients where K3/K5's division (the correctly rounded reciprocal
    and one fma correction) differs from __fdiv_rn: 2^24 numerators, random
    bit patterns of both signs with magnitudes in [2^-20, 2^13) (the march
    indices' range and well beyond), against each edy in ``edys``."""
    lib = _build.load()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bits = torch.randint(107 << 23, 140 << 23, (DIV_NUMERATORS,),
                         generator=gen, device=dev, dtype=torch.int32)
    sign = torch.randint(0, 2, (DIV_NUMERATORS,), generator=gen, device=dev,
                         dtype=torch.int32) << 31
    a = (bits | sign).view(torch.float32)
    q_rcp, q_div = torch.empty_like(a), torch.empty_like(a)
    bad = 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    for edy in edys.tolist():
        rc = lib.slab_arc_div_check(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(q_rcp.data_ptr()),
            ctypes.c_void_p(q_div.data_ptr()), DIV_NUMERATORS, edy,
            ctypes.c_void_p(stream))
        check(rc == 0, f"slab_arc_div_check: CUDA error {rc}")
        bad += int((q_rcp.view(torch.int32) != q_div.view(torch.int32)).sum())
    return bad


def gauge_fit(phi, tx_err, tz_err, a_err, b_err):
    """Least-squares fit of the 5 gauge parameters (global volume shift
    dx, dy, dz and tilt wx, wy) to per-view parameter errors; returns the
    corrected (tx, tz, alpha, beta) errors."""
    c, s = np.cos(phi), np.sin(phi)
    Atx = np.stack([c, s], 1)
    dxy, *_ = np.linalg.lstsq(Atx, tx_err, rcond=None)
    Aab = np.concatenate([np.stack([c, s], 1), np.stack([-s, c], 1)], 0)
    w, *_ = np.linalg.lstsq(Aab, np.concatenate([a_err, b_err]), rcond=None)
    return (tx_err - Atx @ dxy, tz_err - tz_err.mean(),
            a_err - np.stack([c, s], 1) @ w, b_err - np.stack([-s, c], 1) @ w)


def param_errors(theta, d):
    """Gauge-corrected (mean, max) |error| of tx, tz, alpha, beta for an
    (n_proj, 6) θ against the dataset's truth."""
    errs = gauge_fit(np.asarray(d["phi"], np.float64),
                     theta[:, 0] - d["xyz"][:, 0],
                     theta[:, 2] - d["xyz"][:, 2],
                     theta[:, 4] - d["alpha"], theta[:, 5] - d["beta"])
    return {k: (float(np.abs(e).mean()), float(np.abs(e).max()))
            for k, e in zip(("tx", "tz", "alpha", "beta"), errs)}


def fmt_errors(e):
    return " ".join(f"{k} {m:.4g}/{x:.4g}" for k, (m, x) in e.items())


def phase_config4(tmp, dev):
    """BASELINE config 4 through the CLI: arc simulate, then align with
    COM pre-alignment, arc CGLS and lm_slab."""
    data = os.path.join(tmp, "config4.npz")
    out = os.path.join(tmp, "align_c4.npy")
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["simulate", "--size", str(N), "--views", str(N_ARC),
              "--set", "simulate.family=slab",
              "--set", "simulate.max_shift_px=2",
              "--set", "simulate.max_angle_deg=0.5",
              "--set", "simulate.seed=0", "-o", data])
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = cli.main(["align", "-i", data, "-o", out,
                  "--set", "align.pre_align_cc=true",
                  "--set", "align.family=slab",
                  "--set", "align.refine_method=lm_slab",
                  "--set", "align.recon=cgls",
                  "--set", "align.recon_iters=30",
                  "--set", "align.refine_iters=10",
                  "--set", "align.param_set=xzab",
                  "--set", "align.moment_period=1",
                  "--set", "align.accel_period=4",
                  "--set", "align.outer_iters=6"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": slabk.slab_arc_fwd.launches,
                "adj": slabk.slab_arc_adj.launches,
                "jac": slabk.slab_project_jac.launches,
                "field": slabk.slab_project_field.launches}

    d = io.load_dataset(data)
    x = np.load(out)
    check(x.shape == (N, N, N) and np.isfinite(x).all(),
          f"config 4: volume shape {x.shape} or non-finite values")
    hist = r["state"].history
    thetas = r["theta_per_outer"]
    check(len(thetas) == 6 == len(hist["recon_rms"]),
          f"config 4: {len(thetas)} outers recorded")
    geom = Geometry(n_proj=N_ARC, vox_shape=(N,) * 3, det_shape=(N, N))
    est = com_align(torch.as_tensor(d["projections"], device=dev), geom,
                    d["phi"], device=dev).cpu().numpy()
    th0 = np.zeros((N_ARC, 6))
    th0[:, 0], th0[:, 2], th0[:, 3] = est[:, 0], est[:, 1], d["phi"]
    e0 = param_errors(th0, d)
    print(f"config 4 start (COM, zero tilts): gauge-corrected mean/max "
          f"{fmt_errors(e0)}")
    errs = []
    for k, th in enumerate(thetas):
        errs.append(param_errors(np.asarray(th, np.float64), d))
        print(f"config 4 outer {k}: vol rel-L2 {hist['recon_rms'][k]:.4f}, "
              f"refine cost {hist['refine_cost'][k]:.6g}, gauge-corrected "
              f"mean/max {fmt_errors(errs[-1])}")
    print(f"config 4 wall: simulate {t_sim:.2f} s, align {wall:.2f} s")
    print(f"config-4 kernel launches: K3 {launches['fwd']}, "
          f"K4 {launches['adj']}, K5 {launches['jac']}, single-field entry "
          f"{launches['field']} (off the main path: lm_slab takes K5)")
    rel0, rel5 = hist["recon_rms"][0], hist["recon_rms"][5]
    last = errs[-1]
    check(rel5 < rel0 and rel5 <= C4_REL_L2_MAX,
          f"config 4 vol rel-L2 outer 0 {rel0} -> outer 5 {rel5} "
          f"(bar {C4_REL_L2_MAX})")
    check(last["tx"][1] <= C4_T_MAX and last["tz"][1] <= C4_T_MAX,
          f"config 4 gauge-corrected max tx/tz {last['tx'][1]}/"
          f"{last['tz'][1]} > {C4_T_MAX} px")
    check(last["alpha"][0] < e0["alpha"][0]
          and last["beta"][0] < e0["beta"][0],
          f"config 4 alpha/beta mean errors did not fall: {last} vs {e0}")
    check(min(launches["fwd"], launches["adj"], launches["jac"]) > 0,
          f"config 4 did not launch K3, K4 and K5: {launches}")
    return launches, hist


def fast_problem(dev):
    """256³ × 90 jittered views over the full circle (both octants)."""
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=N_FAST, vox_shape=(N,) * 3, det_shape=(N, N))
    amax = np.deg2rad(1.0)
    views = Views.create(
        N_FAST, phi=0.3 + np.linspace(0, 2 * np.pi, N_FAST, endpoint=False),
        alpha=rng.uniform(-amax, amax, N_FAST),
        beta=rng.uniform(-amax, amax, N_FAST),
        t=rng.uniform(-2, 2, (N_FAST, 3)), device=dev)
    return geom, views


def unique_bytes(t):
    """Bytes a kernel must read of ``t``: its storage, once, when the
    tensor is a broadcast (stride 0) view of it."""
    return min(t.untyped_storage().nbytes(), t.numel() * t.element_size())


def rel_l2(a, b):
    return float(torch.linalg.norm((a - b).double())
                 / torch.linalg.norm(b.double()))


def grid_of(off, sl, m, n):
    """``grid_sample``'s grid (rows, 1, m, 2), align_corners=True, for the
    positions off + sl·i on rows of n values."""
    gx = rs._positions(off, sl, m).reshape(-1, 1, m) * (2.0 / (n - 1)) - 1.0
    return torch.stack([gx, torch.zeros_like(gx)], dim=-1)


def probed(name, probe, run):
    """``run()`` with ``rs.<name>`` replaced by ``probe(kernel, *args)``:
    every call the path makes is checked and timed on its own operands, at
    its own chunking. The path's launches through the probe count on the
    probe, not on the kernel's counter."""
    kernel = getattr(rs, name)

    def wrapper(*args, **kwargs):
        return probe(kernel, *args, **kwargs)

    wrapper.launches = 0
    setattr(rs, name, wrapper)
    try:
        with torch.no_grad():
            return run()
    finally:
        setattr(rs, name, kernel)


def sliced(fn, *args):
    """``fn(rows, offsets, slope, width)`` over slices of PLAIN_VIEWS views,
    concatenated: the plain versions' temporaries at a whole chunk of the
    path (25 views) would take most of the card."""
    x, off, sl, width = args
    return torch.cat([fn(x[v:v + PLAIN_VIEWS], off[v:v + PLAIN_VIEWS],
                         sl[v:v + PLAIN_VIEWS], width)
                      for v in range(0, x.shape[0], PLAIN_VIEWS)])


def phase_resample(dev):
    """K7/K8/K9 against their plain versions and the library call on every
    call of one fast A and one fast Aᵀ at 256³ × 90 views, with times and
    bounds at those calls; then the fast operator's adjoint identity and
    apply times."""
    geom, views = fast_problem(dev)
    E, _ = fastp.view_affine(geom, views.phi, views.alpha, views.beta,
                             views.t, views.cor)
    flags = fastp.marching_x(E)
    check(0 < flags.sum() < N_FAST, f"need both octants: {flags.sum()}")
    vol = torch.as_tensor(phantom.shepp3d(N), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((N_FAST, geom.n_det), generator=gen, device=dev)
    err = {k: [] for k in ("fwd", "fwd_abs", "fwd_equal", "adj", "adj_abs",
                           "lib_fwd", "lib_adj")}
    t = dict.fromkeys(("fwd", "fwd_plain", "fwd_lib", "raw", "adj",
                       "adj_plain", "adj_lib", "adj_p3", "adj_p2", "adj_p1",
                       "adj_lib_p3", "adj_lib_p2", "adj_lib_p1"), 0.0)
    work = {k: [0, 0] for k in ("fwd", "adj", "p3", "p2", "p1")}  # B, flops
    views_per_call = {"fwd": [], "adj": []}

    def fwd_probe(k7, arr, off, sl, m, out_order=None):
        ker = k7(arr, off, sl, m, out_order)
        ref = sliced(rs.resample_rows_plain, arr, off, sl, m)
        check(torch.equal(rs.resample_rows_raw(arr, off, sl, m), ker),
              "K9 differs from K7")
        err["fwd_equal"].append(torch.equal(ker, ref))
        err["fwd"].append(rel_l2(ker, ref))
        err["fwd_abs"].append(float((ker - ref).abs().max()))
        n = arr.shape[-1]
        inp = arr.reshape(-1, 1, 1, n)
        grid = grid_of(off, sl, m, n)

        def lib():
            # grid_sample's own kernel (bilinear, zeros, align_corners);
            # its cuDNN route refuses these shapes
            return torch.grid_sampler_2d(inp, grid, 0, 0, True)

        err["lib_fwd"].append(rel_l2(lib().reshape(ker.shape), ref))
        del ref
        work["fwd"][0] += (unique_bytes(arr) + 4 * off.numel()
                           + 4 * sl.numel() + 4 * ker.numel())
        work["fwd"][1] += 8 * ker.numel()
        views_per_call["fwd"].append(arr.shape[0])
        t["fwd"] += cuda_ms(lambda: k7(arr, off, sl, m, out_order), 3)
        t["raw"] += cuda_ms(lambda: rs.resample_rows_raw(arr, off, sl, m), 3)
        t["fwd_plain"] += cuda_ms(
            lambda: sliced(rs.resample_rows_plain, arr, off, sl, m), 1)
        t["fwd_lib"] += cuda_ms(lib, 3)
        return ker

    def adj_probe(k8, g, off, sl, n, out_order=None, *, add_into=None):
        # the chain runs passes 3, 2, 1 per chunk; pass 1 sums its views
        # and adds them into the volume, checked and timed here adding
        # into zeros in the volume's strides
        pas = 3 - len(views_per_call["adj"]) % 3
        summed = add_into is not None

        def run(dst=None):
            return k8(g, off, sl, n, out_order, add_into=dst)

        def plain():
            ref = sliced(rs.resample_rows_transpose_plain, g, off, sl, n)
            return ref.sum(0) if summed else ref

        scratch = torch.zeros_like(add_into) if summed else None
        ker = run(scratch)
        ref = plain()
        err["adj"].append(rel_l2(ker, ref))
        err["adj_abs"].append(float((ker - ref).abs().max()))
        m = g.shape[-1]
        gout = g.reshape(-1, 1, 1, m)
        grid = grid_of(off, sl, m, n)
        shape_in = torch.empty((gout.shape[0], 1, 1, n), device=dev)

        def lib():
            res = torch.ops.aten.grid_sampler_2d_backward(
                gout, shape_in, grid, 0, 0, True, [True, False])[0]
            res = res.reshape(*g.shape[:-1], n)
            return res.sum(0) if summed else res

        err["lib_adj"].append(rel_l2(lib(), ref))
        del ref, ker
        # each call's own bytes: its inputs once, and its output written
        # once (the view sum read and written once)
        nbytes = (unique_bytes(g) + 4 * off.numel() + 4 * sl.numel()
                  + (8 * add_into.numel() if summed
                     else 4 * g.shape[:-1].numel() * n))
        for k in ("adj", f"p{pas}"):
            work[k][0] += nbytes
            work[k][1] += 8 * g.numel()
        views_per_call["adj"].append(g.shape[0])
        ms = cuda_ms(lambda: run(scratch), 3)
        lib_ms = cuda_ms(lib, 3)
        t["adj"] += ms
        t[f"adj_p{pas}"] += ms
        t["adj_plain"] += cuda_ms(plain, 1)
        t["adj_lib"] += lib_ms
        t[f"adj_lib_p{pas}"] += lib_ms
        return run(add_into)   # the path's own call

    op = make_operator(geom, views, family="fast", device=dev)
    ax = probed("resample_fwd", fwd_probe, lambda: op.A(vol))
    aty = probed("resample_transpose", adj_probe, lambda: op.AT(y))
    for k, label in (("fwd", "K7 (A)"), ("adj", "K8 (AT)")):
        print(f"{label}: {len(views_per_call[k])} calls, views per call "
              f"{views_per_call[k]}")
    print(f"K7 vs plain: bit-equal on {sum(err['fwd_equal'])} of "
          f"{len(err['fwd_equal'])} calls, max per-call rel L2 "
          f"{max(err['fwd']):.3e}, max abs {max(err['fwd_abs']):.3e}; K9 "
          "bit-equal to K7 on every call")
    print(f"K8 vs plain vjp: max per-call rel L2 {max(err['adj']):.3e} (tol "
          f"{TOL_RESAMPLE}), max abs {max(err['adj_abs']):.3e}; the fused "
          f"pass-1 calls against the plain vjp summed over their views: "
          f"max rel L2 {max(err['adj'][2::3]):.3e}")
    print(f"grid_sample vs K7's plain version: max rel L2 "
          f"{max(err['lib_fwd']):.3e}; its input gradient vs K8's: "
          f"{max(err['lib_adj']):.3e} (tol {TOL_LIBRARY})")
    t["bound_fwd"] = roofline.bound(*work["fwd"])
    t["bound_adj"] = roofline.bound(*work["adj"])
    for k, label in (("fwd", "K7"), ("adj", "K8")):
        b_ms, b_by = t["bound_" + k]
        print(f"{label} {t[k]:.3f} ms vs plain {t[k + '_plain']:.3f} ms vs "
              f"library {t[k + '_lib']:.3f} ms per {N_FAST}-view apply "
              f"({N}^3, 3 passes); bound {b_ms:.3f} ms ({b_by}: "
              f"{work[k][0] / 1e9:.2f} GB, {work[k][1] / 1e9:.2f} GFLOP)")
    for pas, what in ((3, "a3 stored (V, nx, nv, nj)"),
                      (2, "a2 stored (V, nx, ny, nv)"),
                      (1, "views summed into the volume")):
        b_ms, b_by = roofline.bound(*work[f"p{pas}"])
        print(f"K8 pass {pas} ({what}): {t[f'adj_p{pas}']:.3f} ms vs "
              f"library {t[f'adj_lib_p{pas}']:.3f} ms; bound {b_ms:.3f} ms "
              f"({b_by}: {work[f'p{pas}'][0] / 1e9:.2f} GB)")
    print(f"K9 entry {t['raw']:.3f} ms per {N_FAST}-view apply")

    again = op.AT(y)
    check(torch.equal(again, aty) and torch.equal(again, op.AT(y)),
          "two fast ATs differ")
    print("fast AT: two applies bit-identical (and equal to the probed one)")
    del again
    lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol.double().reshape(-1), aty.double().reshape(-1))
    dot = float(abs(lhs - rhs) / (torch.linalg.norm(ax.double())
                                   * torch.linalg.norm(y.double())))
    del ax, aty
    t["A"] = cuda_ms(lambda: op.A(vol), 2)
    t["AT"] = cuda_ms(lambda: op.AT(y), 2)
    print(f"fast adjoint identity |<Ax,y>-<x,ATy>|/(|Ax||y|): {dot:.3e} (tol "
          f"{TOL_DOT})")
    print(f"fast operator A {t['A']:.3f} ms, AT {t['AT']:.3f} ms per apply; "
          f"fwd+adjoint {N_FAST / ((t['A'] + t['AT']) / 1e3):.1f} proj/s "
          f"({N}^3, {N_FAST} views, fast)")
    check(all(err["fwd_equal"]), f"K7 differs from its plain version: "
          f"rel L2 {err['fwd']}")
    check(max(err["adj"]) <= TOL_RESAMPLE, f"K8 rel L2 {max(err['adj'])}")
    check(max(err["lib_fwd"] + err["lib_adj"]) <= TOL_LIBRARY,
          f"grid_sample does not compute the resample: {err}")
    check(dot <= TOL_DOT, f"fast adjoint identity {dot}")
    return {"fwd_abs": max(err["fwd_abs"]), "adj_abs": max(err["adj_abs"]),
            **t}


def phase_fast_align(tmp, dev, n=N, n_proj=N_FAST, outers=FAST_OUTERS):
    """The fast family's joint alignment through the CLI with
    examples/joint_align_128.py's protocol (its data made with the port's
    fast project)."""
    data = os.path.join(tmp, "fast.npz")
    out = os.path.join(tmp, "align_fast.npy")
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(5)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-2, 2, n_proj)
    t[:, 2] = rng.uniform(-2, 2, n_proj)
    a = np.deg2rad(rng.uniform(-1, 1, n_proj))
    b = np.deg2rad(rng.uniform(-1, 1, n_proj))
    vol = phantom.shepp3d(n)
    true = Views.create(n_proj, alpha=a, beta=b, t=t, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        meas = fastp.project(torch.as_tensor(vol, device=dev), geom, true)
    phi = true.phi.cpu().numpy().astype(np.float64)
    io.save_dataset(data, projections=meas.reshape(n_proj, n, n).cpu()
                    .numpy(), phi=phi, alpha=a, beta=b, xyz=t, phantom=vol)
    t_sim = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    r = cli.main(["align", "-i", data, "-o", out, "--device", str(dev),
                  "--set", "align.family=fast",
                  "--set", "align.refine_method=gd_fast",
                  "--set", "align.recon=sirt",
                  "--set", "align.recon_iters=40",
                  "--set", "align.refine_iters=10",
                  "--set", "align.param_set=xzab",
                  "--set", f"align.outer_iters={outers}"])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": rs.resample_fwd.launches,
                "adj": rs.resample_transpose.launches,
                "raw": rs.resample_rows_raw.launches}
    d = io.load_dataset(data)
    x = np.load(out)
    check(x.shape == (n,) * 3 and np.isfinite(x).all(),
          f"fast align: volume shape {x.shape} or non-finite values")
    hist, thetas = r["state"].history, r["theta_per_outer"]
    check(len(thetas) == outers == len(hist["recon_rms"]),
          f"fast align: {len(thetas)} outers recorded")
    th0 = np.zeros((n_proj, 6))
    th0[:, 3] = d["phi"]
    e0 = param_errors(th0, d)
    print(f"fast align start (zero jitter): gauge-corrected mean/max "
          f"{fmt_errors(e0)}")
    errs = []
    for k, th in enumerate(thetas):
        errs.append(param_errors(np.asarray(th, np.float64), d))
        print(f"fast align outer {k}: vol rel-L2 {hist['recon_rms'][k]:.4f}, "
              f"refine cost {hist['refine_cost'][k]:.6g}, gauge-corrected "
              f"mean/max {fmt_errors(errs[-1])}")
    print(f"fast align wall: simulate {t_sim:.2f} s, align {wall:.2f} s "
          f"({n}^3, {n_proj} views, {outers} outers)")
    print(f"fast-align kernel launches: K7 {launches['fwd']}, K8 "
          f"{launches['adj']}, K9 entry {launches['raw']} (off the main "
          "path)")
    last = errs[-1]
    check(hist["recon_rms"][-1] < hist["recon_rms"][0],
          f"fast align vol rel-L2 did not fall: {hist['recon_rms']}")
    check(last["tx"][0] <= 0.5 * e0["tx"][0]
          and last["tz"][0] <= 0.5 * e0["tz"][0],
          f"fast align mean tx/tz errors not halved: {last} vs {e0}")
    check(last["alpha"][0] < e0["alpha"][0]
          and last["beta"][0] < e0["beta"][0],
          f"fast align alpha/beta mean errors did not fall: {last} vs {e0}")
    check(launches["fwd"] > 0 and launches["adj"] > 0
          and launches["raw"] == 0,
          f"fast align launches: {launches}")
    return launches, wall


def phase_config2(tmp, dev, n=128, n_proj=180):
    """BASELINE config 2 through ``tools/config2`` at its defaults, and the
    CLI's regularized solvers for 10 iterations on its clean data."""
    reset_counts()
    t0 = time.perf_counter()
    rec = config2.main(["--device", str(dev), "--size", str(n), "--views",
                        str(n_proj)])
    wall = time.perf_counter() - t0
    runs = rec["runs"]
    for name, r in runs.items():
        print(f"config 2 {name}: rel-L2 {r['rel_l2_vs_phantom']:.4f}, "
              f"{r['iters_run']} iterations, wall {r['wall_s']:.2f} s")
    print(f"config 2 wall: {wall:.2f} s (tools/config2, {n}^3, {n_proj} "
          "views)")
    for label in ("clean", "noisy"):
        sirt_rel = runs[f"sirt_{label}"]["rel_l2_vs_phantom"]
        fista_rel = runs[f"fista_tv_{label}"]["rel_l2_vs_phantom"]
        check(sirt_rel <= C2_SIRT_MAX,
              f"config 2 SIRT {label} rel-L2 {sirt_rel} > {C2_SIRT_MAX}")
        check(fista_rel <= C2_FISTA_MAX and fista_rel < sirt_rel,
              f"config 2 FISTA-TV {label} rel-L2 {fista_rel} (bar "
              f"{C2_FISTA_MAX}, SIRT {sirt_rel})")

    data = os.path.join(tmp, "config2.npz")
    cli.main(["simulate", "--size", str(n), "--views", str(n_proj),
              "--set", "simulate.family=slab_plane",
              "--set", "simulate.max_shift_px=0",
              "--set", "simulate.max_angle_deg=0", "-o", data,
              "--device", str(dev)])
    for method in ("tikhonov", "lasso", "fista_tv"):
        out = os.path.join(tmp, f"c2_{method}.npy")
        t0 = time.perf_counter()
        r = cli.main(["reconstruct", "-i", data, "-o", out,
                      "--set", "solver.family=slab_plane",
                      "--set", f"solver.method={method}",
                      "--set", "solver.niter=10", "--device", str(dev)])
        torch.cuda.synchronize()
        res, x = r["result"], np.load(out)
        k = int(res.n_iter)
        rms = [float(res.rms_error[0]), float(res.rms_error[k - 1])]
        print(f"config 2 cli {method}: {k} iterations, rel-L2 "
              f"{rms[0]:.4f} -> {rms[1]:.4f}, stop {res.stop_reason}, wall "
              f"{time.perf_counter() - t0:.2f} s")
        check(x.shape == (n,) * 3 and np.isfinite(x).all(),
              f"cli {method}: volume shape {x.shape} or non-finite values")
        check(k >= 2 and rms[1] < rms[0], f"cli {method}: rms {rms}")
    launches = (slabk.slab_plane_fwd.launches, slabk.slab_plane_adj.launches)
    # the kernels against their plain versions at config 2's own shapes,
    # after the counts are read
    geom, vol_np, views = config2.problem(n, n_proj)
    groups = slab_groups(geom, views, torch.as_tensor(vol_np, device=dev),
                         "plane", dev)
    e = pair_errors(groups, geom, "plane")
    print(f"config-2 kernel launches: K1 {launches[0]}, K2 {launches[1]}; "
          f"at its shapes ({n}^3, {n_proj} views, {len(groups)} orientation "
          f"groups) K1 vs plain max per-view rel L2 {e['fwd_rel']:.3e} (tol "
          f"{TOL_FWD}), K2 {e['adj_rel']:.3e} (tol {TOL_ADJ}), adjoint "
          f"identity {e['dot']:.3e} (tol {TOL_DOT}), two applies "
          "bit-identical")
    check(min(launches) > 0, f"config 2 did not launch K1 and K2: {launches}")
    check_pair(e, "K1", "K2")


def phase_config1(tmp, dev, n=64, n_proj=90):
    """BASELINE config 1 and the exact ray family: ``cli simulate`` with
    its default family, ``tools/config1`` at its defaults (ray and slab),
    and the ray A/Aᵀ at 64³ × 90 views against float64 on the CPU."""
    reset_counts()
    data = os.path.join(tmp, "config1.npz")
    t0 = time.perf_counter()
    cli.main(["simulate", "--size", str(n), "--views", str(n_proj), "-o",
              data, "--device", str(dev)])
    torch.cuda.synchronize()
    print(f"config 1 cli simulate (default family: ray, {n}^3, {n_proj} "
          f"views): {time.perf_counter() - t0:.2f} s")
    rec = config1.main(["--device", str(dev), "--size", str(n), "--views",
                        str(n_proj)])
    for fam, r in rec["families"].items():
        print(f"config 1 {fam}: gen {r['gen_s']:.3f} s, CGLS "
              f"{r['cgls_iters_run']} iterations {r['cgls_s']:.2f} s, "
              f"rel-L2 {r['recon_rel_l2_vs_phantom']:.4f}, final rms "
              f"{r['final_rms']:.5f}")
        check(r["recon_rel_l2_vs_phantom"] <= C1_REL_L2_MAX,
              f"config 1 {fam} rel-L2 {r['recon_rel_l2_vs_phantom']} > "
              f"{C1_REL_L2_MAX}")
    launches = (slabk.slab_arc_fwd.launches, slabk.slab_arc_adj.launches)
    ray_launches = {"fwd": rayk.ray_fwd.launches,
                    "adj": rayk.ray_adj.launches}
    print(f"config 1 ray kernel launches (cli simulate, config1's ray CGLS):"
          f" R1 {ray_launches['fwd']}, R2 {ray_launches['adj']}")
    check(min(ray_launches.values()) > 0,
          f"config 1 did not launch R1 and R2: {ray_launches}")
    # the kernels against their plain versions at config 1's own shapes
    # (its jittered views), after the counts are read
    geom, vol_np, views = config1.problem(n, n_proj)
    groups = slab_groups(geom, views, torch.as_tensor(vol_np, device=dev),
                         "arc", dev)
    e = pair_errors(groups, geom, "arc")
    print(f"config-1 kernel launches: K3 {launches[0]}, K4 {launches[1]}; "
          f"at its shapes ({n}^3, {n_proj} views, {len(groups)} orientation "
          f"groups) K3 vs plain max per-view rel L2 {e['fwd_rel']:.3e} (tol "
          f"{TOL_FWD}), K4 {e['adj_rel']:.3e} (tol {TOL_ADJ}), adjoint "
          f"identity {e['dot']:.3e} (tol {TOL_DOT}), two applies "
          "bit-identical")
    check(min(launches) > 0, f"config 1 did not launch K3 and K4: {launches}")
    check_pair(e, "K3", "K4")

    d = io.load_dataset(data)
    n_proj, nu, nv = d["projections"].shape
    geom = Geometry(n_proj=n_proj, vox_shape=d["phantom"].shape,
                    det_shape=(nu, nv))
    views = io.views_from_dataset(d)
    op = make_operator(geom, views, device=dev)
    vol = torch.as_tensor(d["phantom"], device=dev)
    sino = op.A(vol)
    stored = torch.as_tensor(d["projections"]).reshape(n_proj, -1)
    check(op.family == "ray" and float(torch.linalg.norm(sino.cpu() - stored)
                                       / torch.linalg.norm(stored)) <= 1e-6,
          "cli simulate's projections differ from the ray operator's A")
    t0 = time.perf_counter()
    ref = make_operator(geom, views, dtype=torch.float64, device="cpu").A(
        torch.as_tensor(d["phantom"], dtype=torch.float64))
    cpu_s = time.perf_counter() - t0
    rel = float(per_view_rel(sino.cpu().double().reshape(n_proj, nu, nv),
                             ref.reshape(n_proj, nu, nv)).max())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((n_proj, nu * nv), generator=gen, device=dev)
    aty = op.AT(y)
    repeat = torch.equal(op.AT(y), aty)
    lhs = torch.dot(sino.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol.double().reshape(-1), aty.double().reshape(-1))
    dot = float(abs(lhs - rhs) / (torch.linalg.norm(sino.double())
                                  * torch.linalg.norm(y.double())))
    t_A = cuda_ms(lambda: op.A(vol), 3)
    t_AT = cuda_ms(lambda: op.AT(y), 3)
    print(f"ray A (fp32, card) vs float64 CPU: max per-view rel L2 "
          f"{rel:.3e} (tol {TOL_RAY}; CPU A {cpu_s:.2f} s)")
    print(f"ray adjoint identity |<Ax,y>-<x,ATy>|/(|Ax||y|): {dot:.3e} "
          f"(tol {TOL_RAY}); two card AT applies bit-identical: {repeat}")
    print(f"ray A {t_A:.3f} ms, AT {t_AT:.3f} ms per apply ({n}^3, "
          f"{n_proj} views)")
    check(rel <= TOL_RAY, f"ray A vs float64: {rel}")
    check(dot <= TOL_RAY, f"ray adjoint identity {dot}")
    check(repeat, "two ray AT applies differ (R2 is a gather)")
    return {"A": t_A, "AT": t_AT, "launches": ray_launches,
            **ray_kernels(geom, views, vol, y, dev)}


def ray_kernels(geom, views, vol, y, dev):
    """R1 and R2 alone (the setup made beforehand; R2's map included) at
    ``geom``'s shapes beside their bound and the plain march, and their
    largest differences from it (R2's against the march's samples summed
    in float64)."""
    args = [getattr(views, f).to(dev) for f in ("phi", "alpha", "beta",
                                                 "t", "cor")]
    setup = rproj._ray_setup(geom, *args, torch.float32, False)
    vol = vol.float().contiguous()
    out = torch.zeros(geom.n_vox, device=dev)
    before = (rayk.ray_fwd.launches, rayk.ray_adj.launches)
    fwd = rayk.ray_fwd(vol, setup.p0, setup.d_hat, geom)
    adj = rayk.ray_adj(y, setup.p0, setup.d_hat, *args[:3], geom,
                       out.clone())
    check((rayk.ray_fwd.launches, rayk.ray_adj.launches)
          == (before[0] + 1, before[1] + 1), "R1/R2 launch counters")
    ref = rproj._march_forward(vol, setup, geom, torch.float32)
    ref_t = rproj._march_adjoint(y.double(), setup, geom, torch.float32,
                                 torch.zeros(geom.n_vox, dtype=torch.float64,
                                             device=dev))
    shape = (geom.n_proj, *geom.det_shape)
    fwd_rel = float(per_view_rel(fwd.double().reshape(shape),
                                 ref.double().reshape(shape)).max())
    adj_rel = float(torch.linalg.norm(adj.double() - ref_t)
                    / torch.linalg.norm(ref_t))
    ms = {"fwd": cuda_ms(lambda: rayk.ray_fwd(vol, setup.p0, setup.d_hat,
                                              geom), 20),
          "adj": cuda_ms(lambda: rayk.ray_adj(y, setup.p0, setup.d_hat,
                                              *args[:3], geom, out), 20),
          "fwd_plain": cuda_ms(lambda: rproj._march_forward(
              vol, setup, geom, torch.float32), 3),
          "adj_plain": cuda_ms(lambda: rproj._march_adjoint(
              y, setup, geom, torch.float32, out), 3)}
    nbytes = 4.0 * (geom.n_vox + geom.n_proj * geom.n_det) + 24.0 * geom.n_proj
    flops = 2.0 * 8 * geom.n_proj * geom.n_det * geom.n_steps
    bnd = roofline.bound(nbytes, flops)
    print(f"R1 ray_fwd {ms['fwd']:.4f} ms, R2 ray_adj {ms['adj']:.4f} ms per "
          f"apply ({geom.vox_shape[0]}^3, {geom.n_proj} views) against the "
          f"bound {bnd[0] * 1e3:.3f} us ({bnd[1]}) and the plain march's "
          f"{ms['fwd_plain']:.3f} / {ms['adj_plain']:.3f} ms; vs the march: "
          f"R1 max per-view rel L2 {fwd_rel:.3e}, R2 rel L2 {adj_rel:.3e} "
          f"(tol {TOL_RAY_KERNEL})")
    check(fwd_rel <= TOL_RAY_KERNEL and adj_rel <= TOL_RAY_KERNEL,
          f"R1/R2 vs the plain march: {fwd_rel}, {adj_rel}")
    return {"kernels": {**ms, "bound": bnd, "fwd_abs": float(
        (fwd - ref).abs().max()), "adj_abs": float(
        (adj.double() - ref_t).abs().max())}}


def synced(fn, acc, key):
    """``fn`` that adds its device-synchronized wall seconds to
    ``acc[key]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out
    return wrapper


def phase_exact_align(tmp, dev, ray_ms, n=EXACT_N, n_proj=EXACT_VIEWS,
                      outers=EXACT_OUTERS):
    """11a: ``cli align`` at its defaults (ray family, SIRT 100, box LM on
    the exact Jacobian, the moment hook) on phase 10's ``cli simulate``
    dataset, per outer its quality and its wall split; then the LM's time
    per step, split, at the path's view chunk, and the ray Jacobian on the
    card against float64 on the CPU."""
    data = os.path.join(tmp, "config1.npz")
    if not os.path.exists(data):
        cli.main(["simulate", "--size", str(n), "--views", str(n_proj),
                  "-o", data, "--device", str(dev)])
    out = os.path.join(tmp, "align_exact.npy")
    d = io.load_dataset(data)
    split = {"recon": 0.0, "refine": 0.0, "hook": 0.0}
    rows = []
    t_last = [0.0]
    orig = talign.align_reconstruct

    def record(it, views, volume, history):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({"wall": now - t_last[0], **split})
        t_last[0] = now
        for k in split:
            split[k] = 0.0

    def align_with_split(*args, callback=None, **kwargs):
        def both(*a):
            callback(*a)
            record(*a)
        return orig(*args, callback=both, **kwargs)

    patches = [(talign, "align_reconstruct", align_with_split),
               (tpipe, "sirt", synced(tpipe.sirt, split, "recon")),
               (tpipe, "refine_views",
                synced(tpipe.refine_views, split, "refine")),
               (tpipe, "_family_synth",
                synced(tpipe._family_synth, split, "hook")),
               (tpipe, "moment_match",
                synced(tpipe.moment_match, split, "hook"))]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    reset_counts()
    for m, k, f in patches:
        setattr(m, k, f)
    try:
        torch.cuda.synchronize()
        t0 = t_last[0] = time.perf_counter()
        r = cli.main(["align", "-i", data, "-o", out, "--device", str(dev),
                      "--set", f"align.outer_iters={outers}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for m, k, f in saved:
            setattr(m, k, f)
    launched = {fn.__name__: fn.launches for fn in COUNTED if fn.launches}
    x = np.load(out)
    check(x.shape == (n,) * 3 and np.isfinite(x).all(),
          f"exact align: volume shape {x.shape} or non-finite values")
    hist, thetas = r["state"].history, r["theta_per_outer"]
    check(len(thetas) == outers == len(hist["recon_rms"]) == len(rows),
          f"exact align: {len(thetas)} outers recorded")
    th0 = np.zeros((n_proj, 6))
    th0[:, 3] = d["phi"]
    e0 = param_errors(th0, d)
    print(f"exact align start (zero jitter): gauge-corrected mean/max "
          f"{fmt_errors(e0)}")
    errs = []
    for k, (th, row) in enumerate(zip(thetas, rows)):
        other = row["wall"] - row["recon"] - row["refine"] - row["hook"]
        errs.append(param_errors(np.asarray(th, np.float64), d))
        print(f"exact align outer {k}: vol rel-L2 {hist['recon_rms'][k]:.4f},"
              f" refine cost {hist['refine_cost'][k]:.6g}, gauge-corrected "
              f"mean/max {fmt_errors(errs[-1])}; wall {row['wall']:.2f} s = "
              f"recon {row['recon']:.2f} + LM {row['refine']:.2f} + hook "
              f"{row['hook']:.3f} + other {other:.3f}")
    tot = {k: sum(row[k] for row in rows) for k in ("recon", "refine",
                                                    "hook")}
    print(f"exact align wall: {wall:.2f} s ({n}^3, {n_proj} views, {outers} "
          f"outers, ray + lm): recon {tot['recon']:.2f} s, LM "
          f"{tot['refine']:.2f} s, hook {tot['hook']:.3f} s; kernel "
          f"launches {launched or 0} (R1/R2 only: the ray Jacobian is "
          "plain PyTorch)")

    # the LM's time per step at the path's chunk (2^23 // n_vox views)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    ch = max(1, min(n_proj, (1 << 23) // geom.n_vox))
    vol = torch.as_tensor(x, device=dev)
    th = torch.as_tensor(np.asarray(thetas[-1]), device=dev)[:ch]
    cor = torch.zeros((ch, 3), device=dev)
    meas = torch.as_tensor(d["projections"], device=dev).reshape(
        n_proj, -1)[:ch]
    mask_f = trefine._mask(trefine.PARAM_SETS["xzab"], device=dev)
    lam = torch.full((ch,), 1e-3, device=dev)   # lm_lambda0
    with torch.no_grad():
        _, _, res, jac = trefine.alignment_costs_grad(vol, meas, geom, th,
                                                      cor)
        step = {"jacobian": cuda_ms(lambda: trefine.alignment_costs_grad(
                    vol, meas, geom, th, cor), 3),
                "cost": cuda_ms(lambda: trefine.alignment_costs(
                    vol, meas, geom, th, cor), 3),
                "solve": cuda_ms(lambda: trefine._lm_step(
                    jac, res, lam, mask_f), 5)}
    per_view = {k: v / ch for k, v in step.items()}
    print(f"LM step at {ch} views ({n}^3): Jacobian apply "
          f"{step['jacobian']:.3f} ms, cost apply {step['cost']:.3f} ms, "
          f"6x6 normal equations and solves {step['solve']:.3f} ms; per view "
          f"{per_view['jacobian']:.3f} / {per_view['cost']:.3f} / "
          f"{per_view['solve']:.4f} ms against the ray A "
          f"{ray_ms['A'] / n_proj:.3f} and AT {ray_ms['AT'] / n_proj:.3f} ms "
          "per view (phase 10)")

    ray_jacobian_check(geom, d["phantom"], x, np.asarray(thetas[-1]), dev)

    last = errs[-1]
    check(last["tx"][0] <= 0.5 * e0["tx"][0]
          and last["tz"][0] <= 0.5 * e0["tz"][0],
          f"exact align mean tx/tz errors not halved: {last} vs {e0}")
    check(hist["recon_rms"][-1] < hist["recon_rms"][0],
          f"exact align vol rel-L2 did not fall: {hist['recon_rms']}")
    box = np.array([3.0, 0.0, 3.0, 0.0, 0.02, 0.02]) + 1e-6
    for th in thetas:
        check(np.all(np.abs(np.asarray(th, np.float64) - th0) <= box),
              "exact align: theta left the refinement box")
    return {"wall": wall, **tot, "step": step}


def ray_jacobian_check(geom, phantom_np, recon_np, theta, dev):
    """The ray Jacobian in fp32 on the card, and in fp32 on the CPU,
    against float64 on the CPU at ``theta``, over ``JAC_VIEWS`` views
    spread over the scan: the relative L2 error of each (view, field), on
    the phantom and on the reconstructed volume. On the phantom each
    field's median over the views on the card must be ≤ ``TOL_RAY_JAC``,
    so one field wrong in most views fails; on the reconstruction (noisy,
    so more samples sit near a cell boundary where neighbours differ) the
    medians are printed, not bounded. The maxima are printed beside the
    CPU fp32 run's, not bounded: the trilinear weights' gradient jumps at
    cell boundaries wherever neighbouring voxels differ, so a sample
    within fp32 rounding of a boundary takes the other cell's slope, and
    one such sample on an edge of the phantom moves its view's field by
    up to ~1e-1 (ty, whose sum along the ray nearly cancels, most)."""
    n_proj = geom.n_proj
    idx = np.arange(0, n_proj, max(1, n_proj // JAC_VIEWS))[:JAC_VIEWS]
    th = torch.as_tensor(np.asarray(theta, np.float64))[idx]
    args = (th[:, 3], th[:, 4], th[:, 5], th[:, :3], torch.zeros(len(idx), 3))
    names = ("tx", "ty", "tz", "phi", "alpha", "beta")

    def fields(v):
        return ", ".join(f"{k} {x:.3e}" for k, x in zip(names, v.tolist()))

    for label, vol_np in (("phantom", phantom_np), ("recon", recon_np)):
        _, jr = rproj.forward_views_jac(
            torch.as_tensor(vol_np, dtype=torch.float64), geom, *args,
            dtype=torch.float64)
        err = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            vol = torch.as_tensor(vol_np, dtype=torch.float32, device=d)
            _, j32 = rproj.forward_views_jac(vol, geom, *(a.float().to(d)
                                                          for a in args))
            err[where] = (torch.linalg.norm(j32.cpu().double() - jr, dim=2)
                          / torch.linalg.norm(jr, dim=2))   # (views, fields)
        med = err["card"].median(0).values
        print(f"ray Jacobian (fp32) vs float64 CPU on the {label} over "
              f"{len(idx)} views, relative L2 per (view, field): card median "
              f"per field {fields(med)}"
              + (f" (tol {TOL_RAY_JAC})" if label == "phantom" else "")
              + "; max per field "
              f"card {fields(err['card'].max(0).values)}; CPU fp32 median "
              f"{fields(err['cpu'].median(0).values)}, max "
              f"{fields(err['cpu'].max(0).values)}")
        if label == "phantom":
            check(bool((med <= TOL_RAY_JAC).all()),
                  f"ray Jacobian vs float64: median per field {med.tolist()}")


def phase_study(dev, n=EXACT_N, n_proj=EXACT_VIEWS):
    """11b: the convergence study at 64³ × 90 views of ray-family data,
    then ``frozen_polish`` on its final state (slab 40 LM iterations, ray
    10 with the moment match); 11c: K1-K5 against their plain versions
    at this phase's shapes."""
    # the debias stage's defect ‖P_exact x − P_slab x‖: the pipeline's
    # _exact_forward of (x, θ), then the slab forward of the same objects
    exact_fwd, slab_fwd = tpipe._exact_forward, sp.project
    pending, defect_norms = [], []

    def exact_forward(volume, geom, views, *args):
        pending[:] = [(volume, views, exact_fwd(volume, geom, views, *args))]
        return pending[0][2]

    def slab_project(*args, **kwargs):
        out = slab_fwd(*args, **kwargs)
        if (pending and pending[0][0] is args[0]
                and pending[0][1] is args[2]):
            p = pending.pop()[2]
            defect_norms.append(float(torch.linalg.norm(
                p - out.reshape(p.shape))))
        return out

    reset_counts()
    tpipe._exact_forward, sp.project = exact_forward, slab_project
    try:
        t0 = time.perf_counter()
        res = convergence_study.study(convergence_study.parse_args([
            "--device", str(dev), "--size", str(n), "--views", str(n_proj),
            *STUDY_ARGS]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tpipe._exact_forward, sp.project = exact_fwd, slab_fwd
    launches = {"K1": slabk.slab_plane_fwd.launches,
                "K2": slabk.slab_plane_adj.launches,
                "K3": slabk.slab_arc_fwd.launches,
                "K4": slabk.slab_arc_adj.launches,
                "K5": slabk.slab_project_jac.launches}
    rec, states = res["record"], res["states"]
    stages = [s for s in ("fast", "exact", "polish", "cv", "debias")
              if s in states]
    prev, t_prev = rec["start"]["gauge_corrected"], 0.0
    for st in stages:
        its = [e for e in rec["iters"] if e["stage"] == st]
        gc = its[-1]["gauge_corrected"]
        print(f"study {st}: {len(its)} outers, wall "
              f"{its[-1]['wall_s'] - t_prev:.2f} s, vol rel-L2 "
              f"{its[0]['vol_rel_l2']:.4f} -> {its[-1]['vol_rel_l2']:.4f}, "
              "gauge-corrected mean tx/tz/alpha/beta "
              + "/".join(f"{prev[k]['mean']:.4g}" for k in
                         ("tx", "tz", "alpha", "beta")) + " -> "
              + "/".join(f"{gc[k]['mean']:.4g}" for k in
                         ("tx", "tz", "alpha", "beta")))
        for k in ("tx", "tz"):
            check(gc[k]["mean"] <= prev[k]["mean"],
                  f"study {st}: mean |{k}| rose {prev[k]['mean']} -> "
                  f"{gc[k]['mean']}")
        prev, t_prev = gc, its[-1]["wall_s"]
    fr = rec["final_recon"]
    print(f"study final recon: {fr['iters']} plane CGLS iterations x "
          f"{fr['debias_rounds']} defect rounds, rel-L2 per round "
          + "/".join(f"{v:.4f}" for v in fr["rounds_rel_l2"])
          + f", wall {fr['wall_s']:.2f} s; study wall {wall:.2f} s")
    b_norm = float(torch.linalg.norm(torch.as_tensor(res["projections"])))
    defects = [v / b_norm for v in defect_norms]
    print(f"study debias defect rel per recompute: {defects}")
    n_debias = -(-int(rec["config"]["outers_debias"])
                 // int(rec["config"]["debias_period"]))
    check(len(defects) == n_debias
          and all(np.isfinite(v) and v > 0 for v in defects),
          f"debias defect rel {defects}, expected {n_debias} recomputes")
    print("phase-11 study kernel launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    check(min(launches.values()) > 0,
          f"the study did not launch K1-K5: {launches}")

    geom, proj = res["geom"], res["projections"]
    final = states["final"]
    truth = {"xyz": np.stack([res["truth"]["tx"], np.zeros(n_proj),
                              res["truth"]["tz"]], 1),
             "alpha": res["truth"]["alpha"], "beta": res["truth"]["beta"],
             "phi": res["phi"]}
    e_in = param_errors(final.views.theta6().cpu().double().numpy(), truth)
    print(f"frozen_polish input: gauge-corrected mean/max {fmt_errors(e_in)}")
    for fam, iters in (("slab", 40), ("ray", 10)):
        before = slabk.slab_project_jac.launches
        t0 = time.perf_counter()
        pol = tpipe.frozen_polish(proj, geom, final.views, final.volume,
                                  family=fam, refine_iters=iters,
                                  moment=True, device=dev)
        torch.cuda.synchronize()
        e = param_errors(pol.views.theta6().cpu().double().numpy(), truth)
        print(f"frozen_polish {fam} ({iters} LM iterations, moment): wall "
              f"{time.perf_counter() - t0:.2f} s, gauge-corrected mean/max "
              f"{fmt_errors(e)}; K5 launches "
              f"{slabk.slab_project_jac.launches - before}")
        check(torch.equal(pol.volume, final.volume),
              f"frozen_polish {fam} changed the volume")
        check(np.isfinite(pol.views.theta6().cpu().numpy()).all(),
              f"frozen_polish {fam}: non-finite theta")

    # 11c: the kernels at this phase's own shapes, after the counts are read
    vol = torch.as_tensor(res["phantom"], device=dev)
    pl = pair_errors(slab_groups(geom, states["fast"].views, vol, "plane",
                                 dev), geom, "plane")
    ex = pair_errors(slab_groups(geom, states["exact"].views, vol, "arc",
                                 dev), geom, "arc")
    K = int(rec["config"]["cv_folds"])
    comp = np.setdiff1d(np.arange(n_proj), np.arange(0, n_proj, K))
    fold = np.arange(0, n_proj, K)
    cgeom = dataclasses.replace(geom, n_proj=len(comp))
    fgeom = dataclasses.replace(geom, n_proj=len(fold))
    cv_views = states["cv"].views
    cv = pair_errors(slab_groups(cgeom, cv_views.take(comp), vol, "arc",
                                 dev), cgeom, "arc")
    jac_rel, jac_abs = 0.0, 0.0
    for vol_or, sc, _ in slab_groups(fgeom, cv_views.take(fold), vol, "arc",
                                     dev):
        kj = slabk.slab_project_jac(vol_or, sc, fgeom)
        check(torch.equal(kj, slabk.slab_project_jac(vol_or, sc, fgeom)),
              "two K5 applies differ")
        rj = slabk.slab_project_jac_plain(vol_or, sc, fgeom)
        jac_rel = max(jac_rel, float(per_view_rel(kj, rj).max()))
        jac_abs = max(jac_abs, float((kj - rj).abs().max()))
    print(f"phase-11 shapes: K1/K2 at {n}^3 x {n_proj} views (the fast "
          f"stage's final theta) fwd rel {pl['fwd_rel']:.3e}, adj rel "
          f"{pl['adj_rel']:.3e}, identity {pl['dot']:.3e}; K3/K4 at {n}^3 x "
          f"{n_proj} views (the exact "
          f"stage's final theta) fwd rel {ex['fwd_rel']:.3e}, adj rel "
          f"{ex['adj_rel']:.3e}, identity {ex['dot']:.3e}; K3/K4 at one CV "
          f"complement ({len(comp)} views) fwd rel {cv['fwd_rel']:.3e}, adj "
          f"rel {cv['adj_rel']:.3e}, identity {cv['dot']:.3e}; K5 at one CV "
          f"fold ({len(fold)} views) max per-view field rel {jac_rel:.3e} "
          f"(tol {TOL_JAC}), max abs {jac_abs:.3e}; two applies of each "
          "bit-identical")
    check_pair(pl, "K1", "K2")
    check_pair(ex, "K3", "K4")
    check_pair(cv, "K3", "K4")
    check(jac_rel <= TOL_JAC, f"K5 at a CV fold: {jac_rel}")
    return {"wall": wall, "launches": launches}


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_config5(tmp, dev):
    """Phase 12: BASELINE config 5 at 512³ × 1024 views (12a), K1/K2 at
    its shapes (12b), the sharded operators in a world of one over NCCL
    (12c), the voxel family and ``native`` (12d) and a trace of one CGLS
    iteration (12e)."""
    t0 = time.perf_counter()
    vol_np = phantom.shepp3d(C5_N)
    print(f"12: the {C5_N}^3 phantom on the host: "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 12a: tools/config5, CC pre-alignment + CGLS -----------------
    reset_counts()
    t0 = time.perf_counter()
    kept = {}
    rec = config5.main(["--prealign", "cc", "--niter", str(C5_NITER),
                        "--out", os.path.join(tmp, "config5.json")],
                       volume=vol_np, keep=kept)
    wall = time.perf_counter() - t0
    launches = {"fwd": slabk.slab_plane_fwd.launches,
                "adj": slabk.slab_plane_adj.launches}
    conv = rec["cgls_conv"]
    print(f"12a config 5 ({C5_N}^3, {C5_VIEWS} views, CC + CGLS "
          f"{C5_NITER}) on {rec['device']['smi']}: datagen "
          f"{rec['t_datagen_s']:.3f} s ({rec['datagen_proj_per_s']:.1f} "
          f"proj/s), CC {rec['t_prealign_s']:.3f} s, CGLS "
          f"{rec['t_cgls_s']:.3f} s ({rec['cgls_iters_run']} iterations, "
          f"{rec['cgls_proj_per_s']:.1f} proj/s fwd+adj), wall to the "
          f"aligned recon {rec['wall_to_aligned_recon_s']:.3f} s; "
          f"tools/config5 in all {wall:.2f} s")
    print(f"12a quality: rel-L2 {rec['vol_rel_l2']:.4f} (bar "
          f"{C5_REL_L2_MAX}; JAX record 0.2383), CC gauge-corrected mean "
          f"|tx| {rec['prealign_tx_gc_mean']:.4f} px, |tz| "
          f"{rec['prealign_tz_gc_mean']:.4f} px (bars {C5_TX_MAX} / "
          f"{C5_TZ_MAX}; record 0.278 / 0.103); conv "
          + ", ".join(f"{c:.5g}" for c in conv))
    print(f"12a launches: K1 {launches['fwd']}, K2 {launches['adj']}")
    check(rec["cgls_iters_run"] == C5_NITER,
          f"config 5 CGLS ran {rec['cgls_iters_run']} iterations")
    check(rec["vol_rel_l2"] <= C5_REL_L2_MAX,
          f"config 5 rel-L2 {rec['vol_rel_l2']}")
    check(all(b < a for a, b in zip(conv, conv[1:])),
          f"config 5 CGLS conv not falling: {conv}")
    check(rec["prealign_tx_gc_mean"] <= C5_TX_MAX
          and rec["prealign_tz_gc_mean"] <= C5_TZ_MAX,
          "config 5 CC residual")
    check(min(launches.values()) > 0, f"config 5 launches {launches}")

    # ---- 14b: 12a's CGLS again on the bf16 operator -------------------
    geom, phi, t, _ = config5.problem(C5_N, C5_VIEWS)
    launches_bf16 = phase_config5_bf16(geom, phi, kept, vol_np, rec, dev)
    del kept

    # ---- 12b: K1/K2 at 512^3 -----------------------------------------
    views = Views.create(C5_VIEWS, phi=phi, t=t, device=dev)
    vol = torch.as_tensor(vol_np, device=dev)
    groups = slab_groups(geom, views, vol, "plane", dev)
    sub = np.arange(0, C5_VIEWS, C5_VIEWS // C5_CHECK_VIEWS)
    sub_groups = slab_groups(geom, views.take(sub), vol, "plane", dev)
    check(len(sub_groups) == len(groups),
          f"{len(sub)} views cover {len(sub_groups)} of {len(groups)} "
          "orientation groups")
    e = pair_errors(sub_groups, geom, "plane")
    t_k1 = cuda_ms(lambda: [slabk.slab_plane_fwd(vo, sc, geom)
                            for vo, sc, _ in groups], 3)
    t_k2 = cuda_ms(lambda: [slabk.slab_plane_adj(y, sc, geom)
                            for _, sc, y in groups], 3)
    bnd = groups_bound(geom, groups, "plane")
    print(f"12b K1/K2 at {C5_N}^3 on {len(sub)} of the views "
          f"({len(sub_groups)} orientation groups): K1 max per-view rel L2 "
          f"{e['fwd_rel']:.3e} (tol {TOL_FWD}), K2 {e['adj_rel']:.3e} (tol "
          f"{TOL_ADJ}), adjoint identity {e['dot']:.3e} (tol {TOL_DOT}), "
          "two applies bit-identical")
    print(f"12b per {C5_VIEWS}-view apply ({len(groups)} groups): K1 "
          f"{t_k1:.3f} ms, K2 {t_k2:.3f} ms; bound {bnd[0]:.3f} ms "
          f"({bnd[1]}), K1 {t_k1 / bnd[0]:.1f}x, K2 {t_k2 / bnd[0]:.1f}x")
    check_pair(e, "K1", "K2")

    # ---- 12b: K1b/K2b at 512^3, the kernels of 14b's CGLS --------------
    eb, _ = bf16_errors(sub_groups, geom, "plane", label="12b", flips=False)
    t_k1b = cuda_ms(lambda: [slabk.slab_plane_fwd_bf16(vo, sc, geom)
                             for vo, sc, _ in groups], 3)
    t_k2b = cuda_ms(lambda: [slabk.slab_plane_adj_bf16(y, sc, geom)
                             for _, sc, y in groups], 3)
    print(f"12b K1b/K2b at {C5_N}^3 on the same {len(sub)} views: K1b max "
          f"per-view rel L2 {eb['fwd_rel']:.3e} (tol {TOL_FWD}), K2b "
          f"{eb['adj_rel']:.3e} (tol {TOL_ADJ}) against plain bf16; against "
          f"K1 {eb['fwd_f32_min']:.3e}-{eb['fwd_f32']:.3e}, K2 "
          f"{eb['adj_f32_min']:.3e}-{eb['adj_f32']:.3e} (bars >= {MIN_BF16}, "
          f"<= {TOL_BF16}); two applies bit-identical")
    print(f"12b per {C5_VIEWS}-view apply: K1b {t_k1b:.3f} ms (K1 "
          f"{t_k1:.3f}), K2b {t_k2b:.3f} ms (K2 {t_k2:.3f}), each with its "
          f"wrapper's cast; bound {bnd[0]:.3f} ms ({bnd[1]})")
    print(f"12b K1b's own design over K1: {t_k1b / t_k1:.4f} (K1 "
          f"instantiated on bf16: {FP32_ON_BF16_FWD_RATIO['plane_512']}); "
          f"K2b's own design over K2: {t_k2b / t_k2:.4f} (K2 "
          f"instantiated on bf16: {FP32_ON_BF16_ADJ_RATIO['plane_512']})")
    print(f"12b K1b from its plain bf16 version: max per-view rel L2 "
          f"{eb['fwd_rel']:.3e} (bar {TOL_BF16_PLAIN['plane']})")
    check_bf16(eb, "plane", "12b")
    del groups, sub_groups

    # ---- 12c: mesh mode, a world of one over NCCL ---------------------
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", dev.index or 0))
    reset_counts()
    try:
        backend = dist.get_backend()
        mrec = config5.main(["--mode", "mesh"])
    finally:
        dist.destroy_process_group()
    mesh_launches = {fn.__name__: fn.launches for fn in COUNTED[:4]}
    rels = {k: mrec[k] for k in mrec
            if k.startswith("vol_") and k.endswith("_rel")}
    print(f"12c mesh mode ({backend}, world {mrec['world']}, {C5_N}^3, "
          f"{MESH_VIEWS} views): angle-sharded slab_plane bit-equal to the "
          f"unsharded operator: A {mrec['angle_sharded_fwd_equal']}, AT "
          f"{mrec['angle_sharded_adj_equal']}; volume-sharded (halo 32) "
          "rel: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f" (tol {TOL_MESH}; JAX record 1.9e-7 fwd, 7.2e-6 / 8.1e-6 "
          "adj); times " + ", ".join(
              f"{k[:-2]} {mrec[k]:.3f}" for k in mrec if k.endswith("_s"))
          + f" s; launches {mesh_launches}")
    check(backend == "nccl" and mrec["world"] == 1, "12c world")
    check(mrec["angle_sharded_fwd_equal"] and mrec["angle_sharded_adj_equal"],
          "angle-sharded slab_plane differs from the unsharded operator")
    check(max(rels.values()) <= TOL_MESH, f"12c: {rels}")
    mesh_frame_readings(vol_np, dev)

    # ---- 12d: the voxel family and native -----------------------------
    phase_voxel(dev)

    # ---- 12e: a trace of one CGLS iteration at 512^3 ------------------
    op = make_operator(geom, views, family="slab_plane", device=dev)
    b = op.A(vol)
    state = cgls_init(op, b)
    state, _, _ = cgls_steps(op, b, state, nsteps=1, niter=3)
    torch.cuda.synchronize()
    with profiling.trace(os.path.join(tmp, "trace")) as prof:
        t0 = time.perf_counter()
        cgls_steps(op, b, state, nsteps=1, niter=3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kt = profiling.kernel_times(prof)
    total = sum(kt.values())
    k2 = sum(v for k, v in kt.items() if "adj_kernel" in k)
    k1 = sum(v for k, v in kt.items() if "fwd_kernel" in k)
    check(k1 > 0 and k2 > 0, "12e: the trace holds no K1/K2 device time")
    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return name.replace("void ", "").split("(")[0][:48]

    top = ", ".join(f"{short(k)} {v / total:.1%}"
                    for k, v in list(kt.items())[:5])
    print(f"12e one CGLS iteration at {C5_N}^3 x {C5_VIEWS} views "
          f"(torch.profiler): wall {wall * 1e3:.1f} ms, device busy "
          f"{total / 1e6 / wall:.1%}; K2 {k2 / total:.1%} of device time, "
          f"K1 {k1 / total:.1%}; top kernels: {top}")
    return launches, launches_bf16


def phase_config5_bf16(geom, phi, kept, vol_np, rec, dev):
    """14b: 12a's 10 CGLS iterations again, on the bf16 slab_plane
    operator (K1b/K2b), from 12a's data and CC views in memory: rel-L2 ≤
    0.25 and within 2e-3 of 12a's, the residual norm falling at every
    iteration, no reinit quit; K1b/K2b's launches (counts set to 0 just
    before)."""
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        state, cg = config5.cgls_stage(
            geom, phi, kept["t_rec"], kept["proj"].reshape(C5_VIEWS, -1),
            C5_NITER, "bf16", "slab_plane", dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": slabk.slab_plane_fwd_bf16.launches,
                "adj": slabk.slab_plane_adj_bf16.launches}
    counts = {fn.__name__: fn.launches for fn in COUNTED}
    rel = config5.rel_l2(state.x, vol_np)
    conv = cg["cgls_conv"]
    print(f"14b config 5 CGLS {C5_NITER} on the bf16 operator ({C5_N}^3, "
          f"{C5_VIEWS} views, 12a's data and CC views): {cg['t_cgls_s']:.3f} "
          f"s ({cg['cgls_proj_per_s']:.1f} proj/s fwd+adj; 12a "
          f"{rec['t_cgls_s']:.3f} s, {rec['cgls_proj_per_s']:.1f} proj/s), "
          f"wall {wall:.3f} s; rel-L2 {rel:.5f} (bf16) vs {rec['vol_rel_l2']:.5f}"
          f" (f32x2, 12a), bars <= {C5_REL_L2_MAX} and within "
          f"{C5_BF16_DIFF}; stop {cg['cgls_stop']}; conv "
          + ", ".join(f"{c:.5g}" for c in conv))
    print(f"14b CGLS {C5_NITER} wall on the bf16 operator over 12a's: "
          f"{cg['t_cgls_s'] / rec['t_cgls_s']:.4f} ({cg['t_cgls_s']:.3f} s "
          f"over {rec['t_cgls_s']:.3f} s)")
    print(f"14b launches {json.dumps(counts)}")
    check(cg["cgls_iters_run"] == C5_NITER and cg["cgls_stop"] == 0,
          f"14b CGLS ran {cg['cgls_iters_run']} (stop {cg['cgls_stop']})")
    check(rel <= C5_REL_L2_MAX
          and abs(rel - rec["vol_rel_l2"]) <= C5_BF16_DIFF,
          f"14b rel-L2 {rel} vs 12a's {rec['vol_rel_l2']}")
    check(all(b < a for a, b in zip(conv, conv[1:])),
          f"14b CGLS conv not falling: {conv}")
    check(min(launches.values()) > 0
          and counts["slab_plane_fwd"] == counts["slab_plane_adj"] == 0,
          f"14b launches {counts}")
    return launches


def mesh_frame_readings(vol_np, dev):
    """12c: what sets the volume-sharded plane operator's distance from the
    unsharded one in a world of one, printed: A and Aᵀ (of A x) at halos 8
    and 32 on mesh mode's white-noise volume and on the phantom. The block's
    z frame is the volume's moved by the halo; fp32 rounding of z there
    keeps its size from halo 8 to 32 and is smaller on a smooth volume,
    where an error in the frame's offset would grow with the halo."""
    from tomojax_torch.dist import make_mesh, make_volume_sharded_slab_operator
    geom, phi, t, rng = config5.problem(C5_N, MESH_VIEWS)
    views = Views.create(MESH_VIEWS, phi=phi, t=t)
    vols = {"noise": rng.standard_normal((C5_N,) * 3).astype(np.float32),
            "phantom": vol_np}
    plain = make_operator(geom, views, family="slab_plane", device=dev)
    out = []
    with torch.no_grad():
        for name, x in vols.items():
            x = torch.as_tensor(x, device=dev)
            y = plain.A(x)
            b = plain.AT(y)
            for halo in (8, 32):
                op = make_volume_sharded_slab_operator(
                    geom, views, make_mesh(), quad="plane", halo=halo,
                    device=dev)
                out.append(f"{name} halo {halo}: A {rel_l2(op.A(x), y):.3e},"
                           f" AT {rel_l2(op.AT(y), b):.3e}")
    print("12c volume-sharded plane vs unsharded, rel L2 (printed, not "
          "bounded): " + "; ".join(out))


def phase_voxel(dev):
    """12d: the voxel family at 128³ × 90 views on the card against
    float64 on the CPU, and ``native`` against the ray family."""
    n, n_proj = VOX_N, VOX_VIEWS
    rng = np.random.default_rng(SEED)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    kw = dict(phi=np.linspace(0.0, np.pi, n_proj, endpoint=False),
              alpha=rng.uniform(-0.01, 0.01, n_proj),
              beta=rng.uniform(-0.01, 0.01, n_proj),
              t=np.stack([rng.uniform(-2, 2, n_proj), np.zeros(n_proj),
                          rng.uniform(-2, 2, n_proj)], -1))
    v32 = Views.create(n_proj, **kw)
    v64 = Views.create(n_proj, **kw, dtype=torch.float64)
    vol_np = phantom.shepp3d(n)
    vol = torch.as_tensor(vol_np, device=dev)
    vol64 = torch.as_tensor(vol_np, dtype=torch.float64)
    op = make_operator(geom, v32, family="voxel", device=dev)
    ref = make_operator(geom, v64, family="voxel", dtype=torch.float64,
                        device="cpu")
    sino = op.A(vol)
    repeat = float((op.A(vol) - sino).abs().max())
    t0 = time.perf_counter()
    sino64 = ref.A(vol64)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((n_proj, geom.n_det), generator=gen, device=dev)
    aty64 = ref.AT(y.cpu().double())
    cpu_s = time.perf_counter() - t0
    aty = op.AT(y)
    rel_a = float(per_view_rel(sino.cpu().double().reshape(n_proj, n, n),
                               sino64.reshape(n_proj, n, n)).max())
    rel_at = float(torch.linalg.norm(aty.cpu().double() - aty64)
                   / torch.linalg.norm(aty64))
    lhs = torch.dot(sino.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol.double().reshape(-1), aty.double().reshape(-1))
    dot = float(abs(lhs - rhs) / (torch.linalg.norm(sino.double())
                                  * torch.linalg.norm(y.double())))
    t_A = cuda_ms(lambda: op.A(vol), 3)
    t_AT = cuda_ms(lambda: op.AT(y), 3)
    print(f"12d voxel family ({n}^3, {n_proj} views), fp32 card vs float64 "
          f"CPU: A max per-view rel L2 {rel_a:.3e}, AT rel L2 {rel_at:.3e} "
          f"(tol {TOL_VOX}; CPU {cpu_s:.2f} s); adjoint identity {dot:.3e} "
          f"(tol {TOL_VOX}); two card A applies differ by max abs "
          f"{repeat:.3e} (float atomics); A {t_A:.3f} ms, AT {t_AT:.3f} ms "
          "per apply")
    check(rel_a <= TOL_VOX and rel_at <= TOL_VOX,
          f"voxel A/AT vs float64: {rel_a}, {rel_at}")
    check(dot <= TOL_VOX, f"voxel adjoint identity {dot}")

    # the Jacobian: fp32 on the card and on the CPU against float64. The
    # splat's weight gradient jumps where a voxel centre crosses a pixel
    # edge, and fp32 puts the centres within its rounding of an edge on
    # the other side: fp32 itself sits ~1e-3 from float64 on the phantom,
    # so the card is held to the CPU's fp32 at the same θ
    idx = np.arange(0, n_proj, n_proj // VOX_JAC_VIEWS)[:VOX_JAC_VIEWS]
    f64 = [getattr(v64, f)[idx] for f in ("phi", "alpha", "beta", "t",
                                            "cor")]
    _, j64 = vox.forward_views_jac(vol64, geom, *f64, dtype=torch.float64)
    _, j32 = vox.forward_views_jac(vol, geom, *(a.float().to(dev)
                                                for a in f64))
    _, jcpu = vox.forward_views_jac(vol.cpu(), geom,
                                    *(a.float() for a in f64))
    j32 = j32.cpu().double()

    def rel(a, b):                     # per (view, field); ty is 0/0
        return torch.linalg.norm(a - b, dim=2) / torch.linalg.norm(b, dim=2)

    names = ("tx", "ty", "tz", "phi", "alpha", "beta")

    def fields(v):
        return ", ".join(f"{k} {x:.3e}" for k, x in zip(names, v.tolist()))

    card_cpu = rel(j32, jcpu.double()).median(0).values
    print(f"12d voxel Jacobian over {len(idx)} views, relative L2 per (view, "
          f"field), median per field: card fp32 vs CPU fp32 "
          f"{fields(card_cpu)} (tol {TOL_VOX_JAC}); card fp32 vs float64 "
          f"{fields(rel(j32, j64).median(0).values)}; CPU fp32 vs float64 "
          f"{fields(rel(jcpu.double(), j64).median(0).values)}")
    # ty: the voxel family drops each voxel along y, so its ty column is
    # zero (0/0 here)
    check(bool((card_cpu[[0, 2, 3, 4, 5]] <= TOL_VOX_JAC).all()),
          f"voxel Jacobian card vs CPU fp32: {card_cpu.tolist()}")

    t0 = time.perf_counter()
    check(native.is_available(), "native: g++ could not build tomonative")
    build_s = time.perf_counter() - t0
    g1 = Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n, n))
    vol64_dev = vol64.to(dev)
    worst = 0.0
    for i in idx[:NATIVE_VIEWS]:
        args = [getattr(v64, f)[i] for f in ("phi", "alpha", "beta", "t",
                                                "cor")]
        a_nat = native.forward_view(vol_np, g1, *(a.numpy() for a in args))
        a_ray = rproj.forward_views_plain(
            vol64_dev, g1, *(a.to(dev) for a in args),
            dtype=torch.float64)[0].cpu().numpy()
        yv = y[i].double().cpu().numpy()
        b_nat = native.backproject_view(yv, g1, *(a.numpy() for a in args))
        b_ray = rproj.backproject_views_plain(
            torch.as_tensor(yv, device=dev), g1.vox_shape, g1,
            *(a.to(dev) for a in args),
            dtype=torch.float64).cpu().numpy()
        worst = max(worst,
                    np.linalg.norm(a_nat - a_ray) / np.linalg.norm(a_ray),
                    np.linalg.norm(b_nat - b_ray) / np.linalg.norm(b_ray))
    print(f"12d native (g++ build {build_s:.2f} s) forward and adjoint vs the "
          f"ray family's plain march in float64 on the card over "
          f"{NATIVE_VIEWS} views: max rel L2 {worst:.3e} (tol {TOL_NATIVE})")
    check(worst <= TOL_NATIVE, f"native vs ray family: {worst}")


def bf16_errors(groups, geom, quad, label="14a", flips=True):
    """The bf16 kernels (K1b/K2b plane, K3b/K4b arc) on the orientation
    groups ``(vol_or, scalars, y)``: launched alone (their counters rise,
    no other does), then against their plain bf16 versions (max per-view
    rel L2 and max abs of the forward, rel L2 and max abs of the adjoint,
    and the plain versions' time), against the fp32 kernels (the min and
    max rel L2 over groups), two applies bit-identical, and the pair's
    mismatch: tomojax's |<Ax,y>-<x,Aᵀy>|/max(|<Ax,y>|, 1) on ``y`` beside
    the same for the fp32 kernels and the plain bf16 pair, its numerator
    and denominator pooled over 32 standard-normal cotangents, and the
    ratio on |y| (float64 dot products). With ``flips``: the adjoint
    against the plain fp32 one (K2/K4's fp32 distance, which bf16
    rounding amplifies) and ``bf16_gate.rounding_flips`` on the first
    group's first views."""
    fwd_b, adj_b, fwd_f, adj_f = BF16_KERNELS[quad]
    reset_counts()
    for vol_or, sc, y in groups:
        fwd_b(vol_or, sc, geom)
        adj_b(y, sc, geom)
    counts = {fn.__name__: fn.launches for fn in COUNTED}
    check(counts[fwd_b.__name__] == counts[adj_b.__name__] == len(groups)
          and all(v == 0 for k, v in counts.items()
                  if k not in (fwd_b.__name__, adj_b.__name__)),
          f"{label} {quad}: bf16 launches {counts}")
    e = {k: [] for k in ("fwd_rel", "fwd_abs", "adj_rel", "adj_abs",
                         "fwd_f32", "adj_f32", "written", "written_f32",
                         "written_plain", "lhs", "pooled", "abs_y",
                         "adj_f32_plain")}
    plain_ms = {"fwd": 0.0, "adj": 0.0}
    gen = torch.Generator(device=groups[0][0].device).manual_seed(SEED + 1)
    for vol_or, sc, y in groups:
        ker = fwd_b(vol_or, sc, geom)
        check(torch.equal(ker, fwd_b(vol_or, sc, geom)),
              f"two {fwd_b.__name__} applies differ")
        ref, ms = event_timed(lambda: slabk.slab_project_plain(
            vol_or, sc, geom, quad, prec="bf16"))
        plain_ms["fwd"] += ms
        e["fwd_rel"].append(float(per_view_rel(ker, ref).max()))
        e["fwd_abs"].append(float((ker - ref).abs().max()))
        kf = fwd_f(vol_or, sc, geom)
        e["fwd_f32"].append(rel_l2(ker, kf))
        kadj = adj_b(y, sc, geom)
        check(torch.equal(kadj, adj_b(y, sc, geom)),
              f"two {adj_b.__name__} applies differ")
        radj, ms = event_timed(lambda: slabk.slab_backproject_plain(
            y, sc, geom, quad, prec="bf16"))
        plain_ms["adj"] += ms
        e["adj_rel"].append(rel_l2(kadj, radj))
        e["adj_abs"].append(float((kadj - radj).abs().max()))
        kadj_f = adj_f(y, sc, geom)
        e["adj_f32"].append(rel_l2(kadj, kadj_f))
        e["written"].append(bf16_gate.mismatch(ker, y, vol_or, kadj))
        e["written_f32"].append(bf16_gate.mismatch(kf, y, vol_or, kadj_f))
        e["written_plain"].append(bf16_gate.mismatch(ref, y, vol_or, radj))
        e["lhs"].append(bf16_gate.dot(ker, y)
                        / float(torch.linalg.norm(ker)))
        if flips:
            e["adj_f32_plain"].append(rel_l2(
                kadj_f, slabk.slab_backproject_plain(y, sc, geom, quad)))
        del ref, radj, kf, kadj_f
        e["pooled"].append(bf16_gate.pooled_mismatch(
            ker, vol_or, lambda g: adj_b(g, sc, geom), tuple(y.shape), gen,
            MISMATCH_DRAWS)["pooled"])
        e["abs_y"].append(bf16_gate.mismatch(ker, y.abs(), vol_or,
                                             adj_b(y.abs(), sc, geom)))
    out = {k: max(v) for k, v in e.items() if v}
    out["fwd_f32_min"], out["adj_f32_min"] = min(e["fwd_f32"]), min(
        e["adj_f32"])
    print(f"{label} {quad} bf16 pair mismatch, tomojax's |<Ax,y>-<x,A^T y>|/"
          f"max(|<Ax,y>|,1) on one standard-normal y per group: "
          + ", ".join(f"{w:.2e}" for w in e["written"])
          + " (<Ax,y>/|Ax| " + ", ".join(f"{v:.3f}" for v in e["lhs"])
          + "; the plain bf16 pair " + ", ".join(
              f"{w:.2e}" for w in e["written_plain"]) + "; the fp32 kernels "
          + ", ".join(f"{w:.1e}" for w in e["written_f32"])
          + f"; printed); pooled over {MISMATCH_DRAWS} draws "
          + ", ".join(f"{w:.3e}" for w in e["pooled"])
          + f"; on |y| max {out['abs_y']:.3e} (tol {TOL_MISMATCH} both)")
    if flips:
        vo, sc, y = groups[0]
        r = bf16_gate.rounding_flips(y[:FLIP_VIEWS], sc[:FLIP_VIEWS], geom,
                                     quad)
        out["flips"] = r
        d = out["adj_f32_plain"]
        k_law = out["adj_rel"] / d ** 0.5 if d > 0 else float("nan")
        print(f"{label} {quad} rounding flips (plain bf16 adjoint in "
              f"float32 vs float64, {FLIP_VIEWS} views): {r['flips']:.3e} "
              "of the "
              f"tables' nonzero elements differ, {r['one_ulp']:.3f} of them "
              "by one "
              f"bf16 ulp; bf16 adjoints {r['gap']:.3e} apart, fp32 ones "
              f"{r['delta']:.3e}: gap/sqrt(delta) "
              f"{r['gap'] / r['delta'] ** 0.5:.4f}; the kernels: "
              f"{adj_b.__name__} vs plain {out['adj_rel']:.3e}, "
              f"{adj_f.__name__} vs plain {out['adj_f32_plain']:.3e}: "
              f"{k_law:.4f}")
    check(out["pooled"] <= TOL_MISMATCH and out["abs_y"] <= TOL_MISMATCH,
          f"{label} {quad} mismatch: pooled {out['pooled']}, on |y| "
          f"{out['abs_y']}")
    return out, plain_ms


def check_bf16(e, quad, label):
    """The bars of ``bf16_errors``'s readings ``e`` against the plain bf16
    versions (phase 3's, and ``TOL_BF16_PLAIN`` for the forwards) and the
    fp32 kernels (tomojax's, and moved)."""
    fwd_b, adj_b, _, _ = BF16_KERNELS[quad]
    check(e["fwd_rel"] <= min(TOL_FWD, TOL_BF16_PLAIN[quad]),
          f"{label} {fwd_b.__name__} vs plain {e['fwd_rel']}")
    check(e["adj_rel"] <= TOL_ADJ,
          f"{label} {adj_b.__name__} vs plain {e['adj_rel']}")
    for k in ("fwd", "adj"):
        check(MIN_BF16 <= e[f"{k}_f32_min"] and e[f"{k}_f32"] <= TOL_BF16,
              f"{label} {quad} {k} vs fp32: {e[f'{k}_f32_min']}-"
              f"{e[f'{k}_f32']}")


def gate_readings(dev):
    """14a: ``tools/bf16_gate`` (tomojax's gate problem: 8 views, its seed)
    at 64³ and 256³ on the kernels: each group's forward against fp32 ≤
    3e-3 and the pooled mismatch ≤ 5e-3; tomojax's single draw printed
    with its verdict."""
    for size in GATE_SIZES:
        rows = bf16_gate.run(size, dev, MISMATCH_DRAWS)
        worst = max(r["bf16"] for r in rows)
        print(f"14a tomojax's gate problem at {size}^3 (8 views, seed 7): "
              "fwd rel " + ", ".join(f"{r['fwd_rel']:.2e}" for r in rows)
              + "; single-draw mismatch " + ", ".join(
                  f"{r['bf16']:.2e}" for r in rows)
              + f" (worst {worst:.2e}: "
              f"{'PASS' if worst <= TOL_MISMATCH else 'FAIL'} against "
              f"{TOL_MISMATCH}, printed; <Ax,y>/|Ax| " + ", ".join(
                  f"{r['lhs'] / r['ax_norm']:.3f}" for r in rows)
              + "; bf16 A + fp32 AT " + ", ".join(
                  f"{r['bf16_fwd']:.2e}" for r in rows)
              + "; fp32 A + bf16 AT " + ", ".join(
                  f"{r['bf16_adj']:.2e}" for r in rows)
              + "); pooled over 32 draws " + ", ".join(
                  f"{r['pooled']:.3e}" for r in rows))
        check(max(r["fwd_rel"] for r in rows) <= TOL_BF16
              and max(r["pooled"] for r in rows) <= TOL_MISMATCH,
              f"14a gate problem at {size}^3: {rows}")


def phase_bf16_kernels(dev):
    """14a: K1b/K2b at phase 3's problem and K3b/K4b at phase 5's, each
    against its plain bf16 version and its fp32 kernel, with its time per
    apply beside the fp32 kernel's and the bound."""
    t_phase = time.perf_counter()
    res = {}
    for quad, problem in (("plane", plane_problem), ("arc", arc_problem)):
        geom, views, vol = problem(dev)
        groups = slab_groups(geom, views, vol, quad, dev)
        e, plain_ms = bf16_errors(groups, geom, quad)
        fwd_b, adj_b, fwd_f, adj_f = BF16_KERNELS[quad]

        def fwd(fn):
            return lambda: [fn(vo, sc, geom) for vo, sc, _ in groups]

        def adj(fn):
            return lambda: [fn(y, sc, geom) for _, sc, y in groups]

        t = {"fwd": cuda_ms(fwd(fwd_b), 5), "fwd_f32": cuda_ms(fwd(fwd_f), 5),
             "adj": cuda_ms(adj(adj_b), 3), "adj_f32": cuda_ms(adj(adj_f), 3),
             "fwd_plain": plain_ms["fwd"], "adj_plain": plain_ms["adj"],
             "bound": groups_bound(geom, groups, quad)}
        n_views = sum(sc.shape[0] for _, sc, _ in groups)
        fn_name, an_name = fwd_b.__name__, adj_b.__name__
        print(f"14a {fn_name} vs plain bf16: max per-view rel L2 "
              f"{e['fwd_rel']:.3e} (tol {TOL_FWD}), max abs "
              f"{e['fwd_abs']:.3e}; vs {fwd_f.__name__}: rel L2 "
              f"{e['fwd_f32_min']:.3e}-{e['fwd_f32']:.3e} over "
              f"{len(groups)} groups (bars >= {MIN_BF16}, <= {TOL_BF16})")
        print(f"14a {an_name} vs plain bf16: rel L2 {e['adj_rel']:.3e} "
              f"(tol {TOL_ADJ}), max abs {e['adj_abs']:.3e}; vs "
              f"{adj_f.__name__}: rel L2 {e['adj_f32_min']:.3e}-"
              f"{e['adj_f32']:.3e}; two applies of each bit-identical")
        print(f"14a per {n_views}-view apply ({N}^3): {fn_name} "
              f"{t['fwd']:.3f} ms vs {fwd_f.__name__} {t['fwd_f32']:.3f} ms, "
              f"{an_name} {t['adj']:.3f} ms vs {adj_f.__name__} "
              f"{t['adj_f32']:.3f} ms (each with its wrapper's cast); "
              f"plain bf16 {t['fwd_plain']:.3f} / {t['adj_plain']:.3f} ms; "
              f"bound {t['bound'][0]:.3f} ms ({t['bound'][1]})")
        print(f"14a {fn_name}'s own design over {fwd_f.__name__}: "
              f"{t['fwd'] / t['fwd_f32']:.4f} ({fwd_f.__name__} "
              f"instantiated on bf16: {FP32_ON_BF16_FWD_RATIO[quad]}); "
              f"{an_name}'s own design over {adj_f.__name__}: "
              f"{t['adj'] / t['adj_f32']:.4f} ({adj_f.__name__} "
              f"instantiated on bf16: {FP32_ON_BF16_ADJ_RATIO[quad]})")
        check_bf16(e, quad, "14a")
        res[quad] = {**e, **t}
        del groups
    gate_readings(dev)
    print(f"14a: {time.perf_counter() - t_phase:.1f} s")
    return res


def phase_bf16_align(tmp, dev, hist6):
    """14c: config 4's dataset (phase 6's file) through ``cli align`` with
    phase 6's settings, ``--recon-prec bf16`` and 3 outers: outer 2's
    rel-L2 within 5e-3 of phase 6's outer 2, the gauge-corrected mean |tx|
    and |tz| errors below their start, K3b, K4b and K5 launched."""
    data = os.path.join(tmp, "config4.npz")
    out = os.path.join(tmp, "align_c4_bf16.npy")
    reset_counts()
    t0 = time.perf_counter()
    r = cli.main(["align", "-i", data, "-o", out, "--recon-prec", "bf16",
                  "--set", "align.pre_align_cc=true",
                  "--set", "align.family=slab",
                  "--set", "align.refine_method=lm_slab",
                  "--set", "align.recon=cgls",
                  "--set", "align.recon_iters=30",
                  "--set", "align.refine_iters=10",
                  "--set", "align.param_set=xzab",
                  "--set", "align.moment_period=1",
                  "--set", "align.accel_period=4",
                  "--set", f"align.outer_iters={C4_BF16_OUTERS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in COUNTED}
    d = io.load_dataset(data)
    geom = Geometry(n_proj=N_ARC, vox_shape=(N,) * 3, det_shape=(N, N))
    est = com_align(torch.as_tensor(d["projections"], device=dev), geom,
                    d["phi"], device=dev).cpu().numpy()
    th0 = np.zeros((N_ARC, 6))
    th0[:, 0], th0[:, 2], th0[:, 3] = est[:, 0], est[:, 1], d["phi"]
    e0 = param_errors(th0, d)
    hist = r["state"].history
    last = C4_BF16_OUTERS - 1
    for k, th in enumerate(r["theta_per_outer"]):
        print(f"14c config 4 bf16 outer {k}: vol rel-L2 "
              f"{hist['recon_rms'][k]:.4f} (phase 6: "
              f"{hist6['recon_rms'][k]:.4f}), refine cost "
              f"{hist['refine_cost'][k]:.6g}, gauge-corrected mean/max "
              f"{fmt_errors(param_errors(np.asarray(th, np.float64), d))}")
    e = param_errors(np.asarray(r["theta_per_outer"][last], np.float64), d)
    print(f"14c align wall {wall:.2f} s ({C4_BF16_OUTERS} outers); launches "
          f"{json.dumps(launches)}")
    diff = abs(hist["recon_rms"][last] - hist6["recon_rms"][last])
    check(diff <= C4_BF16_DIFF, f"14c outer {last} rel-L2 differs from "
          f"phase 6's by {diff}")
    check(e["tx"][0] < e0["tx"][0] and e["tz"][0] < e0["tz"][0],
          f"14c |tx|, |tz| errors {e} not below the start {e0}")
    check(min(launches["slab_arc_fwd_bf16"], launches["slab_arc_adj_bf16"],
              launches["slab_project_jac"]) > 0,
          f"14c did not launch K3b, K4b and K5: {launches}")
    return launches


def _plain_arc(vol, y, geom, gstruct, scalars):
    """The arc operator's plain versions over the orientation groups:
    ``(forward (V, nu, nv), adjoint vox_shape)``, flips as the operator's."""
    nu, nv = geom.det_shape
    fwd = vol.new_zeros((geom.n_proj, nu, nv))
    adj = torch.zeros_like(vol)
    y = y.reshape(-1, nu, nv)
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        rows = torch.as_tensor(idx, device=vol.device)
        vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
        p = slabk.slab_project_plain(vol_or, sc, geom, "arc")
        fwd[rows] = p.flip(1) if uf else p
        g = y[rows].flip(1) if uf else y[rows]
        adj += sp.unorient_volume(
            slabk.slab_backproject_plain(g.contiguous(), sc, geom, "arc"),
            sw, yf)
    return fwd, adj


def phase_default_calls(dev):
    """Phase 13: tomojax's default slab calls on the card — ``project``
    and ``backproject`` with no ``quad`` (the arc quadrature, as
    tomojax's), ``views_chunk`` and the slab ``forward_view`` — at 256³ ×
    90 views over the full circle (phase 5's problem)."""
    t_phase = time.perf_counter()
    geom, views, vol = arc_problem(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    y = torch.randn((N_ARC, geom.n_det), generator=gen, device=dev)
    gstruct, scalars = sp.scalar_groups(geom, views, device=dev)
    n_groups = len(gstruct)

    reset_counts()
    fwd, fwd_ms = event_timed(lambda: sp.project(vol, geom, views))
    adj, adj_ms = event_timed(lambda: sp.backproject(y, geom, views))
    counts = {fn.__name__: fn.launches for fn in COUNTED}
    print(f"13: default project / backproject at {N}^3 x {N_ARC} views "
          f"({n_groups} orientation groups): {fwd_ms:.3f} / {adj_ms:.3f} "
          f"ms (first calls, scalars on the host included); launches "
          f"{json.dumps(counts)}")
    check(counts["slab_arc_fwd"] == n_groups
          and counts["slab_arc_adj"] == n_groups,
          f"default calls: K3/K4 launches {counts} != {n_groups} groups")
    check(all(v == 0 for k, v in counts.items()
              if k not in ("slab_arc_fwd", "slab_arc_adj")),
          f"default calls launched another kernel: {counts}")

    same_fwd = torch.equal(fwd, sp.project(vol, geom, views, quad="arc"))
    same_adj = torch.equal(adj, sp.backproject(y, geom, views, quad="arc"))
    print(f"13: default == quad='arc': forward {same_fwd}, adjoint "
          f"{same_adj} (bit-equal)")
    check(same_fwd and same_adj, "the default call is not the arc call")

    pf, pa = _plain_arc(vol, y, geom, gstruct, scalars)
    f_rel = float(per_view_rel(fwd.reshape(pf.shape), pf).max())
    a_rel = float(torch.linalg.norm(adj - pa) / torch.linalg.norm(pa))
    print(f"13: default calls vs the plain arc path: forward max per-view "
          f"rel L2 {f_rel:.3e} (tol {TOL_FWD}), adjoint rel L2 "
          f"{a_rel:.3e} (tol {TOL_ADJ})")
    check(f_rel <= TOL_FWD, f"default forward vs plain {f_rel}")
    check(a_rel <= TOL_ADJ, f"default adjoint vs plain {a_rel}")
    del pf, pa

    fwd16 = sp.project(vol, geom, views, views_chunk=16)
    adj16 = sp.backproject(y, geom, views, views_chunk=16)
    c_rel = float(torch.linalg.norm(adj16 - adj) / torch.linalg.norm(adj))
    same16 = torch.equal(fwd16, fwd)
    print(f"13: views_chunk=16: forward bit-equal {same16}, adjoint rel L2 "
          f"{c_rel:.3e} (tol {TOL_ADJ})")
    check(same16, "views_chunk changed the forward")
    check(c_rel <= TOL_ADJ, f"views_chunk adjoint {c_rel}")

    worst, equal = 0.0, 0
    picks = [gstruct[g][0][0] for g in range(min(4, n_groups))]
    for i in picks:
        v = views.view(i)
        row = sp.forward_view(vol, geom, v.phi, v.alpha, v.beta, v.t, v.cor)
        ref = fwd[i]
        worst = max(worst, float(torch.linalg.norm(row - ref)
                                 / torch.linalg.norm(ref)))
        equal += int(torch.equal(row, ref))
    print(f"13: forward_view on views {picks} (one per group) vs project's "
          f"rows: max rel L2 {worst:.3e} (tol {TOL_FWD}), {equal} of "
          f"{len(picks)} bit-equal")
    check(worst <= TOL_FWD, f"forward_view vs project {worst}")
    print(f"13: {time.perf_counter() - t_phase:.1f} s")


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
    for key in ("TOMOJAX_PEAK_FLOPS", "TOMOJAX_PEAK_BW"):
        os.environ.pop(key, None)      # the bounds use the H100's peaks
    flops, bw = roofline.device_peaks()
    print(f"bounds at {flops / 1e12:g} TFLOP/s fp32, {bw / 1e12:g} TB/s")
    print("tf32: matmul.allow_tf32 = False, cudnn.allow_tf32 = False")

    t_script = t0 = time.perf_counter()
    lib = _build.load()
    print(f"build: {_build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.2f} s ({lib._name})")

    k = phase_kernels(dev)
    tmp = tempfile.mkdtemp(prefix="tomojax_torch_smoke_")
    try:
        launches = phase_main_path(tmp)
        ka = phase_arc_kernels(dev)
        arc_launches, hist6 = phase_config4(tmp, dev)
        kr = phase_resample(dev)
        fast_launches, _ = phase_fast_align(tmp, dev)
        phase_config2(tmp, dev)
        ray_ms = phase_config1(tmp, dev)
        phase_exact_align(tmp, dev, ray_ms)
        phase_study(dev)
        c5_launches, bf16_plane_launches = phase_config5(tmp, dev)
        phase_default_calls(dev)
        kb = phase_bf16_kernels(dev)
        bf16_arc_launches = phase_bf16_align(tmp, dev, hist6)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def timing(ms, plain_ms, bnd, library_ms=None):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": library_ms}

    # library_ms is null for K1-K6: no single PyTorch call computes a slab
    # projection (it is a sum of gathers along rays)
    kernels = [
        {"name": "slab_plane_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "tomojax/kernels/slab.py:293",
         "launches": launches["fwd"] + c5_launches["fwd"],
         "max_abs_err": k["fwd_abs"],
         **timing(k["fwd"], k["fwd_plain"], k["bound"])},
        {"name": "slab_plane_adj", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "tomojax/kernels/slab.py:605",
         "launches": launches["adj"] + c5_launches["adj"],
         "max_abs_err": k["adj_abs"],
         **timing(k["adj"], k["adj_plain"], k["bound"])},
        {"name": "slab_arc_fwd", "route": "cuda", "source": ARC_SOURCE,
         "replaces": "tomojax/kernels/slab.py:293",
         "launches": arc_launches["fwd"], "max_abs_err": ka["fwd_abs"],
         **timing(ka["fwd"], ka["fwd_plain"], ka["bound"])},
        {"name": "slab_arc_adj", "route": "cuda", "source": ARC_SOURCE,
         "replaces": "tomojax/kernels/slab.py:605",
         "launches": arc_launches["adj"], "max_abs_err": ka["adj_abs"],
         **timing(ka["adj"], ka["adj_plain"], ka["bound"])},
        {"name": "slab_arc_jac", "route": "cuda", "source": ARC_SOURCE,
         "replaces": "tomojax/kernels/slab.py:446",
         "launches": arc_launches["jac"], "max_abs_err": ka["jac_abs"],
         **timing(ka["jac"], ka["jac_plain"], ka["bound_jac"])},
        # tomojax's single-field Jacobian entry (its _fwd_kernel with
        # deriv/jweight/rweight) is served by the K5 kernel: the entry
        # launches slab_arc_jac and returns one field. It is off the main
        # path (lm_slab takes the fused K5), so it counts its own launches,
        # and config 4 makes none.
        {"name": "slab_project_field", "route": "cuda",
         "served_by": "slab_arc_jac", "on_main_path": False,
         "source": ARC_SOURCE, "replaces": "tomojax/kernels/slab.py:293",
         "launches": arc_launches["field"], "max_abs_err": ka["field_abs"],
         **timing(ka["field"], ka["field_plain"], ka["bound_jac"])},
        {"name": "resample_fwd", "route": "cuda", "source": RESAMPLE_SOURCE,
         "replaces": "tomojax/kernels/resample.py:38",
         "launches": fast_launches["fwd"], "max_abs_err": kr["fwd_abs"],
         **timing(kr["fwd"], kr["fwd_plain"], kr["bound_fwd"],
                  kr["fwd_lib"])},
        {"name": "resample_transpose", "route": "cuda",
         "source": RESAMPLE_SOURCE,
         "replaces": "tomojax/kernels/resample.py:111",
         "launches": fast_launches["adj"], "max_abs_err": kr["adj_abs"],
         **timing(kr["adj"], kr["adj_plain"], kr["bound_adj"],
                  kr["adj_lib"])},
        # tomojax's non-differentiable direct entry is served by the K7
        # kernel, off the main path, with a counter of its own (0 there);
        # it is bit-equal to K7 on every phase-7 call, so its error is K7's
        {"name": "resample_raw", "route": "cuda", "served_by": "resample_fwd",
         "on_main_path": False, "source": RESAMPLE_SOURCE,
         "replaces": "tomojax/kernels/resample.py:356",
         "launches": fast_launches["raw"], "max_abs_err": kr["fwd_abs"],
         **timing(kr["raw"], kr["fwd_plain"], kr["bound_fwd"],
                  kr["fwd_lib"])},
    ]
    # the exact ray family's kernels replace no TPU kernel (tomojax's ray
    # family is a lax.scan); no single PyTorch call computes a ray march
    rk = ray_ms["kernels"]
    for kname, key in (("ray_fwd", "fwd"), ("ray_adj", "adj")):
        kernels.append({
            "name": kname, "route": "cuda", "source": RAY_SOURCE,
            "replaces": "none (ROADMAP P8)",
            "launches": ray_ms["launches"][key],
            "max_abs_err": rk[f"{key}_abs"],
            **timing(rk[key], rk[f"{key}_plain"], rk["bound"])})
    # the bf16 tier (phase 14): the bf16=True variants of the same two
    # Pallas kernels; K1b/K2b launched by 14b's CGLS, K3b/K4b by 14c's align
    for kname, quad, key, line, n in (
            ("slab_plane_fwd_bf16", "plane", "fwd", 293,
             bf16_plane_launches["fwd"]),
            ("slab_plane_adj_bf16", "plane", "adj", 605,
             bf16_plane_launches["adj"]),
            ("slab_arc_fwd_bf16", "arc", "fwd", 293,
             bf16_arc_launches["slab_arc_fwd_bf16"]),
            ("slab_arc_adj_bf16", "arc", "adj", 605,
             bf16_arc_launches["slab_arc_adj_bf16"])):
        e = kb[quad]
        kernels.append({
            "name": kname, "route": "cuda", "tier": "bf16",
            "design": "own",
            "source": KERNEL_SOURCE if quad == "plane" else ARC_SOURCE,
            "replaces": f"tomojax/kernels/slab.py:{line}",
            "variant": "bf16=True (tomojax/kernels/slab.py:"
                       f"{904 if key == 'fwd' else 1015})",
            "launches": n, "max_abs_err": e[f"{key}_abs"],
            **timing(e[key], e[f"{key}_plain"], e["bound"])})
    print(f"chip_smoke: {time.perf_counter() - t_script:.1f} s from the "
          "build to the kernels' line")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""tomojax's hardware gate for the bf16 tier (``check_bf16`` in
``scripts/tpu_kernel_check.py``) on the port's slab operators, with
readings of what sets its A/Aᵀ mismatch.

    python -m tomojax_torch.tools.bf16_gate [--size 64] [--draws 32]
        [--device cuda|cpu]

tomojax's problem: the Shepp phantom at ``size``³ in float32, 8 views over
the full circle with ±1.5 px shifts and ±0.012 rad tilts (its
``_views(8)``), one standard-normal cotangent per orientation group from
``default_rng(7)``, the arc groups then the plane groups. Its bars per
group: the bf16 forward within 3e-3 relative of the fp32 one, and the
mismatch |⟨Ax, y⟩ − ⟨x, Aᵀy⟩| / max(|⟨Ax, y⟩|, 1) (:func:`mismatch`)
within 5e-3. On a CUDA device the operators are the kernels (K1b-K4b
against K1-K4), on the CPU their plain versions.

One draw of that ratio divides a defect by a random sum: for a fixed x
and a standard-normal y, ⟨Ax, y⟩ is normal with mean 0 and spread |Ax|,
while the defect keeps its own size, so a draw with ⟨Ax, y⟩ near 0 reads
large whatever the pair. Beside each draw the tool prints ⟨Ax, y⟩, |Ax|,
the same measure for the bf16 forward with the fp32 adjoint, for the fp32
forward with the bf16 adjoint and for the fp32 pair, and the measure's
numerator and denominator pooled over ``--draws`` further cotangents
(:func:`pooled_mismatch`): the root mean square of the defect over that
of ⟨Ax, y⟩, which ``chip_smoke.py`` and the tests bound by 5e-3.

:func:`rounding_flips` reads what the adjoint's rounding of the pass-B
transpose does to a difference in fp32 arithmetic: the plain bf16 adjoint
in float32 and in float64, their rounded tables compared element by
element.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels import slab as slabk

TOL_FWD = 3e-3        # the bf16 forward against the fp32 one
TOL_MISMATCH = 5e-3   # tomojax's bar on the mismatch
GATE_SEED = 7         # tomojax's cotangent seed


def gate_views(n_proj: int = 8, device=None) -> Views:
    """tomojax's ``_views`` at its defaults: ``n_proj`` views over the full
    circle with uniform tilts in ±0.012 rad and shifts in ±1.5 px
    (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return Views.create(
        n_proj, phi=np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.012, 0.012, n_proj),
        beta=rng.uniform(-0.012, 0.012, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)), device=device)


def dot(a, b) -> float:
    return float(torch.dot(a.double().reshape(-1), b.double().reshape(-1)))


def mismatch(ax, y, x, aty) -> float:
    """tomojax's measure: |⟨Ax, y⟩ − ⟨x, Aᵀy⟩| / max(|⟨Ax, y⟩|, 1), the
    dot products in float64."""
    lhs = dot(ax, y)
    return abs(lhs - dot(x, aty)) / max(abs(lhs), 1.0)


def pooled_mismatch(ax, x, adj, shape, rng, draws: int) -> dict:
    """:func:`mismatch`'s defect and ⟨Ax, y⟩ over ``draws`` standard-normal
    cotangents of ``shape`` from ``rng`` (a numpy ``Generator``, or a
    ``torch.Generator`` on ``x``'s device; ``adj`` maps one to Aᵀy): the
    root mean square of the defect over that of ⟨Ax, y⟩ (``"pooled"``),
    the largest defect over |Ax| (``"max_defect"``) and the median and
    largest of the draws' :func:`mismatch` (``"median"``, ``"max"``)."""
    d, lhs = [], []
    for _ in range(draws):
        if isinstance(rng, torch.Generator):
            y = torch.randn(shape, generator=rng, dtype=x.dtype,
                            device=x.device)
        else:
            y = torch.as_tensor(rng.standard_normal(shape), dtype=x.dtype,
                                device=x.device)
        lhs.append(dot(ax, y))
        d.append(abs(lhs[-1] - dot(x, adj(y))))
    d, lhs = np.asarray(d), np.asarray(lhs)
    ratio = d / np.maximum(np.abs(lhs), 1.0)
    return {"pooled": float(np.sqrt(np.sum(d ** 2) / np.sum(lhs ** 2))),
            "max_defect": float(d.max() / torch.linalg.norm(ax)),
            "median": float(np.median(ratio)), "max": float(ratio.max())}


def group_readings(vol_or, sc, geom: Geometry, quad: str, y,
                   rng: np.random.Generator, draws: int) -> dict:
    """One orientation group: the bf16 forward against the fp32 one, and
    :func:`mismatch` on ``y`` for the bf16 pair, the bf16 forward with the
    fp32 adjoint, the fp32 forward with the bf16 adjoint and the fp32 pair,
    with ⟨Ax, y⟩ and |Ax| of the bf16 forward, and the bf16 pair's
    :func:`pooled_mismatch` over ``draws`` more cotangents."""
    ax_b = slabk.slab_project(vol_or, sc, geom, quad, prec="bf16")
    ax_f = slabk.slab_project(vol_or, sc, geom, quad, prec="f32x2")
    aty_b = slabk.slab_backproject(y, sc, geom, quad, prec="bf16")
    aty_f = slabk.slab_backproject(y, sc, geom, quad, prec="f32x2")
    return {
        "fwd_rel": float(torch.linalg.norm(ax_b - ax_f)
                         / torch.linalg.norm(ax_f)),
        "lhs": dot(ax_b, y), "ax_norm": float(torch.linalg.norm(ax_b)),
        "bf16": mismatch(ax_b, y, vol_or, aty_b),
        "bf16_fwd": mismatch(ax_b, y, vol_or, aty_f),
        "bf16_adj": mismatch(ax_f, y, vol_or, aty_b),
        "fp32": mismatch(ax_f, y, vol_or, aty_f),
        **pooled_mismatch(
            ax_b, vol_or, lambda g: slabk.slab_backproject(
                g, sc, geom, quad, prec="bf16"), tuple(y.shape), rng, draws),
    }


class _RecordRounding(torch.autograd.Function):
    """The identity, whose vjp rounds the cotangent to bfloat16 as
    ``slab_projector.round_cotangent`` does and appends the rounded table
    to ``store``."""

    @staticmethod
    def forward(ctx, t, store):
        ctx.store = store
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.store.append(g.to(torch.bfloat16))
        return sp.bf16_round(g), None


def rounding_flips(g, sc, geom: Geometry, quad: str) -> dict:
    """The plain bf16 adjoint of the cotangent ``g`` (one orientation
    group) in float32 and in float64, every rounded pass-B transpose
    recorded: the share of the tables' nonzero elements whose bf16 values
    differ (``"flips"``), the share of those one bf16 ulp apart
    (``"one_ulp"``), the relative L2 distance of the two bf16 adjoints
    (``"gap"``) and of the two fp32 adjoints (``"delta"``)."""
    out, tables = {}, {}
    for dtype in (torch.float32, torch.float64):
        store = []
        gd, scd = g.to(dtype), sc.to(dtype)
        out[dtype] = (
            sp.adjoint_oriented(sp.bf16_round(gd), scd, geom, quad,
                                table_hook=lambda t, s=store:
                                _RecordRounding.apply(t, s)).double(),
            slabk.slab_backproject_plain(gd, scd, geom, quad).double())
        tables[dtype] = store
    flips = one_ulp = nonzero = 0
    for a, c in zip(tables[torch.float32], tables[torch.float64]):
        diff = a != c
        flips += int(diff.sum())
        nonzero += int(((a != 0) | (c != 0)).sum())
        ia, ic = a.view(torch.int16).int(), c.view(torch.int16).int()
        one_ulp += int((diff & ((ia < 0) == (ic < 0))
                        & ((ia - ic).abs() == 1)).sum())
    (b32, f32), (b64, f64) = out[torch.float32], out[torch.float64]
    return {"flips": flips / nonzero, "one_ulp": one_ulp / max(flips, 1),
            "gap": float(torch.linalg.norm(b32 - b64) / torch.linalg.norm(b64)),
            "delta": float(torch.linalg.norm(f32 - f64)
                           / torch.linalg.norm(f64))}


def run(size: int, device, draws: int = 32) -> list:
    """tomojax's gate problem at ``size``³ → one :func:`group_readings`
    dict per orientation group (with ``quad`` and ``group``), in tomojax's
    order; the first cotangent of each group is tomojax's, the further
    draws come from ``default_rng([7, 1])``."""
    geom = Geometry(n_proj=8, vox_shape=(size,) * 3, det_shape=(size, size))
    views = gate_views(8, device=device)
    vol = torch.as_tensor(phantom.shepp3d(size), dtype=torch.float32,
                          device=device)
    rng = np.random.default_rng(GATE_SEED)
    more = np.random.default_rng([GATE_SEED, 1])
    out = []
    for quad in ("arc", "plane"):
        gs, scs = sp.scalar_groups(geom, views, quad, device=device)
        for (idx, sw, yf, uf), sc in zip(gs, scs):
            vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
            y = torch.as_tensor(rng.standard_normal((len(idx), size, size)),
                                dtype=torch.float32, device=device)
            out.append({"quad": quad, "group": [bool(sw), bool(yf), bool(uf)],
                        **group_readings(vol_or, sc, geom, quad, y, more,
                                         draws)})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.size, torch.device(args.device), args.draws)
    for r in rows:
        print(f"[bf16 {r['quad']}] group {tuple(r['group'])}: fwd rel "
              f"{r['fwd_rel']:.2e}; mismatch {r['bf16']:.2e} (<Ax,y> "
              f"{r['lhs']:.4g}, |Ax| {r['ax_norm']:.4g}); bf16 A + fp32 AT "
              f"{r['bf16_fwd']:.2e}, fp32 A + bf16 AT {r['bf16_adj']:.2e}, "
              f"fp32 pair {r['fp32']:.2e}; over {args.draws} draws: pooled "
              f"{r['pooled']:.2e}, largest defect / |Ax| "
              f"{r['max_defect']:.2e}, mismatch median {r['median']:.2e}, "
              f"largest {r['max']:.2e}")
    rec = {"size": args.size, "device": args.device, "draws": args.draws,
           "worst_fwd_rel": max(r["fwd_rel"] for r in rows),
           "worst_mismatch": max(r["bf16"] for r in rows),
           "worst_pooled": max(r["pooled"] for r in rows), "groups": rows}
    print(f"[bf16] worst fwd rel {rec['worst_fwd_rel']:.2e} (bound "
          f"{TOL_FWD}), worst A/At mismatch {rec['worst_mismatch']:.2e} "
          f"(bound {TOL_MISMATCH}: "
          f"{'PASS' if rec['worst_mismatch'] <= TOL_MISMATCH else 'FAIL'}), "
          f"worst pooled over {args.draws} draws {rec['worst_pooled']:.2e}")
    return rec


if __name__ == "__main__":
    main()

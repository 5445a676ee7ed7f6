"""What the program's spans and counters cost, and where the host waits on
the card, at config 5's shapes by default (512³, 1024 views of 512²).

    python -m tomojax_torch.tools.trace_cost [--device cuda] [--size 512]
        [--views 1024] [--chains 3] [--out trace_cost.json]

1. ``off``: host µs per :func:`~tomojax_torch.utils.profiling.span` (entered
   and left) and per ``count`` with the switch off and on, beside an empty
   loop's;
2. ``census`` (the card only): the host syncs of one CGLS init and one
   pair on the plane operator, of one CC view, of one slab LM step, and on
   the exact ray family of a SIRT solve of two iterations, one exact LM
   step and the moment hook's reprojection, each as
   ``torch.cuda.set_sync_debug_mode("warn")`` finds them (by the port's
   file and line that called the op) beside the program's ``host_sync.*``
   counters;
3. ``chain``: the CC chain over every view, in turns untraced (host µs per
   view, the chain ended by reading its offsets) and under
   ``profiling.tracing()`` (the mean ``cc.view`` span and its stages).

One JSON line per part; with ``--out`` the same in one JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import warnings

import numpy as np
import torch

from tomojax_torch.align import cc
from tomojax_torch.align.pipeline import _family_synth
from tomojax_torch.align.refine import refine_views
from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.recon.sirt import sirt
from tomojax_torch.utils import profiling

# the checkout's root: sites are named by their path below it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CC_STAGES = ("cc.correlate", "cc.refine", "cc.shift")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def off_cost(n_off: int = 1_000_000, n_on: int = 100_000) -> dict:
    """Host µs per call: an empty loop, ``span`` entered and left and
    ``count``, with the switch off and (inside ``tracing()``) on."""
    def per_call(body, n):
        t0 = time.perf_counter()
        body(n)
        return 1e6 * (time.perf_counter() - t0) / n

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with profiling.span("cc.view"):
                pass

    def counts(n):
        for _ in range(n):
            profiling.count("host_sync.x")

    out = {"loop_us": per_call(empty, n_off),
           "span_off_us": per_call(spans, n_off),
           "count_off_us": per_call(counts, n_off)}
    profiling.reset()
    with profiling.tracing():
        out["span_on_us"] = per_call(spans, n_on)
        out["count_on_us"] = per_call(counts, n_on)
    profiling.reset()
    return out


def views_config5(n_proj: int, device="cpu", seed: int = 0) -> Views:
    """Config 5's views: φ over [0, π], tx and tz uniform in ±2 px."""
    rng = np.random.default_rng(seed)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-2, 2, (n_proj, 2))
    return Views.create(n_proj, phi=np.linspace(0, np.pi, n_proj), t=t,
                        device=device)


def projections(n: int, n_proj: int, device, seed: int = 0):
    """``n_proj`` images of ``n``² for the chain: one smooth image of
    Gaussian blobs, shifted by up to ±2 px per view (Fourier shift)."""
    g = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float32),
                            torch.arange(n, dtype=torch.float32),
                            indexing="ij")
    img = torch.zeros((n, n))
    for cy, cx, w in (n * torch.rand((12, 3), generator=g)).tolist():
        img += torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                         / (2 * (2 + w / 8) ** 2))
    shifts = 4 * torch.rand((n_proj, 2), generator=g) - 2
    return cc.fourier_shift(img.to(device), shifts.to(device)).contiguous()


def census_jobs(n: int, n_proj: int, device) -> dict:
    """The units whose host syncs :func:`sync_census` finds, built and
    warmed up: ``{name: fn}``."""
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    views = views_config5(n_proj)
    op = make_operator(geom, views, family="slab_plane", device=device)
    b = torch.rand((n_proj, geom.n_det), device=device)
    state = cgls_init(op, b)
    state = cgls_steps(op, b, state, nsteps=1, niter=10)[0]
    pair = cc.cross_correlation_chain(projections(n, 2, device),
                                      upsample_factor=100)[1]
    # the driver's LM: views on the card, groups frozen beforehand
    m = min(n, 64)
    g_lm = Geometry(n_proj=8, vox_shape=(m,) * 3, det_shape=(m, m))
    v_lm = views_config5(8, device)
    groups = sp.scalar_groups(g_lm, v_lm, "arc")[0]
    vol = torch.rand(g_lm.vox_shape, device=device)
    meas = make_operator(g_lm, v_lm, family="slab", device=device).A(vol)

    def lm():
        refine_views_slab(vol, meas, g_lm, v_lm, max_iter=1, groups=groups)

    def pair_step():
        cgls_steps(op, b, state, nsteps=1, niter=10)

    # the exact ray family: 8 views, the hook's reprojection in chunks of 3
    r = min(n, 32)
    g_ray = Geometry(n_proj=8, vox_shape=(r,) * 3, det_shape=(r, r))
    op_ray = make_operator(g_ray, v_lm, family="ray", device=device)
    vol_ray = torch.rand(g_ray.vox_shape, device=device)
    b_ray = op_ray.A(vol_ray)
    ray = {"ray_sirt": lambda: sirt(op_ray, b_ray, niter=2, positivity=True),
           "ray_lm_step": lambda: refine_views(vol_ray, b_ray, g_ray, v_lm,
                                               max_iter=1),
           "ray_hook": lambda: _family_synth(vol_ray, g_ray, v_lm, "ray",
                                             None, torch.float32, 3)}
    lm()
    for fn in ray.values():
        fn()
    return {"cgls_init": lambda: cgls_init(op, b), "cgls_pair": pair_step,
            "cc_view": lambda: cc.cross_correlation_chain(
                pair, upsample_factor=100), "lm_step": lm, **ray}


def sync_census(fn) -> tuple:
    """``({site: warnings}, counters)`` of one call of ``fn``: CUDA's sync
    debug mode warns at every op that makes the host wait on the card; a
    site is the innermost frame of the checkout (below :data:`ROOT`) on the
    Python stack at the warning, ``file:line``."""
    sites = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(ROOT + os.sep)]
        site = (f"{os.path.relpath(ours[-1].filename, ROOT)}:"
                f"{ours[-1].lineno}" if ours else f"{filename}:{lineno}")
        sites[site] = sites.get(site, 0) + 1

    # the mode's first switch to "warn" in a process warns once itself
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    profiling.reset()
    with warnings.catch_warnings(), profiling.tracing():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counters = profiling.records()[1]
    profiling.reset()
    return sites, {k: v for k, v in counters.items()
                   if k.startswith("host_sync.")}


def chain_turns(p, chains: int, device) -> dict:
    """Host µs per view of the chain over ``p``, untraced and under
    ``profiling.tracing()``, in turns; the spans' means per view."""
    u = 100
    cc.cross_correlation_chain(p[:3], upsample_factor=u)
    untraced, traced, view, stages = [], [], [], {k: [] for k in CC_STAGES}
    for _ in range(chains):
        for on in (False, True):
            profiling.reset()
            _sync(device)
            t0 = time.perf_counter()
            with profiling.tracing() if on else contextlib.nullcontext():
                off, _ = cc.cross_correlation_chain(p, upsample_factor=u)
                off.cpu()
            us = 1e6 * (time.perf_counter() - t0) / (p.shape[0] - 1)
            (traced if on else untraced).append(us)
            if on:
                spans, _ = profiling.records()
                per = [s.t1 - s.t0 for s in spans if s.name == "cc.view"]
                view.append(1e6 * sum(per) / len(per))
                for k in CC_STAGES:
                    d = [s.t1 - s.t0 for s in spans if s.name == k]
                    stages[k].append(1e6 * sum(d) / len(per))
    profiling.reset()
    return {"views": p.shape[0] - 1, "untraced_view_us": untraced,
            "traced_view_us": traced, "cc_view_span_us": view,
            "stage_us": stages}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=1024)
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    out["off"] = off_cost()
    print(json.dumps({"off": out["off"]}), flush=True)
    if device.type == "cuda":
        out["census"] = {}
        for name, fn in census_jobs(args.size, args.views, device).items():
            sites, counters = sync_census(fn)
            out["census"][name] = {"sites": sites, "counters": counters}
            print(json.dumps({"census": name, "sites": sites,
                              "counters": counters}), flush=True)
    p = projections(args.size, args.views, device)
    out["chain"] = chain_turns(p, args.chains, device)
    print(json.dumps({"chain": out["chain"]}), flush=True)
    spans_per_view = len(CC_STAGES) + 1
    view_us = float(np.median(out["chain"]["untraced_view_us"]))
    out["off_share_of_view"] = (
        (spans_per_view * out["off"]["span_off_us"]
         + out["off"]["count_off_us"]) / view_us)
    print(json.dumps({"off_share_of_view": out["off_share_of_view"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

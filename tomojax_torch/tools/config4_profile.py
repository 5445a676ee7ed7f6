"""Where config 4's time goes: ``cli align`` (BASELINE config 4) for a few
outers, split by the driver's own spans (``align.recon``,
``align.refine``, ``align.hook``: :mod:`tomojax_torch.utils.profiling`),
with the LM's seconds per ``lm.*`` span, the host syncs (``host_sync.*``
counters) and the kernels' launch counts per outer, and
``torch.profiler`` over outer 1 (device time per kernel, busy share).

Each stage ends in a host sync of the driver (the solver's residual norm,
the refinement's cost, the hook's moments or θ copy), so its span holds
its device work too.

    python -m tomojax_torch.tools.config4_profile [--device cuda]
        [--size 256] [--views 90] [--outers 3] [--out profile.json]
        [--set align.KEY=VALUE ...]

One JSON line per outer, then the profiled outer's kernel table; with
``--out`` the same numbers go to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
from unittest import mock

import torch

import tomojax_torch.align as ta
from tomojax_torch import cli
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.utils import profiling

ALIGN_ARGS = [a for kv in (
    "align.pre_align_cc=true", "align.family=slab",
    "align.refine_method=lm_slab", "align.recon=cgls", "align.recon_iters=30",
    "align.refine_iters=10", "align.param_set=xzab", "align.moment_period=1",
    "align.accel_period=4") for a in ("--set", kv)]
COUNTED = {"K3": slabk.slab_arc_fwd, "K4": slabk.slab_arc_adj,
           "K5": slabk.slab_project_jac}


def simulate(tmp, size, views, device) -> str:
    """Config 4's dataset (arc, ±2 px / ±0.5°, seed 0) as ``.npz``."""
    data = os.path.join(tmp, "config4.npz")
    cli.main(["simulate", "--size", str(size), "--views", str(views),
              "--set", "simulate.family=slab",
              "--set", "simulate.max_shift_px=2",
              "--set", "simulate.max_angle_deg=0.5",
              "--set", "simulate.seed=0", "-o", data, "--device", device])
    return data


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--views", type=int, default=90)
    ap.add_argument("--outers", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="an align setting over config 4's (repeatable)")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    # the launch counts and host syncs before the first outer and at each
    # outer's end
    marks = []

    def mark():
        marks.append(({k: f.launches for k, f in COUNTED.items()},
                      profiling.host_syncs(profiling.records()[1])))

    align = ta.align_reconstruct

    def profiled_align(*a, callback=None, **k):
        def cb(it, views, volume, history):
            mark()
            if it == 0:
                prof.start()
            elif it == 1:
                prof.stop()
            if callback is not None:
                callback(it, views, volume, history)
        mark()
        return align(*a, callback=cb, **k)

    profiling.reset()
    with contextlib.ExitStack() as stack:
        # the profiled driver holds only inside this block
        stack.enter_context(mock.patch.object(ta, "align_reconstruct",
                                              profiled_align))
        stack.enter_context(profiling.tracing())
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        data = simulate(tmp, args.size, args.views, args.device)
        cli.main(["align", "-i", data, "-o", os.path.join(tmp, "vol.npy"),
                  "--device", args.device, *ALIGN_ARGS,
                  "--set", f"align.outer_iters={args.outers}",
                  *(a for kv in args.set for a in ("--set", kv))])
    spans, _ = profiling.records()

    rows = []
    outers = [i for i, s in enumerate(spans) if s.name == "align.outer"]
    for i, (j, (c0, h0), (c1, h1)) in enumerate(zip(outers, marks,
                                                    marks[1:])):
        # the callback (the profiler's start and stop) is charged to no
        # outer
        stage = profiling.child_seconds(spans, j)
        wall = spans[j].t1 - spans[j].t0 - stage.get("align.callback", 0.0)
        split = {"recon_s": stage.get("align.recon", 0.0),
                 "refine_s": stage.get("align.refine", 0.0),
                 "moment_match_s": stage.get("align.hook", 0.0)}
        rows.append({"outer": i, "wall_s": wall, **split,
                     "other_s": wall - sum(split.values()),
                     "lm_s": {k: v for k, v in
                              profiling.inner_seconds(spans, j).items()
                              if k.startswith("lm.")},
                     "host_syncs": h1 - h0,
                     "launches": {k: c1[k] - c0[k] for k in c1},
                     "profiled": i == 1})
        print(json.dumps(rows[-1]))

    # the spans' device ranges (user annotations) would count their
    # kernels again
    kern = sorted(((e.key, _self_device_us(e), e.count)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda k: -k[1])
    total_us = sum(k[1] for k in kern)
    prof_wall = rows[1]["wall_s"] if len(rows) > 1 else float("nan")
    busy = total_us / 1e6 / prof_wall
    print(f"outer 1 profiled: wall {prof_wall:.3f} s, device kernel time "
          f"{total_us / 1e6:.3f} s, busy share {busy:.4f}")
    for key, us, cnt in kern[:15]:
        print(f"  {us / 1e6:9.4f} s {100 * us / max(total_us, 1):6.2f}% "
              f"x{cnt:6d} {key[:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": (torch.cuda.get_device_name(0) if cuda
                                  else "cpu"),
                       "rows": rows, "prof_wall_s": prof_wall,
                       "kernel_s": total_us / 1e6,
                       "kernels": [(k, us / 1e6, c)
                                   for k, us, c in kern[:25]]},
                      f, indent=1)


if __name__ == "__main__":
    main()

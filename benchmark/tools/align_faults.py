"""Faults that the timed path of the cell ``c4.align`` can have, planted
under the program, and their readings at the cell's own size:

    python3 benchmark/tools/align_faults.py --seeds 3 --first-seed 9000 \\
        [--faults beta_frozen,hook_skipped] [--out faults.jsonl]

Each fault takes a ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or :func:`planted`'s, which undoes it) and
replaces one function of the program. A run is the cell's own set-up, a
window that closes once the check has what it needs, and the check with
every number the driver computes read and none held to a limit: one JSON
line per run, then per fault and number the smallest reading.
"""

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _mod(name):
    return importlib.import_module(f"tomojax_torch.{name}")


def beta_frozen(put):
    """The LM never moves β."""
    slab_refine = _mod("align.slab_refine")
    real = slab_refine._lm_group

    def group(vol_or, meas, cor, mask_f, *a):
        return real(vol_or, meas, cor,
                    mask_f * mask_f.new_tensor([1, 1, 1, 1, 1, 0]), *a)
    put(slab_refine, "_lm_group", group)


def cgls_step_unchanged(put):
    """The second CGLS iteration of every solve returns its state
    unchanged."""
    import torch
    real = _mod("recon.cgls").cgls_steps

    def steps(op, b, state, *, nsteps, niter, **kw):
        s = state
        while s.k < min(niter, state.k + nsteps) and s.stop == 0:
            new = real(op, b, s, nsteps=1, niter=niter, **kw)[0]
            s = type(s)(**{**vars(s), "k": new.k}) if s.k == 1 else new
        n = max(nsteps, 1)
        return s, torch.zeros(n), torch.zeros(n)
    put(_mod("align.pipeline"), "cgls_steps", steps)


def hook_skipped(put):
    """The moment hook corrects nothing."""
    import torch

    def match(meas, synth, det_shape):
        return torch.zeros(meas.shape[0], 2, dtype=torch.float64,
                           device=meas.device)
    put(_mod("align.pipeline"), "moment_match", match)


def half_the_views_unrefined(put):
    """Every other view keeps the parameters it came in with."""
    pipeline = _mod("align.pipeline")
    real = pipeline.refine_views_slab

    def refine(vol, proj, geom, views, **kw):
        r = real(vol, proj, geom, views, **kw)
        th = r.theta6.clone()
        th[1::2] = views.theta6()[1::2].to(th.dtype)
        return r._replace(theta6=th)
    put(pipeline, "refine_views_slab", refine)


def adjoint_half_the_views(put):
    """The arc adjoint sums the even views only, twice over."""
    sp = _mod("core.slab_projector")
    real = sp.backproject_scalars

    def back(sino, *a, **kw):
        keep = sino.clone().reshape(sino.shape[0], -1)
        keep[1::2] = 0.0
        return 2.0 * real(keep, *a, **kw)
    put(sp, "backproject_scalars", back)


FAULTS = {f.__name__: f for f in (beta_frozen, cgls_step_unchanged,
                                  hook_skipped, half_the_views_unrefined,
                                  adjoint_half_the_views)}


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted inside the block."""
    saved = []

    def put(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    fault(put)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), "c4.align")
    cell.mix["limits"] = {k: float("inf")
                          for k in harness.driver_of(cell).NUMBERS}
    dev = torch.device(args.device)
    rows = []
    for name in args.faults.split(","):
        for i in range(args.seeds):
            seed = args.first_seed + i
            t = time.perf_counter()
            with planted(FAULTS[name]):
                r = harness.run_cell(cell, seed, 0.0, False, dev, t)
            row = {"fault": name, "seed": seed,
                   "wall_s": time.perf_counter() - t,
                   "checks": {k: float(c["value"])
                              for k, c in r["checks"].items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    summary = {name: {k: min(r["checks"][k] for r in rows
                             if r["fault"] == name)
                      for k in rows[0]["checks"]}
               for name in {r["fault"] for r in rows}}
    print(json.dumps({"summary_min": summary}), flush=True)


if __name__ == "__main__":
    main()

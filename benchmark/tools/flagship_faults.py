"""Faults that the timed path of the cell ``c1.flagship`` can have, planted
under the program, and their readings at the cell's own size:

    python3 benchmark/tools/flagship_faults.py --seeds 3 --first-seed 9000 \\
        [--faults beta_frozen,hook_skipped] [--out faults.jsonl]

Each fault takes a ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr`` with ``raising=False``, or :func:`planted`'s, which
undoes it) and replaces one name the program looks up. A run is the
cell's own set-up, a window that closes once the check has what it needs,
and the check with every number the driver computes read and none held to
a limit: one JSON line per run, then per fault and number the smallest
reading.
"""

import argparse
import contextlib
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
_MISSING = object()


def _mod(name):
    return importlib.import_module(f"tomojax_torch.{name}")


def beta_frozen(put):
    """The exact LM never moves β."""
    pipeline = _mod("align.pipeline")
    real = pipeline.refine_views

    def refine(*a, mask=None, **kw):
        return real(*a, mask=tuple(bool(m) and i != 5
                                   for i, m in enumerate(mask)), **kw)
    put(pipeline, "refine_views", refine)


def hook_skipped(put):
    """The moment hook corrects nothing."""
    import torch

    def match(meas, synth, det_shape):
        return torch.zeros(meas.shape[0], 2, dtype=torch.float64,
                           device=meas.device)
    put(_mod("align.pipeline"), "moment_match", match)


def adjoint_half_the_views(put):
    """The ray adjoint sums the even views only, twice over."""
    projector = _mod("core.projector")
    real = projector.backproject_views

    def back(det_img, *a, **kw):
        keep = 2.0 * det_img.reshape(det_img.shape[0], -1)
        keep[1::2] = 0.0
        return real(keep, *a, **kw)
    put(projector, "backproject_views", back)


def sirt_stop_ignored(put):
    """SIRT's stop rule never fires: every solve runs its whole budget."""
    put(_mod("recon.sirt"), "bool", lambda _: False)


FAULTS = {f.__name__: f for f in (beta_frozen, hook_skipped,
                                  adjoint_half_the_views,
                                  sirt_stop_ignored)}


@contextlib.contextmanager
def planted(fault):
    """The program with ``fault`` planted inside the block."""
    saved = []

    def put(obj, name, value):
        saved.append((obj, name, getattr(obj, name, _MISSING)))
        setattr(obj, name, value)
    fault(put)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            if value is _MISSING:
                delattr(obj, name)
            else:
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

    cell = harness.resolve_cell(harness.load_spec(), "c1.flagship")
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

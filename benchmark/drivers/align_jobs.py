"""Joint alignment and reconstruction jobs back to back (traffic kind
``align_jobs``).

Set-up makes the phantom on the device, the views' true 6-DoF jitter from
the seed and the measured sinogram with the plain arc reference (so the
data owes nothing to the program), then warms up every shape of a job with
one short job (``mix["warmup"]``: one outer that takes the flip rescue
too) and forgets it. Each step of the window is one whole job as ``cli
align`` runs it: the centre-of-mass pre-alignment (``com_align``), then
``align_reconstruct`` with the mix's ``align`` settings and the box of
``±bound_trans`` px and ``±bound_angle`` rad around the pre-aligned views.
A callback (``align_reconstruct``'s own) keeps the state the check needs
and each outer's end on the host clock.

The check follows the last job from that state, with the plain reference
(``reference/arc.py``, ``reference/cgls_from.py``, ``reference/lm.py``) on
the orientation frames that the program froze at its first outer:

- ``recon_rel``: outer k's volume (k drawn from the seed among the outers
  that neither flip nor extrapolate) against the reference's CGLS from
  outer k − 1's volume at outer k − 1's views;
- ``theta_gap_mean``: outer k's refined parameters against the
  reference's LM and moment hook from outer k − 1's views on outer k's
  volume, in px at the detector edge (tx and tz as they are, α and β
  times half the detector width), the mean over every view's refined
  parameters;
- ``truth_gap_px``: the job's final parameters against the true jitter,
  the mean of the same px gaps, with the rigid gauge (tx's fit on {cos φ,
  sin φ}, tz's mean) taken out.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness import Phases, forget_peak
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.rigid6 import jittered6
from benchmark.inputs.views import MASK
from benchmark.reference import lm
from benchmark.reference.arc import ArcOperator, flags
from benchmark.reference.cgls_from import solve_from
from benchmark.reference.compare import rel

NUMBERS = ("recon_rel", "theta_gap_mean", "truth_gap_px")
# the divergence guard's slack of the program's fp32 tier
GUARD_TOL = 0.0
LM_BLOCK_VIEWS = 4


def setup(cell, seed, device, *, trace=False, variant=None):
    return AlignJobs(cell, seed, device, variant)


def checked_outers(outer_iters: int, accel_period) -> list:
    """The outers k ≥ 1 whose refinement neither runs the flip rescue nor
    is followed by an Aitken jump (with ``accel_period`` both fall on the
    outers k with (k + 1) a multiple of it)."""
    return [k for k in range(1, outer_iters)
            if not accel_period or (k + 1) % accel_period]


class AlignJobs:
    def __init__(self, cell, seed, device, variant):
        from tomojax_torch.align import align_reconstruct, com_align
        from tomojax_torch.core.geometry import Geometry, Views
        from tomojax_torch.kernels import slab as slabk
        from tomojax_torch.utils import profiling

        phases = Phases(device)
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.truth = jittered6(cfg, seed)
        n = self.n_views = cfg["n_proj"]
        nu, nv = cfg["det_shape"]
        data = ArcOperator(cfg, self.truth, device)
        self.b = data.A(shepp3d(cfg["vox_shape"], device))
        del data
        forget_peak(device)
        phases.mark("data")
        self._align, self._com = align_reconstruct, com_align
        self._views = Views
        self.geom = Geometry(n_proj=n, vox_shape=tuple(cfg["vox_shape"]),
                             det_shape=(nu, nv))
        self.opts = dict(mix["align"])
        if variant == "control":
            self.opts.update(mix["control"])
        lo = np.array([-mix["bound_trans"]] * 3
                      + [-np.inf] + [-mix["bound_angle"]] * 2, np.float32)
        self.bounds = (lo, -lo)
        self.counted = {"k4_launches": slabk.slab_arc_adj,
                        "k5_launches": slabk.slab_project_jac}
        self.k = int(np.random.default_rng([seed & MASK, 11]).choice(
            checked_outers(self.opts["outer_iters"],
                           self.opts["accel_period"])))
        self.caught = None
        self.outer_t = []
        # warm-up: every shape of a job, the flip rescue's too; then forget
        self._job(dict(self.opts, **mix["warmup"]), {})
        profiling.reset()
        self.outer_t = []
        phases.mark("warm-up")

    def _job(self, opts: dict, keep: dict):
        """One job; ``keep`` gets what the check needs of its outers."""
        n = self.n_views
        k = self.k

        def callback(it, views, volume, history):
            self.outer_t.append(time.perf_counter())
            if it in (k - 1, k):
                keep[it] = (views.theta6().clone(), volume.clone())

        phi = self.truth[:, 3]
        est = self._com(self.b, self.geom, phi, device=self.device)
        t0 = np.zeros((n, 3), np.float32)
        t0[:, [0, 2]] = est.cpu().numpy()
        views0 = self._views.create(n, phi=phi, t=t0, device=self.device)
        state = self._align(self.b.reshape(n, -1), self.geom, views0,
                            bounds=self.bounds, device=self.device,
                            callback=callback, **opts)
        keep["start"] = views0.theta6()
        keep["final"] = state.views.theta6()
        return keep

    def step(self) -> dict:
        launches = {name: fn.launches for name, fn in self.counted.items()}
        self.caught = self._job(self.opts, {})
        counts = {name: fn.launches - launches[name]
                  for name, fn in self.counted.items()}
        return dict(counts, jobs=1, outers=self.opts["outer_iters"],
                    views=self.n_views)

    def ready(self) -> bool:
        return self.caught is not None

    def readings(self) -> dict:
        start = self.caught["start"].double().cpu()
        groups = len({tuple(f) for f in flags(start, self.cfg["vox_shape"],
                                              self.cfg["det_shape"])})
        return {"views": self.n_views, "groups": groups,
                "outer_t": list(self.outer_t)}

    def check(self) -> list:
        """Free the program's state, then compare (name, value, limit) for
        each number in ``mix["limits"]``."""
        c = self.caught
        self.caught = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        cfg, opts, dev = self.cfg, self.opts, self.device
        shape, det = cfg["vox_shape"], cfg["det_shape"]
        start = c["start"]
        flg = flags(start.double().cpu(), shape, det)
        iters = opts["recon_iters"]
        b = self.b
        got = {}
        th_prev, vol_prev = c[self.k - 1]
        th_k, vol_k = c[self.k]
        op = ArcOperator(cfg, th_prev, dev, flg)
        x = solve_from(op.A, op.AT, b, vol_prev, iters, GUARD_TOL)
        got["recon_rel"] = rel(vol_k, x)
        del op, x
        # the box as the program computes it: float32 offsets on float32
        lo_off, hi_off = (torch.as_tensor(a, device=dev) for a in self.bounds)
        lo, hi = start + lo_off, start + hi_off
        cols = lm.PARAM_SETS[opts["param_set"]]
        op = ArcOperator(cfg, th_prev, dev, flg, block=LM_BLOCK_VIEWS)
        th = lm.refine(op, vol_k, b, th_prev, lo, hi, cols,
                       opts["refine_iters"])
        th = lm.moment_hook(op, vol_k, b, th, lm.support_mask(b, shape),
                            lo, hi)
        got["theta_gap_mean"] = float(self._px(th_k.double() - th).mean())
        d = c["final"].double() - torch.as_tensor(self.truth, device=dev)
        phi = torch.as_tensor(self.truth[:, 3], device=dev)
        basis = torch.stack([torch.cos(phi), torch.sin(phi)], 1)
        d[:, 0] -= basis @ (torch.linalg.pinv(basis) @ d[:, 0])
        d[:, 2] -= d[:, 2].mean()
        got["truth_gap_px"] = float(self._px(d).mean())
        print(f"check seconds (k = {self.k}): {time.perf_counter() - t:.3f}",
              file=sys.stderr, flush=True)
        limits = self.mix["limits"]
        return [(k, got[k], float(limits[k])) for k in NUMBERS if k in limits]

    def _px(self, d):
        """|gaps| of the refined parameters in px at the detector edge:
        tx, tz as they are, α and β times half the detector width."""
        half = self.cfg["det_shape"][0] / 2.0
        cols = list(lm.PARAM_SETS[self.opts["param_set"]])
        w = torch.tensor([1.0, 1.0, 1.0, half, half, half],
                         dtype=d.dtype, device=d.device)
        return (d.abs() * w)[:, cols]

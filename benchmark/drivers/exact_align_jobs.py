"""Whole alignment jobs on the exact ray family, handed out one outer at a
time (traffic kind ``exact_align_jobs``).

Set-up makes the phantom on the device, the views' true 6-DoF jitter from
the seed and the measured sinogram with the plain ray reference (float64,
then rounded to the float32 the program reads), so the data owes nothing
to the program; then it runs one short job (``mix["warmup"]``) and forgets
it. A job is ``align_reconstruct`` with the mix's ``align`` settings (``cli
align``'s defaults) from the views' known angles and zero jitter, with no
pre-alignment and no ground truth, in the box of ``±bound_trans`` px and
``±bound_angle`` rad around that start. It runs uninterrupted on a worker
thread, and its own callback hands out the outers: the thread waits in the
callback until the next step releases it. One step is one outer; the job
is ready only between jobs, so the window closes at a job boundary and
holds whole jobs, back to back, one at a time.

The check follows the last job with the plain reference
(``reference/ray.py``, ``reference/sirt_from.py``,
``reference/lm_exact.py``), in float64:

- ``recon_rel``: outer k's volume (k ≥ 1, drawn from the seed) against
  the reference's SIRT from outer k − 1's volume at outer k − 1's views,
  at the program's iteration count (the reference's iterate nearest the
  program's volume);
- ``sirt_iters_gap``: the gap between that count and the count at which
  the reference's own stop rule ends the same solve;
- ``theta_gap_mean``: outer k's refined (tx, tz, α, β) against the
  reference's LM and moment hook from outer k − 1's views on outer k's
  volume, in px at the detector edge (α, β times half the detector width),
  the mean over every view's refined parameters;
- ``truth_gap_px``: the job's final parameters against the true jitter,
  the mean of the same px gaps, with the rigid gauge (tx's fit on {cos φ,
  sin φ}, tz's mean) taken out.

The mix's ``control`` (``"sirt": "bf16"``) puts the reference's SIRT
recursion, every vector rounded to bfloat16, on the program's operator in
the place of the program's SIRT.
"""

from __future__ import annotations

import importlib
import queue
import sys
import threading
import time

import numpy as np
import torch

from benchmark.harness import Phases, forget_peak
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.rigid6 import jittered6
from benchmark.inputs.views import MASK
from benchmark.reference import lm, lm_exact, sirt_from
from benchmark.reference.compare import rel
from benchmark.reference.ray import RayOperator

NUMBERS = ("recon_rel", "sirt_iters_gap", "theta_gap_mean", "truth_gap_px")


def setup(cell, seed, device, *, trace=False, variant=None):
    return ExactAlignJobs(cell, seed, device, variant)


class _Handout:
    """One job at a time on a worker thread, paused in its callback after
    each outer: ``go()`` starts a job or releases its callback, then
    ``next()`` gives ``("outer", (it, θ, volume))``, or ``("done",
    state)`` once the call has returned."""

    def __init__(self, run):
        self._run = run
        self._go = queue.Queue()
        self._out = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="exact-align-job")
        self._thread.start()

    def _loop(self):
        while self._go.get():
            try:
                self._out.put(("done", self._run(self._callback)))
            except Exception as e:  # noqa: BLE001 - raised by next()
                self._out.put(("error", e))

    def _callback(self, it, views, volume, history):
        self._out.put(("outer", (it, views.theta6().clone(),
                                 volume.clone())))
        if not self._go.get():
            raise RuntimeError("the job was closed inside an outer")

    def go(self):
        self._go.put(True)

    def next(self):
        kind, payload = self._out.get()
        if kind == "error":
            raise payload
        return kind, payload

    def close(self):
        self._go.put(False)
        self._thread.join(timeout=60)


def _bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def _control_sirt(op, b, *, niter, x0=None, ground_truth=None,
                  positivity=False):
    """The reference's SIRT recursion on the program's operator, every
    vector rounded to bfloat16, with the program's stop rule on the
    residual (the traffic passes no ground truth) and its result type."""
    from tomojax_torch.recon.sirt import SIRTResult

    dev, dt = op.device, op.dtype
    b = torch.as_tensor(b, dtype=dt, device=dev).reshape(op.geom.n_proj, -1)
    x = (torch.zeros(op.vol_shape, dtype=dt, device=dev) if x0 is None
         else torch.as_tensor(x0, dtype=dt, device=dev).reshape(op.vol_shape))
    errors, stopped = [], False
    for _, x, e in sirt_from.iterates(op.A, op.AT, b, x, niter, positivity,
                                      _bf16):
        errors.append(e)
        stopped = len(errors) > 1 and errors[-1] > errors[-2]
        if stopped:
            break
    rms = torch.zeros(niter, dtype=dt, device=dev)
    rms[:len(errors)] = torch.tensor(errors, dtype=dt)
    return SIRTResult(x=x, rms_error=rms, convergence=rms * 0.0,
                      n_iter=len(errors), stop_reason=int(stopped))


CONTROLS = {"bf16": _control_sirt}


class ExactAlignJobs:
    """The cell's inputs, its job on the hand-out thread, and the check."""

    def __init__(self, cell, seed, device, variant):
        from tomojax_torch.align import align_reconstruct
        from tomojax_torch.core.geometry import Geometry, Views
        from tomojax_torch.utils import profiling

        phases = Phases(device)
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.truth = jittered6(cfg, seed)
        n = self.n_views = cfg["n_proj"]
        nu, nv = cfg["det_shape"]
        ref = RayOperator(cfg, device)
        self.b = ref.A(shepp3d(cfg["vox_shape"], device, torch.float64),
                       self.truth).float()
        del ref
        forget_peak(device)
        phases.mark("data")
        self.geom = Geometry(n_proj=n, vox_shape=tuple(cfg["vox_shape"]),
                             det_shape=(nu, nv))
        self.views0 = Views.create(n, phi=self.truth[:, 3], device=device)
        self.opts = dict(mix["align"])
        lo = np.array([-mix["bound_trans"]] * 3
                      + [-np.inf] + [-mix["bound_angle"]] * 2, np.float32)
        self.bounds = (lo, -lo)
        self.k = int(np.random.default_rng([seed & MASK, 11]).integers(
            1, self.opts["outer_iters"]))
        self._pipeline = importlib.import_module(
            "tomojax_torch.align.pipeline")
        self._real_sirt = self._pipeline.sirt
        if variant == "control":
            self._pipeline.sirt = CONTROLS[mix["control"]["sirt"]]
        self._align = align_reconstruct
        self._job_opts = dict(self.opts, **mix["warmup"])
        self.handout = _Handout(self._run)
        self.running, self.keep, self.caught = False, {}, None
        # warm-up: the job's every stage on the worker thread; then forget
        while self._job_opts["outer_iters"] and not self.step()["jobs"]:
            pass
        self._job_opts = self.opts
        self.caught = None
        profiling.reset()
        phases.mark("warm-up")

    def _run(self, callback):
        return self._align(self.b.reshape(self.n_views, -1), self.geom,
                           self.views0, bounds=self.bounds,
                           device=self.device, callback=callback,
                           **self._job_opts)

    def step(self) -> dict:
        if not self.running:
            self.running, self.keep = True, {}
        self.handout.go()
        _, (it, theta, volume) = self.handout.next()
        self.keep[it] = (theta, volume)
        last = it == self._job_opts["outer_iters"] - 1
        if last:
            self.handout.go()
            _, state = self.handout.next()
            self.keep["final"] = state.views.theta6()
            self.caught, self.running = self.keep, False
        return {"outers": 1, "jobs": int(last)}

    def ready(self) -> bool:
        return self.caught is not None and not self.running

    def readings(self) -> dict:
        return {}

    def close(self):
        """End the worker and put the program's SIRT back."""
        self.handout.close()
        self._pipeline.sirt = self._real_sirt

    def check(self) -> list:
        """End the worker, then compare (name, value, limit) for each
        number in ``mix["limits"]``."""
        c = self.caught
        self.caught = None
        self.close()
        t = time.perf_counter()
        cfg, opts, dev = self.cfg, self.opts, self.device
        ref = RayOperator(cfg, dev)
        b = self.b.double()
        start = self.views0.theta6()
        got = {}
        th_prev, vol_prev = c[self.k - 1]
        th_k, vol_k = c[self.k]
        nearest, count, errors = float("inf"), 0, []
        for n, x, e in sirt_from.iterates(
                lambda x: ref.A(x, th_prev), lambda y: ref.AT(y, th_prev),
                b, vol_prev.double(), opts["recon_iters"],
                opts["positivity"]):
            errors.append(e)
            d = rel(vol_k, x)
            if d < nearest:
                nearest, count = d, n
        stop = sirt_from.stop_count(errors)
        got["recon_rel"] = nearest
        got["sirt_iters_gap"] = float(abs(count - stop))
        lo_off, hi_off = (torch.as_tensor(a, device=dev) for a in self.bounds)
        lo, hi = start + lo_off, start + hi_off
        th = lm_exact.refine(ref, vol_k.double(), b, th_prev, lo, hi,
                             lm.PARAM_SETS[opts["param_set"]],
                             opts["refine_iters"])
        mask = lm.support_mask(b.reshape(-1, *cfg["det_shape"]),
                               cfg["vox_shape"])
        th = lm_exact.moment_hook(ref, vol_k.double(), b, th, mask, lo, hi)
        got["theta_gap_mean"] = float(self._px(th_k.double() - th).mean())
        d = c["final"].double() - torch.as_tensor(self.truth, device=dev)
        phi = torch.as_tensor(self.truth[:, 3], device=dev)
        basis = torch.stack([torch.cos(phi), torch.sin(phi)], 1)
        d[:, 0] -= basis @ (torch.linalg.pinv(basis) @ d[:, 0])
        d[:, 2] -= d[:, 2].mean()
        got["truth_gap_px"] = float(self._px(d).mean())
        print(f"check seconds (k = {self.k}): {time.perf_counter() - t:.3f}; "
              f"SIRT iterations of outer k: the program's {count}, the "
              f"reference's stop {stop}", file=sys.stderr, flush=True)
        limits = self.mix["limits"]
        return [(k, got[k], float(limits[k])) for k in NUMBERS if k in limits]

    def _px(self, d):
        """|gaps| of (tx, tz, α, β) in px at the detector edge: tx, tz as
        they are, α and β times half the detector width."""
        half = self.cfg["det_shape"][0] / 2.0
        w = torch.tensor([1.0, 1.0, 1.0, half, half, half],
                         dtype=d.dtype, device=d.device)
        return (d.abs() * w)[:, list(lm.PARAM_SETS[self.opts["param_set"]])]

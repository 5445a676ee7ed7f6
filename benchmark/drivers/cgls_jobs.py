"""CGLS jobs back to back on the plane slab operator (traffic kind
``cgls_jobs``).

Set-up makes the configuration's phantom and views from the seed, the
measured sinogram with the plain reference operator (so the data owes
nothing to the program), and the program's operator
(``make_operator(family="slab_plane", prec=mix["prec"])``), then warms
up its shapes with one init and one iteration. Each step of the window is
one forward-adjoint pair of the program's solver
(``recon.cgls.cgls_init`` or ``cgls_steps(nsteps=1)``): jobs of
``mix["iters"]`` iterations from x = 0, each with its init pair.

The check compares the final iterate of the window's last complete job
with the reference's own CGLS from the same data (float32, so the bf16
tier is held to the distance of its rounding), and follows the solver
from its own state: the init of the window's last job (``p0 = Aᵀ b``)
and the iteration ``k`` (drawn from the seed) of the last job that ran
it, whose forward and adjoint outputs, residual and direction the
reference works out again from the program's state before the step, in
the mix's ``ref_tier``.

A traced run times each forward and adjoint with CUDA events.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from benchmark.harness import Phases, forget_peak
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.views import MASK, jittered
from benchmark.reference import cgls as ref
from benchmark.reference.compare import rel, worst_row_rel
from benchmark.reference.plane import PlaneOperator

# every number the check computes; the mix's ``limits`` says which are
# compared
NUMBERS = ("iter_rel", "start_adj_rel", "fwd_view_rel", "adj_rel",
           "step_x_rel", "step_r_rel", "step_p_rel")


def setup(cell, seed, device, *, trace=False, variant=None):
    return CGLSJobs(cell, seed, device, trace, variant)


class CGLSJobs:
    def __init__(self, cell, seed, device, trace, variant):
        from tomojax_torch.core.geometry import Geometry, Views
        from tomojax_torch.core.operators import make_operator

        phases = Phases(device)
        self.solver = importlib.import_module("tomojax_torch.recon.cgls")
        cfg, mix = cell.config, cell.mix
        self.cfg, self.mix, self.device = cfg, mix, device
        self.timed = trace and device.type == "cuda"
        self.phi, self.t = jittered(cfg, seed)
        n = self.n_views = cfg["n_proj"]
        data = PlaneOperator(cfg, self.phi, self.t, device)
        with torch.no_grad():
            self.b = data.A(shepp3d(cfg["vox_shape"], device)).reshape(n, -1)
        del data
        forget_peak(device)
        phases.mark("data")
        geom = Geometry(n_proj=n, vox_shape=tuple(cfg["vox_shape"]),
                        det_shape=tuple(cfg["det_shape"]))
        views = Views.create(n, phi=self.phi, t=self.t, device=device)
        control = mix["control"] if variant == "control" else {}
        op = make_operator(geom, views, family="slab_plane",
                           prec=control.get("prec", mix["prec"]),
                           device=device)
        if "tier" in control:
            # the reference in the program's place, in a lower precision
            low = PlaneOperator(cfg, self.phi, self.t, device,
                                control["tier"])
            op = dataclasses.replace(
                op, A=lambda x: low.A(x).reshape(n, -1), AT=low.AT)
        phases.mark("operator")
        self._A, self._AT = op.A, op.AT
        self.op = dataclasses.replace(op, A=self.A, AT=self.AT)
        self.iters = mix["iters"]
        self.k_check = int(np.random.default_rng([seed & MASK, 7]).integers(
            0, self.iters))
        self.times = {"A": [], "AT": []}
        self.calls = []
        # warm-up: every shape the window uses, then forget it
        state = self.solver.cgls_init(self.op, self.b)
        self.solver.cgls_steps(self.op, self.b, state, nsteps=1,
                               niter=self.iters,
                               reinit_tol=mix["reinit_tol"])
        phases.mark("warm-up")
        self.times = {"A": [], "AT": []}
        self.state = None
        self.start = None
        self.caught = None
        self.final = None

    def _call(self, name, fn, x):
        if not self.timed:
            y = fn(x)
        else:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            y = fn(x)
            e1.record()
            self.times[name].append((e0, e1))
        self.calls.append((x, y))
        return y

    def A(self, x):
        return self._call("A", self._A, x)

    def AT(self, y):
        return self._call("AT", self._AT, y)

    def step(self) -> dict:
        s = self.state
        self.calls = []
        if s is None or s.k >= self.iters or s.stop != 0:
            with torch.profiler.record_function("cgls_init"):
                self.state = self.solver.cgls_init(self.op, self.b)
            self.start = self.state
        else:
            with torch.profiler.record_function("cgls_steps"):
                self.state = self.solver.cgls_steps(
                    self.op, self.b, s, nsteps=1, niter=self.iters,
                    reinit_tol=self.mix["reinit_tol"])[0]
            if self.state.k == self.iters:
                self.final = self.state.x
            if s.k == self.k_check:
                # the step's first forward is A p, its last adjoint
                # Aᵀ of the new residual (or of a re-initialized one)
                self.caught = (s, self.state, self.calls[0],
                               self.calls[-1])
        return {"pairs": 1, "proj": self.n_views}

    def ready(self) -> bool:
        return self.caught is not None and self.final is not None

    def readings(self) -> dict:
        ms = {k: [a.elapsed_time(b) for a, b in v]
              for k, v in self.times.items()}
        return {"A_ms": ms["A"], "AT_ms": ms["AT"], "views": self.n_views}

    def check(self) -> list:
        """Free the program's operator, then compare (name, value,
        limit) for each number in ``mix["limits"]``."""
        before, after, (a_in, a_out), (at_in, at_out) = self.caught
        start = self.start
        self.op = self._A = self._AT = self.state = None
        self.calls, self.times = [], {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n = self.n_views
        got = {}
        with torch.no_grad():
            f32 = PlaneOperator(self.cfg, self.phi, self.t, self.device)
            got["iter_rel"] = rel(self.final, ref.solve(
                f32.A, f32.AT, self.b, self.iters))
            plain = (f32 if self.mix["ref_tier"] == "f32" else
                     PlaneOperator(self.cfg, self.phi, self.t, self.device,
                                   self.mix["ref_tier"]))
            del f32
            got["start_adj_rel"] = rel(start.p, plain.AT(self.b))
            q = plain.A(before.p).reshape(n, -1)
            got["fwd_view_rel"] = worst_row_rel(a_out, q)
            if after.reinit_iter == before.k:
                # the step re-initialized from x: r = b - A x, p = Aᵀ r
                r = self.b.double() - plain.A(before.x).reshape(n, -1)
                got["step_x_rel"] = rel(after.x, before.x)
                got["step_r_rel"] = rel(after.r, r)
                got["adj_rel"] = rel(at_out, plain.AT(at_in))
                got["step_p_rel"] = rel(after.p, plain.AT(r.float()))
            else:
                gamma = float(before.gamma)
                alpha = gamma / ref.sqnorm(q)
                got["step_x_rel"] = rel(after.x.double() - before.x,
                                            alpha * before.p.double())
                got["step_r_rel"] = rel(after.r.double() - before.r,
                                            -alpha * q.double())
                s = plain.AT(at_in)
                got["adj_rel"] = rel(at_out, s)
                got["step_p_rel"] = rel(
                    after.p, ref.direction(s, before.p, gamma))
        limits = self.mix["limits"]
        return [(k, got[k], float(limits[k])) for k in NUMBERS if k in limits]

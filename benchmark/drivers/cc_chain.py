"""Cross-correlation chains back to back over a configuration's sinogram
(traffic kind ``cc_chain``).

Set-up makes the phantom and the jittered views from the seed and the
sinogram with the plain reference operator, then warms up the chain's
shapes on its first views. Each step of the window is one
``align.cc.cross_correlation_chain(projections, upsample_factor=u)`` over
all views, its offsets read back to the host.

The check follows the window's last chain pair by pair from its own
state: each view's offset against the reference registration of that
view to the program's aligned predecessor (float64), and each aligned
view against the reference's shift of the view by the program's offset.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.harness import Phases, forget_peak
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.views import jittered
from benchmark.reference import cc as ref_cc
from benchmark.reference.compare import worst_row_rel
from benchmark.reference.plane import PlaneOperator

# every number the check computes; the mix's ``limits`` says which are
# compared
NUMBERS = ("shift_gap_px", "shift_gap_mean_px", "aligned_view_rel")
WARM_VIEWS = 3
CHECK_BLOCK = 32


def setup(cell, seed, device, *, trace=False, variant=None):
    return CCChains(cell, seed, device, variant)


class CCChains:
    def __init__(self, cell, seed, device, variant):
        phases = Phases(device)
        self.cc = importlib.import_module("tomojax_torch.align.cc")
        cfg, mix = cell.config, cell.mix
        self.mix, self.device = mix, device
        phi, t = jittered(cfg, seed)
        nu, nv = cfg["det_shape"]
        data = PlaneOperator(cfg, phi, t, device)
        with torch.no_grad():
            self.proj = data.A(shepp3d(cfg["vox_shape"], device)).reshape(
                cfg["n_proj"], nu, nv).contiguous()
        del data
        forget_peak(device)
        phases.mark("data")
        self.u = mix["upsample"]
        self.run = self._program
        if variant == "control":
            # the reference in the program's place, reading bf16 images
            rnd = getattr(torch, mix["control"]["round_to"])
            self.run = lambda p: ref_cc.chain(p, self.u, rnd)
        self.run(self.proj[:WARM_VIEWS])
        phases.mark("warm-up")
        self.last = None

    def _program(self, p):
        return self.cc.cross_correlation_chain(p, upsample_factor=self.u)

    def step(self) -> dict:
        with torch.profiler.record_function("cross_correlation_chain"):
            off, aligned = self.run(self.proj)
            off.cpu()
        self.last = (off, aligned)
        return {"chains": 1, "views": self.proj.shape[0] - 1}

    def ready(self) -> bool:
        return self.last is not None

    def readings(self) -> dict:
        return {}

    def check(self) -> list:
        off, aligned = self.last
        p = self.proj
        n = p.shape[0]
        gaps = [(off[0].double().abs()).max()]
        rels = [worst_row_rel(aligned[:1], p[:1])]
        with torch.no_grad():
            for i0 in range(1, n, CHECK_BLOCK):
                i1 = min(i0 + CHECK_BLOCK, n)
                prev = aligned[i0 - 1:i1 - 1].double()
                img = p[i0:i1].double()
                s = ref_cc.register(prev, img, self.u)
                gaps.append((off[i0:i1].double() - s).abs().amax(-1))
                want = ref_cc.fourier_shift(img, off[i0:i1].double())
                rels.append(worst_row_rel(aligned[i0:i1], want))
        gap = torch.cat([g.reshape(-1) for g in gaps])
        got = {"shift_gap_px": float(gap.max()),
               "shift_gap_mean_px": float(gap.mean()),
               "aligned_view_rel": max(rels)}
        limits = self.mix["limits"]
        return [(k, got[k], float(limits[k])) for k in NUMBERS if k in limits]

"""The exact ray family, SIRT and the exact LM of the port against the
benchmark's plain reference of them (``benchmark/reference/ray.py``,
``sirt_from.py``, ``lm_exact.py``: the published definitions, written with
``grid_sample`` and autograd, importing nothing of the port), in float64
at 16³ × 12 seeded views; the hand-out of a job outer by outer; and the
spans and counters of the ray path."""

from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.rigid6 import jittered6
from benchmark.reference import lm, lm_exact, sirt_from
from benchmark.reference.compare import rel
from benchmark.reference.ray import RayOperator
from tomojax_torch.align.pipeline import align_reconstruct
from tomojax_torch.align.refine import refine_views
from tomojax_torch.core import projector
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.sirt import sirt
from tomojax_torch.utils import profiling

torch.set_num_threads(1)

N, V = 16, 12
CFG = {"vox_shape": [N] * 3, "det_shape": [N, N], "n_proj": V,
       "phi_end_deg": 180.0, "shift_px": 2.0, "angle_deg": 1.0}
F64 = torch.float64
COLS = (0, 2, 4, 5)
XZAB = (True, False, True, False, True, True)
DRIVER = (Path(__file__).resolve().parents[1] / "benchmark" / "drivers"
          / "exact_align_jobs.py")


def _problem(seed=3):
    """Seeded jittered views (float64), the geometry, the reference
    operator and a seeded random volume."""
    th = torch.as_tensor(jittered6(CFG, seed))
    geom = Geometry(n_proj=V, vox_shape=(N,) * 3, det_shape=(N, N))
    vol = torch.rand((N,) * 3, dtype=F64,
                     generator=torch.Generator().manual_seed(seed))
    return th, geom, RayOperator(CFG, "cpu"), vol


def test_forward_adjoint_and_the_dot_product_identity():
    th, geom, ref, vol = _problem()
    views = Views.from_theta6(th)
    y = torch.randn(V, N * N, dtype=F64,
                    generator=torch.Generator().manual_seed(5))
    a_ref = ref.A(vol, th).reshape(V, -1)
    at_ref = ref.AT(y, th)
    assert rel(projector.project(vol, geom, views, dtype=F64), a_ref) < 1e-13
    assert rel(projector.backproject(y, geom.vox_shape, geom, views,
                                     dtype=F64), at_ref) < 1e-13
    lhs = float((a_ref * y).sum())
    assert abs(lhs - float((vol * at_ref).sum())) <= 1e-12 * abs(lhs)


def test_jacobian_matches_away_from_cell_edges():
    """float64 samples of seeded views lie off the cell edges, where the
    trilinear weights' gradients jump (float32 near them: ROADMAP Queue 3's
    known behaviour)."""
    th, geom, ref, vol = _problem(seed=4)
    val, jac = ref.value_jac(vol, th, COLS)
    det, want = projector.forward_views_jac(
        vol, geom, th[:, 3], th[:, 4], th[:, 5], th[:, :3],
        torch.zeros(V, 3, dtype=F64), dtype=F64)
    assert rel(val.reshape(V, -1), det) < 1e-13
    for c, col in enumerate(COLS):
        assert rel(jac[:, c].reshape(V, -1), want[:, col]) < 1e-12


@pytest.mark.parametrize("data", ["consistent", "noise"])
def test_sirt_and_its_stop_rule(data):
    """The port's SIRT from a start with positivity against the
    reference's iterates: the same count and the same volume. The stop
    rule never fires on consistent data; it fires on noise weighted to the
    rays that graze the volume (whose residual SIRT weighs most)."""
    th, geom, ref, vol = _problem()
    op = make_operator(geom, Views.from_theta6(th), dtype=F64, device="cpu")
    g = torch.Generator().manual_seed(2)
    grazing = ref.A(torch.ones((N,) * 3, dtype=F64), th).reshape(V, -1)
    b = (ref.A(shepp3d((N,) * 3, "cpu", F64), th).reshape(V, -1)
         if data == "consistent" else torch.randn(V, N * N, dtype=F64,
                                                  generator=g)
         / grazing.clamp_min(1e-3))
    x0 = 0.5 * vol if data == "consistent" else torch.zeros_like(vol)
    got = sirt(op, b, niter=25, x0=x0, positivity=True)
    its = list(sirt_from.iterates(lambda x: ref.A(x, th),
                                  lambda y: ref.AT(y, th), b, x0, 25))
    count = sirt_from.stop_count([e for _, _, e in its])
    assert got.n_iter == count
    assert got.stop_reason == int(data == "noise")
    assert rel(got.x, its[count - 1][1]) < 1e-12


def test_one_outer_of_sirt_lm_and_hook():
    """One outer of ``align_reconstruct`` (ray family, SIRT, exact LM, the
    moment hook) against the reference's SIRT, LM and hook from the same
    start, off the lattice-aligned poses (ROADMAP Queue 3: there the two
    take other one-sided derivatives)."""
    th, geom, ref, _ = _problem()
    b = ref.A(shepp3d((N,) * 3, "cpu", F64), th).reshape(V, -1)
    start = Views.create(V, phi=th[:, 3], t=0.3 * th[:, :3], dtype=F64)
    off = torch.tensor([3.0, 3.0, 3.0, float("inf"), 0.02, 0.02], dtype=F64)
    state = align_reconstruct(b, geom, start, outer_iters=1, recon_iters=8,
                              refine_iters=4, bounds=(-off, off),
                              dtype=F64, device="cpu")
    th0 = start.theta6()
    x = list(sirt_from.iterates(lambda x: ref.A(x, th0),
                                lambda y: ref.AT(y, th0), b,
                                torch.zeros((N,) * 3, dtype=F64), 8))[-1][1]
    assert rel(state.volume, x) < 1e-12
    lo, hi = th0 - off, th0 + off
    want = lm_exact.refine(ref, x, b, th0, lo, hi, COLS, 4)
    want = lm_exact.moment_hook(ref, x, b, want,
                                lm.support_mask(b.reshape(V, N, N),
                                                CFG["vox_shape"]), lo, hi)
    got = state.views.theta6()
    assert float((got - want)[:, list(COLS)].abs().max()) < 1e-9


def test_the_exact_lm_stops_each_view_as_the_reference_does():
    """Per-view stops: from near the truth most views converge before the
    last step, and stay where the reference's stop leaves them."""
    th, geom, ref, vol = _problem(seed=6)
    b = ref.A(vol, th)
    start = th.clone()
    start[:, [0, 2]] += 0.05
    off = torch.tensor([3.0, 3.0, 3.0, float("inf"), 0.02, 0.02], dtype=F64)
    got = refine_views(vol, b.reshape(V, -1), geom,
                       Views.from_theta6(start), mask=XZAB,
                       lower=start - off, upper=start + off, max_iter=12,
                       dtype=F64)
    assert int(got.converged.sum()) >= V // 2
    want = lm_exact.refine(ref, vol, b, start, start - off, start + off,
                           COLS, 12)
    assert float((got.theta6 - want).abs().max()) < 1e-9


def test_a_job_handed_out_outer_by_outer_is_one_call():
    """The benchmark's hand-out (the job on a worker thread, held in its
    callback between steps) gives every outer's volume and views of one
    uninterrupted call, to the bit."""
    th, geom, ref, _ = _problem()
    b = ref.A(shepp3d((N,) * 3, "cpu", F64), th).reshape(V, -1).float()
    start = Views.create(V, phi=th[:, 3])
    kw = dict(outer_iters=3, recon_iters=6, refine_iters=2, device="cpu")
    want = {}
    align_reconstruct(b, geom, start, callback=lambda it, views, vol, h:
                      want.update({it: (views.theta6().clone(),
                                        vol.clone())}), **kw)
    handout = harness.load_module(DRIVER, "driver")._Handout(
        lambda cb: align_reconstruct(b, geom, start, callback=cb, **kw))
    got = {}
    try:
        for _ in range(3):
            handout.go()
            kind, (it, theta, vol) = handout.next()
            got[it] = (theta, vol)
        handout.go()
        kind, _ = handout.next()
    finally:
        handout.close()
    assert kind == "done" and sorted(got) == [0, 1, 2]
    for it in got:
        assert torch.equal(got[it][0], want[it][0])
        assert torch.equal(got[it][1], want[it][1])


def test_the_ray_path_records_its_spans_and_counters():
    th, geom, ref, _ = _problem()
    b = ref.A(shepp3d((N,) * 3, "cpu", F64), th).reshape(V, -1).float()
    start = Views.create(V, phi=th[:, 3])
    kw = dict(outer_iters=1, recon_iters=3, refine_iters=2, device="cpu")
    profiling.reset()
    align_reconstruct(b, geom, start, **kw)
    assert profiling.records() == ([], {})
    try:
        with profiling.tracing():
            align_reconstruct(b, geom, start, **kw)
        spans, counters = profiling.records()
    finally:
        profiling.reset()
    names = [s.name for s in spans]
    parent = {i: spans[s.parent].name for i, s in enumerate(spans)
              if s.parent >= 0}
    # SIRT: the two sums, then one A and one Aᵀ an iteration
    assert names.count("sirt.init") == 1 and names.count("sirt.iter") == 3
    for i, s in enumerate(spans):
        if s.name in ("ray.A", "ray.AT"):
            assert parent[i] in ("sirt.init", "sirt.iter", "lm.cost",
                                 "align.hook")
        if s.name == "ray.jac":
            assert parent[i] == "lm.jac"
        if s.name in ("lm.jac", "lm.solve"):
            assert parent[i] == "lm.step"
    assert all(s.device_s is None for s in spans)
    steps = names.count("lm.step")
    assert 1 <= steps <= 2
    assert counters["host_sync.sirt.stop"] == 2
    assert counters["host_sync.lm.solve"] == steps
    assert counters["host_sync.lm.active"] >= steps
    assert counters["ray.jac.views"] == V * steps
    calls = sum(names.count(k) for k in ("ray.A", "ray.AT", "ray.jac"))
    assert counters["host_sync.ray.setup"] == 3 * calls
    assert counters["ray.AT.views"] == V * 4
    assert counters["ray.A.views"] >= V * 4


def test_a_span_on_the_cpu_has_no_device_time():
    profiling.reset()
    try:
        with profiling.tracing():
            with profiling.span("x", torch.device("cpu")):
                torch.ones(4).sum()
            with profiling.span("y"):
                pass
        spans, _ = profiling.records()
    finally:
        profiling.reset()
    assert [(s.name, s.device_s) for s in spans] == [("x", None),
                                                     ("y", None)]


"""The cell ``c1.flagship`` at a size the CPU runs (16³ × 12 views, 3
outers of SIRT 10 and LM 3, the mix cut here and not in its file): its
result line, its control and the faults its timed path can have coming out
not correct, the plain ray reference against the program's plain path in
float32, the four per-layer readers on a recorded run, and the ray
roofline's arithmetic."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, roofline
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.rigid6 import jittered6
from benchmark.reference.compare import rel, worst_row_rel
from benchmark.reference.ray import RayOperator
from benchmark.roofline_ray import ray_apply
from benchmark.tools.flagship_faults import FAULTS
from tomojax_torch.core import projector
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.utils import profiling

N, V = 16, 12
CUT = {"vox_shape": [N] * 3, "det_shape": [N, N], "n_proj": V}
CUT_ALIGN = {"outer_iters": 3, "recon_iters": 10, "refine_iters": 3}
# no warm-up job: the CPU compiles nothing
CUT_WARMUP = {"outer_iters": 0}
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


def tiny_flagship(**align):
    cell = harness.resolve_cell(harness.load_spec(), "c1.flagship")
    cell.config = dict(cell.config, **CUT)
    cell.mix = dict(cell.mix, align=dict(cell.mix["align"],
                                         **dict(CUT_ALIGN, **align)),
                    warmup=CUT_WARMUP)
    return cell


def run_flagship(seed=2**31 + 9, trace=False, variant=None, **align):
    return harness.run_cell(tiny_flagship(**align), seed, 0.0, trace, CPU,
                            time.perf_counter(), variant)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(trace):
    r = run_flagship(trace=trace)
    assert r["correct"] is True and r["failed"] == 0
    # a step is an outer: one job of three
    assert r["attempted"] == 3
    assert list(r["checks"]) == list(
        harness.driver_of(tiny_flagship()).NUMBERS)
    if trace:
        # the CPU has no device time: device metrics stay unreported
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {"align_outers_per_s", "setup_s"}
        assert r["metrics"]["align_outers_per_s"]["unit"] == "outers/s"


def test_warm_up_job_and_the_window_close_at_a_job_boundary():
    """With a warm-up outer, and a window that outlasts one job, the
    window holds whole jobs."""
    cell = tiny_flagship(outer_iters=2)
    cell.mix["warmup"] = {"outer_iters": 1, "recon_iters": 2,
                          "refine_iters": 1}
    job = harness.driver_of(cell).setup(cell, 5, CPU)
    try:
        _, _, steps, _ = harness.run_window(job, 1e-9, CPU)
        assert len(steps) == 2 and [s["jobs"] for s in steps] == [0, 1]
        assert job.ready()
    finally:
        job.close()


@pytest.mark.parametrize("seed", [11, 2**31 + 3, 7_000_001])
def test_control_is_not_correct(seed):
    """The reference's SIRT recursion in bfloat16 in the program's place
    fails by a reading."""
    r = run_flagship(seed=seed, variant="control")
    assert r["correct"] is False
    assert all(np.isfinite(c["value"]) for c in r["checks"].values())
    assert r["checks"]["recon_rel"]["value"] > r["checks"]["recon_rel"][
        "limit"]


@pytest.mark.parametrize("fault", [f for n, f in FAULTS.items()
                                   if n != "sirt_stop_ignored"],
                         ids=[n for n in FAULTS if n != "sirt_stop_ignored"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(lambda obj, name, value: monkeypatch.setattr(obj, name, value,
                                                       raising=False))
    r = run_flagship()
    assert r["correct"] is False
    assert all(np.isfinite(c["value"]) for c in r["checks"].values())


def test_sirt_stop_ignored_is_the_sound_job_on_this_traffic(monkeypatch):
    """The data's residual falls through every SIRT iteration, so the stop
    rule never fires and ignoring it changes nothing: the planted fault
    reads as the sound job, to the bit."""
    sound = run_flagship()
    FAULTS["sirt_stop_ignored"](
        lambda obj, name, value: monkeypatch.setattr(obj, name, value,
                                                     raising=False))
    planted = run_flagship()
    assert planted["checks"] == sound["checks"]
    assert sound["checks"]["sirt_iters_gap"]["value"] == 0.0


# ---- the reference against the program's plain path ----------------------

def _problem(seed=3):
    th = jittered6(dict(CUT, phi_end_deg=180.0, shift_px=2.0, angle_deg=1.0),
                   seed)
    geom = Geometry(n_proj=V, vox_shape=(N,) * 3, det_shape=(N, N))
    return th, geom, shepp3d((N,) * 3, CPU)


def test_ray_reference_matches_the_plain_path_in_float32():
    th, geom, vol = _problem()
    views = Views.from_theta6(torch.as_tensor(th).float())
    ref = RayOperator(CUT, CPU)
    g = torch.randn(V, N * N, generator=torch.Generator().manual_seed(2))
    want = ref.A(vol, views.theta6()).reshape(V, -1)
    assert worst_row_rel(projector.project(vol, geom, views), want) < 2e-6
    assert rel(projector.backproject(g, geom.vox_shape, geom, views),
               ref.AT(g, views.theta6())) < 2e-6


def test_the_data_is_the_reference_forward_at_the_true_views():
    cell = tiny_flagship()
    job = harness.driver_of(cell).setup(cell, 17, CPU)
    try:
        ref = RayOperator(CUT, CPU)
        want = ref.A(shepp3d((N,) * 3, CPU, torch.float64), job.truth)
        assert torch.equal(job.b, want.float())
        assert job.views0.theta6()[:, [0, 1, 2, 4, 5]].abs().max() == 0.0
    finally:
        job.close()


# ---- the per-layer readers on a recorded run ------------------------------

A_MS, AT_MS = 61.9, 76.2


def _reader_run(trace):
    cell = harness.resolve_cell(harness.load_spec(), "c1.flagship")
    steps = [{"outers": 1, "jobs": 0} for _ in range(10)]
    return harness.Run(cell=cell, setup_s=1.0, window_s=160.0, steps=steps,
                       extra={}, trace=trace, device_kind=H100)


def _records():
    """One outer's spans: SIRT's 101 A and 101 Aᵀ over 90 views, LM costs
    over 90 views in chunks, the outer held 5 s in its callback."""
    Span = profiling.Span
    spans = [Span("align.outer", 0.0, 20.0, -1),
             Span("align.refine", 13.0, 14.5, 0),
             Span("align.callback", 15.0, 20.0, 0)]
    spans += [Span("ray.A", 1.0, 1.1, 0, A_MS * 1e-3)] * 101
    spans += [Span("ray.AT", 1.0, 1.1, 0, AT_MS * 1e-3)] * 101
    spans += [Span("ray.A", 13.0, 13.01, 1, A_MS * 1e-3 / 3)] * 3
    counters = {"ray.A.views": 101 * 90 + 90, "ray.AT.views": 101 * 90,
                "ray.jac.views": 12 * 90, "host_sync.sirt.stop": 99,
                "host_sync.lm.active": 39, "host_sync.ray.setup": 3 * 240}
    return spans, counters


def test_span_and_counter_readers(monkeypatch):
    run = _reader_run({"busy_s": 12.0, "window_s": 16.0, "device_ops": [],
                       "idle_gaps": []})
    rec = _records()
    names = ("ray_roofline_pct.flagship", "host_syncs_per_outer.flagship",
             "refine_pct.flagship")
    readers = {n: harness.reader_of(n) for n in names}
    for reader in readers.values():
        monkeypatch.setattr(reader, "recorded", lambda r: rec)
    bound = roofline.bound_ms(ray_apply((64,) * 3, (64, 64), 90), H100)
    secs = 101 * (A_MS + AT_MS) * 1e-3 + A_MS * 1e-3
    assert readers["ray_roofline_pct.flagship"].read(run) == pytest.approx(
        100.0 * (203 * 90 / 90) * bound * 1e-3 / secs, rel=1e-12)
    # the host syncs of the one traced outer (step 1)
    assert readers["host_syncs_per_outer.flagship"].read(run) == 99 + 39 + 720
    # the outer less the time held in the callback
    assert readers["refine_pct.flagship"].read(run) == pytest.approx(10.0)
    assert harness.reader_of("device_idle_pct.flagship").read(run) == \
        pytest.approx(25.0)


def test_readers_report_nothing_without_device_times(monkeypatch):
    """On a program whose spans carry no device time (a CPU run, or a
    program that predates it) the roofline reports nothing."""
    spans, counters = _records()
    bare = [profiling.Span(s.name, s.t0, s.t1, s.parent) for s in spans]
    reader = harness.reader_of("ray_roofline_pct.flagship")
    monkeypatch.setattr(reader, "recorded", lambda r: (bare, counters))
    run = _reader_run({"busy_s": 1.0, "window_s": 2.0, "device_ops": [],
                       "idle_gaps": []})
    assert reader.read(run) is None
    for name in ("ray_roofline_pct.flagship", "host_syncs_per_outer.flagship",
                 "refine_pct.flagship", "device_idle_pct.flagship"):
        assert harness.reader_of(name).read(_reader_run(None)) is None


# ---- the yardstick --------------------------------------------------------

def test_ray_roofline_arithmetic():
    w = ray_apply((64,) * 3, (64, 64), 90)
    # 90 views × 4096 rays × 128 steps × 8 taps × 2
    assert w["flops"] == 754_974_720.0
    assert w["bytes"] == 4.0 * (64 ** 3 + 90 * 64 * 64) + 24 * 90
    assert roofline.bound_ms(w, H100) == pytest.approx(0.0112683, rel=1e-5)
    assert ray_apply((64,) * 3, (64, 64), 45)["flops"] == w["flops"] / 2
    assert ray_apply((64,) * 3, (64, 64), 90, step=0.5)["flops"] == \
        2 * w["flops"]

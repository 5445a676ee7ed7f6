"""The cell ``c4.align`` at a size the CPU runs (16³ × 24 views, 3 outers
of CGLS 4 and LM 3, the mix cut here and not in its file): its result
line, its control and each fault its timed path can have coming out not
correct, and the plain arc and LM reference against the program's plain
path."""

import importlib
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.rigid6 import jittered6
from benchmark.reference import lm
from benchmark.reference.arc import ArcOperator
from benchmark.reference.cgls_from import solve_from
from benchmark.reference.compare import rel
from benchmark.tools.align_faults import FAULTS
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import operator_from_scalars

pipeline = importlib.import_module("tomojax_torch.align.pipeline")
slab_refine = importlib.import_module("tomojax_torch.align.slab_refine")
cgls_mod = importlib.import_module("tomojax_torch.recon.cgls")

N, V = 16, 24
CUT = {"vox_shape": [N] * 3, "det_shape": [N, N], "n_proj": V}
CUT_ALIGN = {"outer_iters": 3, "recon_iters": 4, "refine_iters": 3}
# no warm-up outer: the CPU compiles nothing
CUT_WARMUP = {"outer_iters": 0}
CPU = torch.device("cpu")


def tiny_align(**align):
    cell = harness.resolve_cell(harness.load_spec(), "c4.align")
    cell.config = dict(cell.config, **CUT)
    cell.mix = dict(cell.mix, align=dict(cell.mix["align"],
                                         **dict(CUT_ALIGN, **align)),
                    warmup=CUT_WARMUP)
    return cell


def run_align(seed=2**31 + 9, trace=False, variant=None, **align):
    return harness.run_cell(tiny_align(**align), seed, 0.0, trace, CPU,
                            time.perf_counter(), variant)


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(trace):
    # the profiler's cost on the CPU's many small operations: a traced job
    # of 2 outers (the check follows outer 1)
    r = run_align(trace=trace, **({"outer_iters": 2} if trace else {}))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] == 1
    assert list(r["checks"]) == list(harness.driver_of(tiny_align()).NUMBERS)
    if trace:
        # the CPU has no device time: device metrics stay unreported
        assert r["metrics"] == {} and r["device"]["busy_s"] == 0.0
    else:
        assert set(r["metrics"]) == {"align_outers_per_s", "setup_s"}
        assert r["metrics"]["align_outers_per_s"]["unit"] == "outers/s"


@pytest.mark.parametrize("seed", [11, 2**31 + 3, 7_000_001])
def test_control_is_not_correct(seed):
    """The program's bf16 reconstruction tier fails by a reading."""
    r = run_align(seed=seed, variant="control")
    assert r["correct"] is False
    assert all(np.isfinite(c["value"]) for c in r["checks"].values())
    assert r["checks"]["recon_rel"]["value"] > r["checks"]["recon_rel"]["limit"]


@pytest.mark.parametrize("fault", FAULTS.values(), ids=list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    r = run_align()
    assert r["correct"] is False
    assert all(np.isfinite(c["value"]) for c in r["checks"].values())


# ---- the reference against the program's plain path ----------------------

def _problem(seed=3):
    th = jittered6(dict(CUT, phi_end_deg=180.0, shift_px=2.0, angle_deg=0.5),
                   seed)
    geom = Geometry(n_proj=V, vox_shape=(N,) * 3, det_shape=(N, N))
    return th, geom, shepp3d((N,) * 3, CPU)


def test_arc_forward_and_adjoint_match_the_plain_path():
    th, geom, vol = _problem()
    views = Views.from_theta6(torch.as_tensor(th))
    ref = ArcOperator(CUT, th, CPU)
    g = torch.randn(V, N, N, generator=torch.Generator().manual_seed(2))
    assert rel(sp.project(vol, geom, views, quad="arc"),
               ref.A(vol).reshape(V, -1)) < 2e-7
    assert rel(sp.backproject(g.reshape(V, -1), geom, views, quad="arc"),
               ref.AT(g)) < 1e-6
    x = torch.rand(N, N, N, generator=torch.Generator().manual_seed(1))
    lhs = float((ref.A(x).double() * g.double()).sum())
    rhs = float((x.double() * ref.AT(g).double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_frozen_frames_match_the_programs_groups():
    """A view marched in another view's frame, as the driver's frozen
    groups do, reads as the program's operator on those groups."""
    th, geom, vol = _problem()
    moved = th.copy()
    moved[:, 3] += 0.3
    gstruct, _ = sp.scalar_groups(geom, Views.from_theta6(torch.as_tensor(th)))
    scal = sp.group_scalars_for(geom, Views.from_theta6(
        torch.as_tensor(moved)), gstruct)
    flg = np.zeros((V, 3), bool)
    for idx, *f in gstruct:
        flg[list(idx)] = f
    op = operator_from_scalars(geom, *scal, family="slab",
                               dtype=torch.float32, device="cpu")
    ref = ArcOperator(CUT, moved, CPU, flg)
    assert rel(op.A(vol), ref.A(vol).reshape(V, -1)) < 2e-7


def test_jacobian_is_tomojaxs_analytic_one():
    """Forward-mode derivative against ``forward_view_jac`` in float64:
    the translations to the last bits; the tilts within 2e-5, where the
    analytic Jacobian's grid-sawtooth terms depart from the exact
    derivative (7.7e-6 and 7.0e-6 at this size)."""
    th, geom, vol = _problem()
    cols = lm.PARAM_SETS["xzab"]
    ref = ArcOperator(CUT, th, CPU, dtype=torch.float64)
    _, jac = ref.value_jac(vol.double(), th, cols)
    for i in range(V):
        _, want = sp.forward_view_jac(vol.double(), geom, th[i, 3], th[i, 4],
                                      th[i, 5], th[i, :3], np.zeros(3),
                                      dtype=torch.float64)
        want = want.reshape(6, N, N)[list(cols)]
        for c, tol in enumerate((1e-12, 1e-12, 2e-5, 2e-5)):
            assert rel(jac[i, c], want[c]) < tol


def test_cgls_from_a_start_matches_the_program():
    th, geom, vol = _problem()
    views = Views.from_theta6(torch.as_tensor(th))
    op = operator_from_scalars(geom, *sp.scalar_groups(geom, views),
                               family="slab", dtype=torch.float32,
                               device="cpu")
    ref = ArcOperator(CUT, th, CPU)
    b = ref.A(vol).reshape(V, -1)
    x0 = 0.5 * vol
    got = cgls_mod.cgls(op, b, niter=5, x0=x0).x
    assert rel(got, solve_from(ref.A, ref.AT, b, x0, 5)) < 1e-5


def test_lm_and_hook_match_the_program():
    """The LM and the moment hook from perturbed views on the true volume
    land where the program's ``refine_views_slab`` and hook land."""
    th, geom, vol = _problem()
    ref = ArcOperator(CUT, th, CPU)
    b = ref.A(vol)
    start = th.copy()
    start[:, [0, 2]] += 0.3
    start[:, 4:] *= 0.5
    lo_off = np.array([-3, -3, -3, -np.inf, -0.02, -0.02])
    lo, hi = torch.as_tensor(start + lo_off), torch.as_tensor(start - lo_off)
    cols = lm.PARAM_SETS["xzab"]
    views = Views.from_theta6(torch.as_tensor(start).float())
    got = slab_refine.refine_views_slab(
        vol, b.reshape(V, -1), geom, views, mask=(1, 0, 1, 0, 1, 1),
        lower=lo.float(), upper=hi.float(), max_iter=4).theta6.double()
    op = ArcOperator(CUT, start, CPU)
    want = lm.refine(op, vol, b, start, lo, hi, cols, 4)
    assert float((got - want).abs()[:, list(cols)].max()) < 1e-4
    mask = lm.support_mask(b, CUT["vox_shape"])
    assert np.array_equal(mask, pipeline._support_mask(geom, b.numpy()))
    hooked = lm.moment_hook(op, vol, b, want, mask, lo, hi)
    synth = sp.project(vol * torch.as_tensor(mask), geom,
                       Views.from_theta6(want), quad="arc",
                       dtype=torch.float64)
    dmom = pipeline._project_out_gauge(pipeline.moment_match(
        b.double(), synth, (N, N)), want[:, 3])
    assert torch.allclose(hooked[:, [0, 2]] - want[:, [0, 2]], dmom,
                          atol=1e-6)


# ---- the per-layer readers on a run built here ----------------------------

K4_MS, K5_MS = 42.365, 17.359


def _reader_run(trace):
    cell = harness.resolve_cell(harness.load_spec(), "c4.align")
    # one job of 10 outers in 3 orientation groups: 31 arc adjoints and
    # 10 Jacobians an outer
    steps = [{"k4_launches": 310 * 3, "k5_launches": 100 * 3, "outers": 10,
              "jobs": 1, "views": 90}]
    return harness.Run(cell=cell, setup_s=1.0, window_s=25.0, steps=steps,
                       extra={"views": 90, "groups": 3, "outer_t": []},
                       trace=trace, device_kind="NVIDIA H100 80GB HBM3")


def test_roofline_readers_take_the_kernels_from_the_trace():
    ops = [["(anonymous namespace)::arc_adj_kernel(float const*, float "
            "const*, float*, float*, int)", 310 * K4_MS * 1e-3],
           ["(anonymous namespace)::arc_adj_bf16_kernel(__nv_bfloat16 "
            "const*)", 5.0],
           ["void (anonymous namespace)::arc_march_kernel<true>(float "
            "const*)", 100 * K5_MS * 1e-3],
           ["void (anonymous namespace)::arc_march_kernel<false>(float "
            "const*)", 5.0]]
    run = _reader_run({"busy_s": 20.0, "window_s": 25.0, "device_ops": ops,
                       "idle_gaps": []})
    k4 = harness.reader_of("arc_adj_roofline_pct.align").read(run)
    k5 = harness.reader_of("jac_roofline_pct.align").read(run)
    assert k4 == pytest.approx(100 * 0.36058 / K4_MS, rel=1e-4)
    assert k5 == pytest.approx(100 * 4.32702 / K5_MS, rel=1e-4)
    assert harness.reader_of("device_idle_pct.align").read(run) == \
        pytest.approx(20.0)
    # K4's add of its two sides counts as K4's time
    ops.append(["(anonymous namespace)::add_kernel(float*, float const*, "
                "long long)", 310 * K4_MS * 1e-3])
    assert harness.reader_of("arc_adj_roofline_pct.align").read(run) == \
        pytest.approx(k4 / 2, rel=1e-6)
    for name in ("arc_adj_roofline_pct.align", "jac_roofline_pct.align"):
        assert harness.reader_of(name).read(_reader_run(None)) is None


def test_span_and_counter_readers():
    from tomojax_torch.utils import profiling

    profiling.reset()
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("align.outer"):
                with profiling.span("align.recon"):
                    time.sleep(0.03)
                with profiling.span("align.refine"):
                    time.sleep(0.01)
                profiling.count("host_sync.align.flip", 7)
                profiling.count("cc.views", 5)
    try:
        run = _reader_run({"busy_s": 1.0, "window_s": 2.0, "device_ops": [],
                           "idle_gaps": []})
        run.steps[0]["outers"] = 2
        pct = harness.reader_of("refine_pct.align").read(run)
        assert 15.0 < pct < 35.0
        assert harness.reader_of("host_syncs_per_outer.align").read(run) == 7
        assert harness.reader_of("refine_pct.align").read(
            _reader_run(None)) is None
    finally:
        profiling.reset()

"""The port's spans and counters (``utils/profiling.py``'s recorder) on the
CPU: the switch, nesting and self time, the spans in a ``torch.profiler``
trace, and the sites that record them: the CC chain, a CGLS pair on the
plane operator, and the alignment driver with the slab LM and its
heartbeat."""

import json

import numpy as np
import pytest
import torch

from tomojax_torch.align import cc
from tomojax_torch.align.pipeline import align_reconstruct
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _on():
    """Whether the recorder's switch is on: ``span`` returns a recording
    span, not the shared no-op."""
    return profiling.span("a") is not profiling.span("b")


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not _on()
    first = profiling.span("a")
    assert profiling.span("b") is first
    with profiling.span("a") as i:
        profiling.count("host_sync.x")
    assert i is None
    assert profiling.records() == ([], {})


def test_spans_nest_and_self_time_is_the_rest():
    with profiling.tracing():
        assert _on()
        with profiling.span("outer") as i:
            with profiling.span("a"):
                with profiling.span("a.inner"):
                    pass
            with profiling.span("b"):
                profiling.count("n", 2)
            profiling.count("n")
        with profiling.span("next"):
            pass
    assert not _on()
    spans, counters = profiling.records()
    assert i == 0
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", -1), ("a", 0), ("a.inner", 1), ("b", 0), ("next", -1)]
    assert counters == {"n": 3}
    assert all(s.t0 <= s.t1 for s in spans)
    dur = [s.t1 - s.t0 for s in spans]
    # self time: the duration less the children's
    assert profiling.child_seconds(spans, 0) == {"a": dur[1], "b": dur[3]}
    assert profiling.child_seconds(spans, 1) == {"a.inner": dur[2]}
    assert profiling.child_seconds(spans, 2) == {}
    assert dur[0] - dur[1] - dur[3] > 0
    assert profiling.inner_seconds(spans, 0) == {
        "a": dur[1], "a.inner": dur[2], "b": dur[3]}
    assert profiling.host_syncs({"host_sync.a.b": 2, "host_sync.c": 1,
                                 "n": 5}) == 3
    with profiling.tracing(), profiling.span("open"):
        with pytest.raises(RuntimeError):
            profiling.reset()


def test_spans_are_annotations_in_the_profilers_trace(tmp_path):
    x = torch.ones(32, 32)
    with profiling.trace(str(tmp_path / "tr")):
        assert _on()
        with profiling.span("outer.span"):
            with profiling.span("inner.span"):
                y = x @ x
            y = y + 1
    assert not _on()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"outer.span", "inner.span"} <= set(ann)

    def inside(e, span):
        return (span["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= span["ts"] + span["dur"])

    ops = [e for e in events if e.get("cat") == "cpu_op"]
    mm = [e for e in ops if e["name"] in ("aten::mm", "aten::matmul")]
    add = [e for e in ops if e["name"] == "aten::add"]
    assert mm and all(inside(e, ann["inner.span"]) for e in mm)
    assert add and all(inside(e, ann["outer.span"])
                       and not inside(e, ann["inner.span"]) for e in add)
    spans, _ = profiling.records()
    assert [(s.name, s.parent) for s in spans] == [("outer.span", -1),
                                                   ("inner.span", 0)]


def test_cc_chain_records_each_view_and_its_stages():
    n = 5
    g = torch.Generator().manual_seed(0)
    p = torch.rand((n, 16, 16), generator=g, dtype=torch.float64)
    with profiling.tracing():
        off, _ = cc.cross_correlation_chain(p, upsample_factor=10)
    spans, counters = profiling.records()
    assert off.shape == (n, 2)
    assert spans[0].name == "cc.chain" and spans[0].parent == -1
    views = [i for i, s in enumerate(spans) if s.name == "cc.view"]
    assert len(views) == n - 1
    for i in views:
        assert spans[i].parent == 0
        assert _children(spans, i) == ["cc.correlate", "cc.refine",
                                       "cc.shift"]
    assert counters == {"cc.views": n - 1}


def _plane_problem(n=16, n_proj=10):
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(1)
    # views in three orientation groups
    phi = np.linspace(0.1, 2.6, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    views = Views.create(n_proj, phi=phi, t=t, device="cpu")
    op = make_operator(geom, views, family="slab_plane", device="cpu")
    b = op.A(torch.rand(geom.vox_shape, generator=torch.Generator()
                        .manual_seed(2)))
    return op, b


def test_a_cgls_pair_counts_its_guard_and_each_groups_rows():
    op, b = _plane_problem()
    groups = len(sp.scalar_groups(op.geom, op.views, "plane")[0])
    assert groups >= 2
    state = cgls_steps(op, b, cgls_init(op, b), nsteps=1, niter=10)[0]
    with profiling.tracing():
        cgls_steps(op, b, state, nsteps=1, niter=10)
    spans, counters = profiling.records()
    # k = 1: the guard runs (it is skipped at k = 0)
    assert counters == {"host_sync.cgls.guard": 1,
                        "host_sync.op.rows": 2 * groups}
    assert spans[0].name == "cgls.iter"
    assert _children(spans, 0) == ["op.A", "op.AT"]
    for i, s in enumerate(spans):
        if s.name in ("op.A", "op.AT"):
            assert _children(spans, i) == ["op.group"] * groups
    profiling.reset()
    with profiling.tracing():
        cgls_init(op, b)
    spans, counters = profiling.records()
    assert [s.name for s in spans if s.parent == -1] == ["cgls.init"]
    assert counters == {"host_sync.op.rows": 2 * groups}


def _align(outer_iters, n=12, n_proj=8, **kw):
    """The slab driver with the slab LM on a jittered box phantom."""
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(3)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    phi = np.linspace(0.1, 2.9, n_proj)
    true = Views.create(n_proj, phi=phi, t=t, device="cpu")
    vol = torch.zeros(geom.vox_shape)
    vol[n // 4:-n // 4, n // 4:-n // 4, n // 3:-n // 3] = 1.0
    meas = make_operator(geom, true, family="slab", device="cpu").A(vol)
    start = Views.create(n_proj, phi=phi, device="cpu")
    align_reconstruct(meas, geom, start, outer_iters=outer_iters,
                      recon="cgls", recon_iters=3, refine_iters=2,
                      family="slab", refine_method="lm_slab", device="cpu",
                      **kw)


def test_the_heartbeat_records_its_own_outers():
    _align(1, n=8, n_proj=4, progress=True)
    assert not _on()
    spans, _ = profiling.records()
    assert [s.name for s in spans if s.parent == -1] == ["align.outer"]


def test_the_driver_and_the_lm_record_their_stages(capsys):
    with profiling.tracing():
        _align(2, accel_period=2, progress=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[pipeline] outer") and " debias " in ln]
    assert len(lines) == 2
    for it, ln in enumerate(lines):
        words = ln.split()
        assert words[2:4] == [f"{it}:", "debias"]
        assert words[3:12:2] == ["debias", "recon", "refine", "hook", "of"]
        assert words[-2:] == ["host", "syncs"] and int(words[-3]) > 0
    spans, counters = profiling.records()
    outers = [i for i, s in enumerate(spans) if s.name == "align.outer"]
    assert len(outers) == 2
    for i in outers:
        assert _children(spans, i) == ["align.debias", "align.recon",
                                       "align.refine", "align.hook"]
    steps = [i for i, s in enumerate(spans) if s.name == "lm.step"]
    # 2 outers × the groups' LM steps (2 each), the flip rescue's more
    assert len(steps) >= 2 * 2
    for i in steps:
        assert _children(spans, i) == ["lm.jac", "lm.solve", "lm.cost"]
        assert spans[spans[i].parent].name != "align.outer"
    assert counters["host_sync.align.bounds"] == 2
    assert counters["host_sync.align.recon_rms"] == 2
    assert counters["host_sync.align.refine_cost"] == 2
    assert counters["host_sync.align.moment"] == 2 * 2
    assert counters["host_sync.align.aitken"] == 2
    assert counters["host_sync.align.flip"] >= 2
    assert counters["host_sync.cgls.guard"] == 2 * 2
    assert counters["host_sync.lm.solve"] == len(steps)
    assert counters["host_sync.lm.rows"] >= 2

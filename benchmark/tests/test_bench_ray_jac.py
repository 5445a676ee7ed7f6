"""The exact ray family's Jacobian roofline: ``ray_jac_roofline_pct.
flagship`` on recorded spans (nothing without device times; the same
share for the same spans whatever implements the apply) and its bound's
arithmetic."""

import pytest

from benchmark import harness, roofline
from benchmark.roofline_ray import ray_apply
from benchmark.roofline_ray_jac import ray_jac_apply
from tomojax_torch.utils import profiling

H100 = "NVIDIA H100 80GB HBM3"
NAME = "ray_jac_roofline_pct.flagship"
JAC_MS = 2.0


def _run(trace):
    cell = harness.resolve_cell(harness.load_spec(), "c1.flagship")
    steps = [{"outers": 1, "jobs": 0} for _ in range(10)]
    return harness.Run(cell=cell, setup_s=1.0, window_s=20.0, steps=steps,
                       extra={}, trace=trace, device_kind=H100)


def _records(kernel_spans):
    """One outer's LM: 12 steps over chunks of 32, 32 and 26 views, each
    chunk's ``ray.jac`` span timed on the card; with ``kernel_spans`` a
    ``kernel.ray_jac`` span inside each (the kernel's path), without them
    the plain march's."""
    Span = profiling.Span
    spans = [Span("align.outer", 0.0, 2.0, -1)]
    for i, v in enumerate([32, 32, 26] * 12):
        spans.append(Span("ray.jac", 1.0, 1.01, 0, JAC_MS * 1e-3 * v / 90))
        if kernel_spans:
            spans.append(Span("kernel.ray_jac", 1.0, 1.001, len(spans) - 1))
    spans += [Span("ray.A", 0.5, 0.6, 0, 1e-3)] * 101
    counters = {"ray.jac.views": 12 * 90, "ray.A.views": 101 * 90}
    if kernel_spans:
        counters["ray_jac.launches"] = 36
    return spans, counters


@pytest.mark.parametrize("kernel_spans", [False, True])
def test_reads_the_same_share_whatever_implements_the_apply(
        monkeypatch, kernel_spans):
    reader = harness.reader_of(NAME)
    rec = _records(kernel_spans)
    monkeypatch.setattr(reader, "recorded", lambda r: rec)
    run = _run({"busy_s": 1.0, "window_s": 2.0, "device_ops": [],
                "idle_gaps": []})
    bound = roofline.bound_ms(ray_jac_apply((64,) * 3, (64, 64), 90), H100)
    # 12 applies of 90 views, 12 × JAC_MS of device time
    assert reader.read(run) == pytest.approx(
        100.0 * 12 * bound / (12 * JAC_MS), rel=1e-12)


def test_reads_nothing_without_device_times(monkeypatch):
    reader = harness.reader_of(NAME)
    spans, counters = _records(True)
    bare = [profiling.Span(s.name, s.t0, s.t1, s.parent) for s in spans]
    monkeypatch.setattr(reader, "recorded", lambda r: (bare, counters))
    run = _run({"busy_s": 1.0, "window_s": 2.0, "device_ops": [],
                "idle_gaps": []})
    assert reader.read(run) is None
    monkeypatch.setattr(reader, "recorded", lambda r: (spans, {}))
    assert reader.read(run) is None
    monkeypatch.undo()
    assert harness.reader_of(NAME).read(_run(None)) is None


def test_ray_jac_roofline_arithmetic():
    w = ray_jac_apply((64,) * 3, (64, 64), 90)
    assert w["flops"] == 4 * ray_apply((64,) * 3, (64, 64), 90)["flops"]
    assert w["flops"] == 3_019_898_880.0
    assert w["bytes"] == 4.0 * (64 ** 3 + 7 * 90 * 64 * 64) + 24 * 90
    # bound by the operations: 45.07 µs against 3.39 µs for the bytes
    assert roofline.bound_ms(w, H100) == pytest.approx(0.0450731, rel=1e-5)
    assert w["bytes"] / roofline.PEAKS[H100]["bytes_per_s"] < 4e-6
    assert ray_jac_apply((64,) * 3, (64, 64), 45)["flops"] == w["flops"] / 2

"""The yardstick's arithmetic against the kernel table's bounds (PERF.md
§6: 16.411 ms per plane apply at 512³ × 1024 views, 0.361 ms per arc
apply at 256³ × 90)."""

import pytest

from benchmark import roofline

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("shape, views, quad, ms", [
    ((512, 512, 512), 1024, "plane", 16.411),
    ((256, 256, 256), 180, "plane", 0.361),
    ((256, 256, 256), 90, "arc", 0.361),
])
def test_bound_matches_the_kernel_table(shape, views, quad, ms):
    work = roofline.slab_apply(shape, shape[:2], views, quad)
    assert roofline.bound_ms(work, H100) == pytest.approx(ms, abs=5e-4)
    # operations bound these applies, not bytes
    assert work["flops"] / 67e12 > work["bytes"] / 3.35e12


def test_share_is_bound_over_time():
    work = roofline.slab_apply((512,) * 3, (512, 512), 1024, "plane")
    b = roofline.bound_ms(work, H100)
    assert roofline.share_pct(work, H100, 2 * b) == pytest.approx(50.0)
    assert roofline.share_pct(work, "another card", 1.0) is None
    assert roofline.share_pct(work, H100, 0.0) is None

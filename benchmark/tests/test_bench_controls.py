"""Each cell's control (the mix's ``control``: the program's bf16 tier
for ``c5.cgls``, the reference in float8 for ``c5.cgls_bf16``, the
reference chain reading bf16 images for ``c5.prealign``) comes out not
correct, at a size the CPU runs; PERF.md gives its readings at the
cells' own size on the card."""

import pytest

from benchmark.tests.conftest import CELLS, run_tiny


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 3, 7_000_001])
def test_control_is_not_correct(workload, seed):
    r = run_tiny(workload, seed=seed, variant="control")
    assert r["correct"] is False
    # a control fails a number by a reading, not by crashing
    assert all(c["value"] == c["value"] for c in r["checks"].values())

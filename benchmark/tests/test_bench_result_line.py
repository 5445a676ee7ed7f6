"""The shape of a run's result at a size the CPU runs, on the program's
plain path, and the entry's refusals."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(workload, trace):
    r = run_tiny(workload, trace=trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    want = [k for k in KEYS if k != "checks"] + (["breakdown"] if trace
                                                 else []) + ["checks"]
    assert list(r) == want
    cell = harness.resolve_cell(harness.load_spec(), workload)
    specs = {m["name"]: m for m in cell.end_to_end + cell.per_layer}
    for name, m in r["metrics"].items():
        assert m["unit"] == specs[name]["unit"]
    if trace:
        # the CPU has no device time: device metrics stay unreported
        assert r["metrics"] == {}
        assert r["device"]["busy_s"] == 0.0 and r["device"]["window_s"] > 0
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        harness.print_result(r)
    assert json.loads(out.getvalue().splitlines()[-1]) == r
    lines = err.getvalue().splitlines()
    assert len(lines) == len(r["checks"])
    assert all(line.startswith("check ") and line.endswith(" ok")
               for line in lines)


def _entry(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "c5.cgls",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _entry(harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = _entry(tmp_path)
    assert out.returncode != 0 and out.stdout == ""

"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and entries alone: in a copy of the
benchmark, a dummy of each is found by name and run, with no file that
was there edited."""

import json
import shutil
import time

import torch

from benchmark import harness
from benchmark.tests.conftest import CELLS

DRIVER = '''
import torch

NUMBERS = ("echo_gap",)


def setup(cell, seed, device, *, trace=False, variant=None):
    return Job(cell, seed)


class Job:
    def __init__(self, cell, seed):
        self.x = torch.full((cell.config["n"],), float(seed % 7))
        self.limits = cell.mix["limits"]

    def step(self):
        self.y = self.x * 2.0
        return {"items": self.x.numel()}

    def ready(self):
        return True

    def readings(self):
        return {"sum": float(self.y.sum())}

    def check(self):
        gap = float((self.y - 2.0 * self.x).abs().max())
        return [("echo_gap", gap, float(self.limits["echo_gap"]))]
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _snapshot(root):
    return {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
            if p.is_file()}


def test_the_cells_are_found_from_their_files():
    spec = harness.load_spec()
    for name in CELLS:
        cell = harness.resolve_cell(spec, name)
        assert cell.config["name"] == "config5_512"
        assert harness.driver_of(cell).NUMBERS
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader_of(m["name"]).read)


def test_a_new_config_mix_cell_and_metric_are_files_and_entries(tmp_path):
    root = _copy(tmp_path)
    before = _snapshot(root)
    b = root / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps({"n": 8}))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "dummy_kind", "trace_steps": [0, 1],
         "limits": {"echo_gap": 0.0}}))
    (b / "drivers" / "dummy_kind.py").write_text(DRIVER)
    (b / "metrics" / "dummy_items_per_s.py").write_text(
        "def read(run):\n    return run.total('items') / run.window_s\n")
    (b / "metrics" / "dummy_sum.layer.py").write_text(
        "def read(run):\n    return run.extra['sum']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "none",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_items_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["dummy.cell"]})
    spec["per_layer"].append({"name": "dummy_sum.layer", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "dummy_items_per_s",
                              "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # no file that was there changed
    assert all(p.read_bytes() == data for p, data in before.items())

    cell = harness.resolve_cell(harness.load_spec(root), "dummy.cell", root)
    assert {m["name"] for m in cell.end_to_end} == {"dummy_items_per_s",
                                                    "setup_s"}
    for trace in (False, True):
        r = harness.run_cell(cell, 12, 0.05, trace, torch.device("cpu"),
                             time.perf_counter(), root=root)
        assert r["correct"] is True
        assert r["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.0}}
        want = ({"dummy_sum.layer"} if trace
                else {"dummy_items_per_s", "setup_s"})
        assert set(r["metrics"]) == want
    assert r["metrics"]["dummy_sum.layer"]["value"] == 8 * 2.0 * (12 % 7)
    # the real cells still resolve in the copy
    for name in CELLS:
        harness.resolve_cell(harness.load_spec(root), name, root)

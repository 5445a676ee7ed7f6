"""Shared fixtures of the benchmark's CPU tests: a cell of
``BENCHMARK.json`` cut to a size the CPU runs in a second."""

import time

import pytest
import torch

from benchmark import harness

TINY = {"vox_shape": [16, 16, 16], "det_shape": [16, 16], "n_proj": 24}
CELLS = ("c5.cgls", "c5.cgls_bf16", "c5.prealign")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(workload: str):
    cell = harness.resolve_cell(harness.load_spec(), workload)
    cell.config = dict(cell.config, **TINY)
    return cell


def run_tiny(workload: str, seed: int = 2**31 + 9, trace: bool = False,
             variant=None) -> dict:
    return harness.run_cell(tiny_cell(workload), seed, 0.0, trace,
                            torch.device("cpu"), time.perf_counter(),
                            variant)

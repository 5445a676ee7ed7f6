"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload c5.cgls --seed 7 --seconds 10 --trace 0

Exits with 2, printing no result, where CUDA is missing or the host has
fewer cards than the cell asks for, and with 3 where a JAX module was
loaded by the time the window closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
THREADS = 4


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout,
    so only a checkout's first run builds."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["OMP_NUM_THREADS"] = str(THREADS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    # the checkout in place of this script's folder, whose module names
    # (trace, harness) would shadow others'
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measured process: {bad}", file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readers of the program's own spans and counters
(``cc_view_host_us.prealign``, ``host_syncs_per_pair.recon``), each on a
``Run`` built here from what the program recorded at a size the CPU runs,
with a trace that stands in for the card's; and None where nothing was
recorded, where the trace holds no device time, and where the program
has no recorder (the parent of the change that added it)."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny_cell
from tomojax_torch.align import cc
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon.cgls import cgls_init, cgls_steps
from tomojax_torch.utils import profiling

CARD = {"busy_s": 0.25, "window_s": 1.0, "device_ops": [], "idle_gaps": []}


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _run(workload, steps, trace=CARD):
    return harness.Run(cell=tiny_cell(workload), setup_s=1.0, window_s=1.0,
                       steps=steps, extra={}, trace=trace,
                       device_kind="NVIDIA H100 80GB HBM3")


def _chain():
    """One traced chain over 6 views of 16², as the cell's step 1."""
    p = torch.rand((6, 16, 16), generator=torch.Generator().manual_seed(4))
    with profiling.tracing():
        cc.cross_correlation_chain(p, upsample_factor=10)
    return [{"chains": 1, "views": 5}] * 2


def _pairs():
    """CGLS steps 2-4 of a job (the cells' traced steps) on the plane
    operator at 16³; the operator's orientation groups."""
    geom = Geometry(n_proj=10, vox_shape=(16,) * 3, det_shape=(16, 16))
    views = Views.create(10, phi=np.linspace(0.1, 2.6, 10), device="cpu")
    op = make_operator(geom, views, family="slab_plane", device="cpu")
    b = op.A(torch.rand(geom.vox_shape,
                        generator=torch.Generator().manual_seed(5)))
    s = cgls_steps(op, b, cgls_init(op, b), nsteps=1, niter=10)[0]
    with profiling.tracing():
        for _ in range(3):
            s = cgls_steps(op, b, s, nsteps=1, niter=10)[0]
    # the same solver call after the traced steps is not the reader's
    cgls_steps(op, b, s, nsteps=1, niter=10)
    steps = [{"pairs": 1, "proj": 10}] * 6
    return steps, len(sp.scalar_groups(geom, views, "plane")[0])


def test_cc_view_host_us_is_the_mean_view_span():
    run = _run("c5.prealign", _chain())
    spans, counters = profiling.records()
    views = [s.t1 - s.t0 for s in spans if s.name == "cc.view"]
    assert len(views) == counters["cc.views"] == 5
    got = harness.reader_of("cc_view_host_us.prealign").read(run)
    assert got == pytest.approx(1e6 * sum(views) / 5)
    assert 0 < got < 1e6 * (spans[0].t1 - spans[0].t0) / 5


@pytest.mark.parametrize("workload", ["c5.cgls", "c5.cgls_bf16"])
def test_host_syncs_per_pair_counts_guard_and_rows(workload):
    steps, groups = _pairs()
    got = harness.reader_of("host_syncs_per_pair.recon").read(
        _run(workload, steps))
    # per pair: the guard's bool and one row copy per group of A and of Aᵀ
    assert got == 1 + 2 * groups


@pytest.mark.parametrize("name, workload", [
    ("cc_view_host_us.prealign", "c5.prealign"),
    ("host_syncs_per_pair.recon", "c5.cgls")])
@pytest.mark.parametrize("case", ["nothing recorded", "no device time",
                                  "no recorder"])
def test_reader_finds_nothing(name, workload, case, monkeypatch):
    steps = [{"pairs": 1, "proj": 10, "chains": 1, "views": 5}] * 6
    trace = CARD
    if case == "no device time":
        (_chain if workload == "c5.prealign" else _pairs)()
        trace = dict(CARD, busy_s=0.0)
    elif case == "no recorder":
        (_chain if workload == "c5.prealign" else _pairs)()
        monkeypatch.delattr(profiling, "records")
    assert harness.reader_of(name).read(_run(workload, steps, trace)) is None

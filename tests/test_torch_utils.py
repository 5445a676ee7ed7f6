"""The port's ``utils/profiling.py`` and ``utils/roofline.py`` on the CPU:
the timers (as tomojax's ``tests/test_utils.py`` holds its ``timed``), a
``torch.profiler`` trace written to disk, and the roofline model's bytes
and operations against the count ``chip_smoke.py`` made inline before the
model existed (phases 3 and 5: K1/K2 at 256³ × 180 views in 4 orientation
groups, K3/K4/K5 at 256³ × 90 views), with the bound digits phases 3 and 5
print."""

import json

import numpy as np
import pytest
import torch

from tomojax.utils import profiling as jprofiling

import chip_smoke
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry
from tomojax_torch.utils import profiling, roofline

torch.set_num_threads(1)


def test_timed_helper_matches_tomojax():
    import jax.numpy as jnp
    out, dt = profiling.timed(lambda x: torch.sum(x * 2), torch.ones(16),
                              reps=2)
    jout, _ = jprofiling.timed(lambda x: jnp.sum(x * 2), jnp.ones(16),
                               reps=2)
    assert float(out) == float(jout) == 32.0
    assert dt >= 0.0


def test_timed_counts_warmup_and_reps():
    calls = []
    out, dt = profiling.timed(lambda: calls.append(1) or len(calls),
                              reps=3, warmup=2)
    assert out == 5 and len(calls) == 5 and dt >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # no card here: no device time
    assert profiling.kernel_times(prof) == {}


def _inline_count(groups, taps, fields=1):
    """``chip_smoke.py``'s count before ``utils/roofline.py``: per group
    ``(volume shape, scalar rows, detector shape)``, each oriented volume,
    its scalars and ``fields`` detector images per view read or written
    once; a multiply-add per tap of each sample, one sample per slab."""
    nbytes = flops = 0
    for vol_shape, v, det_shape in groups:
        y = v * det_shape[0] * det_shape[1]
        nbytes += 4 * (np.prod(vol_shape) + v * sp.NS + fields * y)
        flops += 2 * taps * fields * y * vol_shape[1]
    return nbytes, flops


@pytest.mark.parametrize("quad, n_views, sizes, fields, ms", [
    ("plane", 180, (45, 45, 45, 45), 1, "0.361"),      # phase 3: K1, K2
    ("arc", 90, (23, 22, 23, 22), 1, "0.361"),         # phase 5: K3, K4
    ("arc", 90, (23, 22, 23, 22), 12, "4.327"),        # phase 5: K5
])
def test_slab_apply_model_matches_the_smokes_count(quad, n_views, sizes,
                                                   fields, ms):
    geom = Geometry(n_proj=n_views, vox_shape=(256,) * 3,
                    det_shape=(256, 256))
    groups = [((256,) * 3, v, (256, 256)) for v in sizes]
    m = roofline.slab_apply_model(geom, quad, n_views=n_views,
                                  fields=fields, n_groups=len(sizes))
    assert (m["bytes"], m["flops"]) == _inline_count(
        groups, roofline.TAPS[quad], fields)
    bnd = roofline.slab_bound(geom, quad, n_views=n_views, fields=fields,
                              n_groups=len(sizes))
    assert f"{bnd[0]:.3f}" == ms and bnd[1] == "operations"
    assert bnd == roofline.bound(m["bytes"], m["flops"])


def test_groups_bound_of_the_smoke():
    """``chip_smoke.groups_bound`` reads the views and groups from the
    groups it is given."""
    geom = Geometry(n_proj=12, vox_shape=(8,) * 3, det_shape=(8, 8))
    groups = [(torch.zeros(8, 8, 8), torch.zeros(v, sp.NS),
               torch.zeros(v, 8, 8)) for v in (5, 7)]
    assert chip_smoke.groups_bound(geom, groups, "arc", 12) == (
        roofline.slab_bound(geom, "arc", n_views=12, fields=12, n_groups=2))


def test_roofline_shares(monkeypatch):
    geom = Geometry(n_proj=180, vox_shape=(256,) * 3, det_shape=(256, 256))
    r = roofline.roofline(geom, "plane", "f32x2", 6.3e-3, 19.4e-3,
                          n_groups=4)
    assert r["fwd"]["bound"] == "operations"
    assert r["fwd"]["pct_sol"] == pytest.approx(0.3606e-3 / 6.3e-3,
                                                rel=1e-3)
    assert r["adj"]["pct_sol"] < r["fwd"]["pct_sol"]
    monkeypatch.setenv("TOMOJAX_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("TOMOJAX_PEAK_BW", "1e9")
    assert roofline.device_peaks() == (1e12, 1e9)

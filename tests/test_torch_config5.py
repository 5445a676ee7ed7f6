"""``tomojax_torch.tools.config5`` (BASELINE config 5) on the CPU:
``device`` mode at 16³ × 16 views against tomojax's
``examples/baseline_config5.py`` on XLA:CPU (both float32: the record's
``vol_rel_l2`` and the pre-alignment means to 1e-6), and ``mesh`` mode in a
2-rank gloo world (the angle-sharded slab_plane forward bit-equal to the
unsharded one and its adjoint within 1e-6, the volume-sharded plane and
arc operators within 1e-5)."""

import importlib.util
import json
from pathlib import Path

import jax
import pytest
import torch

from tests import _torch_dist_ranks as ranks
from tomojax_torch.tools import config5

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--size", "16", "--views", "16"]
TOL = 1e-6


@pytest.fixture(scope="module")
def jconfig5():
    spec = importlib.util.spec_from_file_location(
        "baseline_config5", ROOT / "examples" / "baseline_config5.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_record(jconfig5, tmp_path, monkeypatch, argv):
    """tomojax's config-5 script, writing into ``tmp_path`` (its record and its
    compilation cache); the process's cache setting is restored after."""
    out = tmp_path / "jax.json"
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr("sys.argv", ["baseline_config5.py", *argv, "--out",
                                     str(out)])
    cache = jax.config.jax_compilation_cache_dir
    try:
        jconfig5.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return json.loads(out.read_text())


@pytest.mark.parametrize("prealign", ["none", "cc", "com"])
def test_device_mode_matches_tomojax(jconfig5, tmp_path, monkeypatch,
                                     prealign):
    argv = [*SMALL, "--prealign", prealign]
    want = _jax_record(jconfig5, tmp_path, monkeypatch, argv)
    got = config5.main([*argv, "--device", "cpu", "--out",
                        str(tmp_path / "port.json")])
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert got["cgls_iters_run"] == want["cgls_iters_run"] == 10
    assert abs(got["vol_rel_l2"] - want["vol_rel_l2"]) <= TOL
    keys = ["prealign_tx_gc_mean", "prealign_tz_gc_mean"]
    if prealign == "none":
        assert not set(keys) & set(got)
        assert "wall_to_aligned_recon_s" not in got
    else:
        for k in keys:
            assert abs(got[k] - want[k]) <= TOL, k
        assert got["wall_to_aligned_recon_s"] == pytest.approx(
            got["t_prealign_s"] + got["t_cgls_s"])
    assert got["device"] == {"type": "cpu", "name": "cpu"}


def test_reduced_precision_raises(tmp_path):
    """``--prec bf16`` (which raised until the tier was ported) runs the
    CGLS stage on the bf16 operator: the record says so, CGLS runs its 10
    iterations, and the rel-L2 lies within 5e-3 of the f32x2 run on the
    same problem (the data stays fp32)."""
    out = tmp_path / "bf16.json"
    got = config5.main([*SMALL, "--device", "cpu", "--prec", "bf16",
                        "--out", str(out)])
    want = config5.main([*SMALL, "--device", "cpu"])
    assert json.loads(out.read_text())["prec"] == got["prec"] == "bf16"
    assert want["prec"] == "f32x2"
    assert got["cgls_iters_run"] == 10 and got["cgls_stop"] == 0
    assert abs(got["vol_rel_l2"] - want["vol_rel_l2"]) <= 5e-3
    assert got["vol_rel_l2"] != want["vol_rel_l2"]


def test_mesh_mode_in_a_two_rank_world(tmp_path):
    out = tmp_path / "mesh.json"
    ranks.spawn(ranks.main_rank, 2, tmp_path, "tomojax_torch.tools.config5",
                ["--mode", "mesh", "--device", "cpu", *SMALL, "--out",
                 str(out)])
    rec = json.loads(out.read_text())
    assert rec["world"] == 2 and rec["volume_mesh"] == [1, 2]
    # each rank's views sum into its own volume before the all_reduce: the
    # adjoint's sums run in another order than the unsharded operator's
    assert rec["angle_sharded_fwd_equal"]
    assert rec["angle_sharded_adj_rel"] <= 1e-6
    for quad in ("plane", "arc"):
        assert rec[f"vol_sharded_{quad}_fwd_rel"] <= 1e-5
        assert rec[f"vol_sharded_{quad}_adj_rel"] <= 1e-5
    assert rec["vol_vs_angle_fwd_rel"] <= 1e-5

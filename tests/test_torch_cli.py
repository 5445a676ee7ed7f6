"""The port's CLI end to end against tomojax's, on the CPU.

The port's ``simulate`` (slab_plane) writes a 32³ dataset; tomojax's and
the port's ``reconstruct`` both read it and run CGLS on slab_plane. Both
run float32 (tomojax's CLI operator is float32), so the volumes agree to
float32 rounding grown over the iterations: 1e-4 relative.
"""

import types

import numpy as np
import pytest
import torch

from tomojax import cli as jcli
from tomojax.utils import io as jio

from tests import _torch_dist_ranks as ranks
from tomojax_torch import cli as tcli

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

SIM = ["--size", "32", "--views", "10", "--set", "simulate.family=slab_plane",
       "--set", "simulate.max_shift_px=3"]
RECON = ["--set", "solver.family=slab_plane", "--set", "solver.method=cgls",
         "--set", "solver.niter=8"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "d.h5"
    tcli.main(["simulate", *SIM, "-o", str(path), "--device", "cpu"])
    return path


def test_simulate_matches_tomojax(dataset, tmp_path):
    ref_path = tmp_path / "ref.h5"
    jcli.main(["simulate", *SIM, "-o", str(ref_path)])
    got, ref = jio.load_dataset(dataset), jio.load_dataset(ref_path)
    assert sorted(got) == sorted(ref)
    for k in ("phi", "alpha", "beta", "xyz", "phantom"):
        np.testing.assert_array_equal(got[k], ref[k])
    p, q = got["projections"], ref["projections"]
    assert p.dtype == q.dtype == np.float32 and p.shape == q.shape
    assert np.linalg.norm(p - q) / np.linalg.norm(q) < 1e-6


def test_simulate_arc_matches_tomojax(tmp_path):
    sim = ["--size", "24", "--views", "8", "--set", "simulate.family=slab",
           "--set", "simulate.max_angle_deg=0.5"]
    tcli.main(["simulate", *sim, "-o", str(tmp_path / "t.h5"), "--device",
               "cpu"])
    jcli.main(["simulate", *sim, "-o", str(tmp_path / "j.h5")])
    got = jio.load_dataset(tmp_path / "t.h5")
    ref = jio.load_dataset(tmp_path / "j.h5")
    for k in ("phi", "alpha", "beta", "xyz", "phantom"):
        np.testing.assert_array_equal(got[k], ref[k])
    p, q = got["projections"], ref["projections"]
    assert p.dtype == q.dtype == np.float32 and p.shape == q.shape
    assert np.linalg.norm(p - q) / np.linalg.norm(q) < 1e-6


def test_simulate_ray_matches_tomojax(tmp_path):
    """The default family, the exact ray family, and the fast family,
    which tomojax simulates with the ray projector too."""
    for fam in ("ray", "fast"):
        sim = ["--size", "16", "--views", "6", "--set",
               f"simulate.family={fam}"][:4 if fam == "ray" else 6]
        tcli.main(["simulate", *sim, "-o", str(tmp_path / "t.h5"),
                   "--device", "cpu"])
        jcli.main(["simulate", *sim, "-o", str(tmp_path / "j.h5")])
        got = jio.load_dataset(tmp_path / "t.h5")
        ref = jio.load_dataset(tmp_path / "j.h5")
        for k in ("phi", "alpha", "beta", "xyz", "phantom"):
            np.testing.assert_array_equal(got[k], ref[k])
        p, q = got["projections"], ref["projections"]
        assert p.dtype == q.dtype == np.float32 and p.shape == q.shape
        assert np.linalg.norm(p - q) / np.linalg.norm(q) < 1e-6


def _residual_line(text):
    return [line for line in text.splitlines()
            if line.startswith("pre-align")]


@pytest.mark.parametrize("pre_align", ["none", "com", "cc"])
def test_reconstruct_matches_tomojax(dataset, tmp_path, pre_align, capsys,
                                     monkeypatch):
    args = ["reconstruct", "-i", str(dataset), *RECON, "--pre-align",
            pre_align]
    # tomojax's cc path subtracts in place from np.asarray of a JAX array,
    # which is read-only: run it with a copying asarray
    copying_np = types.SimpleNamespace(**vars(np))
    copying_np.asarray = np.array
    monkeypatch.setattr(jcli, "np", copying_np)
    jcli.main([*args, "-o", str(tmp_path / "j.npy")])
    want = _residual_line(capsys.readouterr().out)
    out = tcli.main([*args, "-o", str(tmp_path / "t.npy"), "--device",
                     "cpu"])
    assert _residual_line(capsys.readouterr().out) == want
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == ref.shape == (32, 32, 32)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4
    assert out["result"].n_iter == 8
    assert ("pre_align_residual" in out) == (pre_align != "none")
    assert len(want) == (pre_align != "none")


@pytest.mark.parametrize("method", ["tikhonov", "lasso", "fista_tv"])
def test_reconstruct_solvers_match_tomojax(dataset, tmp_path, method,
                                           capsys):
    args = ["reconstruct", "-i", str(dataset), "--set",
            "solver.family=slab_plane", "--set", f"solver.method={method}",
            "--set", "solver.niter=6", "--set", "solver.hyper=400",
            "--set", "solver.reg_param=0.5", "--set", "solver.niter_tv=5"]
    jcli.main([*args, "-o", str(tmp_path / "j.npy")])
    want = capsys.readouterr().out.splitlines()[0]
    out = tcli.main([*args, "-o", str(tmp_path / "t.npy"), "--device",
                     "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == want
    assert want.startswith(f"{method}: {out['result'].n_iter} iterations")
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def test_reconstruct_shard_in_a_two_rank_world(dataset, tmp_path):
    """With more than one rank, ``--shard`` angle-shards the ray family
    over the process group, as tomojax's does over its devices (its
    sharded operator is the ray family whatever ``solver.family`` says):
    in a 2-rank gloo world rank 0 writes the volume, equal to the
    unsharded ray-family run up to float32 summation order."""
    args = ["reconstruct", "-i", str(dataset), *RECON, "--device", "cpu"]
    shard, plain = tmp_path / "shard.npy", tmp_path / "plain.npy"
    ranks.spawn(ranks.main_rank, 2, tmp_path, "tomojax_torch.cli",
                [*args, "--shard", "-o", str(shard)])
    out = tcli.main([*args, "--set", "solver.family=ray", "-o", str(plain)])
    got, ref = np.load(shard), np.load(plain)
    assert got.shape == ref.shape == (32, 32, 32)
    assert out["result"].n_iter == 8
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-5


def test_reconstruct_shard_on_one_device_is_unsharded(dataset, tmp_path):
    """tomojax angle-shards only over more than one device: on one it
    builds the plain operator, and so does the port. (This process's JAX
    sees several CPU devices, so tomojax's reference here is its unsharded
    run.)"""
    args = ["reconstruct", "-i", str(dataset), *RECON]
    jcli.main([*args, "-o", str(tmp_path / "j.npy")])
    for name, extra in (("shard", ["--shard"]), ("plain", [])):
        tcli.main([*args, *extra, "-o", str(tmp_path / f"{name}.npy"),
                   "--device", "cpu"])
    got = np.load(tmp_path / "shard.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "plain.npy"))
    ref = np.load(tmp_path / "j.npy")
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-4


def test_cuda_device_raises_without_card(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["reconstruct", "-i", str(dataset), "-o",
                   str(tmp_path / "t.npy"), *RECON])

"""tomojax_torch foundations against tomojax: geometry grids, rotations,
phantoms, config, dataset IO, interop, and the package's import boundary.

Inputs come from numpy with a seed and go to both packages; grids and
rotations must agree to 1e-14 (both float64), phantoms bit for bit.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import rotations as jrot
from tomojax.utils import config as jcfg
from tomojax.utils import io as jio

from tomojax_torch.core import geometry as tgeo
from tomojax_torch.core import phantom as tph
from tomojax_torch.core import rotations as trot
from tomojax_torch.core.operators import make_operator
from tomojax_torch.utils import config as tcfg
from tomojax_torch.utils import interop
from tomojax_torch.utils import io as tio

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


GEOMETRIES = [
    dict(n_proj=7, vox_shape=(16, 16, 12), det_shape=(20, 14)),
    dict(n_proj=3, vox_shape=(9, 9, 9), det_shape=(9, 11),
         vox_pix=(0.5, 0.5, 0.75), det_pix=(0.8, 1.1), step_size=0.5),
]


@pytest.mark.parametrize("kw", GEOMETRIES)
def test_geometry_grids_match(kw):
    jg, tg = jgeo.Geometry(**kw), tgeo.Geometry(**kw)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    for name in ("n_vox", "n_det", "vox_size", "det_size", "ray_length",
                 "n_steps"):
        assert getattr(jg, name) == getattr(tg, name), name
    np.testing.assert_allclose(tg.vox_origin_np(), jg.vox_origin_np(),
                               rtol=0, atol=1e-14)


@pytest.mark.parametrize("kw", GEOMETRIES)
@pytest.mark.parametrize("name", ["vox_centers", "source_centers",
                                  "det_centers", "det_grid", "det_orig"])
def test_ray_family_grids_match(kw, name):
    """The ray family's host grids equal tomojax's; the tensor accessors
    carry them in the dtype and on the device asked for."""
    jg, tg = jgeo.Geometry(**kw), tgeo.Geometry(**kw)
    want = np.asarray(getattr(jg, name + "_np")())
    np.testing.assert_array_equal(np.asarray(getattr(tg, name + "_np")()),
                                  want)
    if hasattr(tg, name):
        t = getattr(tg, name)(dtype=torch.float64, device="cpu")
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), want)
        assert getattr(tg, name)().dtype == torch.float32


@pytest.mark.parametrize("kw", GEOMETRIES)
def test_factor_matches(kw):
    assert tgeo.Geometry(**kw).factor == jgeo.Geometry(**kw).factor


@pytest.mark.parametrize("name", ["rot_x", "rot_y", "rot_z", "der_rot_x",
                                  "der_rot_y", "der_rot_z"])
def test_rotations_match(name):
    rng = np.random.default_rng(0)
    for a in rng.uniform(-4, 4, 5):
        ref = np.asarray(getattr(jrot, name)(jnp.asarray(a, jnp.float64)))
        got = getattr(trot, name)(torch.tensor(a, dtype=torch.float64))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


@pytest.mark.parametrize("name", ["ray_rotation", "voxel_rotation"])
def test_composed_rotations_match(name):
    rng = np.random.default_rng(1)
    angles = rng.uniform(-3, 3, (4, 3))
    got = getattr(trot, name)(*torch.as_tensor(angles.T))   # batched
    for i, (p, a, b) in enumerate(angles):
        ref = np.asarray(getattr(jrot, name)(
            *(jnp.asarray(v, jnp.float64) for v in (p, a, b))))
        np.testing.assert_allclose(got[i].numpy(), ref, rtol=0, atol=1e-14)


def test_phantoms_bit_equal():
    np.testing.assert_array_equal(tph.shepp3d(24), jph.shepp3d(24))
    np.testing.assert_array_equal(tph.shepp3d((20, 16, 12)),
                                  jph.shepp3d((20, 16, 12)))
    np.testing.assert_array_equal(tph.arbitrary_phantom(20, seed=3),
                                  jph.arbitrary_phantom(20, seed=3))


def test_views_create_and_interop_match():
    rng = np.random.default_rng(2)
    n = 9
    kw = dict(phi=rng.uniform(0, 6, n), alpha=rng.uniform(-.02, .02, n),
              beta=rng.uniform(-.02, .02, n), t=rng.uniform(-2, 2, (n, 3)))
    jv = jax.tree.map(np.asarray, jgeo.Views.create(n, **kw))
    tv = tgeo.Views.create(n, **kw)
    iv = interop.views(jv)
    for f in ("phi", "alpha", "beta", "t", "cor"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(), getattr(jv, f))
        np.testing.assert_array_equal(getattr(iv, f).numpy(), getattr(jv, f))
        assert getattr(tv, f).dtype == torch.float32
    # default phi: [0, π] with the endpoint, float32
    np.testing.assert_allclose(
        tgeo.Views.create(n).phi.numpy(),
        np.asarray(jgeo.Views.create(n).phi), rtol=0, atol=1e-6)
    jg = jgeo.Geometry(n_proj=n, vox_shape=(8, 8, 6), det_shape=(8, 7))
    assert interop.geometry(dataclasses.asdict(jg)) == tgeo.Geometry(
        n_proj=n, vox_shape=(8, 8, 6), det_shape=(8, 7))


def test_config_matches():
    assert (dataclasses.asdict(tcfg.ExperimentConfig())
            == dataclasses.asdict(jcfg.ExperimentConfig()))
    s = jcfg.ExperimentConfig().to_json()
    assert (dataclasses.asdict(tcfg.ExperimentConfig.from_json(s))
            == dataclasses.asdict(jcfg.ExperimentConfig.from_json(s)))
    assert tcfg.SolverConfig().family == "ray"
    g = tcfg.GeometryConfig(n_proj=5).build()
    assert isinstance(g, tgeo.Geometry) and g.n_proj == 5


def test_dataset64_loads():
    path = REPO / "dataset64.h5"
    got, ref = tio.load_dataset(path), jio.load_dataset(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    tv = tio.views_from_dataset(got, device="cpu")
    jv = jio.views_from_dataset(ref)
    for f in ("phi", "alpha", "beta", "t", "cor"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)))


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_dataset_roundtrip(tmp_path, suffix):
    rng = np.random.default_rng(4)
    arrays = dict(projections=rng.random((3, 4, 5), np.float32),
                  phi=rng.random(3), alpha=rng.random(3), beta=rng.random(3),
                  xyz=rng.random((3, 3)), phantom=rng.random((4, 4, 5)))
    path = tmp_path / f"d{suffix}"
    tio.save_dataset(path, **arrays)
    got = tio.load_dataset(path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    if suffix == ".h5":   # readable by tomojax
        np.testing.assert_array_equal(jio.load_dataset(path)["phi"],
                                      arrays["phi"])


def test_import_loads_no_jax():
    code = (
        "import sys; before = set(sys.modules)\n"
        "import tomojax_torch, tomojax_torch.cli, tomojax_torch.recon, "
        "tomojax_torch.align, tomojax_torch.utils, "
        "tomojax_torch.kernels.slab, tomojax_torch.kernels._build, "
        "tomojax_torch.core.operators, tomojax_torch.align.pipeline, "
        "tomojax_torch.align.slab_refine, tomojax_torch.core.projector, "
        "tomojax_torch.tools.config1, tomojax_torch.tools.config2, "
        "tomojax_torch.tools.config3\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tomojax'))\n"
        "assert 'jax' not in sys.modules, 'jax loaded'\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_make_operator_cuda_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    geom = tgeo.Geometry(n_proj=2, vox_shape=(8, 8, 8), det_shape=(8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        make_operator(geom, tgeo.Views.create(2), family="slab_plane",
                      device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        make_operator(geom, tgeo.Views.create(2),     # default device
                      family="slab_plane")
    with pytest.raises(RuntimeError, match="cuda"):
        make_operator(geom, tgeo.Views.create(2))     # and family (ray)

"""The port's ``native`` runtime (its own copy of ``tomonative.cpp``, built
with g++ into ``build/native/``) against the port's exact ray family and
tomojax's ``native``: tomojax's three checks (``tests/test_native.py``),
float64, to 1e-12."""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from tomojax import native as jnative

from tomojax_torch import native
from tomojax_torch.core import projector
from tomojax_torch.core.geometry import Geometry

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.is_available():
        pytest.skip("no C++ toolchain (g++)")


def _setup(n=16):
    rng = np.random.default_rng(0)
    vol = rng.random((n, n, n))
    geom = Geometry(n_proj=1, vox_shape=(n, n, n), det_shape=(n, n))
    return vol, geom


def _t(*a):
    return [torch.as_tensor(np.asarray(x, np.float64)) for x in a]


def test_native_forward_matches_ray_family():
    vol, geom = _setup()
    t = np.array([0.6, 0.0, -0.3])
    cor = np.array([0.4, 0.0, 0.0])
    got = native.forward_view(vol, geom, 0.7, 0.011, -0.007, t, cor)
    want = projector.forward_view(torch.as_tensor(vol), geom,
                                  *_t(0.7, 0.011, -0.007, t, cor),
                                  dtype=F64).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jnative.forward_view(
        vol, geom, 0.7, 0.011, -0.007, t, cor), rtol=TOL, atol=TOL)


def test_native_adjoint_matches_ray_family():
    vol, geom = _setup()
    y = np.random.default_rng(1).random(geom.n_det)
    t = np.array([0.2, 0.0, 0.1])
    got = native.backproject_view(y, geom, 0.4, 0.005, -0.003, t)
    want = projector.backproject_view(torch.as_tensor(y), geom.vox_shape,
                                      geom, *_t(0.4, 0.005, -0.003, t,
                                                np.zeros(3)),
                                      dtype=F64).numpy()
    assert got.shape == geom.vox_shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_native_sparse_coo_reconstructs_forward():
    vol, geom = _setup(12)
    det_inds, dat_inds, wts = native.sparse_view_coo(
        geom, 0.9, 0.0, 0.0, np.zeros(3))
    out = np.zeros(geom.n_det)
    np.add.at(out, det_inds, wts * vol.ravel()[dat_inds])
    want = native.forward_view(vol, geom, 0.9, 0.0, 0.0, np.zeros(3))
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


def test_native_source_is_the_ports_own_copy():
    """The port builds its own copy (byte for byte tomojax's) into
    ``build/native/``, never into ``tomojax/native/``."""
    here = Path(native.__file__).resolve().parent
    root = here.parents[1]
    assert filecmp.cmp(here / "tomonative.cpp",
                       root / "tomojax" / "native" / "tomonative.cpp",
                       shallow=False)
    lib = native.library_path()
    assert lib.exists() and lib.parent == root / "build" / "native"

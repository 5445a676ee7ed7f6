"""tomojax_torch's slab_plane projector against tomojax's XLA path.

Same inputs (numpy, seeded) through both packages in float64 on the CPU,
where tomojax's ``project`` takes its XLA path and the port's wrappers take
their plain versions. Generic angles (phi0 = 0.3 rad, never k·90°) and
jitter put views in all four reachable orientation groups. The operator
must agree to 1e-10 relative and pass the dot-product test at 1e-10, as
tests/test_slab_projector.py holds tomojax to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import slab_projector as jsp
from tomojax.core.operators import make_operator as jmake

from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 24, 10
    rng = np.random.default_rng(0)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n, n, n),
                       det_shape=(n + 4, n - 2))
    jv = jgeo.Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, n_proj),
        beta=rng.uniform(-0.02, 0.02, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)))
    vol = jph.shepp3d(n).astype(np.float64) + 0.1 * rng.random((n,) * 3)
    y = rng.standard_normal((n_proj, jg.n_det))
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return dict(jg=jg, jv=jv, tg=tg, tv=tv, vol=vol, y=y)


def test_scalar_groups_match(prob):
    jg, jv, tg, tv = prob["jg"], prob["jv"], prob["tg"], prob["tv"]
    jgs, jsc = jsp.scalar_groups(jg, jv, "plane", jnp.float64)
    tgs, tsc = tsp.scalar_groups(tg, tv, "plane", dtype=F64, device="cpu")
    assert len(tgs) == 4
    assert tgs == tuple(g[:4] for g in jgs)
    for a, b in zip(tsc, jsc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)
        # the scalars agree to an ulp (they come from the torch θ → scalars
        # map); the named fields must follow from a row exactly
        got = tsp.params_from_scalars(torch.as_tensor(np.array(b)))
        for i in range(a.shape[0]):
            ref = jsp.params_from_scalars(b[i])   # one row
            for name, val in got.items():
                assert float(val[i]) == float(getattr(ref, name)), name
    for a, b in zip(tsp.orient_flags(tv, tg), jsp.orient_flags(jv, jg)):
        np.testing.assert_array_equal(a, b)
    # a frozen structure gives the same scalars
    _, tsc2 = tsp.group_scalars_for(tg, tv, tgs, "plane", dtype=F64)
    _, jsc2 = jsp.group_scalars_for(jg, jv, jgs, "plane", jnp.float64)
    for a, b in zip(tsc2, jsc2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("yflip", [False, True])
def test_orient_volume_roundtrip(prob, swap, yflip):
    jg, tg = prob["jg"], prob["tg"]
    vol = prob["vol"]
    ref = np.asarray(jsp.orient_volume(jnp.asarray(vol), jg, swap, yflip))
    got = tsp.orient_volume(torch.as_tensor(vol), tg, swap, yflip)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tsp.unorient_volume(got, swap, yflip)
    np.testing.assert_array_equal(back.numpy(), vol)


def test_forward_matches_tomojax(prob):
    ref = jsp.project(jnp.asarray(prob["vol"]), prob["jg"], prob["jv"],
                      dtype=jnp.float64, quad="plane")
    got = tsp.project(torch.as_tensor(prob["vol"]), prob["tg"], prob["tv"],
                      dtype=F64, quad="plane")
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) < 1e-10


def test_adjoint_matches_tomojax(prob):
    ref = jsp.backproject(jnp.asarray(prob["y"]), prob["jg"], prob["jv"],
                          dtype=jnp.float64, quad="plane")
    got = tsp.backproject(torch.as_tensor(prob["y"]), prob["tg"],
                          prob["tv"], dtype=F64, quad="plane")
    assert _rel(got.numpy(), ref) < 1e-10


def test_adjoint_dot_product(prob):
    tg, tv = prob["tg"], prob["tv"]
    x, y = torch.as_tensor(prob["vol"]), torch.as_tensor(prob["y"])
    ax = tsp.project(x, tg, tv, dtype=F64, quad="plane")
    aty = tsp.backproject(y, tg, tv, dtype=F64, quad="plane")
    lhs, rhs = float(torch.dot(ax.reshape(-1), y.reshape(-1))), float(
        torch.dot(x.reshape(-1), aty.reshape(-1)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_autograd_backward_equals_backproject(prob):
    tg, tv = prob["tg"], prob["tv"]
    x = torch.as_tensor(prob["vol"]).requires_grad_(True)
    y = torch.as_tensor(prob["y"])
    (gx,) = torch.autograd.grad(tsp.project(x, tg, tv, dtype=F64,
                                            quad="plane"), x, y)
    ref = tsp.backproject(y, tg, tv, dtype=F64, quad="plane")
    assert _rel(gx.numpy(), ref.numpy()) < 1e-13


def test_cpu_wrappers_take_plain_version(prob):
    tg, tv = prob["tg"], prob["tv"]
    one = {k: v[:1] for k, v in tv.numpy().items()}
    ((_, sw, yf, _),), (sc,) = tsp.scalar_groups(tg, one, "plane",
                                                 dtype=F64)
    vol_or = tsp.orient_volume(torch.as_tensor(prob["vol"]), tg, sw, yf)
    counts = (slabk.slab_plane_fwd.launches, slabk.slab_plane_adj.launches)
    np.testing.assert_array_equal(
        slabk.slab_project(vol_or, sc, tg).numpy(),
        tsp.forward_oriented(vol_or, sc, tg).numpy())
    g = torch.as_tensor(prob["y"][:1]).reshape(1, *tg.det_shape)
    np.testing.assert_array_equal(
        slabk.slab_backproject(g, sc, tg).numpy(),
        tsp.adjoint_oriented(g, sc, tg).numpy())
    # no kernel ran: the counters count kernel launches only
    assert counts == (slabk.slab_plane_fwd.launches,
                      slabk.slab_plane_adj.launches)


def test_voxel_mask_matches_tomojax(prob):
    n = prob["jg"].vox_shape[0]
    mask = np.random.default_rng(7).random((n,) * 3) > 0.3
    jop = jmake(prob["jg"], prob["jv"], family="slab_plane",
                dtype=jnp.float64, voxel_mask=mask)
    top = tmake(prob["tg"], prob["tv"], family="slab_plane", dtype=F64,
                voxel_mask=mask, device="cpu")
    x, y = prob["vol"], prob["y"]
    assert _rel(top.A(torch.as_tensor(x)).numpy(),
                jop.A(jnp.asarray(x))) < 1e-10
    aty = top.AT(torch.as_tensor(y)).numpy()
    assert _rel(aty, jop.AT(jnp.asarray(y))) < 1e-10
    assert np.all(aty[~mask] == 0.0)
    assert top.shape == jop.shape and top.vol_shape == jop.vol_shape


@pytest.mark.parametrize("family", ["voxel"])
def test_formerly_unported_families_match_tomojax(prob, family):
    """The voxel family (it raised before it was ported) on this
    file's problem: A and Aᵀ as tomojax's."""
    jop = jmake(prob["jg"], prob["jv"], family=family, dtype=jnp.float64)
    top = tmake(prob["tg"], prob["tv"], family=family, dtype=F64,
                device="cpu")
    assert top.family == family
    x, y = prob["vol"], prob["y"]
    assert _rel(top.A(torch.as_tensor(x)).numpy(),
                jop.A(jnp.asarray(x))) < 1e-10
    assert _rel(top.AT(torch.as_tensor(y)).numpy(),
                jop.AT(jnp.asarray(y))) < 1e-10

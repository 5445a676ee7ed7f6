"""The port's voxel-driven family (``core/voxel_projector.py``) against
tomojax's, on the CPU in float64, and tomojax's own checks of the family
(``tests/test_voxel_projector.py``) on the port.

Parity: ``forward_view``, ``backproject_view``, ``forward_view_jac``,
``make_operator(family="voxel")`` A/Aᵀ (with a voxel mask and view chunks)
to 1e-10 relative. ``align_reconstruct(family="voxel")`` is held to
tomojax's in ``tests/test_torch_align.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tomojax.core import geometry as jgeo
from tomojax.core import operators as jops
from tomojax.core import phantom as jph
from tomojax.core import voxel_projector as jvox

from tomojax_torch.core import phantom
from tomojax_torch.core import projector as ray
from tomojax_torch.core import voxel_projector as vox
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-10

PHI = np.array([0.3, 1.2, 2.0])
ALPHA = np.array([0.01, -0.01, 0.0])
BETA = np.array([0.0, 0.008, -0.012])
T = np.array([[0.5, 0.0, -0.4], [0.0, 0.0, 0.2], [1.0, 0.0, 0.0]])
COR = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [-0.2, 0.0, 0.0]])


def _setup(n=16, seed=0):
    """tomojax's problem (3 jittered views), with a centre-of-rotation
    shift on two views: ``(vol, geom, views, jgeom, jviews)``."""
    vol = np.random.default_rng(seed).random((n, n, n))
    geom = Geometry(n_proj=3, vox_shape=(n, n, n), det_shape=(n, n))
    views = Views.create(3, phi=PHI, alpha=ALPHA, beta=BETA, t=T, cor=COR,
                         dtype=F64)
    jg = jgeo.Geometry(n_proj=3, vox_shape=(n, n, n), det_shape=(n, n))
    jv = jgeo.Views.create(3, phi=PHI, alpha=ALPHA, beta=BETA, t=T, cor=COR,
                           dtype=jnp.float64)
    return vol, geom, views, jg, jv


def _view(views, i):
    return [getattr(views, f)[i] for f in ("phi", "alpha", "beta", "t",
                                            "cor")]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---- tomojax's checks of the family, on the port ------------------------


def test_voxel_adjoint_dot_product():
    vol, geom, views, _, _ = _setup()
    y = torch.as_tensor(np.random.default_rng(1).random((3, geom.n_det)))
    x = torch.as_tensor(vol)
    lhs = float(torch.vdot(vox.project(x, geom, views, dtype=F64).reshape(-1),
                           y.reshape(-1)))
    rhs = float(torch.vdot(x.reshape(-1), vox.backproject(
        y, geom, views, dtype=F64).reshape(-1)))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), 1.0)


def test_voxel_phi0_is_column_sum():
    """At φ = 0 without jitter every voxel centre lands on a pixel centre:
    the splat is the straight y-sum."""
    n = 16
    vol = np.random.default_rng(2).random((n, n, n))
    geom = Geometry(n_proj=1, vox_shape=(n, n, n), det_shape=(n, n))
    views = Views.create(1, phi=np.zeros(1), dtype=F64)
    out = vox.forward_view(torch.as_tensor(vol), geom, *_view(views, 0),
                           dtype=F64)
    np.testing.assert_allclose(out.numpy().reshape(n, n), vol.sum(axis=1),
                               rtol=1e-12, atol=1e-12)


def test_voxel_jacobian_matches_autodiff():
    vol, geom, views, _, _ = _setup(n=8)
    i = 1
    theta = views.theta6()[i]
    x = torch.as_tensor(vol)

    def fwd(th):
        return vox.forward_view(x, geom, th[3], th[4], th[5], th[:3],
                                views.cor[i], dtype=F64)

    jac_ad = torch.autograd.functional.jacobian(fwd, theta)  # (n_det, 6)
    _, jac_an = vox.forward_view_jac(x, geom, *_view(views, i), dtype=F64)
    np.testing.assert_allclose(jac_an.T.numpy(), jac_ad.numpy(), rtol=1e-9,
                               atol=1e-10)


def test_voxel_jacobian_matches_finite_differences():
    vol, geom, views, _, _ = _setup(n=8)
    i = 0
    x = torch.as_tensor(vol)
    theta0 = views.theta6()[i].numpy()

    def fwd_np(th):
        th = torch.as_tensor(th)
        return vox.forward_view(x, geom, th[3], th[4], th[5], th[:3],
                                views.cor[i], dtype=F64).numpy()

    _, jac = vox.forward_view_jac(x, geom, *_view(views, i), dtype=F64)
    grad_an = jac.numpy() @ fwd_np(theta0)
    eps = 1e-6

    def cost(th):
        return 0.5 * np.linalg.norm(fwd_np(th)) ** 2

    for p in range(6):
        dp = np.zeros(6)
        dp[p] = eps
        g_fd = (cost(theta0 + dp) - cost(theta0 - dp)) / (2 * eps)
        np.testing.assert_allclose(grad_an[p], g_fd, rtol=2e-4, atol=1e-6)


def test_families_agree_on_smooth_volume():
    """The ray integral and the voxel splat discretize the same transform:
    ~14% apart pointwise at 32³, total mass to 2%."""
    n = 32
    vol = torch.as_tensor(phantom.shepp3d(n), dtype=F64)
    geom = Geometry(n_proj=1, vox_shape=(n, n, n), det_shape=(n, n))
    views = Views.create(1, phi=np.array([0.4]), dtype=F64)
    a = ray.project(vol, geom, views, dtype=F64)[0].numpy()
    b = vox.project(vol, geom, views, dtype=F64)[0].numpy()
    assert _rel(b, a) < 0.2
    assert abs(a.sum() - b.sum()) / abs(b.sum()) < 0.02


def test_voxel_jacobian_consistent_with_ray_family():
    """At α = β = 0, t = 0 the two parameterizations describe the same
    projection (the ray family moves the rays, the voxel family the
    volume, with the translation before the rotation), so J_ray[tx] =
    −(cos φ J_vox[tx] + sin φ J_vox[ty]), J_ray[tz] = −J_vox[tz] and
    J_ray[φ] = J_vox[φ]; held on Gaussian-smoothed fields (the splat's
    derivative carries voxel-scale aliasing), as tomojax holds its own."""
    n = 32
    g = np.arange(n) - (n - 1) / 2
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    vol = torch.as_tensor(np.exp(-(X**2 + (Y * 1.3)**2 + (Z * 0.8)**2)
                                 / (2 * (n / 6.0) ** 2)))
    geom = Geometry(n_proj=1, vox_shape=(n, n, n), det_shape=(n, n))
    phi = 0.4
    args = (torch.tensor(phi, dtype=F64), torch.zeros((), dtype=F64),
            torch.zeros((), dtype=F64), torch.zeros(3, dtype=F64),
            torch.zeros(3, dtype=F64))
    _, jr = ray.forward_view_jac(vol, geom, *args, dtype=F64)
    _, jv = vox.forward_view_jac(vol, geom, *args, dtype=F64)
    jr = jr.numpy().reshape(6, n, n)
    jv = jv.numpy().reshape(6, n, n)
    c, s = np.cos(phi), np.sin(phi)

    def rel(a, b):
        a = gaussian_filter(a, 2.0)
        b = gaussian_filter(b, 2.0)
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)

    assert rel(jr[0], -(c * jv[0] + s * jv[1])) < 0.2
    assert rel(jr[2], -jv[2]) < 0.25
    assert rel(jr[3], jv[3]) < 0.1


# ---- parity with tomojax --------------------------------------------------


def test_voxel_views_match_tomojax():
    """``forward_view``, ``backproject_view`` and ``forward_view_jac`` of
    each view, and ``voxel_transform``/``derivative_voxel_points``."""
    vol, geom, views, jg, jv = _setup()
    y = np.random.default_rng(4).random(geom.n_det)
    x = torch.as_tensor(vol)
    for i in range(3):
        jargs = _view(jv, i)
        targs = _view(views, i)
        want = jvox.forward_view(jnp.asarray(vol), jg, *jargs,
                                 dtype=jnp.float64)
        assert _rel(vox.forward_view(x, geom, *targs, dtype=F64), want) < TOL
        want = jvox.backproject_view(jnp.asarray(y), jg, *jargs,
                                     dtype=jnp.float64)
        got = vox.backproject_view(torch.as_tensor(y), geom, *targs,
                                   dtype=F64)
        assert got.shape == geom.vox_shape and _rel(got, want) < TOL
        jd, jj = jvox.forward_view_jac(jnp.asarray(vol), jg, *jargs,
                                       dtype=jnp.float64)
        td, tj = vox.forward_view_jac(x, geom, *targs, dtype=F64)
        assert _rel(td, jd) < TOL and _rel(tj, jj) < TOL
    centers = np.array(jg.vox_centers(jnp.float64))
    a, b, p = 0.01, -0.02, 0.7
    t = np.array([0.3, -0.1, 0.2])
    want = jvox.voxel_transform(jnp.asarray(centers), a, b, p,
                                jnp.asarray(t))
    targs = [torch.tensor(v, dtype=F64) for v in (a, b, p)]
    got = vox.voxel_transform(torch.as_tensor(centers), *targs,
                              torch.as_tensor(t))
    assert _rel(got, want) < TOL
    want = jvox.derivative_voxel_points(jnp.asarray(centers), a, b, p,
                                        jnp.asarray(t))
    got = vox.derivative_voxel_points(torch.as_tensor(centers), *targs,
                                      torch.as_tensor(t))
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("chunk, masked", [(None, False), (2, True)])
def test_make_operator_voxel_matches_tomojax(chunk, masked):
    """``make_operator(family="voxel")``: A and Aᵀ, in tomojax's chunks or
    in chunks of 2 views, with and without a voxel mask."""
    n, n_proj = 16, 6
    rng = np.random.default_rng(5)
    kw = dict(phi=np.linspace(0.1, np.pi, n_proj),
              alpha=rng.uniform(-0.01, 0.01, n_proj),
              beta=rng.uniform(-0.01, 0.01, n_proj),
              t=rng.uniform(-1, 1, (n_proj, 3)))
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    mask = rng.random((n,) * 3) > 0.3 if masked else None
    op = make_operator(geom, Views.create(n_proj, **kw, dtype=F64),
                       family="voxel", dtype=F64, views_chunk=chunk,
                       voxel_mask=mask, device="cpu")
    jop = jops.make_operator(jg, jgeo.Views.create(n_proj, **kw,
                                                   dtype=jnp.float64),
                             family="voxel", dtype=jnp.float64,
                             views_chunk=chunk, voxel_mask=mask)
    vol = jph.shepp3d(n).astype(np.float64)
    y = rng.standard_normal((n_proj, geom.n_det))
    assert op.family == "voxel"
    assert _rel(op.A(torch.as_tensor(vol)), jop.A(jnp.asarray(vol))) < TOL
    assert _rel(op.AT(torch.as_tensor(y)), jop.AT(jnp.asarray(y))) < TOL

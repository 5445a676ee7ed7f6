"""The port's batched line searches and gradient descent against tomojax's
``vmap`` of them, on the CPU in float64.

``gradient_descent_views`` runs every view at once; tomojax's pipeline runs
``jax.vmap(gradient_descent_view)``. At 16³ with 5 views and 3 iterations
θ must agree to 1e-8 and cost, ``n_iter`` and ``converged`` must agree.
Two views sit at a lattice-aligned pose (φ = 0, no tilt, integer shifts)
with noisy data: every sample position is an integer there, the cost has
a kink, and the Armijo search along the one-sided gradient fails, so the
brute backoff runs (failing for one view, succeeding for the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align.refine import PARAM_SETS as JSETS
from tomojax.align.refine import gradient_descent_view as jgd
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.recon import linesearch as jls

from tomojax_torch.align import refine as trefine
from tomojax_torch.core import fast_projector as tfp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.recon import linesearch as tls

torch.set_num_threads(1)

F64 = torch.float64


def _quartic():
    """A per-view cost with its own minimum and curvature: f(x) =
    Σ c·(x − m)⁴ + (x − m)², vectorized over views."""
    rng = np.random.default_rng(0)
    m, c = rng.normal(size=(6, 3)), rng.uniform(0.1, 50.0, (6, 3))
    return m, c


def _jax_search(kind, x, d, g, f0, a0, m, c):
    def one(x, d, g, f0, a0, m, c):
        def f(z):
            return jnp.sum(c * (z - m) ** 4 + (z - m) ** 2)

        def gf(z):
            return jax.grad(f)(z)

        if kind == "armijo":
            return jls.armijo(f, x, d, g, f0, alpha0=a0)
        if kind == "wolfe":
            return jls.wolfe(f, gf, x, d, g, f0, alpha0=a0)
        return jls.brute_backoff(f, x, d, f0, alpha0=a0)

    return jax.vmap(one)(x, d, g, f0, a0, m, c)


@pytest.mark.parametrize("kind", ["armijo", "wolfe", "brute"])
def test_line_searches_match_tomojax_vmap(kind):
    m, c = _quartic()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 3)) * 2.0
    g = 4 * c * (x - m) ** 3 + 2 * (x - m)
    d = -g * np.array([[1.0], [1.0], [30.0], [1e-3], [1.0], [-1.0]])
    f0 = np.sum(c * (x - m) ** 4 + (x - m) ** 2, axis=1)
    a0 = np.array([1.0, 0.1, 1.0, 1.0, 1e-2, 1.0])
    want = _jax_search(kind, *(jnp.asarray(a) for a in (x, d, g, f0, a0, m,
                                                        c)))
    tm, tc = torch.as_tensor(m), torch.as_tensor(c)

    def f(z, idx):
        return (tc[idx] * (z - tm[idx]) ** 4 + (z - tm[idx]) ** 2).sum(-1)

    def gf(z, idx):
        return 4 * tc[idx] * (z - tm[idx]) ** 3 + 2 * (z - tm[idx])

    args = [torch.as_tensor(a) for a in (x, d, g, f0)]
    a0t = torch.as_tensor(a0)
    if kind == "armijo":
        got = tls.armijo(f, *args, alpha0=a0t)
    elif kind == "wolfe":
        got = tls.wolfe(f, gf, *args, alpha0=a0t)
    else:
        got = tls.brute_backoff(f, args[0], args[1], args[3], alpha0=a0t)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_array_equal(got.n_evals.numpy(),
                                  np.asarray(want.n_evals))
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=1e-12)
    np.testing.assert_allclose(got.f_new.numpy(), np.asarray(want.f_new),
                               rtol=1e-12)
    if kind == "armijo":
        assert not bool(got.success.all())


@pytest.fixture(scope="module")
def gd_prob():
    n, V = 16, 5
    rng = np.random.default_rng(3)
    jg = jgeo.Geometry(n_proj=V, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = jph.shepp3d(n).astype(np.float64)
    th_true = np.zeros((V, 6))
    th_true[:, 3] = [0.3, 0.7, 2.0, 0.0, 0.0]
    th_true[:3, [0, 2]] = rng.uniform(-1, 1, (3, 2))
    th_true[:3, [4, 5]] = rng.uniform(-0.01, 0.01, (3, 2))
    th_true[3:, 0], th_true[3:, 2] = 1.0, -2.0      # lattice-aligned
    tg = Geometry(n_proj=V, vox_shape=(n,) * 3, det_shape=(n, n))
    # the port's fast project equals tomojax's (tests/test_torch_fast.py)
    meas = tfp.project(torch.as_tensor(vol), tg,
                       Views.from_theta6(torch.as_tensor(th_true)),
                       dtype=F64).numpy()
    for view, seed in ((3, 5), (4, 11)):
        meas[view] += 0.01 * np.random.default_rng(seed).standard_normal(
            n * n)
    th0 = th_true.copy()
    th0[:3, [0, 2]] += rng.uniform(-0.5, 0.5, (3, 2))
    th0[:3, [4, 5]] = 0.0
    cor = np.zeros((V, 3))

    def one(th, p, c):
        return jgd(jnp.asarray(vol), p, jg, th, c, mask=JSETS["xzab"],
                   max_iter=3, family="fast", dtype=jnp.float64)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(th0), jnp.asarray(meas),
                                 jnp.asarray(cor))
    return dict(vol=vol, meas=meas, th0=th0, cor=cor, tg=tg,
                ref=jax.tree.map(np.asarray, ref))


def test_gradient_descent_views_matches_tomojax_vmap(gd_prob, monkeypatch):
    p = gd_prob
    brute = []

    def spy(*a, **k):
        r = tls.brute_backoff(*a, **k)
        brute.extend(r.success.tolist())
        return r

    monkeypatch.setattr(trefine, "brute_backoff", spy)
    got = trefine.gradient_descent_views(
        torch.as_tensor(p["vol"]), torch.as_tensor(p["meas"]), p["tg"],
        torch.as_tensor(p["th0"]), torch.as_tensor(p["cor"]),
        mask=trefine.PARAM_SETS["xzab"], max_iter=3, family="fast",
        dtype=F64)
    ref = p["ref"]
    assert sorted(brute) == [False, True]
    np.testing.assert_allclose(got.theta6.numpy(), ref.theta6, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), ref.cost, rtol=1e-10)
    np.testing.assert_array_equal(got.n_iter.numpy(), ref.n_iter)
    np.testing.assert_array_equal(got.converged.numpy(), ref.converged)


def test_gradient_descent_view_is_one_view_of_the_batch(gd_prob):
    p = gd_prob
    k = 1
    one = trefine.gradient_descent_view(
        torch.as_tensor(p["vol"]), torch.as_tensor(p["meas"][k]), p["tg"],
        torch.as_tensor(p["th0"][k]), torch.as_tensor(p["cor"][k]),
        max_iter=3, family="fast", dtype=F64)
    np.testing.assert_allclose(one.theta6.numpy(), p["ref"].theta6[k],
                               rtol=0, atol=1e-8)
    assert int(one.n_iter) == int(p["ref"].n_iter[k])

"""The port's fast projector family against tomojax's, on the CPU, in
float64 at 16³ with jittered views in every octant.

Bars: project, backproject and the per-view forward to 1e-10 relative,
the adjoint identity to 1e-10, the θ-gradient of the alignment cost to
1e-8 relative, and SIRT on ``make_operator(family="fast")`` to 1e-10.

tomojax is run the way its pipeline runs it: the per-view forward
(``swapped=None``) and the cost gradient under ``jax.vmap``, where its
``lax.cond`` becomes a select. Two reference runs need XLA:CPU's
optimizer off (``xla_backend_optimization_level=0``): on this path
inside a non-batched ``lax.cond`` or SIRT's ``lax.while_loop``, the
optimized XLA:CPU program gives other numbers than tomojax's own eager
operations (2-15% at some x-marching views), while the unoptimized one
equals them and the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align.refine import alignment_cost as jcost
from tomojax.core import fast_projector as jfp
from tomojax.core import geometry as jgeo
from tomojax.core.operators import make_operator as jmake
from tomojax.recon import sirt as jsirt

from tomojax_torch.align import refine as trefine
from tomojax_torch.core import fast_projector as tfp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.recon import sirt as tsirt
from tomojax_torch.utils import interop

torch.set_num_threads(1)

F64 = torch.float64
OPT0 = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 16, 12
    rng = np.random.default_rng(0)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    theta = np.zeros((n_proj, 6))
    theta[:, 3] = 0.2 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False)
    theta[:, [0, 2]] = rng.uniform(-2, 2, (n_proj, 2))
    theta[:, [4, 5]] = rng.uniform(-0.05, 0.05, (n_proj, 2))
    jv = jgeo.Views.create(n_proj, phi=theta[:, 3], alpha=theta[:, 4],
                           beta=theta[:, 5], t=theta[:, :3],
                           dtype=jnp.float64)
    tv = interop.views(jax.tree.map(np.asarray, jv))
    assert 0 < jfp.swap_flags(jv).sum() < n_proj
    return dict(jg=jg, jv=jv, tg=interop.geometry(dataclasses.asdict(jg)),
                tv=tv, theta=theta, vol=rng.random((n,) * 3),
                y=rng.random((n_proj, n * n)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_project_matches_tomojax(prob):
    want = jax.jit(lambda v: jfp.project(v, prob["jg"], prob["jv"],
                                         dtype=jnp.float64))(
        jnp.asarray(prob["vol"]))
    got = tfp.project(torch.as_tensor(prob["vol"]), prob["tg"], prob["tv"],
                      dtype=F64)
    assert np.all(np.linalg.norm(got.numpy() - np.asarray(want), axis=1)
                  <= 1e-10 * np.linalg.norm(np.asarray(want), axis=1))


def test_backproject_matches_tomojax(prob):
    want = jax.jit(lambda y: jfp.backproject(y, prob["jg"], prob["jv"],
                                             dtype=jnp.float64))(
        jnp.asarray(prob["y"]))
    got = tfp.backproject(torch.as_tensor(prob["y"]), prob["tg"],
                          prob["tv"], dtype=F64)
    assert _rel(got.numpy(), want) < 1e-10


def test_forward_view_matches_tomojax(prob):
    jv, tv = prob["jv"], prob["tv"]

    def one(p, a, b, t, c):
        return jfp.forward_view(jnp.asarray(prob["vol"]), prob["jg"], p, a,
                                b, t, c, dtype=jnp.float64, swapped=None)

    want = np.asarray(jax.jit(jax.vmap(one))(jv.phi, jv.alpha, jv.beta, jv.t,
                                             jv.cor))
    vol = torch.as_tensor(prob["vol"])
    for k in range(prob["tg"].n_proj):
        got = tfp.forward_view(vol, prob["tg"], tv.phi[k], tv.alpha[k],
                               tv.beta[k], tv.t[k], tv.cor[k], dtype=F64)
        assert _rel(got.numpy(), want[k]) < 1e-10, k


def test_octant_decision_matches_tomojax(prob):
    tv = prob["tv"]
    E, _ = tfp.view_affine(prob["tg"], tv.phi, tv.alpha, tv.beta, tv.t,
                           tv.cor, F64)
    np.testing.assert_array_equal(tfp.marching_x(E),
                                  jfp.swap_flags(prob["jv"]))


def test_adjoint_identity(prob):
    x, y = torch.as_tensor(prob["vol"]), torch.as_tensor(prob["y"])
    ax = tfp.project(x, prob["tg"], prob["tv"], dtype=F64)
    aty = tfp.backproject(y, prob["tg"], prob["tv"], dtype=F64)
    lhs, rhs = float((ax * y).sum()), float((x * aty).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_cost_gradient_matches_jax_grad(prob):
    theta = prob["theta"] + np.random.default_rng(1).uniform(
        -0.3, 0.3, prob["theta"].shape) * [1, 0, 1, 0, 0.05, 0.05]
    meas = tfp.project(torch.as_tensor(prob["vol"]), prob["tg"], prob["tv"],
                       dtype=F64).numpy()
    cor = np.zeros((len(theta), 3))

    def cost(th, p, c):
        return jcost(jnp.asarray(prob["vol"]), p, prob["jg"], th, c,
                     dtype=jnp.float64, family="fast")

    want_c, want_g = (np.asarray(a) for a in jax.jit(jax.vmap(
        jax.value_and_grad(cost)))(theta, meas, cor))
    th = torch.as_tensor(theta).requires_grad_(True)
    c = trefine.alignment_costs(torch.as_tensor(prob["vol"]),
                                torch.as_tensor(meas), prob["tg"], th,
                                torch.as_tensor(cor), dtype=F64,
                                family="fast")
    (g,) = torch.autograd.grad(c.sum(), th)
    np.testing.assert_allclose(c.detach().numpy(), want_c, rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-8,
                               atol=1e-8 * np.abs(want_g).max())
    one = trefine.alignment_cost(torch.as_tensor(prob["vol"]),
                                 torch.as_tensor(meas[3]), prob["tg"],
                                 torch.as_tensor(theta[3]),
                                 torch.as_tensor(cor[3]), dtype=F64,
                                 family="fast")
    assert float(one) == pytest.approx(float(want_c[3]), rel=1e-10)


def test_make_operator_fast_sirt_matches_tomojax(prob):
    b = tfp.project(torch.as_tensor(prob["vol"]), prob["tg"], prob["tv"],
                    dtype=F64).numpy()
    jop = jmake(prob["jg"], prob["jv"], family="fast", dtype=jnp.float64)
    want = jax.jit(lambda bb: jsirt(jop, bb, niter=6, positivity=True,
                                    ground_truth=prob["vol"]),
                   compiler_options=OPT0)(jnp.asarray(b))
    top = tmake(prob["tg"], prob["tv"], family="fast", dtype=F64,
                device="cpu")
    assert top.family == "fast" and top.shape == jop.shape
    got = tsirt(top, torch.as_tensor(b), niter=6, positivity=True,
                ground_truth=prob["vol"])
    assert _rel(got.x.numpy(), want.x) < 1e-10
    np.testing.assert_allclose(got.rms_error.numpy(),
                               np.asarray(want.rms_error), rtol=1e-10)
    assert got.n_iter == int(want.n_iter)


def test_fast_family_needs_square_footprint():
    geom = Geometry(n_proj=2, vox_shape=(8, 10, 8), det_shape=(8, 8))
    views = Views.create(2, dtype=F64)
    with pytest.raises(ValueError, match="nx == ny"):
        tfp.project(torch.zeros(8, 10, 8, dtype=F64), geom, views, dtype=F64)


def test_fast_operator_defaults_to_the_card(prob):
    """No device means the card; without one, the operator raises."""
    if torch.cuda.is_available():
        op = tmake(prob["tg"], prob["tv"], family="fast")
        assert op.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tmake(prob["tg"], prob["tv"], family="fast")

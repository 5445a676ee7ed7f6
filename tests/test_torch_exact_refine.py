"""The port's exact-family refinement against tomojax's, on the CPU in
float64: the ray family's cost gradient and Jacobian, its finite-difference
check, box Levenberg–Marquardt (``refine_view``/``refine_views``,
``refine_method="lm"``) and gradient descent on the ray family.

One problem throughout (16³, 6 noisy views of the Shepp phantom, ±1 px /
±0.01 rad jitter, starts ±0.5 px off with zero tilts), so tomojax compiles
its programs for one shape. Both packages run the same steps on the same
analytic Jacobian: the gradient and the Jacobian agree to 1e-10 relative,
the refined θ to 1e-8, the costs to 1e-10 relative, and ``n_iter`` and
``converged`` exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import refine as jref
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import projector as jproj

from tomojax_torch.align import refine as tref
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
BOX = np.array([0.8, 0.8, 0.8, np.inf, 0.015, 0.015])


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 16, 6
    rng = np.random.default_rng(4)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = 0.2 + np.linspace(0, np.pi, n_proj, endpoint=False)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    al, be = rng.uniform(-0.01, 0.01, (2, n_proj))
    vol = jph.shepp3d(n).astype(np.float64)
    true = jgeo.Views.create(n_proj, phi=phi, alpha=al, beta=be, t=t,
                             dtype=jnp.float64)
    meas = np.asarray(jproj.project(jnp.asarray(vol), jg, true,
                                    dtype=jnp.float64))
    meas = meas + 0.01 * rng.standard_normal(meas.shape)
    t0 = t.copy()
    t0[:, [0, 2]] += rng.uniform(-0.5, 0.5, (n_proj, 2))
    init = jgeo.Views.create(n_proj, phi=phi, t=t0, dtype=jnp.float64)
    th0 = np.asarray(init.theta6())
    return dict(jg=jg, tg=interop.geometry(dataclasses.asdict(jg)), vol=vol,
                meas=meas, th0=th0, jinit=init,
                init=interop.views(jax.tree.map(np.asarray, init)))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_alignment_cost_grad_matches_tomojax(prob):
    """Per view: cost, gradient and the 6 × n_det Jacobian to 1e-10
    relative; the batched form is the single view's."""
    vol, cor = prob["vol"], np.zeros(3)
    costs = []
    for k, th in enumerate(prob["th0"]):
        want = jref.alignment_cost_grad(jnp.asarray(vol),
                                        jnp.asarray(prob["meas"][k]),
                                        prob["jg"], jnp.asarray(th),
                                        jnp.asarray(cor), dtype=jnp.float64)
        got = tref.alignment_cost_grad(_t(vol), _t(prob["meas"][k]),
                                       prob["tg"], _t(th), _t(cor),
                                       dtype=F64)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max())
        costs.append(float(got[0]))
    batch = tref.alignment_costs_grad(_t(vol), _t(prob["meas"]), prob["tg"],
                                      _t(prob["th0"]), torch.zeros(6, 3),
                                      dtype=F64)
    np.testing.assert_allclose(batch[0].numpy(), costs, rtol=1e-12)


@pytest.mark.parametrize("param_set", ["xzab", "all"])
def test_fd_gradient_matches_tomojax(prob, param_set):
    """Central differences over the masked parameters (zero elsewhere):
    tomojax's to 1e-10 relative, and the analytic gradient to the
    differences' own truncation (1e-3 relative)."""
    k, cor = 2, np.zeros(3)
    th = prob["th0"][k]
    mask = jref.PARAM_SETS[param_set]
    want = np.asarray(jref.fd_gradient(
        jnp.asarray(prob["vol"]), jnp.asarray(prob["meas"][k]), prob["jg"],
        jnp.asarray(th), jnp.asarray(cor), mask=mask, dtype=jnp.float64))
    got = tref.fd_gradient(_t(prob["vol"]), _t(prob["meas"][k]), prob["tg"],
                           _t(th), _t(cor), mask=tref.PARAM_SETS[param_set],
                           dtype=F64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())
    on = np.asarray(tref.PARAM_SETS[param_set])
    assert np.all(got[~on] == 0.0)
    grad = tref.alignment_cost_grad(_t(prob["vol"]), _t(prob["meas"][k]),
                                    prob["tg"], _t(th), _t(cor),
                                    dtype=F64)[1].numpy()
    np.testing.assert_allclose(got[on], grad[on], rtol=1e-3,
                               atol=1e-3 * np.abs(grad).max())


CASES = {"xzab_box": dict(param_set="xzab", box=True, max_iter=6),
         "xz": dict(param_set="xz", box=False, max_iter=12)}


@pytest.mark.parametrize("case", list(CASES))
def test_refine_views_matches_tomojax(prob, case):
    """θ to 1e-8, the costs to 1e-10 relative, ``n_iter`` and
    ``converged`` exactly: the box case stops on its step budget, the xz
    case converges view by view at different steps."""
    c = CASES[case]
    th0 = prob["th0"]
    lo, hi = (th0 - BOX, th0 + BOX) if c["box"] else (None, None)
    want = jref.refine_views(
        jnp.asarray(prob["vol"]), jnp.asarray(prob["meas"]), prob["jg"],
        prob["jinit"], mask=jref.PARAM_SETS[c["param_set"]],
        lower=None if lo is None else jnp.asarray(lo),
        upper=None if hi is None else jnp.asarray(hi),
        max_iter=c["max_iter"], dtype=jnp.float64)
    got = tref.refine_views(_t(prob["vol"]), _t(prob["meas"]), prob["tg"],
                            prob["init"],
                            mask=tref.PARAM_SETS[c["param_set"]], lower=lo,
                            upper=hi, max_iter=c["max_iter"], dtype=F64)
    np.testing.assert_allclose(got.theta6.numpy(), np.asarray(want.theta6),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-10)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    if case == "xz":
        assert len(set(got.n_iter.tolist())) > 1, got.n_iter
        assert bool(got.converged.all())
        # frozen parameters never move
        np.testing.assert_array_equal(got.theta6.numpy()[:, [1, 3, 4, 5]],
                                      th0[:, [1, 3, 4, 5]])
    else:
        assert np.all(got.theta6.numpy() >= lo - 1e-12)
        assert np.all(got.theta6.numpy() <= hi + 1e-12)


def test_refine_view_is_one_view_of_the_batch(prob):
    """``refine_view`` (tomojax's, with its ``lm_lambda0``) for one view,
    and the batch's result for that view."""
    k, cor = 4, np.zeros(3)
    th0 = prob["th0"][k]
    kw = dict(max_iter=6, lm_lambda0=1e-2)
    want = jref.refine_view(jnp.asarray(prob["vol"]),
                            jnp.asarray(prob["meas"][k]), prob["jg"],
                            jnp.asarray(th0), jnp.asarray(cor),
                            lower=jnp.asarray(th0 - BOX),
                            upper=jnp.asarray(th0 + BOX), dtype=jnp.float64,
                            **kw)
    got = tref.refine_view(_t(prob["vol"]), _t(prob["meas"][k]), prob["tg"],
                           _t(th0), _t(cor), lower=th0 - BOX,
                           upper=th0 + BOX, dtype=F64, **kw)
    np.testing.assert_allclose(got.theta6.numpy(), np.asarray(want.theta6),
                               rtol=0, atol=1e-8)
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    batch = tref.refine_views(_t(prob["vol"]), _t(prob["meas"]), prob["tg"],
                              prob["init"], max_iter=6, dtype=F64)
    one = tref.refine_view(_t(prob["vol"]), _t(prob["meas"][k]), prob["tg"],
                           _t(th0), _t(cor), max_iter=6, dtype=F64)
    np.testing.assert_allclose(one.theta6.numpy(), batch.theta6[k].numpy(),
                               rtol=0, atol=1e-12)


def test_gradient_descent_ray_matches_tomojax_vmap(prob):
    """Gradient descent on the ray family (tomojax's default family): the
    port's batch against tomojax's ``jax.vmap`` of ``gradient_descent_view``,
    θ to 1e-8, the costs to 1e-10 relative, ``n_iter`` and ``converged``
    exactly; the single-view entry gives the batch's view."""
    vol, meas, th0 = prob["vol"], prob["meas"], prob["th0"]
    cor = np.zeros((len(th0), 3))

    def one(th, p, c):
        return jref.gradient_descent_view(jnp.asarray(vol), p, prob["jg"],
                                          th, c, mask=jref.PARAM_SETS["xzab"],
                                          max_iter=3, dtype=jnp.float64)

    want = jax.jit(jax.vmap(one))(jnp.asarray(th0), jnp.asarray(meas),
                                  jnp.asarray(cor))
    got = tref.gradient_descent_views(_t(vol), _t(meas), prob["tg"], _t(th0),
                                      _t(cor), max_iter=3, dtype=F64)
    np.testing.assert_allclose(got.theta6.numpy(), np.asarray(want.theta6),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-10)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    k = 1
    single = tref.gradient_descent_view(_t(vol), _t(meas[k]), prob["tg"],
                                        _t(th0[k]), _t(cor[k]), max_iter=3,
                                        family="ray", dtype=F64)
    np.testing.assert_allclose(single.theta6.numpy(),
                               np.asarray(want.theta6)[k], rtol=0, atol=1e-8)

"""tomojax_torch's exact ray family against tomojax's and the NumPy
oracle (tests/oracle.py), on the CPU in float64.

One non-cubic volume (10, 12, 9) and one non-square detector (11, 8), so
that an axis swap shows; jittered views with a centre-of-rotation shift.
Forward, backprojection and Jacobian agree with the oracle and with
tomojax to 1e-12, the adjoint identity holds to 1e-10, and the autograd
gradients match tomojax's custom_vjp to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import oracle
from tomojax.align.refine import alignment_cost as jcost
from tomojax.align.refine import alignment_cost_grad as jcost_grad
from tomojax.core import geometry as jgeo
from tomojax.core import projector as jproj
from tomojax.core.operators import make_operator as jmake

from tomojax_torch.align import refine as trefine
from tomojax_torch.core import projector as tproj
from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.utils import interop

torch.set_num_threads(1)

F64 = torch.float64
VOX, DET, NP = (10, 12, 9), (11, 8), 4


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    vol = rng.random(VOX)
    jg = jgeo.Geometry(n_proj=NP, vox_shape=VOX, det_shape=DET)
    t = rng.uniform(-2, 2, (NP, 3))
    t[:, 1] = 0.0
    cor = np.zeros((NP, 3))
    cor[:, 0] = rng.uniform(-1, 1, NP)
    jv = jgeo.Views.create(NP, phi=np.array([0.0, 0.35, 1.1, 2.2]),
                           alpha=np.array([0.01, -0.017, 0.0, 0.005]),
                           beta=np.array([-0.008, 0.012, 0.017, 0.0]),
                           t=t, cor=cor, dtype=jnp.float64)
    nv = {k: np.array(getattr(jv, k)) for k in jv._fields}
    return dict(vol=vol, jg=jg, jv=jv, nv=nv,
                tg=interop.geometry(dataclasses.asdict(jg)),
                tv=interop.views(jax.tree.map(np.asarray, jv)),
                y=rng.random((NP, DET[0] * DET[1])), rng=rng)


def _oracle_args(prob, i):
    nv = prob["nv"]
    return (nv["alpha"][i], nv["beta"][i], nv["phi"][i], nv["t"][i],
            nv["cor"][i], 1.0)


def _view(prob, i):
    tv = prob["tv"]
    return (tv.phi[i], tv.alpha[i], tv.beta[i], tv.t[i], tv.cor[i])


def _jview(prob, i):
    jv = prob["jv"]
    return (jv.phi[i], jv.alpha[i], jv.beta[i], jv.t[i], jv.cor[i])


def test_forward_matches_oracle_and_tomojax(prob):
    got = tproj.project(torch.as_tensor(prob["vol"]), prob["tg"], prob["tv"],
                        dtype=F64).numpy()
    want = np.asarray(jproj.project(jnp.asarray(prob["vol"]), prob["jg"],
                                    prob["jv"], dtype=jnp.float64))
    assert got.shape == (NP, DET[0] * DET[1])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for i in range(NP):
        ref = oracle.project_view(prob["vol"], DET, *_oracle_args(prob, i))
        np.testing.assert_allclose(got[i], ref, rtol=1e-12, atol=1e-12)
        one = tproj.forward_view(torch.as_tensor(prob["vol"]), prob["tg"],
                                 *_view(prob, i), dtype=F64)
        np.testing.assert_allclose(one.numpy(), ref, rtol=1e-12,
                                   atol=1e-12)


def test_backproject_matches_oracle_and_tomojax(prob):
    for i in (1, 3):
        y = prob["y"][i]
        got = tproj.backproject_view(torch.as_tensor(y), VOX, prob["tg"],
                                     *_view(prob, i), dtype=F64).numpy()
        ref = oracle.backproject_view(y, VOX, DET, *_oracle_args(prob, i))
        want = jproj.backproject_view(jnp.asarray(y), VOX, prob["jg"],
                                      *_jview(prob, i), dtype=jnp.float64)
        assert got.shape == VOX
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_adjoint_dot_product_identity(prob):
    x, y = torch.as_tensor(prob["vol"]), torch.as_tensor(prob["y"])
    ax = tproj.project(x, prob["tg"], prob["tv"], dtype=F64)
    aty = tproj.backproject(y, VOX, prob["tg"], prob["tv"], dtype=F64)
    lhs, rhs = float((ax * y).sum()), float((x * aty).sum())
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_jacobian_matches_oracle_and_tomojax(prob):
    vol = torch.as_tensor(prob["vol"])
    sino, jac = tproj.project_with_jacobians(vol, prob["tg"], prob["tv"],
                                             dtype=F64)
    wsino, wjac = jproj.project_with_jacobians(jnp.asarray(prob["vol"]),
                                               prob["jg"], prob["jv"],
                                               dtype=jnp.float64)
    assert jac.shape == (NP, 6, DET[0] * DET[1])
    np.testing.assert_allclose(sino.numpy(), wsino, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(jac.numpy(), wjac, rtol=1e-12, atol=1e-12)
    for i in range(NP):
        det, jo = oracle.projection_gradient(prob["vol"], DET,
                                             *_oracle_args(prob, i))
        d1, j1 = tproj.forward_view_jac(vol, prob["tg"], *_view(prob, i),
                                        dtype=F64)
        np.testing.assert_allclose(d1.numpy(), det, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(j1.numpy(), jo, rtol=1e-12, atol=1e-12)


def test_project_view_t_gradients(prob):
    """Volume and θ gradients of autograd through the port's Function
    against tomojax's custom_vjp (1e-10) and θ's against central finite
    differences of the oracle."""
    i = 1
    th = np.concatenate([prob["nv"]["t"][i],
                         [prob["nv"][k][i] for k in ("phi", "alpha",
                                                     "beta")]])
    cor = prob["nv"]["cor"][i]
    b = prob["y"][i]

    def jloss(v, t6):
        d = jproj.project_view_t(v, t6, prob["jg"], jnp.asarray(cor),
                                 jnp.float64)
        return 0.5 * jnp.sum((d - b) ** 2)

    jgv, jgt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(prob["vol"]),
                                               jnp.asarray(th))
    v = torch.as_tensor(prob["vol"]).requires_grad_(True)
    t6 = torch.as_tensor(th).requires_grad_(True)
    d = tproj.project_view_t(v, t6, prob["tg"], torch.as_tensor(cor), F64)
    (0.5 * ((d - torch.as_tensor(b)) ** 2).sum()).backward()
    np.testing.assert_allclose(v.grad.numpy(), jgv, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(t6.grad.numpy(), jgt, rtol=1e-10, atol=1e-10)

    def cost(x):
        p = oracle.project_view(prob["vol"], DET, x[4], x[5], x[3], x[:3],
                                cor, 1.0)
        return 0.5 * np.sum((p - b) ** 2)

    eps = 1e-6
    for k in range(6):
        dp = np.zeros(6)
        dp[k] = eps
        fd = (cost(th + dp) - cost(th - dp)) / (2 * eps)
        np.testing.assert_allclose(float(t6.grad[k]), fd, rtol=2e-4,
                                   atol=1e-6)


def test_chunked_matches_unchunked(prob):
    x, y = torch.as_tensor(prob["vol"]), torch.as_tensor(prob["y"])
    full = tproj.project(x, prob["tg"], prob["tv"], dtype=F64, views_chunk=4)
    bp = tproj.backproject(y, VOX, prob["tg"], prob["tv"], dtype=F64,
                           views_chunk=4)
    for chunk in (1, 2, 3):      # 3 → the divisor 2
        np.testing.assert_allclose(
            tproj.project(x, prob["tg"], prob["tv"], dtype=F64,
                          views_chunk=chunk).numpy(), full.numpy(),
            rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(
            tproj.backproject(y, VOX, prob["tg"], prob["tv"], dtype=F64,
                              views_chunk=chunk).numpy(), bp.numpy(),
            rtol=1e-12, atol=1e-12)
    # the march's step blocks do not change the result either
    old = tproj.BLOCK_SAMPLES
    try:
        tproj.BLOCK_SAMPLES = 3 * DET[0] * DET[1]
        small = tproj.project(x, prob["tg"], prob["tv"], dtype=F64)
    finally:
        tproj.BLOCK_SAMPLES = old
    np.testing.assert_allclose(small.numpy(), full.numpy(), rtol=1e-13,
                               atol=1e-13)


def test_f32_close_to_f64(prob):
    x = torch.as_tensor(prob["vol"])
    v32 = interop.views({k: v.astype(np.float32)
                         for k, v in prob["nv"].items()})
    got32 = tproj.project(x.float(), prob["tg"], v32)
    got64 = tproj.project(x, prob["tg"], prob["tv"], dtype=F64)
    assert got32.dtype == torch.float32
    rel = (torch.linalg.norm(got32.double() - got64, dim=1)
           / torch.linalg.norm(got64, dim=1))
    assert float(rel.max()) < 1e-5, rel


def test_make_operator_ray_family(prob):
    """The default family is the ray family; with a mask and with
    tomojax-style ``views_chunk=``/``prec=`` it matches tomojax's A and
    Aᵀ."""
    mask = prob["rng"].random(VOX) > 0.3
    x, y = prob["vol"], prob["y"]
    plain = tmake(prob["tg"], prob["tv"], dtype=F64, device="cpu")
    assert plain.family == "ray" and plain.shape == (NP * 88, 1080)
    for kw in (dict(), dict(views_chunk=2, prec="f32x2")):
        top = tmake(prob["tg"], prob["tv"], dtype=F64, voxel_mask=mask,
                    device="cpu", **kw)
        jop = jmake(prob["jg"], prob["jv"], dtype=jnp.float64,
                    voxel_mask=mask, **kw)
        np.testing.assert_allclose(top.A(torch.as_tensor(x)).numpy(),
                                   jop.A(jnp.asarray(x)), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(top.AT(torch.as_tensor(y)).numpy(),
                                   jop.AT(jnp.asarray(y)), rtol=1e-12,
                                   atol=1e-12)
        assert not top.AT(torch.as_tensor(y)).numpy()[~mask].any()
    chunked = tmake(prob["tg"], prob["tv"], dtype=F64, device="cpu",
                    views_chunk=1)
    np.testing.assert_allclose(chunked.A(torch.as_tensor(x)).numpy(),
                               plain.A(torch.as_tensor(x)).numpy(),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(chunked.AT(torch.as_tensor(y)).numpy(),
                               plain.AT(torch.as_tensor(y)).numpy(),
                               rtol=1e-12, atol=1e-12)
    # the tier is the slab families' (K1b-K4b); the others ignore it, as
    # tomojax's make_operator does
    tier = tmake(prob["tg"], prob["tv"], dtype=F64, device="cpu",
                 prec="bf16")
    assert torch.equal(tier.A(torch.as_tensor(x)),
                       plain.A(torch.as_tensor(x)))
    assert torch.equal(tier.AT(torch.as_tensor(y)),
                       plain.AT(torch.as_tensor(y)))


def test_alignment_cost_ray_matches_tomojax(prob):
    """The single-view cost (default family: ray) and the batched cost's
    θ-gradient, which is tomojax's J·r."""
    vol = torch.as_tensor(prob["vol"])
    theta = prob["tv"].theta6().clone()
    theta[:, [0, 2]] += 0.3
    meas = prob["y"]
    for i in range(NP):
        want = jcost(jnp.asarray(prob["vol"]), jnp.asarray(meas[i]),
                     prob["jg"], jnp.asarray(theta[i].numpy()),
                     jnp.asarray(prob["nv"]["cor"][i]), dtype=jnp.float64)
        got = trefine.alignment_cost(vol, torch.as_tensor(meas[i]),
                                     prob["tg"], theta[i], prob["tv"].cor[i],
                                     dtype=F64)
        assert float(got) == pytest.approx(float(want), rel=1e-12)
    th = theta.clone().requires_grad_(True)
    c = trefine.alignment_costs(vol, torch.as_tensor(meas), prob["tg"], th,
                                prob["tv"].cor, dtype=F64, family="ray")
    (g,) = torch.autograd.grad(c.sum(), th)
    for i in range(NP):
        wc, wg, _, _ = jcost_grad(jnp.asarray(prob["vol"]),
                                  jnp.asarray(meas[i]), prob["jg"],
                                  jnp.asarray(theta[i].numpy()),
                                  jnp.asarray(prob["nv"]["cor"][i]),
                                  dtype=jnp.float64)
        assert float(c[i].detach()) == pytest.approx(float(wc), rel=1e-12)
        np.testing.assert_allclose(g[i].numpy(), wg, rtol=1e-10, atol=1e-10)

"""tomojax_torch's arc-quadrature slab projector against tomojax's XLA path.

Same inputs (numpy, seeded) through both packages in float64 on the CPU,
where tomojax's slab projector takes its XLA path (``_forward_oriented_xla``)
and the port's kernel wrappers take their plain versions. Views sweep all
octants (phi0 = 0.3 rad plus the boundary angles of
tests/test_slab_projector.py) so every reachable orientation group occurs.
The forward, each Jacobian building block and the adjoint must agree to
1e-10 relative, and the adjoint must pass the dot-product test at 1e-10,
as tests/test_slab_projector.py holds tomojax to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import fast_projector as jfp
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import slab_projector as jsp
from tomojax.core.operators import make_operator as jmake

from tomojax_torch.core import fast_projector as tfp
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
SWEEP_DEG = [0, 22, 45, 46, 90, 135, 170, 181, 225, 269, 315]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problem(phi, jitter, n=24, det=(28, 22), seed=0):
    rng = np.random.default_rng(seed)
    n_proj = len(phi)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=det)
    amp = 0.02 if jitter else 0.0
    jv = jgeo.Views.create(
        n_proj, phi=phi, alpha=rng.uniform(-amp, amp, n_proj),
        beta=rng.uniform(-amp, amp, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)) if jitter else None)
    vol = jph.shepp3d(n).astype(np.float64) + 0.1 * rng.random((n,) * 3)
    y = rng.standard_normal((n_proj, jg.n_det))
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return dict(jg=jg, jv=jv, tg=tg, tv=tv, vol=vol, y=y)


@pytest.fixture(scope="module")
def prob():
    return _problem(0.3 + np.linspace(0, 2 * np.pi, 10, endpoint=False),
                    True)


@pytest.mark.parametrize("jitter", [False, True])
def test_arc_forward_octant_sweep(jitter):
    p = _problem(np.deg2rad(SWEEP_DEG), jitter)
    ref = jsp.project(jnp.asarray(p["vol"]), p["jg"], p["jv"],
                      dtype=jnp.float64, quad="arc")
    got = tsp.project(torch.as_tensor(p["vol"]), p["tg"], p["tv"],
                      dtype=F64, quad="arc")
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("deriv, jweight, rweight",
                         [pas[1:] for pas in tsp.JAC_PASSES[1:]],
                         ids=[pas[0] for pas in tsp.JAC_PASSES[1:]])
def test_arc_variants_match_tomojax(prob, deriv, jweight, rweight):
    jgs, jsc = jsp.scalar_groups(prob["jg"], prob["jv"], "arc", jnp.float64)
    tgs, tsc = tsp.scalar_groups(prob["tg"], prob["tv"], "arc", dtype=F64)
    vol = prob["vol"]
    for (idx, sw, yf, uf, _), sj, st in zip(jgs, jsc, tsc):
        vo = jsp.orient_volume(jnp.asarray(vol), prob["jg"], sw, yf)

        def one(row):
            return jsp._forward_oriented_xla(
                vo, jsp.params_from_scalars(row), prob["jg"], quad="arc",
                dtype=jnp.float64, deriv=deriv, jweight=jweight,
                rweight=rweight)

        ref = np.asarray(jax.vmap(one)(sj))
        vt = tsp.orient_volume(torch.as_tensor(vol), prob["tg"], sw, yf)
        got = slabk.slab_project(vt, st, prob["tg"], "arc", deriv, jweight,
                                 rweight).numpy()
        assert _rel(got, ref) < 1e-10, (idx, _rel(got, ref))


def test_arc_adjoint_matches_tomojax(prob):
    ref = jsp.backproject(jnp.asarray(prob["y"]), prob["jg"], prob["jv"],
                          dtype=jnp.float64, quad="arc")
    got = tsp.backproject(torch.as_tensor(prob["y"]), prob["tg"],
                          prob["tv"], dtype=F64, quad="arc")
    assert _rel(got.numpy(), ref) < 1e-10


def test_arc_adjoint_dot_product(prob):
    tg, tv = prob["tg"], prob["tv"]
    x, y = torch.as_tensor(prob["vol"]), torch.as_tensor(prob["y"])
    ax = tsp.project(x, tg, tv, dtype=F64, quad="arc")
    aty = tsp.backproject(y, tg, tv, dtype=F64, quad="arc")
    lhs = float(torch.dot(ax.reshape(-1), y.reshape(-1)))
    rhs = float(torch.dot(x.reshape(-1), aty.reshape(-1)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_make_operator_slab_matches_tomojax(prob):
    n = prob["jg"].vox_shape[0]
    mask = np.random.default_rng(7).random((n,) * 3) > 0.3
    x, y = prob["vol"], prob["y"]
    for vm in (None, mask):
        jop = jmake(prob["jg"], prob["jv"], family="slab",
                    dtype=jnp.float64, voxel_mask=vm)
        top = tmake(prob["tg"], prob["tv"], family="slab", dtype=F64,
                    voxel_mask=vm, device="cpu")
        assert _rel(top.A(torch.as_tensor(x)).numpy(),
                    jop.A(jnp.asarray(x))) < 1e-10
        aty = top.AT(torch.as_tensor(y)).numpy()
        assert _rel(aty, jop.AT(jnp.asarray(y))) < 1e-10
        if vm is not None:
            assert np.all(aty[~vm] == 0.0)
    assert top.family == "slab" and top.shape == jop.shape


def test_arc_autograd_backward_is_adjoint(prob):
    tg, tv = prob["tg"], prob["tv"]
    x = torch.as_tensor(prob["vol"]).requires_grad_(True)
    y = torch.as_tensor(prob["y"])
    (gx,) = torch.autograd.grad(tsp.project(x, tg, tv, dtype=F64,
                                            quad="arc"), x, y)
    ref = tsp.backproject(y, tg, tv, dtype=F64, quad="arc")
    assert _rel(gx.numpy(), ref.numpy()) < 1e-13


def test_cpu_arc_wrappers_take_plain_version(prob):
    tg, tv = prob["tg"], prob["tv"]
    gstruct, scalars = tsp.scalar_groups(tg, tv, "arc", dtype=F64)
    (idx, sw, yf, _), sc = gstruct[0], scalars[0][:2]
    vol_or = tsp.orient_volume(torch.as_tensor(prob["vol"]), tg, sw, yf)
    counts = [f.launches for f in (slabk.slab_arc_fwd, slabk.slab_arc_adj,
                                   slabk.slab_project_jac)]
    fwd = slabk.slab_arc_fwd(vol_or, sc, tg)
    assert torch.equal(fwd, tsp.forward_oriented(vol_or, sc, tg, "arc"))
    g = torch.as_tensor(prob["y"][list(idx[:2])]).reshape(2, *tg.det_shape)
    assert torch.equal(slabk.slab_backproject(g, sc, tg, "arc"),
                       tsp.adjoint_oriented(g, sc, tg, "arc"))
    jac = slabk.slab_project_jac(vol_or, sc, tg)
    assert jac.shape == (2, 12, *tg.det_shape)
    assert torch.equal(jac[:, 0], fwd)
    for i, (_, dv, jw, rw) in enumerate(tsp.JAC_PASSES):
        assert torch.equal(jac[:, i], tsp.forward_oriented(vol_or, sc, tg,
                                                           "arc", dv, jw,
                                                           rw))
    # no kernel ran: the counters count kernel launches only
    assert counts == [f.launches for f in (slabk.slab_arc_fwd,
                                           slabk.slab_arc_adj,
                                           slabk.slab_project_jac)]


@pytest.mark.parametrize("step", [0.5, 0.75, 1.0, 1.5])
def test_n_branch_and_view_affine_match(step):
    assert tsp._n_branch(step) == jsp._n_branch(step)
    jg = jgeo.Geometry(n_proj=1, vox_shape=(12, 12, 10), det_shape=(14, 9),
                       det_pix=(1.0, 1.25), step_size=step)
    tg = interop.geometry(dataclasses.asdict(jg))
    args = (0.7, 0.013, -0.009, np.array([0.4, -0.2, 0.9]),
            np.array([0.3, 0.0, 0.0]))
    E, B = jfp.view_affine(jg, *(jnp.asarray(a) for a in args), jnp.float64)
    tE, tB = tfp.view_affine(tg, *(torch.as_tensor(a, dtype=F64)
                                   for a in args))
    np.testing.assert_allclose(tE.numpy(), np.asarray(E), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tB.numpy(), np.asarray(B), rtol=0, atol=1e-13)


def test_derivative_variants_refused_for_plane(prob):
    tg, tv = prob["tg"], prob["tv"]
    (g, *_), (sc, *_) = tsp.scalar_groups(tg, tv, "plane", dtype=F64)
    vol_or = tsp.orient_volume(torch.as_tensor(prob["vol"]), tg, g[1], g[2])
    with pytest.raises(ValueError, match="arc-mode only"):
        slabk.slab_project(vol_or, sc, tg, "plane", deriv="x")
    with pytest.raises(ValueError, match="quadrature"):
        slabk.slab_project(vol_or, sc, tg, "trapezoid")

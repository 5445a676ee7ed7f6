"""The port's analytic slab Jacobian against tomojax, and against finite
differences of its own forward.

float64 on the CPU, inputs made with numpy from a seed. The per-view
scalars built from θ (``slab_scalars_t``) must equal tomojax's traceable
and host builders to 1e-12; ``forward_view_jac``'s value and (6, n_det)
Jacobian must equal tomojax's to 1e-9; and the response fields and the
translation rows must match central differences as closely as
tests/test_slab_projector.py holds tomojax to (3e-5 and 1e-5).
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

from tomojax_torch.align.slab_refine import _group_value_jac
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64


def _smooth_vol(n):
    xx, yy, zz = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    return np.exp(-((xx - n * 0.47) ** 2 + (yy - n * 0.5) ** 2
                    + (zz - n * 0.45) ** 2) / (n * 1.2))


def _views(n_proj, seed):
    rng = np.random.default_rng(seed)
    return jgeo.Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, n_proj),
        beta=rng.uniform(-0.01, 0.01, n_proj),
        t=rng.uniform(-1, 1, (n_proj, 3)), cor=rng.uniform(-0.5, 0.5,
                                                           (n_proj, 3)),
        dtype=jnp.float64)


def test_slab_scalars_t_matches_jnp_and_np():
    n = 16
    jg = jgeo.Geometry(n_proj=8, vox_shape=(n,) * 3, det_shape=(n + 2, n))
    tg = interop.geometry(dataclasses.asdict(jg))
    jv = _views(8, 4)
    vnp = jax.tree.map(np.asarray, jv)
    for idx, sw, yf, uf in jsp._orient_groups(vnp, jg):
        sub = jax.tree.map(lambda a: a[idx], vnp)
        sc_np = jsp.slab_scalars_np(jg, sub, sw, yf, uf, "arc")
        th = np.concatenate([sub.t, np.stack([sub.phi, sub.alpha, sub.beta],
                                             -1)], -1)
        sc_j = np.asarray(jax.vmap(lambda t6, c: jsp.slab_scalars_jnp(
            jg, t6, c, sw, yf, uf, "arc", dtype=jnp.float64))(
            jnp.asarray(th), jnp.asarray(sub.cor)))
        got = tsp.slab_scalars_t(tg, torch.as_tensor(th),
                                 torch.as_tensor(sub.cor), sw, yf, uf,
                                 "arc").numpy()
        np.testing.assert_allclose(got, sc_j, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got, sc_np, rtol=1e-12, atol=1e-12)
        plane = tsp.slab_scalars_t(tg, torch.as_tensor(th),
                                   torch.as_tensor(sub.cor), sw, yf, uf,
                                   "plane").numpy()
        np.testing.assert_allclose(
            plane, jsp.slab_scalars_np(jg, sub, sw, yf, uf, "plane"),
            rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("phi", [0.5, 2.1, 3.8, 5.3])
def test_forward_view_jac_matches_tomojax(phi):
    n = 24
    jg = jgeo.Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n + 2, n))
    tg = interop.geometry(dataclasses.asdict(jg))
    vol = jph.shepp3d(n).astype(np.float64)
    t = np.array([0.7, -0.3, -0.4])
    cor = np.array([0.2, 0.0, 0.0])
    al, be = 0.011, -0.008
    v_j, j_j = jsp.forward_view_jac(jnp.asarray(vol), jg, phi, al, be,
                                    jnp.asarray(t), jnp.asarray(cor),
                                    dtype=jnp.float64)
    v_t, j_t = tsp.forward_view_jac(torch.as_tensor(vol), tg, phi, al, be,
                                    t, cor, dtype=F64)
    assert j_t.shape == (6, tg.n_det)
    scale = float(np.abs(np.asarray(v_j)).max())
    assert np.abs(v_t.numpy() - np.asarray(v_j)).max() <= 1e-9 * scale
    for k in range(6):
        ref = np.asarray(j_j[k])
        den = max(np.abs(ref).max(), 1e-12)
        assert np.abs(j_t[k].numpy() - ref).max() <= 1e-9 * den, k


def _fd_setup():
    n = 16
    geom = Geometry(n_proj=1, vox_shape=(n,) * 3, det_shape=(n, n))
    vol = torch.as_tensor(_smooth_vol(n))
    th = np.array([0.7, 0.0, -0.4, 0.6, 0.01, -0.008])
    sw, yf, _ = tsp.orient_flags(Views.from_theta6(torch.as_tensor(
        th[None])), geom)
    return geom, vol, th, bool(sw[0]), bool(yf[0])


def test_scalar_responses_fd_exact():
    """Each response field is the a.e.-exact derivative of the arc
    forward in that scalar (central differences, smooth volume)."""
    geom, vol, th, sw, yf = _fd_setup()
    vol_or = tsp.orient_volume(vol, geom, sw, yf)
    sc = tsp.slab_scalars_t(geom, torch.as_tensor(th[None]),
                            torch.zeros(1, 3, dtype=F64), sw, yf, False)
    f = {name: blk for (name, *_), blk in zip(
        tsp.JAC_PASSES, tsp.jac_passes_oriented(vol_or, sc, geom)[0])}
    p = tsp.params_from_scalars(sc[0])
    resp = tsp._scalar_responses(
        p, {a: f["p" + a] for a in "xyz"}, {a: f["j" + a] for a in "xyz"},
        {a: f["r" + a] for a in "xyz"}, f["zm"], f["zc"], geom)
    cols = {"cxb": tsp.S_CXB, "czb": tsp.S_CZB, "b1": tsp.S_B1,
            "rx": tsp.S_RX, "rz": tsp.S_RZ, "eux": tsp.S_EUX,
            "evx": tsp.S_EVX, "evz": tsp.S_EVZ, "gzx": tsp.S_GZX,
            "edx": tsp.S_EDX, "edz": tsp.S_EDZ}
    eps = 1e-6
    for field, col in cols.items():
        sp_, sm_ = sc.clone(), sc.clone()
        sp_[0, col] += eps
        sm_[0, col] -= eps
        fd = (tsp.forward_oriented(vol_or, sp_, geom, "arc")
              - tsp.forward_oriented(vol_or, sm_, geom, "arc"))[0] / (2 * eps)
        rel = float(torch.linalg.norm(resp[field] - fd)
                    / max(float(torch.linalg.norm(fd)), 1e-9))
        assert rel < 3e-5, (field, rel)


def test_jacobian_theta_fd():
    """Whole-θ central differences: the assembled rows of the refined
    parameters (tx, tz, alpha, beta) are the a.e.-exact derivatives."""
    geom, vol, th, sw, yf = _fd_setup()
    _, jac = tsp.forward_view_jac(vol, geom, th[3], th[4], th[5], th[:3],
                                  np.zeros(3), dtype=F64, swap=sw, yflip=yf)

    def fwd(t6):
        return tsp.forward_view_jac(vol, geom, t6[3], t6[4], t6[5], t6[:3],
                                    np.zeros(3), dtype=F64, swap=sw,
                                    yflip=yf)[0]

    for k, (eps, tol) in {0: (1e-5, 1e-5), 2: (1e-5, 1e-5),
                          4: (1e-6, 1e-3), 5: (1e-6, 1e-3)}.items():
        tp, tm = th.copy(), th.copy()
        tp[k] += eps
        tm[k] -= eps
        fd = (fwd(tp) - fwd(tm)) / (2 * eps)
        rel = float(torch.linalg.norm(jac[k] - fd) / torch.linalg.norm(fd))
        assert rel < tol, (k, rel)


def test_param_jacobian_matches_autograd():
    n = 12
    geom = Geometry(n_proj=3, vox_shape=(n,) * 3, det_shape=(n, n + 3))
    rng = np.random.default_rng(2)
    th = torch.as_tensor(np.column_stack([
        rng.uniform(-1, 1, (3, 3)), [0.4, 0.5, 0.6],
        rng.uniform(-0.01, 0.01, (3, 2))]))
    cor = torch.as_tensor(rng.uniform(-0.3, 0.3, (3, 3)))
    got = tsp.param_jacobian(geom, th, cor, False, True, True)

    def fields(t6, c):
        E, B = tsp._oriented_affine_theta(geom, t6, c, False, True, True)
        p = tsp.slab_params(E, B)._asdict()
        return torch.stack([p[k] for k in tsp.PARAM_FIELDS])

    for i in range(3):
        ref = torch.autograd.functional.jacobian(
            lambda t6: fields(t6, cor[i]), th[i])
        assert torch.allclose(got[i], ref, rtol=1e-12, atol=1e-12)


def test_batched_group_jacobian_matches_single_views():
    """refine's batched (value, Jacobian) of a group equals
    forward_view_jac of each view (u-flipped rows undone)."""
    n = 16
    geom = Geometry(n_proj=6, vox_shape=(n,) * 3, det_shape=(n + 2, n))
    vol = torch.as_tensor(jph.shepp3d(n).astype(np.float64))
    jv = _views(6, 9)
    views = interop.views(jax.tree.map(np.asarray, jv))
    th, cor = views.theta6(), views.cor
    for idx, sw, yf, uf in tsp._orient_groups(views.numpy(), geom):
        ix = torch.as_tensor(idx)
        vol_or = tsp.orient_volume(vol, geom, sw, yf)
        val, jac = _group_value_jac(vol_or, th[ix], cor[ix], geom,
                                    (sw, yf, uf))
        if uf:
            val, jac = val.flip(-2), jac.flip(-2)
        for k, i in enumerate(idx):
            v1, j1 = tsp.forward_view_jac(
                vol, geom, float(th[i, 3]), float(th[i, 4]),
                float(th[i, 5]), th[i, :3].numpy(), cor[i].numpy(),
                dtype=F64, swap=sw, yflip=yf)
            assert torch.allclose(val[k].reshape(-1), v1, rtol=1e-12,
                                  atol=1e-12)
            assert torch.allclose(jac[k].reshape(6, -1), j1, rtol=1e-10,
                                  atol=1e-10)

"""The port's batched slab LM and the alignment helpers against tomojax.

float64 on the CPU, the same numpy inputs through both packages. The LM
runs the same box-constrained Levenberg–Marquardt steps on the same
analytic Jacobian, so the refined θ must agree to 1e-8 and the costs to
1e-9 relative; the helpers (moment matching, gauge projection, support
mask, Aitken extrapolation, θ packing) must agree to rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import cc as jcc
from tomojax.align import pipeline as jpipe
from tomojax.align.refine import PARAM_SETS as JPARAM_SETS
from tomojax.align.slab_refine import refine_views_slab as jrefine
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import slab_projector as jsp

from tomojax_torch.align import cc as tcc
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.align.refine import PARAM_SETS
from tomojax_torch.align.slab_refine import refine_views_slab as trefine
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.core.geometry import Views
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
BOX = np.array([3.0, 3.0, 3.0, np.inf, 0.02, 0.02])


@pytest.fixture(scope="module")
def lm():
    """Noisy arc data of jittered views, an init ±0.3 px / zero tilts off,
    and tomojax's refinement of it against frozen groups taken at zero
    translations (as the pipeline freezes them at its first outer)."""
    n, n_proj = 24, 8
    rng = np.random.default_rng(11)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = 0.2 + np.linspace(0, np.pi, n_proj, endpoint=False)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    al, be = rng.uniform(-0.01, 0.01, (2, n_proj))
    vol = jph.shepp3d(n).astype(np.float64)
    true = jgeo.Views.create(n_proj, phi=phi, alpha=al, beta=be, t=t,
                             dtype=jnp.float64)
    meas = np.asarray(jsp.project(jnp.asarray(vol), jg, true,
                                  dtype=jnp.float64, quad="arc"))
    meas = meas + 0.01 * rng.standard_normal(meas.shape)
    t0 = t.copy()
    t0[:, [0, 2]] += rng.uniform(-0.3, 0.3, (n_proj, 2))
    init = jgeo.Views.create(n_proj, phi=phi, t=t0, dtype=jnp.float64)
    th0 = np.asarray(init.theta6())
    jgs, _ = jsp.scalar_groups(jg, jgeo.Views.create(n_proj, phi=phi,
                                                     dtype=jnp.float64),
                               "arc", jnp.float64)
    kw = dict(mask=JPARAM_SETS["xzab"], max_iter=6)
    ref = jrefine(jnp.asarray(vol), jnp.asarray(meas), jg, init,
                  lower=jnp.asarray(th0 - BOX), upper=jnp.asarray(th0 + BOX),
                  groups=jgs, dtype=jnp.float64, **kw)
    return dict(jg=jg, tg=interop.geometry(dataclasses.asdict(jg)), vol=vol,
                meas=meas, th0=th0, t=t, groups=tuple(g[:4] for g in jgs),
                init=interop.views(jax.tree.map(np.asarray, init)), ref=ref)


def _run(lm, **kw):
    return trefine(torch.as_tensor(lm["vol"]), torch.as_tensor(lm["meas"]),
                   lm["tg"], lm["init"], param_set="xzab",
                   lower=lm["th0"] - BOX, upper=lm["th0"] + BOX, max_iter=6,
                   dtype=F64, **kw)


def test_refine_views_slab_matches_tomojax(lm):
    got = _run(lm, groups=lm["groups"])
    ref = lm["ref"]
    np.testing.assert_allclose(got.theta6.numpy(), np.asarray(ref.theta6),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost),
                               rtol=1e-9, atol=0)
    # and it refined: translations moved towards the truth
    err0 = np.abs(lm["th0"][:, [0, 2]] - lm["t"][:, [0, 2]]).mean()
    err = np.abs(got.theta6.numpy()[:, [0, 2]] - lm["t"][:, [0, 2]]).mean()
    assert err < 0.3 * err0, (err, err0)


def test_refine_views_slab_frozen_groups_match_self_grouped(lm):
    a = _run(lm)
    b = _run(lm, groups=lm["groups"])
    assert torch.equal(a.theta6, b.theta6)
    assert torch.equal(a.cost, b.cost)


def test_param_sets_and_bounds_match():
    assert PARAM_SETS.keys() == JPARAM_SETS.keys()
    for k, v in PARAM_SETS.items():
        assert list(v) == [bool(b) for b in np.asarray(JPARAM_SETS[k])], k
    lo, hi = tpipe._default_bounds(F64)
    jlo, jhi = jpipe._default_bounds(jnp.float64)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_moment_match_matches_tomojax():
    rng = np.random.default_rng(7)
    nu, nv, n = 20, 14, 9
    u = np.arange(nu)[None, :, None]
    v = np.arange(nv)[None, None, :]
    cu, cv = rng.uniform(6, 14, (2, n, 1, 1))
    meas = np.exp(-((u - cu) ** 2 + (v - cv) ** 2) / 12.0)
    synth = np.exp(-((u - cu - 0.37) ** 2 + (v - cv + 0.81) ** 2) / 11.0)
    synth[3] = 0.0                     # a view with no mass: no correction
    ref = np.asarray(jcc.moment_match(jnp.asarray(meas), jnp.asarray(synth),
                                      (nu, nv)))
    got = tcc.moment_match(torch.as_tensor(meas).reshape(n, -1),
                           torch.as_tensor(synth), (nu, nv))
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    assert np.all(got.numpy()[3] == 0.0)


@pytest.mark.parametrize("n", [1, 40])
def test_project_out_gauge_matches_tomojax(n):
    rng = np.random.default_rng(3)
    phi = np.linspace(0, np.pi, n, endpoint=False)
    dmom = np.stack([0.7 * np.cos(phi) - 0.4 * np.sin(phi)
                     + 0.3 * np.cos(2 * phi), 0.9 + 0.1 * np.sin(phi)], 1)
    dmom = dmom + 0.01 * rng.standard_normal(dmom.shape)
    ref = np.asarray(jpipe._project_out_gauge(jnp.asarray(dmom), phi))
    got = tpipe._project_out_gauge(torch.as_tensor(dmom), phi).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_support_mask_matches_tomojax():
    n, n_proj = 24, 10
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(0)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1.5, 1.5, (n_proj, 2))
    views = jgeo.Views.create(n_proj, phi=np.linspace(0, np.pi, n_proj),
                              t=t, dtype=jnp.float64)
    meas = np.asarray(jsp.project(jnp.asarray(jph.shepp3d(n), jnp.float64),
                                  jg, views, dtype=jnp.float64,
                                  quad="arc"))
    tg = interop.geometry(dataclasses.asdict(jg))
    got = tpipe._support_mask(tg, meas)
    np.testing.assert_array_equal(got, jpipe._support_mask(jg, meas))
    assert 0 < got.sum() < got.size


def test_aitken_extrapolate_matches_tomojax():
    rng = np.random.default_rng(5)
    n = 7
    star = rng.uniform(-1, 1, (n, 6))
    c = rng.uniform(0.5, 2.0, (n, 6))
    th = [star + c * 0.9 ** k for k in range(3)]
    th[2][0] = th[1][0] - 0.1          # a sign-flipping view: no jump
    mask = np.array([True, False, True, False, True, True])
    lo, hi = np.full((n, 6), -1.5), np.full((n, 6), 1.5)
    got = tpipe.aitken_extrapolate(*th, lo, hi, mask)
    np.testing.assert_array_equal(
        got, jpipe.aitken_extrapolate(*th, lo, hi, mask))
    np.testing.assert_allclose(got[1:, mask], np.clip(star, lo, hi)[1:, mask],
                               atol=1e-9)


def test_theta6_roundtrip_matches_tomojax():
    rng = np.random.default_rng(1)
    n = 5
    jv = jgeo.Views.create(n, phi=rng.uniform(0, 3, n),
                           alpha=rng.uniform(-.1, .1, n),
                           beta=rng.uniform(-.1, .1, n),
                           t=rng.uniform(-2, 2, (n, 3)),
                           cor=rng.uniform(-1, 1, (n, 3)), dtype=jnp.float64)
    tv = interop.views(jax.tree.map(np.asarray, jv))
    th = tv.theta6()
    np.testing.assert_array_equal(th.numpy(), np.asarray(jv.theta6()))
    back = Views.from_theta6(th, cor=tv.cor)
    jback = jgeo.Views.from_theta6(jv.theta6(), cor=jv.cor)
    for f in ("phi", "alpha", "beta", "t", "cor"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)))
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(tv, f).numpy())
    zero = Views.from_theta6(th)
    assert torch.equal(zero.cor, torch.zeros(n, 3, dtype=F64))
    sub = tv.take([4, 1])
    assert torch.equal(sub.theta6(), th[[4, 1]])

"""tomojax_torch's cross-correlation pre-alignment against tomojax's.

The same seeded float64 inputs go to both packages on the CPU. Registered
shifts must be equal (the same upsampled grid point), Fourier shifts and
chained stacks agree to 1e-12/1e-10, and align_to_reprojection's t and
shifts to 1e-8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import cc as jcc
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core.operators import make_operator as jmake

from tomojax_torch.align import cc as tcc
from tomojax_torch.utils import interop

torch.set_num_threads(1)

F64 = torch.float64


def _image(n=32):
    return jph.shepp3d(n)[:, n // 2, :].astype(np.float64)


def _stack(n_views=12, n=32, seed=0):
    """``n_views`` copies of a Shepp slice, each moved by a random
    fractional shift (view 0 unmoved)."""
    img = _image(n)
    rng = np.random.default_rng(seed)
    s = rng.uniform(-3, 3, (n_views, 2))
    s[0] = 0.0
    return np.stack([np.asarray(jcc.fourier_shift(jnp.asarray(img),
                                                  jnp.asarray(-v)))
                     for v in s])


def test_fourier_shift_matches_roll_and_tomojax():
    img = _image()
    t = torch.as_tensor(img)
    np.testing.assert_allclose(
        tcc.fourier_shift(t, torch.tensor([2.0, -1.0], dtype=F64)).numpy(),
        np.roll(np.roll(img, 2, 0), -1, 1), atol=1e-10)
    shifts = np.array([[1.25, -2.75], [0.3, 0.6], [-1.7, 2.2]])
    got = tcc.fourier_shift(t.expand(3, -1, -1), torch.as_tensor(shifts))
    for i, s in enumerate(shifts):
        want = jcc.fourier_shift(jnp.asarray(img), jnp.asarray(s))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("u", [1, 20])
@pytest.mark.parametrize("normalization", ["phase", None])
def test_phase_cross_correlation_matches_tomojax(u, normalization):
    stack = _stack(n_views=4, seed=1)
    ref = stack[0]
    want = np.stack([np.asarray(jcc.phase_cross_correlation(
        jnp.asarray(ref), jnp.asarray(m), upsample_factor=u,
        normalization=normalization)) for m in stack[1:]])
    tref = torch.as_tensor(ref)
    one = np.stack([tcc.phase_cross_correlation(
        tref, torch.as_tensor(m), upsample_factor=u,
        normalization=normalization).numpy() for m in stack[1:]])
    batch = tcc.phase_cross_correlation(
        tref.expand(3, -1, -1), torch.as_tensor(stack[1:]),
        upsample_factor=u, normalization=normalization).numpy()
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(batch, want)


def test_cor_flipping_matches_tomojax():
    img = _image()
    p180 = np.fliplr(np.asarray(jcc.fourier_shift(jnp.asarray(img),
                                                  jnp.asarray([0.0, -3.0]))))
    want = float(jcc.cor_flipping(jnp.asarray(img), jnp.asarray(p180)))
    got = float(tcc.cor_flipping(torch.as_tensor(img),
                                 torch.as_tensor(p180.copy())))
    assert got == want and abs(abs(got) - 3.0) < 0.1


def test_cross_correlation_chain_matches_tomojax():
    stack = _stack()
    jo, ja = jcc.cross_correlation_chain(jnp.asarray(stack))
    to, ta = tcc.cross_correlation_chain(stack, device="cpu")
    assert to.shape == (12, 2) and ta.shape == stack.shape
    np.testing.assert_allclose(to.numpy(), jo, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=1e-10)


def test_cross_correlation_filtered_matches_tomojax():
    img = _image()
    shifts = [(0, 0), (2, -3), (-1, 4), (5, 1)]
    stack = np.stack([np.roll(np.roll(img, a, 0), b, 1) for a, b in shifts])
    jo, ja = jcc.cross_correlation_filtered(jnp.asarray(stack))
    to, ta = tcc.cross_correlation_filtered(torch.as_tensor(stack))
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(ta.numpy(), ja)


def _reproj_problem(n_proj, n=16):
    rng = np.random.default_rng(3)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = np.linspace(0, np.pi, n_proj, endpoint=False)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.5, 1.5, n_proj)
    t[:, 2] = rng.uniform(-1.5, 1.5, n_proj)
    vol = jnp.asarray(jph.shepp3d(n).astype(np.float64))
    true = jgeo.Views.create(n_proj, phi=phi, t=t, dtype=jnp.float64)
    meas = np.asarray(jmake(jg, true, family="slab_plane",
                            dtype=jnp.float64).A(vol))
    jv0 = jgeo.Views.create(n_proj, phi=phi, dtype=jnp.float64)
    tg = interop.geometry(dataclasses.asdict(jg))
    tv0 = interop.views(jax.tree.map(np.asarray, jv0))
    return jg, jv0, tg, tv0, meas


@pytest.mark.parametrize("folds", [4, None])
def test_align_to_reprojection_matches_tomojax(folds):
    jg, jv0, tg, tv0, meas = _reproj_problem(16)
    kw = dict(rounds=2, recon_iters=5, folds=folds)
    jviews, jsh = jcc.align_to_reprojection(meas, jg, jv0, dtype=jnp.float64,
                                            **kw)
    tviews, tsh = tcc.align_to_reprojection(meas, tg, tv0, dtype=F64,
                                            device="cpu", **kw)
    np.testing.assert_allclose(tviews.t.numpy(), jviews.t, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tsh.numpy(), jsh, rtol=0, atol=1e-8)
    assert np.abs(tsh.numpy()).max() > 0.05


def test_align_to_reprojection_default_folds_clamp():
    """With 6 views the default folds clamp to 3 (tomojax's folds=3); an
    explicit out-of-range folds raises as tomojax's does."""
    jg, jv0, tg, tv0, meas = _reproj_problem(6)
    jviews, _ = jcc.align_to_reprojection(meas, jg, jv0, rounds=1,
                                          recon_iters=4, folds=3,
                                          dtype=jnp.float64)
    tviews, _ = tcc.align_to_reprojection(meas, tg, tv0, rounds=1,
                                          recon_iters=4, dtype=F64,
                                          device="cpu")
    np.testing.assert_allclose(tviews.t.numpy(), jviews.t, rtol=0,
                               atol=1e-8)
    with pytest.raises(ValueError, match="folds"):
        tcc.align_to_reprojection(meas, tg, tv0, folds=5, dtype=F64,
                                  device="cpu")

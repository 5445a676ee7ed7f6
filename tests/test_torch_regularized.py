"""tomojax_torch's regularized solvers and TV prox against tomojax's.

Both packages get the same float64 inputs (numpy, seeded) on the CPU and
the same slab_plane operator (built through ``utils.interop``); the
iterates must agree to 1e-8, the per-iteration arrays to rtol 1e-8, and
``n_iter``/``stop_reason`` exactly. ``estimate_lipschitz`` draws its
start from another random stream than tomojax's, so it is held against
the largest eigenvalue of a dense AᵀA instead.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core.operators import make_operator as jmake
from tomojax.recon import lasso as jlasso
from tomojax.recon import tikhonov as jtikh
from tomojax.recon import tv as jtv

from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.recon import (fista_tv, lasso_fista, lasso_ista,
                                 tikhonov_gd, tv)
from tomojax_torch.utils import interop

# the packages' recon/__init__ export the function fista_tv under the
# module's name
jfista_mod = importlib.import_module("tomojax.recon.fista_tv")
tfista_mod = importlib.import_module("tomojax_torch.recon.fista_tv")

torch.set_num_threads(1)

F64 = torch.float64
NITER = 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 16, 10
    rng = np.random.default_rng(7)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    jv = jgeo.Views.create(
        n_proj, phi=0.2 + np.linspace(0, np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, n_proj),
        beta=rng.uniform(-0.01, 0.01, n_proj),
        t=rng.uniform(-1.0, 1.0, (n_proj, 3)))
    gt = jph.shepp3d(n).astype(np.float64)
    jop = jmake(jg, jv, family="slab_plane", dtype=jnp.float64)
    b = np.asarray(jop.A(jnp.asarray(gt)))
    b = b + 0.02 * np.abs(b).max() * rng.standard_normal(b.shape)
    top = tmake(interop.geometry(dataclasses.asdict(jg)),
                interop.views(jax.tree.map(np.asarray, jv)),
                family="slab_plane", dtype=F64, device="cpu")
    return dict(jop=jop, top=top, b=b, gt=gt, vol=rng.random((9, 7, 8)))


def _same(got, want, fields):
    assert got.n_iter == int(want.n_iter)
    assert got.stop_reason == int(want.stop_reason)
    assert _rel(got.x.numpy(), want.x) < 1e-8
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-8,
                                   atol=0)


def test_gradient_div_adjoint_and_norms(prob):
    x = prob["vol"]
    p = np.random.default_rng(1).random((3,) + x.shape)
    # the dual fields live where the gradient does: zero trailing faces
    p[0, -1], p[1, :, -1], p[2, :, :, -1] = 0.0, 0.0, 0.0
    tx, tp = torch.as_tensor(x), torch.as_tensor(p)
    lhs = float((tv.gradient(tx) * tp).sum())
    rhs = -float((tx * tv.div(tp)).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    np.testing.assert_allclose(tv.gradient(tx).numpy(),
                               jtv.gradient(jnp.asarray(x)), atol=1e-12)
    np.testing.assert_allclose(tv.div(tp).numpy(), jtv.div(jnp.asarray(p)),
                               atol=1e-12)
    for fn, jfn in ((tv.tv_norm, jtv.tv_norm),
                    (tv.tv_norm_3d, jtv.tv_norm_3d)):
        assert float(fn(tx)) == pytest.approx(float(jfn(jnp.asarray(x))),
                                              rel=1e-12)


@pytest.mark.parametrize("eps, niter", [(1e-5, 12), (1e-2, 40)])
def test_denoise_fista_matches_tomojax(prob, eps, niter):
    """Run to the cap, and stopped early by the dual gap."""
    x = prob["vol"]
    got = tv.denoise_fista(torch.as_tensor(x), weight=0.3, niter=niter,
                           eps=eps)
    want = jtv.denoise_fista(jnp.asarray(x), weight=0.3, niter=niter,
                             eps=eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # the 2-D prox (factor 8)
    got2 = tv.denoise_fista(torch.as_tensor(x[0]), weight=0.3, niter=niter,
                            eps=eps)
    want2 = jtv.denoise_fista(jnp.asarray(x[0]), weight=0.3, niter=niter,
                              eps=eps)
    np.testing.assert_allclose(got2.numpy(), want2, rtol=0, atol=1e-12)


@pytest.mark.parametrize("step_search, fail_alpha, reg", [
    ("armijo", None, 0.5), ("wolfe", None, 0.5),
    # a huge λ makes every search fail: stop, or take fail_alpha
    ("armijo", None, 1e12), ("armijo", 1e-13, 1e12),
    ("wolfe", 1e-13, 1e12)])
def test_tikhonov_matches_tomojax(prob, step_search, fail_alpha, reg):
    kw = dict(niter=NITER, reg_param=reg, positivity=True,
              fail_alpha=fail_alpha, step_search=step_search,
              ground_truth=prob["gt"])
    want = jtikh.tikhonov_gd(prob["jop"], jnp.asarray(prob["b"]), **kw)
    got = tikhonov_gd(prob["top"], torch.as_tensor(prob["b"]), **kw)
    _same(got, want, ("rms_error", "convergence"))
    assert got.stop_reason == (3 if reg > 1 and fail_alpha is None else 0)


@pytest.mark.parametrize("accelerated", [False, True])
def test_lasso_matches_tomojax(prob, accelerated):
    jfn = jlasso.lasso_fista if accelerated else jlasso.lasso_ista
    tfn = lasso_fista if accelerated else lasso_ista
    kw = dict(niter=NITER, reg_param=0.05)
    want = jfn(prob["jop"], jnp.asarray(prob["b"]), **kw)
    got = tfn(prob["top"], torch.as_tensor(prob["b"]), **kw)
    _same(got, want, ("rms_error", "convergence", "step_size"))
    # with a start and a ground truth
    kw.update(x0=0.5 * prob["gt"], ground_truth=prob["gt"])
    want = jfn(prob["jop"], jnp.asarray(prob["b"]), **kw)
    got = tfn(prob["top"], torch.as_tensor(prob["b"]), **kw)
    _same(got, want, ("rms_error", "convergence", "step_size"))


@pytest.mark.parametrize("gt", [False, True])
def test_fista_tv_matches_tomojax(prob, gt):
    hyper = 1.05 * float(jfista_mod.estimate_lipschitz(prob["jop"]))
    kw = dict(niter=NITER, hyper=hyper, beta_tv=0.5, niter_tv=6,
              ground_truth=prob["gt"] if gt else None)
    want = jfista_mod.fista_tv(prob["jop"], jnp.asarray(prob["b"]), **kw)
    got = fista_tv(prob["top"], torch.as_tensor(prob["b"]), **kw)
    _same(got, want, ("rms_error", "total_cost", "data_fidelity"))


def test_estimate_lipschitz_against_dense_eigenvalue():
    """At 8³ × 4 views the dense AᵀA's largest eigenvalue; 12 power
    iterations from either package's random start land below it within
    1e-6 relative (measured on the CPU: the port 9.6e-9 below it, tomojax
    1.2e-8, the two 2.2e-9 apart)."""
    n, n_proj = 8, 4
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    jv = jgeo.Views.create(n_proj, phi=np.linspace(0, np.pi, n_proj,
                                                   endpoint=False),
                           dtype=jnp.float64)
    top = tmake(interop.geometry(dataclasses.asdict(jg)),
                interop.views(jax.tree.map(np.asarray, jv)),
                family="slab_plane", dtype=F64, device="cpu")
    eye = torch.eye(n ** 3, dtype=F64)
    A = torch.stack([top.A(e.reshape(n, n, n)).reshape(-1) for e in eye], 1)
    lam = float(torch.linalg.eigvalsh(A.T @ A).max())
    got = float(tfista_mod.estimate_lipschitz(top))
    want = float(jfista_mod.estimate_lipschitz(
        jmake(jg, jv, family="slab_plane", dtype=jnp.float64)))
    assert got <= lam * (1 + 1e-12) and want <= lam * (1 + 1e-12)
    assert (lam - got) / lam < 1e-6 and abs(got - want) / lam < 1e-6

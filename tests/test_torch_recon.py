"""tomojax_torch's CGLS, SIRT and COM pre-alignment against tomojax's.

Both packages get the same float64 inputs (numpy, seeded) on the CPU and
the same slab_plane operator; the iterates must agree to 1e-8 relative,
the per-iteration rms and convergence arrays to 1e-8, and ``com_align``
to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import com_align as jcom
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core.operators import make_operator as jmake
from tomojax.recon import cgls as jcgls_mod, sirt as jsirt
from tomojax.recon import cgls_init as jcgls_init, cgls_steps as jcgls_steps

from tomojax_torch.align import com_align as tcom
from tomojax_torch.core.operators import make_operator as tmake
from tomojax_torch.recon import cgls, cgls_init, cgls_steps, sirt
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
NITER = 10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 20, 12
    rng = np.random.default_rng(11)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n, n, n), det_shape=(n, n))
    jv = jgeo.Views.create(
        n_proj, phi=0.3 + np.linspace(0, np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, n_proj),
        beta=rng.uniform(-0.01, 0.01, n_proj),
        t=rng.uniform(-1.5, 1.5, (n_proj, 3)))
    gt = jph.shepp3d(n).astype(np.float64)
    jop = jmake(jg, jv, family="slab_plane", dtype=jnp.float64)
    b = np.asarray(jop.A(jnp.asarray(gt)))
    b = b + 0.01 * np.abs(b).max() * rng.standard_normal(b.shape)
    top = tmake(interop.geometry(dataclasses.asdict(jg)),
                interop.views(jax.tree.map(np.asarray, jv)),
                family="slab_plane", dtype=F64, device="cpu")
    return dict(jop=jop, top=top, b=b, gt=gt, jg=jg)


def test_cgls_tracks_tomojax(prob):
    """Both solvers continue from one tomojax CGLSState (carried over by
    interop) and must agree iterate for iterate."""
    jop, top, b, gt = prob["jop"], prob["top"], prob["b"], prob["gt"]
    js0 = jcgls_init(jop, b)
    ts0 = interop.cgls_state(jax.tree.map(np.asarray, js0))
    js, jconv, jrms = jcgls_steps(jop, b, js0, nsteps=NITER, niter=NITER,
                                  ground_truth=gt)
    ts, tconv, trms = cgls_steps(top, torch.as_tensor(b), ts0, nsteps=NITER,
                                 niter=NITER, ground_truth=gt)
    assert ts.k == int(js.k) == NITER and ts.stop == int(js.stop)
    assert _rel(ts.x.numpy(), js.x) < 1e-8
    np.testing.assert_allclose(tconv.numpy(), jconv, rtol=1e-8)
    np.testing.assert_allclose(trms.numpy(), jrms, rtol=1e-8)
    # and a fresh start agrees with tomojax's cgls()
    jres = jcgls_mod(jop, b, niter=NITER)
    tres = cgls(top, torch.as_tensor(b), niter=NITER)
    assert _rel(tres.x.numpy(), jres.x) < 1e-8
    np.testing.assert_allclose(tres.rms_error.numpy(), jres.rms_error,
                               rtol=1e-8)
    np.testing.assert_allclose(tres.convergence.numpy(), jres.convergence,
                               rtol=1e-8)
    assert (tres.n_iter, tres.stop_reason) == (int(jres.n_iter),
                                               int(jres.stop_reason))


def test_cgls_chunked_state_matches_single_shot(prob):
    """Chunked cgls_steps with the state threaded through == one cgls()."""
    top, b = prob["top"], torch.as_tensor(prob["b"])
    ref = cgls(top, b, niter=NITER)
    state, convs = cgls_init(top, b), []
    while state.k < NITER and state.stop == 0:
        k0 = state.k
        state, conv, _ = cgls_steps(top, b, state, nsteps=3, niter=NITER)
        convs.append(conv[:state.k - k0])
    assert _rel(state.x.numpy(), ref.x.numpy()) < 1e-12
    np.testing.assert_allclose(torch.cat(convs).numpy(),
                               ref.convergence.numpy(), rtol=1e-12)


@pytest.mark.parametrize("positivity", [True, False])
def test_sirt_tracks_tomojax(prob, positivity):
    jop, top, b, gt = prob["jop"], prob["top"], prob["b"], prob["gt"]
    jres = jsirt(jop, b, niter=NITER, positivity=positivity,
                 ground_truth=gt)
    tres = sirt(top, torch.as_tensor(b), niter=NITER, positivity=positivity,
                ground_truth=gt)
    assert (tres.n_iter, tres.stop_reason) == (int(jres.n_iter),
                                               int(jres.stop_reason))
    assert _rel(tres.x.numpy(), jres.x) < 1e-8
    np.testing.assert_allclose(tres.rms_error.numpy(), jres.rms_error,
                               rtol=1e-8)
    np.testing.assert_allclose(tres.convergence.numpy(), jres.convergence,
                               rtol=1e-8)
    if positivity:
        assert float(tres.x.min()) >= 0.0


def test_com_align_matches_tomojax(prob):
    jg, b = prob["jg"], prob["b"]
    phi = np.linspace(0, np.pi, jg.n_proj, endpoint=False) + 0.3
    ref = np.asarray(jcom(jnp.asarray(b), jg, phi, dtype=jnp.float64))
    got = tcom(torch.as_tensor(b), jg, phi, dtype=F64)
    assert got.shape == (jg.n_proj, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-10)

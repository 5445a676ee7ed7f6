"""The whole slice on the CPU: ``align_reconstruct(family="fast",
refine_method="gd_fast", recon="sirt")`` against tomojax's in float64 at
16³, and ``cli align`` with these settings end to end.

One outer of fast-family SIRT, batched Armijo GD and the moment hook: θ
and the volume must agree to 1e-8 and the history to 1e-10. tomojax's
SIRT on the fast family runs with XLA:CPU's optimizer off
(``xla_backend_optimization_level=0``): its optimized while-loop program
gives other numbers than its own eager operations on this path (see
tests/test_torch_fast.py), the unoptimized one equals them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import pipeline as jpipe
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.recon import sirt as jsirt

from tomojax_torch import cli as tcli
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.core import fast_projector as tfp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.utils import interop

torch.set_num_threads(1)

F64 = torch.float64
KW = dict(outer_iters=1, recon="sirt", recon_iters=10, param_set="xzab",
          refine_iters=3, refine_method="gd_fast", family="fast")


def _sirt_opt0(op, b, *, x0, **kw):
    return jax.jit(lambda b, x0: jsirt(op, b, x0=x0, **kw),
                   compiler_options={"xla_backend_optimization_level": 0})(
        b, x0)


@pytest.fixture(scope="module")
def prob():
    """examples/joint_align_128.py's protocol at 16³ × 8 views: Shepp
    phantom, default_rng(5), tx, tz in ±1 px and α, β in ±1°, projected
    with the fast family, and a zero-jitter start."""
    n, n_proj = 16, 8
    rng = np.random.default_rng(5)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1, 1, n_proj)
    t[:, 2] = rng.uniform(-1, 1, n_proj)
    a = np.deg2rad(rng.uniform(-1, 1, n_proj))
    b = np.deg2rad(rng.uniform(-1, 1, n_proj))
    vol = jph.shepp3d(n).astype(np.float64)
    tg = interop.geometry(dataclasses.asdict(jg))
    true = Views.create(n_proj, alpha=a, beta=b, t=t, dtype=F64)
    # the port's fast project equals tomojax's (tests/test_torch_fast.py)
    meas = tfp.project(torch.as_tensor(vol), tg, true, dtype=F64).numpy()
    init = jgeo.Views.create(n_proj, dtype=jnp.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "_sirt", _sirt_opt0)
        ref = jpipe.align_reconstruct(jnp.asarray(meas), jg, init,
                                      ground_truth=vol, dtype=jnp.float64,
                                      **KW)
    return dict(tg=tg, vol=vol, meas=meas, ref=ref,
                init=interop.views(jax.tree.map(np.asarray, init)))


def test_align_fast_gd_matches_tomojax(prob):
    got = tpipe.align_reconstruct(
        torch.as_tensor(prob["meas"]), prob["tg"], prob["init"],
        ground_truth=prob["vol"], dtype=F64, device="cpu", **KW)
    ref = prob["ref"]
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)
    for key in ("recon_rms", "refine_cost"):
        np.testing.assert_allclose(got.history[key], ref.history[key],
                                   rtol=1e-10)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-10)


def test_refine_chunk_does_not_change_gd(prob):
    args = (torch.as_tensor(prob["meas"]), prob["tg"], prob["init"])
    whole = tpipe.align_reconstruct(*args, dtype=F64, device="cpu", **KW)
    parts = tpipe.align_reconstruct(*args, dtype=F64, device="cpu",
                                    refine_chunk=3, **KW)
    np.testing.assert_allclose(parts.views.theta6().numpy(),
                               whole.views.theta6().numpy(), rtol=0,
                               atol=1e-12)


def test_cli_align_fast_gd(tmp_path):
    from tomojax_torch.utils import io
    n, n_proj = 16, 6
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(0)
    phi = np.linspace(0.0, np.pi, n_proj)
    xyz = np.zeros((n_proj, 3))
    xyz[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    alpha, beta = rng.uniform(-0.01, 0.01, (2, n_proj))
    vol = jph.shepp3d(n).astype(np.float32)
    proj = tfp.project(torch.as_tensor(vol), geom,
                       Views.create(n_proj, phi=phi, alpha=alpha, beta=beta,
                                    t=xyz))
    data = tmp_path / "d.npz"
    io.save_dataset(data, projections=proj.reshape(n_proj, n, n).numpy(),
                    phi=phi, alpha=alpha, beta=beta, xyz=xyz, phantom=vol)
    out = tcli.main([
        "align", "-i", str(data), "-o", str(tmp_path / "v.npy"), "--device",
        "cpu", "--set", "align.family=fast", "--set",
        "align.refine_method=gd_fast", "--set", "align.recon=sirt", "--set",
        "align.recon_iters=5", "--set", "align.refine_iters=2", "--set",
        "align.outer_iters=2"])
    state = out["state"]
    x = np.load(tmp_path / "v.npy")
    assert x.shape == (n,) * 3 and np.isfinite(x).all()
    assert len(out["theta_per_outer"]) == 2
    ref = tpipe.align_reconstruct(
        proj, geom, Views.create(n_proj, phi=phi), outer_iters=2,
        recon="sirt", recon_iters=5, refine_iters=2, family="fast",
        refine_method="gd_fast", ground_truth=vol, device="cpu",
        bounds=(np.array([-3, -3, -3, -np.inf, -0.02, -0.02], np.float32),
                np.array([3, 3, 3, np.inf, 0.02, 0.02], np.float32)))
    assert torch.equal(ref.views.theta6(), state.views.theta6())
    assert ref.history == state.history

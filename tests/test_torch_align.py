"""The port's alternating driver against tomojax's, its checkpoint/resume,
its refusals, and ``cli align`` end to end — all on the CPU.

``align_reconstruct`` runs the same stages as tomojax's on the same numpy
inputs in float64 (arc CGLS, batched slab LM, the moment hook, Aitken with
the flip rescue every outer), so after three outers θ and the volume must
agree to 1e-8. A second case starts every view from the mirror of its true
tilts, so that the flip rescue keeps flips on both sides. (tomojax's rescue
writes into a read-only array when it runs in float64 and a flip wins,
``tomojax/align/pipeline.py:734``; that run goes through a numpy whose
``asarray`` copies.)
"""

import contextlib
import dataclasses
import io
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import pipeline as jpipe
from tomojax.align.pipeline import align_reconstruct as jalign
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import projector as jproj
from tomojax.core import slab_projector as jsp

from tomojax_torch import cli as tcli
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
KW = dict(outer_iters=3, recon="cgls", recon_iters=8, param_set="xzab",
          refine_iters=4, family="slab", refine_method="lm_slab",
          accel_period=1, moment_period=1)


@pytest.fixture(scope="module")
def prob():
    n, n_proj = 24, 10
    rng = np.random.default_rng(5)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = np.linspace(0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.5, 1.5, n_proj)
    t[:, 2] = rng.uniform(-1.5, 1.5, n_proj)
    al = rng.uniform(-0.008, 0.008, n_proj)
    be = rng.uniform(-0.008, 0.008, n_proj)
    vol = jph.shepp3d(n).astype(np.float64)
    true = jgeo.Views.create(n_proj, phi=phi, t=t, alpha=al, beta=be,
                             dtype=jnp.float64)
    meas = np.asarray(jsp.project(jnp.asarray(vol), jg, true,
                                  dtype=jnp.float64, quad="arc"))
    t0 = t.copy()
    t0[:, [0, 2]] += rng.uniform(-0.3, 0.3, (n_proj, 2))
    init = jgeo.Views.create(n_proj, phi=phi, t=t0, dtype=jnp.float64)
    ref = jalign(jnp.asarray(meas), jg, init, ground_truth=vol,
                 dtype=jnp.float64, **KW)
    return dict(tg=interop.geometry(dataclasses.asdict(jg)), vol=vol,
                meas=meas, init=interop.views(jax.tree.map(np.asarray,
                                                           init)), ref=ref)


def _flip_lines(text):
    return [re.sub(r" \(t=\d+s\)", "", line) for line in text.splitlines()
            if "flip-rescue" in line]


@pytest.fixture(scope="module")
def flip_prob():
    n, n_proj = 24, 10
    rng = np.random.default_rng(1)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = np.linspace(0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.5, 1.5, n_proj)
    t[:, 2] = rng.uniform(-1.5, 1.5, n_proj)
    al = 0.008 * rng.choice([-1.0, 1.0], n_proj)
    be = 0.008 * rng.choice([-1.0, 1.0], n_proj)
    vol = jph.shepp3d(n).astype(np.float64)
    true = jgeo.Views.create(n_proj, phi=phi, t=t, alpha=al, beta=be,
                             dtype=jnp.float64)
    meas = np.asarray(jsp.project(jnp.asarray(vol), jg, true,
                                  dtype=jnp.float64, quad="arc"))
    t0 = t.copy()
    t0[:, [0, 2]] += rng.uniform(-0.3, 0.3, (n_proj, 2))
    init = jgeo.Views.create(n_proj, phi=phi, t=t0, alpha=-al, beta=-be,
                             dtype=jnp.float64)
    kw = {**KW, "outer_iters": 2, "refine_iters": 2}
    copying_np = types.SimpleNamespace(**vars(np))
    copying_np.asarray = np.array
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jpipe, "np", copying_np)
        ref = jalign(jnp.asarray(meas), jg, init, ground_truth=vol,
                     dtype=jnp.float64, progress=True, **kw)
    return dict(tg=interop.geometry(dataclasses.asdict(jg)), vol=vol,
                meas=meas, init=interop.views(jax.tree.map(np.asarray,
                                                           init)),
                ref=ref, kw=kw, flips=_flip_lines(out.getvalue()))


def _align(prob, **kw):
    args = {**KW, **kw}
    return tpipe.align_reconstruct(torch.as_tensor(np.array(prob["meas"])),
                                   prob["tg"], prob["init"],
                                   ground_truth=prob["vol"], dtype=F64,
                                   device="cpu", **args)


def test_align_reconstruct_matches_tomojax(prob):
    got, ref = _align(prob), prob["ref"]
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.history["recon_rms"],
                               ref.history["recon_rms"], rtol=1e-8)
    np.testing.assert_allclose(got.history["refine_cost"],
                               ref.history["refine_cost"], rtol=1e-8)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-8,
                               atol=1e-12)


def test_align_accepts_debias_chunk(prob):
    """tomojax's ``debias_chunk`` with the debias stage off: the same run
    as without it, and tomojax's θ and volume."""
    got = _align(prob, debias_chunk=15, debias_period=None)
    plain = _align(prob)
    assert torch.equal(got.views.theta6(), plain.views.theta6())
    assert torch.equal(got.volume, plain.volume)
    ref = prob["ref"]
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)


def test_align_flip_rescue_matches_tomojax(flip_prob, capsys):
    got = _align(flip_prob, progress=True, **flip_prob["kw"])
    flips = _flip_lines(capsys.readouterr().out)
    assert flips and flips == flip_prob["flips"]
    ref = flip_prob["ref"]
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.history["refine_cost"],
                               ref.history["refine_cost"], rtol=1e-8)


def test_checkpoint_resume_equals_uninterrupted(prob, tmp_path):
    kw = dict(outer_iters=4, accel_period=2)
    full = _align(prob, checkpoint_dir=str(tmp_path / "a"), **kw)
    part = _align(prob, checkpoint_dir=str(tmp_path / "b"),
                  **{**kw, "outer_iters": 2})
    assert len(part.history["recon_rms"]) == 2
    seen = []
    resumed = _align(prob, checkpoint_dir=str(tmp_path / "b"),
                     callback=lambda it, *_: seen.append(it), **kw)
    assert seen == [2, 3]
    assert torch.equal(resumed.views.theta6(), full.views.theta6())
    assert torch.equal(resumed.volume, full.volume)
    assert resumed.history == full.history
    files = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert files == [f"align_ckpt_{i:04d}.npz" for i in range(4)]
    z = tpipe.load_checkpoint(tmp_path / "b" / files[-1])
    assert z["iteration"] == 3 and z["history"] == full.history
    np.testing.assert_array_equal(z["volume"], full.volume.numpy())


def test_align_slab_plane_sirt_runs(prob):
    out = _align(prob, family="slab_plane", recon="sirt", outer_iters=2,
                 accel_period=None, refine_chunk=3)
    assert out.volume.shape == (24, 24, 24)
    assert len(out.history["recon_rms"]) == 2
    assert np.all(np.isfinite(out.views.theta6().numpy()))


@pytest.mark.parametrize("kw, match", [
    pytest.param(dict(recon_prec="bf16"), "recon_prec", id="kw4-Queue 3"),
])
def test_unported_options_raise(prob, kw, match):
    """The option that raised until the bf16 tier was ported
    (``recon_prec="bf16"``) now runs, as tomojax's; an unknown tier still
    raises ``ValueError`` naming the setting, as tomojax's does."""
    out = _align(prob, **kw, outer_iters=1)
    assert np.all(np.isfinite(out.volume.numpy()))
    with pytest.raises(ValueError, match=match):
        _align(prob, **{**kw, "recon_prec": "fp8"})


def test_align_voxel_family_matches_tomojax():
    """``align_reconstruct(family="voxel")``, 2 outers at 16³ (CGLS on the
    voxel family, box LM on the exact Jacobian, the moment hook on the
    voxel reprojection): θ and the volume to 1e-8, as tomojax's."""
    n, n_proj = 16, 12
    rng = np.random.default_rng(3)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = 0.2 + np.linspace(0, np.pi, n_proj, endpoint=False)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    vol = jph.shepp3d(n).astype(np.float64)
    true = jgeo.Views.create(n_proj, phi=phi, t=t, dtype=jnp.float64)
    meas = np.asarray(jproj.project(jnp.asarray(vol), jg, true,
                                    dtype=jnp.float64))
    init = jgeo.Views.create(n_proj, phi=phi, dtype=jnp.float64)
    kw = dict(outer_iters=2, recon_iters=6, refine_iters=3, family="voxel",
              param_set="xz")
    ref = jpipe.align_reconstruct(jnp.asarray(meas), jg, init,
                                  dtype=jnp.float64, **kw)
    got = tpipe.align_reconstruct(
        torch.as_tensor(meas), interop.geometry(dataclasses.asdict(jg)),
        interop.views(jax.tree.map(np.asarray, init)), dtype=F64,
        device="cpu", **kw)
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.history["refine_cost"],
                               ref.history["refine_cost"], rtol=1e-8)


def test_com_align_device(prob):
    """A tensor keeps its device; anything else resolves to the card, and
    raises without one unless the CPU is asked for."""
    geom, phi = prob["tg"], prob["init"].phi.numpy()
    meas = np.array(prob["meas"])
    from tomojax_torch.align import com_align
    got = com_align(torch.as_tensor(meas), geom, phi)
    assert got.device.type == "cpu" and got.shape == (geom.n_proj, 2)
    assert torch.equal(got, com_align(meas, geom, phi, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            com_align(meas, geom, phi)


def test_cli_align_end_to_end(tmp_path):
    data = tmp_path / "d.npz"
    tcli.main(["simulate", "--size", "24", "--views", "12", "--set",
               "simulate.family=slab", "--set", "simulate.max_angle_deg=0.5",
               "-o", str(data), "--device", "cpu"])
    args = ["--set", "align.pre_align_cc=true", "--set", "align.family=slab",
            "--set", "align.refine_method=lm_slab", "--set",
            "align.recon=cgls", "--set", "align.recon_iters=6", "--set",
            "align.refine_iters=3", "--set", "align.outer_iters=2"]
    out = tcli.main(["align", "-i", str(data), "-o", str(tmp_path / "v.npy"),
                     "--device", "cpu", *args])
    vol = np.load(tmp_path / "v.npy")
    assert vol.shape == (24, 24, 24) and np.all(np.isfinite(vol))
    state = out["state"]
    assert len(out["theta_per_outer"]) == 2
    np.testing.assert_array_equal(out["theta_per_outer"][-1],
                                  state.views.theta6().numpy())
    assert len(state.history["recon_rms"]) == 2
    # the CLI is align_reconstruct on the dataset with COM starting values
    from tomojax_torch.align import com_align
    from tomojax_torch.utils import io
    d = io.load_dataset(data)
    geom = Geometry(n_proj=12, vox_shape=(24,) * 3, det_shape=(24, 24))
    proj = torch.as_tensor(d["projections"])
    est = com_align(proj, geom, d["phi"], device="cpu").numpy()
    t0 = np.zeros((12, 3), np.float32)
    t0[:, [0, 2]] = est
    ref = tpipe.align_reconstruct(
        proj.reshape(12, -1), geom, Views.create(12, phi=d["phi"], t=t0),
        outer_iters=2, recon="cgls", recon_iters=6, refine_iters=3,
        family="slab", refine_method="lm_slab",
        bounds=(np.array([-3, -3, -3, -np.inf, -0.02, -0.02], np.float32),
                np.array([3, 3, 3, np.inf, 0.02, 0.02], np.float32)),
        ground_truth=d["phantom"], device="cpu")
    assert torch.equal(ref.views.theta6(), state.views.theta6())
    assert ref.history == state.history

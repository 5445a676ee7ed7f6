"""The port's exact-family alignment drivers against tomojax's, on the CPU
in float64: ``align_reconstruct`` on the ray family with
``refine_method="lm"`` (and ``"lm"`` on a slab recon), the debias stage,
``frozen_polish``, ``align_reconstruct_cv`` with its checkpoints,
``_fov_mask``, ``cli align`` at its defaults and the convergence-study
tool.

One problem throughout (16³, 24 views over [0.2, π + 0.2), ±1 px / ±0.01 rad
jitter, exact ray-family data, zero-jitter starts), so tomojax compiles its
programs for one shape. The drivers run the same stages on the same
numpy inputs: θ and the volumes agree to 1e-8, the histories to 1e-8
relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tomojax.align as jalign_mod
from tomojax import cli as jcli
from tomojax.align import pipeline as jpipe
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import projector as jproj

import tomojax_torch.align as talign_mod
from tomojax_torch import cli as tcli
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.align.refine import PARAM_SETS
from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import projector as tproj
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.tools import convergence_study
from tomojax_torch.utils import interop

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)

F64 = torch.float64
N, V = 16, 24


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(3)
    jg = jgeo.Geometry(n_proj=V, vox_shape=(N,) * 3, det_shape=(N, N))
    # off the lattice-aligned poses (φ = 0, π/4, …), where the slab
    # Jacobian's one-sided derivatives depend on the last bit of the
    # sample positions (ROADMAP Queue 3)
    phi = 0.2 + np.linspace(0, np.pi, V, endpoint=False)
    t = np.zeros((V, 3))
    t[:, [0, 2]] = rng.uniform(-1, 1, (V, 2))
    al, be = rng.uniform(-0.01, 0.01, (2, V))
    vol = jph.shepp3d(N).astype(np.float64)
    true = jgeo.Views.create(V, phi=phi, alpha=al, beta=be, t=t,
                             dtype=jnp.float64)
    meas = np.asarray(jproj.project(jnp.asarray(vol), jg, true,
                                    dtype=jnp.float64))
    init = jgeo.Views.create(V, phi=phi, dtype=jnp.float64)
    return dict(jg=jg, tg=interop.geometry(dataclasses.asdict(jg)), vol=vol,
                meas=meas, jinit=init, jtrue=true,
                init=interop.views(jax.tree.map(np.asarray, init)),
                true=interop.views(jax.tree.map(np.asarray, true)))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, ref, history=True):
    np.testing.assert_allclose(got.views.theta6().numpy(),
                               np.asarray(ref.views.theta6()), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.volume.numpy(), np.asarray(ref.volume),
                               rtol=0, atol=1e-8)
    if history:
        for k in ("recon_rms", "refine_cost"):
            np.testing.assert_allclose(got.history[k], ref.history[k],
                                       rtol=1e-8)


RAY = dict(outer_iters=1, recon="sirt", recon_iters=10, refine_iters=4)


@pytest.fixture(scope="module")
def ray_ref(prob):
    return jpipe.align_reconstruct(jnp.asarray(prob["meas"]), prob["jg"],
                                   prob["jinit"], ground_truth=prob["vol"],
                                   dtype=jnp.float64, **RAY)


def _align(prob, **kw):
    return tpipe.align_reconstruct(_t(prob["meas"]), prob["tg"],
                                   prob["init"], ground_truth=prob["vol"],
                                   dtype=F64, device="cpu", **kw)


def test_align_ray_lm_matches_tomojax(prob, ray_ref):
    """tomojax's defaults (ray family, SIRT, box LM on the exact
    Jacobian, the moment hook on the ray reprojection), one outer: θ and
    the volume to 1e-8, also with the refinement in chunks of 2 views
    (equal to the unchunked run to 1e-12)."""
    got = _align(prob, **RAY)
    _close(got, ray_ref)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ray_ref.residuals), rtol=1e-8)
    chunked = _align(prob, refine_chunk=2, **RAY)
    np.testing.assert_allclose(chunked.views.theta6().numpy(),
                               got.views.theta6().numpy(), rtol=0,
                               atol=1e-12)
    assert torch.equal(chunked.volume, got.volume)


def test_align_ray_lm_resume_equals_uninterrupted(prob, tmp_path):
    kw = {**RAY, "outer_iters": 2, "recon_iters": 4, "refine_iters": 2}
    full = _align(prob, **kw)
    _align(prob, checkpoint_dir=str(tmp_path), **{**kw, "outer_iters": 1})
    seen = []
    resumed = _align(prob, checkpoint_dir=str(tmp_path),
                     callback=lambda it, *_: seen.append(it), **kw)
    assert seen == [1]
    assert torch.equal(resumed.views.theta6(), full.views.theta6())
    assert torch.equal(resumed.volume, full.volume)
    assert resumed.history == full.history


def test_lm_on_slab_plane_recon_matches_tomojax(prob):
    """``refine_method="lm"`` refines on the exact Jacobian while the
    recon runs on slab_plane (CGLS)."""
    kw = dict(outer_iters=1, recon="cgls", recon_iters=6, refine_iters=3,
              family="slab_plane", refine_method="lm")
    ref = jpipe.align_reconstruct(jnp.asarray(prob["meas"]), prob["jg"],
                                  prob["jinit"], ground_truth=prob["vol"],
                                  dtype=jnp.float64, **kw)
    _close(_align(prob, **kw), ref)


def test_exact_forward_and_defect_fixed_point(prob):
    """``_exact_forward`` in chunks is the ray family's ``project``; the
    defect at the truth re-centres slab data so that the truth is a
    stationary point again (tests/test_align.py's debias check, float32):
    residual < 1e-5 relative, and the slab LM started at the truth stays
    within 1e-4 on the debiased data, no further than on the raw data."""
    geom, vt = prob["tg"], prob["true"].take(slice(0, 6))
    g6 = dataclasses.replace(geom, n_proj=6)
    vol = torch.as_tensor(prob["vol"], dtype=torch.float32)
    meas = tproj.project(vol, g6, vt).reshape(6, -1)
    p_exact = tpipe._exact_forward(vol, g6, vt, torch.float32, 4)
    np.testing.assert_allclose(p_exact.numpy(), meas.numpy(), rtol=0,
                               atol=1e-5)
    p_slab = tsp.project(vol, g6, vt, quad="arc")
    work = meas - (p_exact - p_slab)
    assert float(torch.linalg.norm(p_slab - work)
                 / torch.linalg.norm(meas)) < 1e-5
    th = vt.theta6().double().numpy()
    kw = dict(mask=PARAM_SETS["xzab"], lower=th - 0.5, upper=th + 0.5,
              max_iter=10)
    m = np.asarray(PARAM_SETS["xzab"])
    walk = {name: np.abs(refine_views_slab(vol, data, g6, vt, **kw)
                         .theta6.double().numpy() - th)[:, m].max()
            for name, data in (("raw", meas), ("debiased", work))}
    assert walk["debiased"] < 1e-4 and walk["debiased"] <= walk["raw"], walk


def test_debias_stage_matches_tomojax(prob, capsys):
    """Two outers of slab CGLS + lm_slab on ray data with the defect
    recomputed every outer (from the second, once the volume is
    nonzero): tomojax's θ, volume and printed defect."""
    kw = dict(outer_iters=2, recon="cgls", recon_iters=6, refine_iters=3,
              family="slab", refine_method="lm_slab", debias_period=1,
              debias_chunk=7, progress=True)
    ref = jpipe.align_reconstruct(jnp.asarray(prob["meas"]), prob["jg"],
                                  prob["jinit"], ground_truth=prob["vol"],
                                  dtype=jnp.float64, **kw)
    want = [ln.split(": ", 1)[1].split(" (t=")[0] for ln in
            capsys.readouterr().out.splitlines() if "debias defect" in ln]
    got = _align(prob, **kw)
    lines = [ln.split(": ", 1)[1].split(" (t=")[0] for ln in
             capsys.readouterr().out.splitlines() if "debias defect" in ln]
    assert lines == want and len(lines) == 1, (lines, want)
    rel = float(lines[0].split("rel=")[1])
    assert 0 < rel < 0.1
    _close(got, ref)


@pytest.mark.parametrize("family, iters", [("ray", 4), ("slab", 5)])
def test_frozen_polish_matches_tomojax(prob, family, iters):
    """The deep per-view LM against a frozen volume and the final moment
    match: θ to 1e-8, the residuals to 1e-8 relative; the volume is
    returned unchanged (the same bits)."""
    vol = jph.shepp3d(N).astype(np.float64) * 0.9
    kw = dict(refine_iters=iters, family=family)
    ref = jpipe.frozen_polish(jnp.asarray(prob["meas"]), prob["jg"],
                              prob["jinit"], jnp.asarray(vol),
                              dtype=jnp.float64, **kw)
    v = torch.as_tensor(vol)
    got = tpipe.frozen_polish(_t(prob["meas"]), prob["tg"], prob["init"], v,
                              dtype=F64, device="cpu", **kw)
    assert torch.equal(got.volume, v)
    _close(got, ref, history=False)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-8)
    np.testing.assert_allclose(got.history["refine_cost"],
                               ref.history["refine_cost"], rtol=1e-8)


def test_fov_mask_matches_tomojax():
    for det, margins in (((16, 16), (1.5, 2.0)), ((12, 20), (0.0, 11.0))):
        jg = jgeo.Geometry(n_proj=4, vox_shape=(16, 14, 18), det_shape=det)
        tg = interop.geometry(dataclasses.asdict(jg))
        got = tpipe._fov_mask(tg, *margins)
        want = np.asarray(jpipe._fov_mask(jg, *margins))
        assert got.dtype == bool and got.shape == (16, 14, 18)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < got.size


def test_cli_align_defaults_match_tomojax(tmp_path, monkeypatch):
    """``cli align`` at its defaults (ray family, SIRT, lm, the moment
    hook) against tomojax's on one ray-family dataset, one outer of 10
    SIRT iterations. Both CLIs run float32; run in float64 (their
    ``align_reconstruct`` given ``dtype``) θ and the volume agree to
    1e-8. The port's float32 run at the CLI's own dtype gives its float64
    volume to 1e-5 relative (float32 rounding over 10 SIRT iterations)
    and θ inside the box; its θ is not held closer, since one LM outer on
    a 10-iteration volume moves the tilts by float32 rounding's choice of
    accepted steps (4e-3 rad here)."""
    data = tmp_path / "d.h5"
    tcli.main(["simulate", "--size", str(N), "--views", str(V), "-o",
               str(data), "--device", "cpu"])
    args = ["align", "-i", str(data), "--set", "align.outer_iters=1",
            "--set", "align.recon_iters=10"]
    t32 = tcli.main([*args, "-o", str(tmp_path / "t32.npy"), "--device",
                     "cpu"])
    j_align, t_align = jalign_mod.align_reconstruct, \
        talign_mod.align_reconstruct
    states = {}

    def f64(name, fn, dtype):
        def run(*a, **k):
            states[name] = fn(*a, dtype=dtype, **k)
            return states[name]
        return run

    monkeypatch.setattr(jalign_mod, "align_reconstruct",
                        f64("jax", j_align, jnp.float64))
    monkeypatch.setattr(talign_mod, "align_reconstruct",
                        f64("torch", t_align, F64))
    jcli.main([*args, "-o", str(tmp_path / "j.npy")])
    out = tcli.main([*args, "-o", str(tmp_path / "t.npy"), "--device",
                     "cpu"])
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == ref.shape == (N, N, N)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    # the saved volume is the SIRT before the LM: θ holds the CLI's LM
    th, th_ref = (states["torch"].views.theta6().numpy(),
                  np.asarray(states["jax"].views.theta6()))
    assert np.abs(th - th[:, 3:4] * [0, 0, 0, 1, 0, 0]).max() > 1e-3
    np.testing.assert_allclose(th, th_ref, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(out["state"].views.theta6().numpy(), th)
    assert len(out["theta_per_outer"]) == 1
    v32 = np.load(tmp_path / "t32.npy")
    assert np.linalg.norm(v32 - got) / np.linalg.norm(got) < 1e-5
    th32 = t32["state"].views.theta6().numpy()
    th0 = np.zeros_like(th32)
    th0[:, 3] = th32[:, 3]
    assert np.all(np.abs(th32 - th0) <= [3, 0, 3, 0, 0.02, 0.02])


def test_convergence_study_record(tmp_path):
    """The convergence-study tool at a tiny size, one outer per stage:
    the record's keys, one entry per stage outer, errors finite."""
    out = tmp_path / "c.json"
    rec = convergence_study.main([
        "--device", "cpu", "--size", "12", "--views", "8",
        "--outers-fast", "1", "--outers-exact", "1", "--outers-polish", "1",
        "--outers-cv", "1", "--cv-folds", "2", "--outers-debias", "1",
        "--recon-iters", "3", "--refine-iters", "2",
        "--recon-iters-polish", "3", "--refine-iters-polish", "2",
        "--final-recon-iters", "3", "--out", str(out)])
    assert out.exists() and not (tmp_path / "c.json.partial").exists()
    assert {"config", "iters", "final_recon", "total_wall_s",
            "final"} <= set(rec)
    assert [e["stage"] for e in rec["iters"]] == ["fast", "exact", "polish",
                                                  "cv", "debias"]
    for e in rec["iters"]:
        assert {"raw", "gauge_corrected", "gauge", "stage", "outer",
                "vol_rel_l2", "recon_rms", "wall_s"} <= set(e)
        for kind in ("raw", "gauge_corrected"):
            for p in ("tx", "tz", "alpha", "beta"):
                assert np.isfinite(e[kind][p]["mean"])
    fr = rec["final_recon"]
    assert {"iters", "stop", "prec", "debias_rounds", "rounds_rel_l2",
            "wall_s", "vol_rel_l2"} <= set(fr)
    assert fr["iters"] == 3 and len(fr["rounds_rel_l2"]) == 2
    assert rec["config"]["device"] == "cpu"

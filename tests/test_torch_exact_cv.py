"""The port's cross-validated alternation, ``align_reconstruct_cv``,
against tomojax's on the CPU in float64: K = 3 interleaved folds, the
``cv_ckpt_####.npz`` checkpoints, the resume, the change of the fold count
and tomojax's legacy 2-fold layout.

The problem is ``tests/test_torch_exact_align.py``'s (16³, 24 views of
exact ray-family data, zero-jitter starts); a file of its own, so that
tomojax's per-complement and per-fold programs compile in another test
worker. θ, the volumes and the histories agree to 1e-8.
"""

import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import pipeline as jpipe

from tomojax_torch.align import pipeline as tpipe

from tests.test_torch_exact_align import F64, N, _close, _t
from tests.test_torch_exact_align import prob  # noqa: F401 (fixture)

# These tests run small ops, where torch's intra-op threads only contend
# with the other test workers on the same cores.
torch.set_num_threads(1)


CV = dict(recon="cgls", recon_iters=6, refine_iters=3)


def _cv_pair(prob, jdir, tdir, **kw):
    # tomojax's CV writes fold θ into np.asarray of a float64 JAX array,
    # which is read-only: run it with a copying asarray
    copying_np = types.SimpleNamespace(**vars(np))
    copying_np.asarray = np.array
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "np", copying_np)
        ref = jpipe.align_reconstruct_cv(jnp.asarray(prob["meas"]), prob["jg"],
                                         prob["jinit"], dtype=jnp.float64,
                                         checkpoint_dir=str(jdir), **CV,
                                         **kw)
    got = tpipe.align_reconstruct_cv(_t(prob["meas"]), prob["tg"],
                                     prob["init"], dtype=F64, device="cpu",
                                     checkpoint_dir=str(tdir), **CV, **kw)
    return ref, got


def _vols(path, it):
    return np.load(path / f"cv_ckpt_{it:04d}.npz")["vols"]


def test_align_reconstruct_cv_matches_tomojax(prob, tmp_path):
    """K = 3 interleaved folds, one outer: θ, the mean volume, the
    histories and each complement's volume (``vols``) to 1e-8; the
    checkpoints carry the same keys."""
    ref, got = _cv_pair(prob, tmp_path / "j", tmp_path / "t", folds=3,
                        outer_iters=1)
    _close(got, ref)
    np.testing.assert_allclose(got.residuals.numpy(),
                               np.asarray(ref.residuals), rtol=1e-8)
    zj = np.load(tmp_path / "j" / "cv_ckpt_0000.npz")
    zt = np.load(tmp_path / "t" / "cv_ckpt_0000.npz")
    assert sorted(zj.files) == sorted(zt.files)
    assert zt["vols"].shape == (3, N, N, N)
    np.testing.assert_allclose(zt["vols"], zj["vols"], rtol=0, atol=1e-8)


def test_align_reconstruct_cv_resume(prob, tmp_path):
    """Resuming: from the port's own checkpoint the same bits as the
    uninterrupted run; from a checkpoint of another fold count (3 → 2)
    and from tomojax's legacy 2-fold ``vol_a``/``vol_b`` layout, tomojax's
    θ and volume to 1e-8 (each fold re-warmed as tomojax does)."""
    kw = dict(folds=3, outer_iters=2)
    full = tpipe.align_reconstruct_cv(_t(prob["meas"]), prob["tg"],
                                      prob["init"], dtype=F64, device="cpu",
                                      checkpoint_dir=str(tmp_path / "full"),
                                      **CV, **kw)
    first = tmp_path / "first"
    tpipe.align_reconstruct_cv(_t(prob["meas"]), prob["tg"], prob["init"],
                               dtype=F64, device="cpu", checkpoint_dir=str(
                                   first), **CV, folds=3, outer_iters=1)
    resumed_dir = tmp_path / "resumed"
    shutil.copytree(first, resumed_dir)
    seen = []
    resumed = tpipe.align_reconstruct_cv(
        _t(prob["meas"]), prob["tg"], prob["init"], dtype=F64, device="cpu",
        checkpoint_dir=str(resumed_dir),
        callback=lambda it, *_: seen.append(it), **CV, **kw)
    assert seen == [1]
    assert torch.equal(resumed.views.theta6(), full.views.theta6())
    assert torch.equal(resumed.volume, full.volume)
    np.testing.assert_array_equal(_vols(resumed_dir, 1),
                                  _vols(tmp_path / "full", 1))

    # the fold count changes from 3 to 2
    for name in ("j2", "t2"):
        shutil.copytree(first, tmp_path / name)
    ref, got = _cv_pair(prob, tmp_path / "j2", tmp_path / "t2", folds=2,
                        outer_iters=2)
    _close(got, ref)
    np.testing.assert_allclose(_vols(tmp_path / "t2", 1),
                               _vols(tmp_path / "j2", 1), rtol=0, atol=1e-8)

    # tomojax's legacy 2-fold layout
    z = dict(np.load(first / "cv_ckpt_0000.npz"))
    vols = z.pop("vols")
    for name in ("jl", "tl"):
        (tmp_path / name).mkdir()
        np.savez(tmp_path / name / "cv_ckpt_0000.npz", vol_a=vols[0],
                 vol_b=vols[1], **z)
    ref, got = _cv_pair(prob, tmp_path / "jl", tmp_path / "tl", folds=2,
                        outer_iters=2)
    _close(got, ref)

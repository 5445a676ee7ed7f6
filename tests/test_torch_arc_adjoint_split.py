"""The arc adjoint K4's dataflow, emulated in float64 on the CPU, against
the port's plain vjp and tomojax's adjoint.

K4 (``tomojax_torch/kernels/csrc/slab_arc.cu``) runs on the card only. It
factors the exact transpose of the arc forward into two 1-D gathers per
view, source slab r = -1 .. ny-1 and branch b: a pass-B transpose from the
detector to T_all(x, v) = Σ_u w_x·ok·g and T_fy(x, v) = Σ_u w_x·ok·fy·g
over the u in the widened inversion window of X, then a pass-A transpose
that gathers, for each voxel (x, z), w_z·(T_all − T_fy) into slab r and
w_z·T_fy into slab r + 1 over the v in the widened inversion window of ζ.
(The kernel sweeps the joint window of a few neighbouring points at once,
a superset of each point's window; the tap tests pick the same entries.)
This file runs that dataflow, with each point's own inversion window and
K3's exact tap and mask tests, in float64 numpy, and holds it to the
port's plain vjp (``core/slab_projector.adjoint_oriented``) and to
tomojax's ``backproject_scalars`` at 1e-12 relative. It proves the
source-major factorization and its bookkeeping: a side or a branch mixed
up, or a lost source slab −1, fails here. It does not run K4's float32
corner-union windows or their chunking; the card tests in
``test_torch_cuda.py`` (the odd sizes at a fine detector pitch, where
windows span several chunks) check those. Geometries: 16³ × 12 jittered
views over the full circle (all
orientation groups), detector 18 × 14, march steps 1, 0.75 and 0.5 (2, 2
and 3 branches; branch 1 carries samples wherever edy < 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import geometry as jgeo
from tomojax.core import slab_projector as jsp

from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.utils import interop

torch.set_num_threads(1)

N, DET, N_PROJ = 16, (18, 14), 12
STEPS = [1.0, 0.75, 0.5]


def _problem(step):
    rng = np.random.default_rng(11)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=DET,
                       step_size=step)
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-1.5, 1.5, (N_PROJ, 3)))
    sino = rng.standard_normal((N_PROJ, jg.n_det))
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, sino


def _index_range(a, b, lo_val, hi_val, n):
    """The kernel's candidate window: every i with lo_val < a + b·i <
    hi_val, widened by one index on each side, clamped to [0, n)."""
    a, lo_val, hi_val = np.broadcast_arrays(a, lo_val, hi_val)
    if abs(b) < 1e-6:
        return np.zeros(a.shape, int), np.full(a.shape, n - 1)
    t0, t1 = (lo_val - a) / b, (hi_val - a) / b
    tl = np.clip(np.minimum(t0, t1), -2.0, n + 1.0)
    th = np.clip(np.maximum(t0, t1), -2.0, n + 1.0)
    return (np.maximum(0, np.floor(tl).astype(int) - 1),
            np.minimum(n - 1, np.ceil(th).astype(int) + 1))


def _tap_weight(pos, k):
    """Lerp weight that position ``pos`` gives integer tap ``k``."""
    f = np.floor(pos)
    w = pos - f
    return np.where(k == f, 1.0 - w, np.where(k == f + 1, w, 0.0))


def _gather(lo, hi, weight_of, *values_of):
    """For each value function f: Σ over i in [lo, hi] of weight_of(i)·
    f(i), elementwise over the windows."""
    acc = [np.zeros(lo.shape) for _ in values_of]
    for k in range(int((hi - lo).max(initial=-1)) + 1):
        i = np.minimum(lo + k, hi)     # past the window: masked to 0
        w = np.where(lo + k <= hi, weight_of(i), 0.0)
        for a, f in zip(acc, values_of):
            a += w * f(i)
    return acc


def split_adjoint(g, sc, geom, stats):
    """K4's dataflow for one orientation group: ``g`` (V, nu, nv), ``sc``
    (V, NS) float64 → the oriented volume (nx, ny, nz). ``stats`` counts
    the branch-1 samples and collects the slab-(−1) side-1 sums."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    n_branch = tsp._n_branch(geom.step_size)
    vol = np.zeros((nx, ny, nz))
    u = np.arange(nu, dtype=float)[:, None]
    v = np.arange(nv, dtype=float)[None, :]
    x = np.arange(nx, dtype=float)[:, None]
    z = np.arange(nz, dtype=float)[None, :]
    for gv, row in zip(np.asarray(g), np.asarray(sc)):
        p = tsp.params_from_scalars(row)
        p = {k: float(val) for k, val in p.items()}
        zav = p["evz"] - p["gzx"] * p["evx"]
        for ri in range(-1, ny):
            r = float(ri)
            cx = p["cxb"] + p["rx"] * r
            cz = p["czb"] + p["rz"] * r
            # the sample's march index (u, v) and pass A's grid sawtooth
            jreal = (r - (p["b1"] + u * p["euy"] + v * p["evy"])) / p["edy"]
            d = x - cx - v * p["evx"]                       # (nx, nv)
            jr = (r - (p["b1"] + d * (1.0 / p["eux"]) * p["euy"]
                       + v * p["evy"])) / p["edy"]
            cf = np.ceil(jr) - jr
            zeta_aff = cz + p["gzx"] * d + v * p["evz"]
            for b in range(n_branch):
                # 1. samples
                j = np.ceil(jreal) + b
                cfb = j - jreal
                fy = p["edy"] * cfb
                ok = (j >= 0) & (j < geom.n_steps) & (fy < 1.0)
                X = cx + u * p["eux"] + v * p["evx"] + p["edx"] * cfb
                G = np.where(ok, gv, 0.0)
                Gy = np.where(ok, fy * gv, 0.0)
                if b == 1:
                    stats["branch1_samples"] += int(ok.sum())
                # 2. pass-B transpose over the widened u windows
                ex = (p["edx"] * b, p["edx"] * (b + 1))
                lo, hi = _index_range(cx + v * p["evx"], p["eux"],
                                      x - 1.0 - max(ex), x + 1.0 - min(ex),
                                      nu)                   # (nx, nv)
                col = np.broadcast_to(np.arange(nv), lo.shape)
                xs = np.broadcast_to(x, lo.shape)
                t_all, t_fy = _gather(
                    lo, hi, lambda i: _tap_weight(X[i, col], xs),
                    lambda i: G[i, col], lambda i: Gy[i, col])
                zeta = zeta_aff + p["edz"] * (cf + b)       # (nx, nv)
                # 3. pass-A transpose over the widened v windows
                ez = (p["edz"] * b, p["edz"] * (b + 1))
                lo, hi = _index_range(cz + p["gzx"] * (x - cx), zav,
                                      z - 1.0 - max(ez), z + 1.0 - min(ez),
                                      nv)                   # (nx, nz)
                rowx = np.broadcast_to(np.arange(nx)[:, None], lo.shape)
                zs = np.broadcast_to(z, lo.shape)
                side0, side1 = _gather(
                    lo, hi, lambda i: _tap_weight(zeta[rowx, i], zs),
                    lambda i: t_all[rowx, i] - t_fy[rowx, i],
                    lambda i: t_fy[rowx, i])
                if ri >= 0:
                    vol[:, ri, :] += side0
                if ri + 1 < ny:
                    vol[:, ri + 1, :] += side1
                if ri == -1:
                    stats["slab_m1_side1"].append(float(np.abs(side1).sum()))
    return vol


def _split_backproject(sino, tg, tv, stats):
    """The multi-view adjoint through :func:`split_adjoint`, grouped and
    oriented as ``backproject_scalars``; also returns each group's
    (emulation, plain vjp) pair."""
    gstruct, scalars = tsp.scalar_groups(tg, tv, "arc", dtype=torch.float64)
    nu, nv = tg.det_shape
    sino = torch.as_tensor(sino).reshape(-1, nu, nv)
    vol = torch.zeros(tg.vox_shape, dtype=torch.float64)
    pairs = []
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        g = sino[list(idx)]
        if uf:
            g = g.flip(1)
        got = torch.as_tensor(split_adjoint(g.numpy(), sc.numpy(), tg, stats))
        pairs.append((got, tsp.adjoint_oriented(g, sc, tg, "arc")))
        vol += tsp.unorient_volume(got, sw, yf)
    return vol, pairs, len(gstruct)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=STEPS, ids=lambda s: f"step{s}")
def split(request):
    jg, jv, tg, tv, sino = _problem(request.param)
    stats = {"branch1_samples": 0, "slab_m1_side1": []}
    vol, pairs, n_groups = _split_backproject(sino, tg, tv, stats)
    return dict(jg=jg, jv=jv, sino=sino, vol=vol, pairs=pairs,
                n_groups=n_groups, stats=stats)


def test_split_matches_plain_vjp_per_group(split):
    for got, want in split["pairs"]:
        assert _rel(got.numpy(), want.numpy()) < 1e-12


def test_split_matches_tomojax_backproject_scalars(split):
    gstruct, scalars = jsp.scalar_groups(split["jg"], split["jv"], "arc",
                                         jnp.float64)
    want = jsp.backproject_scalars(jnp.asarray(split["sino"]), split["jg"],
                                   gstruct, scalars, quad="arc",
                                   dtype=jnp.float64)
    assert _rel(split["vol"].numpy(), np.asarray(want)) < 1e-12


def test_split_covers_all_groups_branch1_and_slab_minus1(split):
    assert split["n_groups"] >= 4
    assert split["stats"]["branch1_samples"] > 0
    assert max(split["stats"]["slab_m1_side1"]) > 0.0

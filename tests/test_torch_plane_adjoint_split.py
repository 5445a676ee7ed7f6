"""The plane adjoint K2's dataflow, emulated in float64 on the CPU, against
the port's plain vjp and tomojax's adjoint.

K2 (``tomojax_torch/kernels/csrc/slab_plane.cu``) runs on the card only. It
factors the exact transpose of the plane forward K1 into two 1-D
transposes per view and slab r: a pass-B transpose from the detector to
T[x, v] = Σ_u w_x(X_r(u, v) → x)·g[u, v], then a pass-A transpose that
gathers, for each voxel (x, z), scale·Σ_v w_z(ζ_r(x, v) → z)·T[x, v]. A
CTA owns slab r and an (x, z) tile; per view it takes the v whose ζ-taps
can reach the tile (the union of the windows at the tile's two extreme
columns), cuts them into chunks of rows from the multiple of a few rows
below the window (so rows are staged in 16-byte words; the extra rows add
nothing), takes per row chunk the u whose
X-taps can reach the tile's columns and cuts those into chunks of
columns. In each column chunk an owner of a few columns of one row v
sweeps their joint u window once, keeping the running sums of the
candidate's two columns and adding a column's sum into T when the sweep
has passed it; after a row chunk's last column chunk the owner of a few
voxels of one column sweeps their v window the same way (pass A). Every
window comes from one reciprocal of the slope (eux in u, zav in v),
widened by the rounding slack, and K1's exact tap tests decide.

This file runs that dataflow (tiles, row and column chunks, the owners'
sweeps, the windows from reciprocals and the tap tests) in float64 numpy,
with small tiles, chunks and owner runs so that every volume edge and
chunk boundary is crossed, and holds
it to the port's plain vjp (``core/slab_projector.adjoint_oriented``) and
to tomojax's ``backproject_scalars`` (slab_plane) at 1e-12 relative: a
window that drops an entry, a chunk whose sums are lost or counted twice,
or a group mixed up fails here. K2's float32 windows are the card tests'
to check (``test_torch_cuda.py``). Geometries: 17³ × 12 jittered views over
the full circle (every orientation group, u-flip included), detector
19 × 15, detector pitch 1 and 0.7.
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

N, DET, N_PROJ = 17, (19, 15), 12
PITCHES = [1.0, 0.7]
TX, TZ = 6, 7          # the tile: small, so tiles end at the volume's edge
UC, VC = 5, 4          # column and row chunks: windows span several
VA = 2                 # row chunks start at a multiple of VA (VC's divisor)
XR = 4                 # pass B's columns per owner: groups of 4 and 2
ZR = 3                 # pass A's voxels per owner: runs of 3 and 1


def _problem(det_pix):
    rng = np.random.default_rng(13)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=DET,
                       det_pix=(det_pix, det_pix))
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-1.5, 1.5, (N_PROJ, 3)))
    sino = rng.standard_normal((N_PROJ, jg.n_det))
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, sino


def _window(a, b, inv_b, lo_val, hi_val, ext, n):
    """The kernel's candidate window: every i with a + b·i in [lo_val,
    hi_val), widened by the rounding slack, clamped to [0, n);
    elementwise over broadcast arrays."""
    a, lo_val, hi_val = np.broadcast_arrays(a, lo_val, hi_val)
    if not abs(b) >= 1e-6:
        return np.zeros(a.shape, int), np.full(a.shape, n - 1)
    slack = ((2 * abs(a) + ext + abs(b) * n + abs(lo_val) + abs(hi_val) + 2)
             * 1e-6 * abs(inv_b))
    t0, t1 = (lo_val - a) * inv_b, (hi_val - a) * inv_b
    tl = np.clip(np.minimum(t0, t1) - slack, -2.0, n + 1.0)
    th = np.clip(np.maximum(t0, t1) + slack, -2.0, n + 1.0)
    return (np.maximum(0, np.ceil(tl).astype(int)),
            np.minimum(n - 1, np.floor(th).astype(int)))


def split_adjoint(g, sc, geom, stats):
    """K2's dataflow for one orientation group: ``g`` (V, nu, nv), ``sc``
    (V, NS) float64 → the oriented volume (nx, ny, nz). ``stats`` counts
    the tiles whose views took more than one row or column chunk."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    vol = np.zeros((nx, ny, nz))
    for r in range(ny):
        for x0 in range(0, nx, TX):
            x = np.arange(x0, min(x0 + TX, nx))[:, None]          # (tx, 1)
            for z0 in range(0, nz, TZ):
                z = np.arange(z0, min(z0 + TZ, nz))[None, :]      # (1, tz)
                acc = np.zeros((x.size, z.size))
                for gv, row in zip(np.asarray(g), np.asarray(sc)):
                    acc += _tile_view(gv, row, r, x, z, nu, nv, stats)
                vol[x[:, 0], r, z0:z0 + z.size] = acc
    return vol


def _tile_view(gv, row, r, x, z, nu, nv, stats):
    """One view's contribution to one tile of slab r: its row chunks, each
    row chunk's column chunks, pass B into T, pass A into the tile."""
    p = {k: float(val) for k, val in tsp.params_from_scalars(row).items()}
    zav, scale = float(row[tsp.S_ZAV]), float(row[tsp.S_SCALE])
    cx, cz = p["cxb"] + p["rx"] * r, p["czb"] + p["rz"] * r
    inv_eux, inv_zav = 1.0 / p["eux"], 1.0 / zav
    ext = abs(p["evx"]) * nv
    xa, xb, za, zb = float(x.min()), float(x.max()), float(z.min()), float(
        z.max())

    def zeta_a(xx):                                # ζ at v = 0
        return cz + p["gzx"] * (xx - cx)

    lo, hi = _window(np.array([zeta_a(xa), zeta_a(xb)]), zav, inv_zav,
                     za - 1.0, zb + 1.0, 0.0, nv)
    vlo, vhi = int(lo.min()), int(hi.max())
    acc = np.zeros((x.size, z.size))
    n_chunks = 0
    for vc0 in range(vlo // VA * VA, vhi + 1, VC):
        vc1 = min(vhi, vc0 + VC - 1)
        v = np.arange(vc0, vc1 + 1)[None, :]                     # (1, nvw)
        lo, hi = _window(cx + p["evx"] * np.array([vc0, vc1], float),
                         p["eux"], inv_eux, xa - 1.0, xb + 1.0, ext, nu)
        ulo, uhi = int(lo.min()), int(hi.max())
        if ulo > uhi:
            continue
        T = np.zeros((x.size, v.size))
        for uc0 in range(ulo, uhi + 1, UC):
            n_chunks += 1
            _pass_b(T, gv, p, cx, inv_eux, ext, x[:, 0], v[0], uc0,
                    min(uhi, uc0 + UC - 1), nu)
        _pass_a(acc, T, scale, zeta_a, zav, inv_zav, x[:, 0], z[0], vc0,
                vc1, nv)
    if n_chunks > 1:
        stats["multi_chunk"] += 1
    return acc


def _pass_b(T, gv, p, cx, inv_eux, ext, xs, v, uc0, uc1, nu):
    """K2's pass B over one column chunk [uc0, uc1], added into T (tx,
    nvw): the owner of XR neighbouring columns x of one row v sweeps their
    joint u window once (:func:`_sweep`). Vectorized over the rows."""
    rows = np.arange(v.size)
    for g0 in range(0, xs.size, XR):
        xa, xb = xs[g0], xs[min(g0 + XR, xs.size) - 1]
        lo, hi = _window(cx + p["evx"] * v, p["eux"], inv_eux, xa - 1.0,
                         xb + 1.0, ext, nu)
        lo, hi = np.maximum(lo, uc0), np.minimum(hi, uc1)
        part = np.zeros((v.size, xb - xa + 1))
        _sweep(part, lo, hi, p["eux"] > 0,
               lambda u: cx + p["eux"] * u + p["evx"] * v,
               lambda u: gv[np.clip(u, 0, nu - 1), v], xa, xb, rows)
        T[xa - xs[0]:xb - xs[0] + 1] += part.T


def _sweep(acc, lo, hi, up, pos_of, val_of, first, last, rows):
    """The kernels' owner sweep, vectorized over the owners (``rows``):
    each sweeps [lo, hi] once in the direction in which its position
    grows, keeping the running sums of the candidate's two taps k and
    k + 1 (k never falls) and adding a tap's sum into acc[rows, k -
    first] when the sweep has passed it, for taps in [first, last]."""
    n = hi - lo + 1
    cur = np.zeros(rows.size, int)
    s0, s1 = np.zeros(rows.size), np.zeros(rows.size)

    def flush(mask, col, val):
        ok = mask & (col >= first) & (col <= last)
        acc[rows[ok], col[ok] - first] += val[ok]

    for i in range(int(n.max(initial=0))):
        live = i < n
        idx = lo + i if up else hi - i
        pos = pos_of(np.clip(idx, 0, None))
        k = np.floor(pos).astype(int)
        w = pos - np.floor(pos)
        val = val_of(idx)
        cur = np.where(i == 0, k, cur)
        while True:                              # the sweep passed cur
            adv = live & (cur < k)
            if not adv.any():
                break
            flush(adv, cur, s0)
            s0, s1 = np.where(adv, s1, s0), np.where(adv, 0.0, s1)
            cur = np.where(adv, cur + 1, cur)
        s0 = s0 + np.where(live, (1.0 - w) * val, 0.0)
        s1 = s1 + np.where(live, w * val, 0.0)
    flush(n > 0, cur, s0)
    flush(n > 0, cur + 1, s1)


def _pass_a(acc, T, scale, zeta_a, zav, inv_zav, xs, zs, vc0, vc1, nv):
    """K2's pass A over one row chunk [vc0, vc1], added into acc (tx, tz):
    the owner of ZR neighbouring voxels z of one column x sweeps their
    joint v window once (:func:`_sweep`). Vectorized over the columns."""
    cols = np.arange(xs.size)
    for r0 in range(0, zs.size, ZR):
        za, zb = zs[r0], zs[min(r0 + ZR, zs.size) - 1]
        lo, hi = _window(zeta_a(xs), zav, inv_zav, za - 1.0, zb + 1.0, 0.0,
                         nv)
        lo, hi = np.maximum(lo, vc0), np.minimum(hi, vc1)
        part = np.zeros((xs.size, zb - za + 1))
        _sweep(part, lo, hi, zav > 0, lambda v: zeta_a(xs) + zav * v,
               lambda v: T[cols, np.clip(v - vc0, 0, T.shape[1] - 1)],
               za, zb, cols)
        acc[:, za - zs[0]:zb - zs[0] + 1] += scale * part


def _split_backproject(sino, tg, tv, stats):
    """The multi-view adjoint through :func:`split_adjoint`, grouped and
    oriented as ``backproject_scalars``; also returns each group's
    (emulation, plain vjp) pair and the groups' flags."""
    gstruct, scalars = tsp.scalar_groups(tg, tv, "plane",
                                         dtype=torch.float64)
    nu, nv = tg.det_shape
    sino = torch.as_tensor(sino).reshape(-1, nu, nv)
    vol = torch.zeros(tg.vox_shape, dtype=torch.float64)
    pairs = []
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        g = sino[list(idx)]
        if uf:
            g = g.flip(1)
        got = torch.as_tensor(split_adjoint(g.numpy(), sc.numpy(), tg, stats))
        pairs.append((got, tsp.adjoint_oriented(g, sc, tg, "plane")))
        vol += tsp.unorient_volume(got, sw, yf)
    return vol, pairs, [g[1:] for g in gstruct]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=PITCHES, ids=lambda d: f"pix{d}")
def split(request):
    jg, jv, tg, tv, sino = _problem(request.param)
    stats = {"multi_chunk": 0}
    vol, pairs, flags = _split_backproject(sino, tg, tv, stats)
    return dict(jg=jg, jv=jv, sino=sino, vol=vol, pairs=pairs, flags=flags,
                stats=stats)


def test_split_matches_plain_vjp_per_group(split):
    for got, want in split["pairs"]:
        assert _rel(got.numpy(), want.numpy()) < 1e-12


def test_split_matches_tomojax_backproject_scalars(split):
    gstruct, scalars = jsp.scalar_groups(split["jg"], split["jv"], "plane",
                                         jnp.float64)
    want = jsp.backproject_scalars(jnp.asarray(split["sino"]), split["jg"],
                                   gstruct, scalars, quad="plane",
                                   dtype=jnp.float64)
    assert _rel(split["vol"].numpy(), np.asarray(want)) < 1e-12


def test_split_covers_every_group_and_chunk_boundaries(split):
    assert len(split["flags"]) == 4
    assert any(uf for _, _, uf in split["flags"])
    assert split["stats"]["multi_chunk"] > 0

"""The plane adjoint K2's dataflow, emulated in float64 on the CPU, against
the port's plain vjp and tomojax's adjoint.

K2 (``tomojax_torch/kernels/csrc/slab_plane.cu``, ``adj_kernel`` on the
gather schedule ``adj_gather`` that K2b shares) runs on the card only. It
factors the exact transpose of the plane forward K1 into two 1-D
transposes per view and slab r: a pass-B transpose from the detector to
T[x, v] = scale·Σ_u w_x(X_r(u, v) → x)·g[u, v], then a pass-A transpose
that gathers, for each voxel (x, z), Σ_v w_z(ζ_r(x, v) → z)·T[x, v]. A CTA
owns slab r and an (x, z) tile and walks the group's views in chunks: per
view the v whose ζ-taps can reach the tile (the union of the windows at
the tile's two extreme columns, from the multiple of a few rows below it),
cut into v chunks, and the u whose X-taps can reach the tile's columns
over those rows, cut into u chunks. Phase k, between two barriers, stages
chunk k + 1 into the other of two buffers, runs pass B of chunk k (into
one of two tables T, or into the thread's carries where a v chunk has
more u chunks to come) and pass A of chunk k − 1 from the other table.
Each view's windows and constants are computed once, into a ring of
three batches of records, a batch ahead of the staging.

Both transposes are gathers. An entry (a voxel) sums K1's lerp weight
times its value over consecutive candidates from the first integer of its
window less a slack, (x ± 1 − X(0, v))/eux − su (likewise in v); it takes
K + 1 of them, K = floor(2/|slope| + 2·slack), the most such a window
holds; past the chunk's capacity it takes the whole chunk. The weight is
picked by the candidate's floor: 1 − w for floor(p) = the tap, w for
floor(p) = the tap − 1, else 0, from K1's positions. Where zav = 1 (no
tilt, a unit v pitch), a pass-A thread's voxels, consecutive in z, share
their candidates: voxel j's start is voxel 0's plus j, each row of the
thread's range is weighted for every voxel whose 2 (or, where the
thread's windows hold one more, 3) candidates hold it, and rows outside
the chunk read zero.

This file runs that dataflow (the windows and records, the ring, the chunk
phases with their buffers and tables, the carries, the gathers with their
starts, counts, clamps and weights, and the shared-candidate pass A) in
float64 numpy, with small tiles, chunks, record batches and voxel runs so
that every volume edge and chunk boundary is crossed and the ring turns
over. It holds the result to the port's plain
vjp (``core/slab_projector.adjoint_oriented``) and to tomojax's
``backproject_scalars`` (slab_plane) at 1e-12 relative, checks that each
phase reads the chunk, table and record it should, and counts, per entry
and voxel, the candidates of its chunk with a nonzero weight that its
gather leaves out (none may be). Geometries: 17³ × 12 jittered views over
the full circle (every orientation group, u-flip included), detector
19 × 15 at pitches 1 and 0.7, and 61 × 53 at pitch 0.3, where a view's
candidate count reaches its cap; and the same views without tilts or z
shifts at pitch 1 ("flat"), where zav = 1 and the slab offsets cz are
whole, so that some threads' windows hold 3 candidates. K2's float32
windows are the card tests' to check (``test_torch_cuda.py``).
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

N, N_PROJ = 17, 12
# name: (detector pitch, detector, tilts)
PROBLEMS = {"pix1.0": (1.0, (19, 15), 0.02), "pix0.7": (0.7, (19, 15), 0.02),
            "pix0.3": (0.3, (61, 53), 0.02), "flat": (1.0, (19, 15), 0.0)}
TX, TZ = 6, 7          # the tile: small, so tiles end at the volume's edge
ZR = 3                 # pass A's voxels a thread: runs of 3 and 1
UC, VC = 5, 4          # u and v chunks: windows span several
VA = 2                 # v chunks start at a multiple of VA (VC's divisor)
B = 2                  # view records per batch: the ring of 3 turns over
POS_MAX = 2.0 ** 21    # floor_small's range, with room


def _problem(name):
    det_pix, det, tilt = PROBLEMS[name]
    rng = np.random.default_rng(13)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=det,
                       det_pix=(det_pix, det_pix))
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-tilt, tilt, N_PROJ),
        beta=rng.uniform(-tilt, tilt, N_PROJ),
        t=rng.uniform(-1.5, 1.5, (N_PROJ, 3)) * [1, 1, tilt > 0])
    sino = rng.standard_normal((N_PROJ, jg.n_det))
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, sino


def _window(a, b, inv_b, lo_val, hi_val, ext, n):
    """The kernel's candidate window (``slab_plane.cu::window``): every i
    with a + b·i in [lo_val, hi_val), widened by the rounding slack,
    clamped to [0, n)."""
    if not abs(b) >= 1e-6:
        return 0, n - 1
    slack = ((2 * abs(a) + ext + abs(b) * n + abs(lo_val) + abs(hi_val) + 2)
             * 1e-6 * abs(inv_b))
    t0, t1 = (lo_val - a) * inv_b, (hi_val - a) * inv_b
    tl = min(max(min(t0, t1) - slack, -2.0), n + 1.0)
    th = max(min(max(t0, t1) + slack, n + 1.0), -2.0)
    return max(0, int(np.ceil(tl))), min(n - 1, int(np.floor(th)))


def _exact_candidates(width, reach, cap):
    """K2's count: K + 1 with K = floor(width) (at most cap), or cap + 1
    (the whole chunk) for a window beyond floor_small's range."""
    if not reach < POS_MAX:
        return cap + 1
    return min(int(np.floor(width)), cap) + 1


def _record(row, r, xa, xb, za, zb, nu, nv):
    """K2's view record (``slab_plane.cu::view_rec_f32``) for one tile."""
    p = {k: float(v) for k, v in tsp.params_from_scalars(row).items()}
    w = dict(cx=p["cxb"] + p["rx"] * r, cz=p["czb"] + p["rz"] * r,
             eux=p["eux"], evx=p["evx"], zav=float(row[tsp.S_ZAV]),
             gzx=p["gzx"], scale=float(row[tsp.S_SCALE]))
    w["inv_eux"], w["inv_zav"] = 1.0 / w["eux"], 1.0 / w["zav"]
    a0 = w["cz"] + w["gzx"] * (xa - w["cx"])
    a1 = w["cz"] + w["gzx"] * (xb - w["cx"])
    lo0, hi0 = _window(a0, w["zav"], w["inv_zav"], za - 1.0, zb + 1.0, 0.0,
                       nv)
    lo1, hi1 = _window(a1, w["zav"], w["inv_zav"], za - 1.0, zb + 1.0, 0.0,
                       nv)
    vlo, w["vhi"] = min(lo0, lo1), max(hi0, hi1)
    w["vs"] = vlo // VA * VA
    ext = abs(w["evx"]) * nv
    lo0, hi0 = _window(w["cx"] + w["evx"] * w["vs"], w["eux"], w["inv_eux"],
                       xa - 1.0, xb + 1.0, ext, nu)
    lo1, hi1 = _window(w["cx"] + w["evx"] * w["vhi"], w["eux"],
                       w["inv_eux"], xa - 1.0, xb + 1.0, ext, nu)
    w["ulo"], w["uhi"] = min(lo0, lo1), max(hi0, hi1)
    empty = vlo > w["vhi"] or w["ulo"] > w["uhi"]
    w["nvc"] = 0 if empty else (w["vhi"] - w["vs"]) // VC + 1
    w["nuc"] = 1 if empty else (w["uhi"] - w["ulo"]) // UC + 1
    iu, iv = abs(w["inv_eux"]), abs(w["inv_zav"])
    mu = abs(w["cx"]) + abs(w["eux"]) * nu + ext + max(abs(xa), abs(xb)) + 4
    w["su"] = 2e-6 * iu * mu
    wu = 2 * iu + 2 * w["su"]
    w["cu"] = _exact_candidates(wu, iu * mu + wu, UC)
    mv = (max(abs(a0), abs(a1)) + abs(w["zav"]) * nv + max(abs(za), abs(zb))
          + 12)
    w["sv"] = 2e-6 * iv * mv
    w["wv"] = 2 * iv + 2 * w["sv"]
    w["cv"] = _exact_candidates(w["wv"], iv * mv + w["wv"], VC)
    return w


def _weight(pos, tap):
    """K1's lerp weight that position pos gives tap: 1 − w for floor(pos)
    = tap, w for floor(pos) = tap − 1 (w = pos − floor(pos)), else 0."""
    f = np.floor(pos)
    w = pos - f
    return np.where(f == tap, 1.0 - w, np.where(f == tap - 1, w, 0.0))


def _extent(w, pos):
    """A chunk's rows [vc0, vc0 + nvw) and staged columns [uc0, uc0 +
    nst)."""
    _, vci, uci = pos
    vc0 = w["vs"] + vci * VC
    uc0 = w["ulo"] + uci * UC
    nst = min(max(min(w["uhi"] - uc0 + 1, UC), w["cu"]), UC)
    return vc0, min(w["vhi"] - vc0 + 1, VC), uc0, nst


def _gather_start(A, lo, hi, stats):
    """Each entry's first candidate, floor(A) + 1 clamped to [lo, hi]
    (``slab_plane.cu::first_candidate``)."""
    k = np.floor(A).astype(int) + 1
    first = np.clip(k, lo, hi)
    stats["clamped"] += int((first != k).sum())
    return first


def _tile(g, sc, r, xs, zs, nu, nv, stats):
    """One tile of slab r over the group's views: the chunk walker with its
    phases, ring, buffers, tables and carries → the tile's voxels."""
    V = len(sc)
    ring = [None] * (3 * B)

    def put(view):
        ring[(view // B) % 3 * B + view % B] = (view, _record(
            sc[view], float(r), float(xs[0]), float(xs[-1]), float(zs[0]),
            float(zs[-1]), nu, nv))

    def rec(view):
        held, w = ring[(view // B) % 3 * B + view % B]
        assert held == view, (held, view)
        return w

    def advance(pos):
        view, vci, uci = pos
        w = rec(view)
        if uci + 1 < w["nuc"]:
            return view, vci, uci + 1
        if vci + 1 < max(w["nvc"], 1):
            return view, vci + 1, 0
        return view + 1, 0, 0

    def stage(pos):
        w = rec(pos[0])
        if w["nvc"] == 0:
            return pos, None
        vc0, nvw, uc0, nst = _extent(w, pos)
        G = np.full((UC, VC), np.nan)       # slots nothing may read
        rows = np.arange(uc0, uc0 + nst)
        G[:nst, :nvw] = 0.0
        ok = rows < nu
        G[:nst][ok, :nvw] = g[pos[0]][rows[ok], vc0:vc0 + nvw]
        return pos, G

    for view in range(min(2 * B, V)):
        put(view)
    acc = np.zeros((xs.size, zs.size))
    carry = np.zeros((xs.size, VC))
    buf, tab = [None, None], [None, None]
    pa, pb, ps = (V, 0, 0), (0, 0, 0), (0, 0, 0)
    if V > 0:
        buf[0] = stage(pb)
        ps = advance(ps)
    k = 0
    while pb[0] < V or pa[0] < V:
        if ps[0] < V:
            buf[(k + 1) & 1] = stage(ps)
            # entering batch b >= 1: batch b + 1 into batch b - 2's slots
            if ps[0] % B == 0 and ps[0] > 0 and ps[1:] == (0, 0):
                for view in range(ps[0] + B, min(ps[0] + 2 * B, V)):
                    put(view)
        if pb[0] < V and rec(pb[0])["nvc"] > 0:
            held, G = buf[k & 1]
            assert held == pb, (held, pb)
            w = rec(pb[0])
            T = _pass_b(w, pb, G, xs, carry, stats)
            if T is not None:
                tab[k & 1] = ((pb[0], pb[1]), T)
        if pa[0] < V:
            w = rec(pa[0])
            if w["nvc"] > 0 and pa[2] == w["nuc"] - 1:
                held, T = tab[(k - 1) & 1]
                assert held == (pa[0], pa[1]), (held, pa)
                _pass_a(w, pa, T, xs, zs, acc, stats)
        pa, pb = pb, ps
        if ps[0] < V:
            ps = advance(ps)
        k += 1
    return acc


def _pass_b(w, pos, G, xs, carry, stats):
    """Pass B of one chunk over every entry (x, v): the sum goes to the
    carries, or after the v chunk's last u chunk, times scale, to a table
    (returned; rows past the chunk zero)."""
    vc0, nvw, uc0, nst = _extent(w, pos)
    first, last = pos[2] == 0, pos[2] == w["nuc"] - 1
    if w["nuc"] * w["nvc"] > 1:
        stats["multi_chunk"] += 1
    count = min(w["cu"], nst)
    stats["capped"] += int(w["cu"] > nst)
    x = xs[:, None].astype(float)                              # (tx, 1)
    v = (vc0 + np.arange(VC))[None, :].astype(float)          # (1, VC)
    row_in = np.arange(VC)[None, :] < nvw
    base = w["cx"] + w["evx"] * v
    lo = -1.0 if w["eux"] > 0 else 1.0
    A = (x + lo - base) * w["inv_eux"] - w["su"]
    u0 = _gather_start(A, uc0, uc0 + nst - count, stats)
    t = np.zeros(A.shape) if first else carry.copy()
    cols = np.broadcast_to(np.arange(VC)[None, :], A.shape)
    for i in range(count):
        u = u0 + i
        take = row_in
        pos_x = w["cx"] + w["eux"] * u + w["evx"] * v
        t += np.where(take, _weight(pos_x, x) * G[np.where(take, u - uc0, 0),
                                                  cols], 0.0)
    # every candidate of the chunk with a nonzero weight is gathered
    for u in range(uc0, uc0 + nst):
        hit = row_in & (_weight(w["cx"] + w["eux"] * u + w["evx"] * v, x)
                        != 0.0)
        stats["miss"] += int((hit & ((u < u0) | (u >= u0 + count))).sum())
    if not last:
        carry[:] = t
        return None
    return np.where(row_in, t * w["scale"], 0.0)


def _pass_a(w, pos, T, xs, zs, acc, stats):
    """Pass A of one chunk's table over every voxel (x, z), added into
    acc."""
    vc0, nvw, _, _ = _extent(w, pos)
    a = w["cz"] + w["gzx"] * (xs[:, None] - w["cx"])          # (tx, 1)
    z = zs[None, :].astype(float)                              # (1, tz)
    lo = -1.0 if w["zav"] > 0 else 1.0
    A = (z + lo - a) * w["inv_zav"] - w["sv"]
    if w["zav"] == 1.0 and w["cv"] == 3:
        v0, count = _pass_a_unit(w, vc0, T, a, A, zs, acc, stats)
    else:
        nvs = min(max(nvw, w["cv"]), VC)
        count = min(w["cv"], nvs)
        stats["capped"] += int(w["cv"] > nvs)
        v0 = _gather_start(A, vc0, vc0 + nvs - count, stats)
        rows = np.broadcast_to(np.arange(xs.size)[:, None], A.shape)
        for i in range(count):
            v = v0 + i
            acc += _weight(a + w["zav"] * v, z) * T[rows, v - vc0]
    for v in range(vc0, vc0 + nvw):
        hit = _weight(a + w["zav"] * v, z) != 0.0
        stats["miss"] += int((hit & ((v < v0) | (v >= v0 + count))).sum())


def _pass_a_unit(w, vc0, T, a, A, zs, acc, stats):
    """Pass A where zav = 1: each thread's run of ZR voxels (from the
    tile's first z) shares its rows; voxel j's candidates are the run's
    first voxel's shifted by j. Returns each voxel's first candidate and
    the count it took, (tx, tz), for the coverage count."""
    stats["unit"] += 1
    v0 = np.zeros(A.shape, int)
    count = np.zeros(A.shape, int)
    z = zs.astype(float)
    for g0 in range(0, zs.size, ZR):
        A0 = A[:, g0]                                         # (tx,)
        s0 = np.floor(A0).astype(int) + 1
        n = np.where(np.floor(A0 + w["wv"]) - np.floor(A0) > 2, 3, 2)
        stats["more"] += int((n == 3).sum())
        for m in range(3 + ZR - 1):
            v = s0 + m
            tv = np.where((v >= vc0) & (v < vc0 + VC),
                          T[np.arange(A0.size), np.clip(v - vc0, 0, VC - 1)],
                          0.0)
            for i in range(3):
                j = m - i
                if not 0 <= j < ZR or g0 + j >= zs.size:
                    continue
                take = i < n
                acc[:, g0 + j] += np.where(
                    take, _weight(a[:, 0] + w["zav"] * v, z[g0 + j]) * tv,
                    0.0)
        for j in range(min(ZR, zs.size - g0)):
            v0[:, g0 + j], count[:, g0 + j] = s0 + j, n
    return v0, count


def split_adjoint(g, sc, geom, stats):
    """K2's dataflow for one orientation group: ``g`` (V, nu, nv), ``sc``
    (V, NS) float64 → the oriented volume (nx, ny, nz)."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    g, sc = np.asarray(g), np.asarray(sc)
    vol = np.zeros((nx, ny, nz))
    for r in range(ny):
        for x0 in range(0, nx, TX):
            xs = np.arange(x0, min(x0 + TX, nx))
            for z0 in range(0, nz, TZ):
                zs = np.arange(z0, min(z0 + TZ, nz))
                vol[xs[0]:xs[-1] + 1, r, zs[0]:zs[-1] + 1] = _tile(
                    g, sc, r, xs, zs, nu, nv, stats)
    return vol


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


@pytest.fixture(scope="module", params=list(PROBLEMS))
def split(request):
    jg, jv, tg, tv, sino = _problem(request.param)
    stats = dict.fromkeys(("multi_chunk", "clamped", "capped", "unit",
                           "more", "miss"), 0)
    vol, pairs, flags = _split_backproject(sino, tg, tv, stats)
    return dict(jg=jg, jv=jv, sino=sino, vol=vol, pairs=pairs, flags=flags,
                stats=stats, name=request.param)


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
    stats = split["stats"]
    assert len(split["flags"]) == 4
    assert any(uf for _, _, uf in split["flags"])
    assert stats["multi_chunk"] > 0 and stats["clamped"] > 0
    # the pitch-0.3 problem's candidate counts reach their caps; without
    # tilts zav = 1, and pass A shares its candidates
    assert (stats["capped"] > 0) == (split["name"] == "pix0.3")
    assert (stats["unit"] > 0) == (split["name"] == "flat")
    assert (stats["more"] > 0) == (split["name"] == "flat")


def test_split_gathers_every_tap(split):
    """No entry or voxel leaves out a candidate of its chunk with a nonzero
    weight."""
    assert split["stats"]["miss"] == 0

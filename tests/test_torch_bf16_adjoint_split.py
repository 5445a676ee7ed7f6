"""The bf16 tier's adjoints K2b (plane) and K4b (arc), their dataflows
emulated in float64 on the CPU, against the port's plain versions and
tomojax's adjoint.

K2b (``slab_plane.cu::adj_bf16_kernel``) and K4b
(``slab_arc.cu::arc_adj_bf16_kernel``) run on the card only. Each
transpose is a gather: an entry or voxel sums ``hat(p − k)·value`` over a
fixed count of consecutive candidates that starts at the first integer
past its window's lower end (``floor(q) + 1``), clamped to the staged
chunk, where ``hat(d) = max(0, 1 − |d|)`` is the lerp weight (1 − w for
the floor's tap, w for the next, zero elsewhere). A candidate outside the
window adds zero, so the windows may be loose; a candidate that belongs
to another chunk reads a zero row or is clamped away, so no term is lost
or counted twice.

K2b: per slab r and (x, z) tile, each view's v window (from a multiple
of a few rows) is cut into v chunks and its u window into u chunks; pass
B gives T[x, v] = Σ_u hat(X(u, v) − x)·scale·g[u, v] (summed over a v
chunk's u chunks; scale·g is the plain vjp's cotangent), rounded once per
(x, v) where the plain version rounds the pass-B cotangent, and pass A
gives vol[x, r, z] += Σ_v hat(ζ(x, v) − z)·T[x, v]. Candidates:
ceil(2/|eux|) per entry, ceil(2/|zav|) per voxel.

K4b: per source slab r and (x, z) tile, each view's v window (the union
over its branches) is cut into v chunks, and the branches into rounds;
per entry (x, v) the grid sawtooth cf and ζ's affine part once, and over
ceil((2 + |edx|·n_branch)/|eux|) candidates u one march index jreal for
all branches, each branch's sample (j = ceil(jreal) + b, cfb, fy, the
mask, X) giving T_all += hat(X − x)·ok·g and T_fy += hat(X − x)·ok·fy·g;
the planes T_all − T_fy (side r) and T_fy (side r + 1) rounded once; then
each voxel gathers ceil((2 + |edz|·n_branch)/|zav|) rows v with
hat(ζ_b(x, v) − z), ζ_b = ζ_aff + edz·(cf + b). The emulation takes the
plain version's operation order for the samples (as the kernels do), so
it makes the same sample decisions.

This file runs those dataflows in float64 numpy with small tiles, chunks
and candidate counts, so that every volume edge and chunk boundary is
crossed. With the rounding off they are held to the plain vjp at 1e-12
relative; with the bf16 rounding at the kernels' points (g, and T) to
``slab_backproject_plain(prec="bf16")`` in float64, also at 1e-12: both
round the same float64 values at the same points (bf16's rounding flips
where two float64 sums differ by ~1e-16 of a bf16 step, which these
problems never reach), so any dropped or doubled term fails here; and
with the rounding on to tomojax's ``backproject_scalars`` at tomojax's
contract for the tier, 3e-3 of its operator. That operator is taken in
float64: tomojax's fp32 arc path itself sits 7.2e-3 from float64 on one
orientation group of the step-1 problem here (its fp32 march indices fall
on the other side of a ceil for some samples), so against fp32 the bar
would read tomojax's rounding, not the tier's. Geometries: K2b 17³ × 12 jittered views
over the full circle (every orientation group, u-flip included), detector
19 × 15, detector pitch 1 and 0.7; K4b 16³ × 12 views, detector 18 × 14,
march steps 1, 0.75 and 0.5 (2, 2 and 3 branches: two rounds of two).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core import geometry as jgeo
from tomojax.core import slab_projector as jsp

from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.kernels import slab as tslabk
from tomojax_torch.utils import interop

torch.set_num_threads(1)

TOL_SPLIT = 1e-12      # the emulation against the plain version, float64
TOL_CONTRACT = 3e-3    # the bf16 tier against tomojax's fp32 adjoint
N, DET, N_PROJ = 17, (19, 15), 12
PITCHES = [1.0, 0.7]
TX, TZ = 6, 7          # K2b's tile: small, so tiles end at the volume's edge
UC, VC, VA = 3, 4, 2   # u chunk, v chunk, v chunks start at multiples of VA
ARC_N, ARC_DET = 16, (18, 14)
STEPS = [1.0, 0.75, 0.5]
ATX, ATZ, AVC = 6, 7, 4  # K4b's tile and v chunk
AMAXB = 2              # branches a round


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).to(torch.float64).numpy()


def _plane_problem(det_pix):
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
    """K2's candidate window (``slab_plane.cu::window``): every i with
    a + b·i in [lo_val, hi_val), widened by the rounding slack, clamped
    to [0, n)."""
    if not abs(b) >= 1e-6:
        return 0, n - 1
    slack = ((2 * abs(a) + ext + abs(b) * n + abs(lo_val) + abs(hi_val) + 2)
             * 1e-6 * abs(inv_b))
    t0, t1 = (lo_val - a) * inv_b, (hi_val - a) * inv_b
    tl = min(max(min(t0, t1) - slack, -2.0), n + 1.0)
    th = max(min(max(t0, t1) + slack, n + 1.0), -2.0)
    return max(0, math.ceil(tl)), min(n - 1, math.floor(th))


def _hat(d):
    return np.maximum(0.0, 1.0 - np.abs(d))


def _first(q, lo, hi):
    """The first candidate: floor(q) + 1 clamped to [lo, hi]."""
    return np.clip(np.floor(q).astype(int) + 1, lo, hi)


def _candidates(inv_b, cap):
    return max(1, min(math.ceil(2.0 * abs(inv_b)), cap))


def _plane_rec(row, r, xa, xb, za, zb, nu, nv):
    """K2b's view record (``slab_plane.cu::view_rec``) for one tile."""
    p = {k: float(v) for k, v in tsp.params_from_scalars(row).items()}
    w = dict(cx=p["cxb"] + p["rx"] * r, cz=p["czb"] + p["rz"] * r,
             eux=p["eux"], evx=p["evx"], zav=float(row[tsp.S_ZAV]),
             gzx=p["gzx"], scale=float(row[tsp.S_SCALE]))
    w["inv_eux"], w["inv_zav"] = 1.0 / w["eux"], 1.0 / w["zav"]
    lo0, hi0 = _window(w["cz"] + w["gzx"] * (xa - w["cx"]), w["zav"],
                       w["inv_zav"], za - 1.0, zb + 1.0, 0.0, nv)
    lo1, hi1 = _window(w["cz"] + w["gzx"] * (xb - w["cx"]), w["zav"],
                       w["inv_zav"], za - 1.0, zb + 1.0, 0.0, nv)
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
    w["cu"] = _candidates(w["inv_eux"], UC)
    w["cv"] = _candidates(w["inv_zav"], VC)
    return w


def k2b_split(g, sc, geom, rnd, stats):
    """K2b's dataflow for one orientation group: ``g`` (V, nu, nv), ``sc``
    (V, NS) float64 → the oriented volume (nx, ny, nz); ``rnd`` rounds g
    and T (the identity, or bf16's). ``stats`` counts the chunks that
    were not a view's only one and the candidates the clamps moved."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    g = rnd(np.asarray(g))
    vol = np.zeros((nx, ny, nz))
    for r in range(ny):
        for x0 in range(0, nx, TX):
            xs = np.arange(x0, min(x0 + TX, nx))
            for z0 in range(0, nz, TZ):
                zs = np.arange(z0, min(z0 + TZ, nz))
                acc = np.zeros((xs.size, zs.size))
                for gv, row in zip(g, np.asarray(sc)):
                    w = _plane_rec(row, float(r), float(xs[0]),
                                   float(xs[-1]), float(zs[0]),
                                   float(zs[-1]), nu, nv)
                    for vci in range(w["nvc"]):
                        _plane_v_chunk(acc, gv, w, vci, xs, zs, nu, rnd,
                                       stats)
                vol[xs[0]:xs[-1] + 1, r, zs[0]:zs[-1] + 1] = acc
    return vol


def _plane_v_chunk(acc, gv, w, vci, xs, zs, nu, rnd, stats):
    vc0 = w["vs"] + vci * VC
    nvw = min(w["vhi"] - vc0 + 1, VC)
    if w["nvc"] * w["nuc"] > 1:
        stats["multi_chunk"] += 1
    v = vc0 + np.arange(nvw)[None, :]                          # (1, nvw)
    x = xs[:, None].astype(float)                              # (tx, 1)
    T = np.zeros((xs.size, VC))          # rows past nvw stay zero
    lo = -1.0 if w["eux"] > 0 else 1.0
    base = w["cx"] + w["evx"] * v
    for uci in range(w["nuc"]):
        # pass B over the staged rows [uc0, uc0 + nst): g, or zero past
        # the detector
        uc0 = w["ulo"] + uci * UC
        nst = min(max(min(w["uhi"] - uc0 + 1, UC), w["cu"]), UC)
        G = np.zeros((UC, VC))
        rows = np.arange(uc0, uc0 + nst)
        ok = rows < nu
        G[:nst][ok, :nvw] = gv[rows[ok], vc0:vc0 + nvw]
        cu = min(w["cu"], nst)
        q = (x + lo - base) * w["inv_eux"]
        u0 = _first(q, uc0, uc0 + nst - cu)
        stats["clamped"] += int((u0 != np.floor(q) + 1).sum())
        for i in range(cu):
            u = u0 + i
            X = base + w["eux"] * u
            T[:, :nvw] += _hat(X - x) * (w["scale"] * G[u - uc0,
                                                        np.arange(nvw)])
    T = rnd(T)
    # pass A over the rows [vc0, vc0 + nvs): T, zero past nvw
    nvs = min(max(nvw, w["cv"]), VC)
    cv = min(w["cv"], nvs)
    lo = -1.0 if w["zav"] > 0 else 1.0
    a = w["cz"] + w["gzx"] * (x - w["cx"])                     # (tx, 1)
    z = zs[None, :].astype(float)                              # (1, tz)
    q = (z + lo - a) * w["inv_zav"]
    v0 = _first(q, vc0, vc0 + nvs - cv)                        # (tx, tz)
    stats["clamped"] += int((v0 != np.floor(q) + 1).sum())
    cols = np.arange(xs.size)[:, None]
    for i in range(cv):
        vv = v0 + i
        acc += _hat(a + w["zav"] * vv - z) * T[cols, vv - vc0]


def _arc_problem(step):
    rng = np.random.default_rng(11)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(ARC_N,) * 3,
                       det_shape=ARC_DET, step_size=step)
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
    """K4's window (``slab_arc.cu::index_range``): every i with lo_val <
    a + b·i < hi_val, widened by one index on each side, in [0, n)."""
    if abs(b) < 1e-6:
        return 0, n - 1
    t0, t1 = (lo_val - a) / b, (hi_val - a) / b
    tl = min(max(min(t0, t1), -2.0), n + 1.0)
    th = min(max(max(t0, t1), -2.0), n + 1.0)
    return max(0, math.floor(tl) - 1), min(n - 1, math.ceil(th) + 1)


def k4b_split(g, sc, geom, rnd, stats):
    """K4b's dataflow for one orientation group: ``g`` (V, nu, nv), ``sc``
    (V, NS) float64 → the oriented volume (nx, ny, nz); ``rnd`` rounds g
    and the planes. ``stats`` counts the v chunks that were not a view's
    only one, the branch rounds past the first and the branch-1 samples
    taken."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    nb = tsp._n_branch(geom.step_size)
    g = rnd(np.asarray(g))
    vol = np.zeros((nx, ny + 1, nz))      # slab ny: side 1 of source ny-1
    for ri in range(-1, ny):
        for x0 in range(0, nx, ATX):
            xs = np.arange(x0, min(x0 + ATX, nx))
            for z0 in range(0, nz, ATZ):
                zs = np.arange(z0, min(z0 + ATZ, nz))
                acc = np.zeros((2, xs.size, zs.size))
                for gv, row in zip(g, np.asarray(sc)):
                    _arc_view(acc, gv, row, float(ri), xs, zs, nb, geom,
                              rnd, stats)
                if ri >= 0:
                    vol[xs[0]:xs[-1] + 1, ri, zs[0]:zs[-1] + 1] += acc[0]
                vol[xs[0]:xs[-1] + 1, ri + 1, zs[0]:zs[-1] + 1] += acc[1]
    return vol[:, :ny]


def _arc_view(acc, gv, row, r, xs, zs, nb, geom, rnd, stats):
    nu, nv = geom.det_shape
    p = {k: float(v) for k, v in tsp.params_from_scalars(row).items()}
    cx, cz = p["cxb"] + p["rx"] * r, p["czb"] + p["rz"] * r
    inv_eux = 1.0 / p["eux"]
    zav = p["evz"] - p["gzx"] * p["evx"]
    inv_zav = 1.0 / zav
    ezmax, ezmin = max(0.0, p["edz"] * nb), min(0.0, p["edz"] * nb)
    exmax, exmin = max(0.0, p["edx"] * nb), min(0.0, p["edx"] * nb)
    xa, xb, za, zb = (float(xs[0]), float(xs[-1]), float(zs[0]),
                      float(zs[-1]))
    lo0, hi0 = _index_range(cz + p["gzx"] * (xa - cx), zav,
                            za - 1.0 - ezmax, zb + 1.0 - ezmin, nv)
    lo1, hi1 = _index_range(cz + p["gzx"] * (xb - cx), zav,
                            za - 1.0 - ezmax, zb + 1.0 - ezmin, nv)
    vlo, vhi = min(lo0, lo1), max(hi0, hi1)
    cu = max(1, min(math.ceil((2.0 + exmax - exmin) * abs(inv_eux)), 64))
    cv = max(1, min(math.ceil((2.0 + ezmax - ezmin) * abs(inv_zav)), AVC))
    lo_x = -1.0 - exmax if p["eux"] > 0 else 1.0 - exmin
    lo_z = -1.0 - ezmax if zav > 0 else 1.0 - ezmin
    x = xs[:, None].astype(float)
    z = zs[None, :].astype(float)
    if vhi - vlo + 1 > AVC:
        stats["multi_chunk"] += 1
    for vc0 in range(vlo, vhi + 1, AVC):
        nvw = min(vhi - vc0 + 1, AVC)
        v = (vc0 + np.arange(nvw))[None, :].astype(float)     # (1, nvw)
        # the grid, as the plain version's affine inversion
        d = x - cx - v * p["evx"]
        jr = (r - (p["b1"] + d * inv_eux * p["euy"] + v * p["evy"])) / p[
            "edy"]
        cf = np.zeros((xs.size, AVC))
        zaff = np.zeros((xs.size, AVC))
        cf[:, :nvw] = np.ceil(jr) - jr
        zaff[:, :nvw] = cz + p["gzx"] * d + v * p["evz"]
        u0 = np.floor((x + lo_x - (cx + p["evx"] * v)) * inv_eux).astype(
            int) + 1                                           # (tx, nvw)
        for b0 in range(0, nb, AMAXB):
            if b0:
                stats["rounds"] += 1
            nbr = min(nb - b0, AMAXB)
            t_all = np.zeros((nbr, xs.size, AVC))
            t_fy = np.zeros((nbr, xs.size, AVC))
            for i in range(cu):
                u = u0 + i
                ok_u = (u >= 0) & (u < nu)
                uc = np.clip(u, 0, nu - 1).astype(float)
                vi = np.broadcast_to(v, u.shape).astype(int)
                gval = np.where(ok_u, gv[uc.astype(int), vi], 0.0)
                jreal = (r - (p["b1"] + uc * p["euy"] + v * p["evy"])) / p[
                    "edy"]
                for bb in range(nbr):
                    j = np.ceil(jreal) + (b0 + bb)
                    cfb = j - jreal
                    fy = p["edy"] * cfb
                    ok = (j >= 0) & (j < geom.n_steps) & (fy < 1.0)
                    if b0 + bb == 1:
                        stats["branch1"] += int((ok & ok_u).sum())
                    X = cx + uc * p["eux"] + v * p["evx"] + p["edx"] * cfb
                    w = _hat(X - x)
                    gw = np.where(ok, gval, 0.0)
                    t_all[bb, :, :nvw] += w * gw
                    t_fy[bb, :, :nvw] += w * (fy * gw)
            p0, p1 = rnd(t_all - t_fy), rnd(t_fy)
            nvs = min(max(nvw, cv), AVC)
            cvv = min(cv, nvs)
            zaf = cz + p["gzx"] * (x - cx)                     # (tx, 1)
            v0 = _first((z + lo_z - zaf) * inv_zav, vc0, vc0 + nvs - cvv)
            cols = np.arange(xs.size)[:, None]
            for i in range(cvv):
                k = v0 + i - vc0
                for bb in range(nbr):
                    zeta = zaff[cols, k] + p["edz"] * (cf[cols, k] + b0 + bb)
                    w = _hat(zeta - z)
                    acc[0] += w * p0[bb][cols, k]
                    acc[1] += w * p1[bb][cols, k]


def _split_backproject(split_fn, quad, sino, tg, tv, rnd, stats):
    """The multi-view adjoint through ``split_fn``, grouped and oriented
    as ``backproject_scalars``, with each group's (emulation, g, scalars)."""
    gstruct, scalars = tsp.scalar_groups(tg, tv, quad, dtype=torch.float64)
    nu, nv = tg.det_shape
    sino = torch.as_tensor(sino).reshape(-1, nu, nv)
    vol = torch.zeros(tg.vox_shape, dtype=torch.float64)
    groups = []
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        g = sino[list(idx)]
        if uf:
            g = g.flip(1)
        got = torch.as_tensor(split_fn(g.numpy(), sc.numpy(), tg, rnd,
                                       stats))
        groups.append((got, g, sc))
        vol += tsp.unorient_volume(got, sw, yf)
    return vol, groups, [s[1:] for s in gstruct]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=PITCHES, ids=lambda d: f"pix{d}")
def plane(request):
    jg, jv, tg, tv, sino = _plane_problem(request.param)
    out = dict(jg=jg, jv=jv, tg=tg, sino=sino)
    for name, rnd in (("exact", lambda a: a), ("bf16", _bf16)):
        stats = {"multi_chunk": 0, "clamped": 0}
        vol, groups, flags = _split_backproject(k2b_split, "plane", sino, tg,
                                                tv, rnd, stats)
        out[name] = dict(vol=vol, groups=groups, flags=flags, stats=stats)
    return out


def test_k2b_split_matches_plain_vjp_per_group(plane):
    for got, g, sc in plane["exact"]["groups"]:
        want = tsp.adjoint_oriented(g, sc, plane["tg"], "plane")
        assert _rel(got.numpy(), want.numpy()) < TOL_SPLIT


def test_k2b_split_with_bf16_rounding_matches_plain_bf16(plane):
    for got, g, sc in plane["bf16"]["groups"]:
        want = tslabk.slab_backproject_plain(g, sc, plane["tg"], "plane",
                                             prec="bf16")
        assert _rel(got.numpy(), want.numpy()) < TOL_SPLIT


def test_k2b_split_within_tomojax_contract(plane):
    gstruct, scalars = jsp.scalar_groups(plane["jg"], plane["jv"], "plane",
                                         jnp.float64)
    exact = jsp.backproject_scalars(jnp.asarray(plane["sino"]), plane["jg"],
                                    gstruct, scalars, quad="plane",
                                    dtype=jnp.float64)
    assert _rel(plane["exact"]["vol"].numpy(), np.asarray(exact)) < TOL_SPLIT
    rel = _rel(plane["bf16"]["vol"].numpy(), np.asarray(exact))
    assert 1e-6 <= rel <= TOL_CONTRACT, rel


def test_k2b_split_covers_every_group_chunks_and_clamps(plane):
    assert len(plane["exact"]["flags"]) == 4
    assert any(uf for _, _, uf in plane["exact"]["flags"])
    assert plane["exact"]["stats"]["multi_chunk"] > 0
    assert plane["exact"]["stats"]["clamped"] > 0


@pytest.fixture(scope="module", params=STEPS, ids=lambda s: f"step{s}")
def arc(request):
    jg, jv, tg, tv, sino = _arc_problem(request.param)
    out = dict(jg=jg, jv=jv, tg=tg, sino=sino)
    for name, rnd in (("exact", lambda a: a), ("bf16", _bf16)):
        stats = {"multi_chunk": 0, "rounds": 0, "branch1": 0}
        vol, groups, flags = _split_backproject(k4b_split, "arc", sino, tg,
                                                tv, rnd, stats)
        out[name] = dict(vol=vol, groups=groups, flags=flags, stats=stats)
    return out


def test_k4b_split_matches_plain_vjp_per_group(arc):
    for got, g, sc in arc["exact"]["groups"]:
        want = tsp.adjoint_oriented(g, sc, arc["tg"], "arc")
        assert _rel(got.numpy(), want.numpy()) < TOL_SPLIT


def test_k4b_split_with_bf16_rounding_matches_plain_bf16(arc):
    for got, g, sc in arc["bf16"]["groups"]:
        want = tslabk.slab_backproject_plain(g, sc, arc["tg"], "arc",
                                             prec="bf16")
        assert _rel(got.numpy(), want.numpy()) < TOL_SPLIT


def test_k4b_split_within_tomojax_contract(arc):
    gstruct, scalars = jsp.scalar_groups(arc["jg"], arc["jv"], "arc",
                                         jnp.float64)
    exact = jsp.backproject_scalars(jnp.asarray(arc["sino"]), arc["jg"],
                                    gstruct, scalars, quad="arc",
                                    dtype=jnp.float64)
    assert _rel(arc["exact"]["vol"].numpy(), np.asarray(exact)) < TOL_SPLIT
    rel = _rel(arc["bf16"]["vol"].numpy(), np.asarray(exact))
    assert 1e-6 <= rel <= TOL_CONTRACT, rel


def test_k4b_split_covers_groups_chunks_branches_and_rounds(arc):
    assert len(arc["exact"]["flags"]) >= 4
    stats = arc["exact"]["stats"]
    assert stats["multi_chunk"] > 0 and stats["branch1"] > 0
    assert (stats["rounds"] > 0) == (tsp._n_branch(arc["tg"].step_size)
                                     > AMAXB)

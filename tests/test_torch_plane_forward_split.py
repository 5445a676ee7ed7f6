"""The plane forward K1's dataflow, emulated in float64 on the CPU, against
the port's plain forward and tomojax's project_scalars.

K1 (``fwd_kernel`` in ``tomojax_torch/kernels/csrc/slab_plane.cu``) runs on
the card only. A CTA owns one view and a tile of detector (u, v) and marches
the slabs r = 0 .. ny-1. Per slab it bounds, from the tile's corners, T's
columns x (every x-tap of the tile's pixels: X = cx_r + eux*u + evx*v is
affine, so its extremes lie at the corners) and the rows z that pass A's
taps reach over those columns (zeta = cz_r + gzx*(x - cx_r) + zav*v), each
widened by a rounding slack (1e-3 + 4e-6 times the magnitudes of the
terms). The forward needs no inversion of a position, so no reciprocal:
the windows are the positions' own ranges. A slab whose window exceeds the
table or the ring runs the direct way (per sample, on global memory); one
that no tap of the tile reaches is skipped. Otherwise the slab's rows over
the window are staged into a ring of three slabs (zeros outside the
volume), two slabs ahead; pass A writes T[x, v], the z-lerp of the staged
row at zeta_r(x, v), once per (x, v) of the window into one of two tables;
pass B reads both x-taps of each pixel from the table. The windows of a
block of steps are computed ahead into slots that are refilled half a
block at a time.

This file runs that dataflow in float64 numpy, at the kernel's tile and
capacities and at a small tile with small capacities and window slots (so
every volume edge, every capacity and every refill is crossed, and some
slabs run direct). A tap that the tables or the staged rows would not hold
is counted as a miss; a ring slot, table or window slot read before it
holds the slab or step that the reader wants is counted as stale; a
skipped slab whose direct contribution is not exactly zero is counted. The
result must equal the port's plain forward (``forward_oriented``) and
tomojax's ``project_scalars`` (slab_plane) to 1e-12 relative with no miss
and nothing stale; a window one column too narrow is caught
(``test_narrowed_window_misses_taps``). Geometries: 17³ × 12 jittered views
over the full circle (every orientation group, u-flip included), detector
19 × 15, detector pitch 1 and 0.7. K1's float32 rounding is the card
tests' to check (``test_torch_cuda.py``).
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
# the kernel's tile, capacities and window slots (slab_plane.cu: kFU, kFV,
# kSX, kSZ, kWin), and a small set: windows beyond the table run direct
KERNEL = dict(tile=(32, 32), sx=56, sz=44, win=128, vec=False)
SMALL = dict(tile=(8, 8), sx=8, sz=10, win=8, vec=True)
RING = 3
EMPTY, DIRECT = -1, -2
POS_MAX = 2.0 ** 21


def _problem(det_pix):
    rng = np.random.default_rng(13)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=DET,
                       det_pix=(det_pix, det_pix))
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-1.5, 1.5, (N_PROJ, 3)))
    vol = rng.random((N,) * 3)
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, vol


def _tap_lo(lo, mag):
    return np.floor(lo - (1e-3 + 4e-6 * mag))


def _tap_hi(hi, mag):
    return np.floor(hi + (1e-3 + 4e-6 * mag)) + 1.0


def _lerp_z(zeta, nz, get):
    """The z-lerp of rows at zeta: taps floor(zeta), +1 weigh 1 - w, w;
    taps outside [0, nz) contribute zero. ``get(k)`` fetches tap k."""
    f = np.floor(zeta)
    k = f.astype(np.int64)
    w = zeta - f
    a = np.where((k >= 0) & (k < nz), get(k), 0.0)
    c = np.where((k + 1 >= 0) & (k + 1 < nz), get(k + 1), 0.0)
    return (1.0 - w) * a + w * c


class _March:
    """K1 over one orientation group: ``vol`` (nx, ny, nz), ``sc`` (V, NS)
    float64, every (view, u tile, v tile) at once on a leading batch
    axis."""

    def __init__(self, vol, sc, geom, cfg, stats, shrink=0):
        self.vol, self.cfg, self.stats = vol, cfg, stats
        self.shrink = shrink            # a mutation: T one column too narrow
        nu, nv = geom.det_shape
        TU, TV = cfg["tile"]
        ntu, ntv = -(-nu // TU), -(-nv // TV)
        V = sc.shape[0]
        bv, bu, bw = np.meshgrid(np.arange(V), np.arange(ntu),
                                 np.arange(ntv), indexing="ij")
        self.shape = (V, ntu, ntv)
        bv, self.u0, self.v0 = bv.ravel(), bu.ravel() * TU, bw.ravel() * TV
        row = np.asarray(sc)[bv]
        p = tsp.params_from_scalars(row)
        self.p = {k: p[k] for k in ("rx", "rz", "eux", "evx", "cxb", "czb",
                                    "gzx")}
        self.p["zav"] = row[:, tsp.S_ZAV]
        self.scale = row[:, tsp.S_SCALE]
        self.ub = np.minimum(self.u0 + TU, nu) - 1.0
        self.vb = np.minimum(self.v0 + TV, nv) - 1.0
        ul, vl = np.arange(TU)[:, None], np.arange(TV)[None, :]
        self.u, self.v = np.broadcast_arrays(
            (self.u0[:, None, None] + ul).astype(np.float64),
            (self.v0[:, None, None] + vl).astype(np.float64))
        self.pix = (self.u < nu) & (self.v < nv)
        self.lane_v = (self.v0[:, None, None]
                       + np.arange(TV)[None, None, :]).astype(np.float64)
        self.lane_in = self.lane_v < nv

    def col(self, name):
        return self.p[name][:, None, None]

    def window(self, ri):
        """step_window: (x0, x1, z0, z1) per batch item; z1 = EMPTY or
        DIRECT marks a step without windows."""
        nx, ny, nz = self.vol.shape
        n = len(self.u0)
        if ri >= ny:
            return np.tile([0, -1, 0, EMPTY], (n, 1))
        P = self.p
        cx, cz = P["cxb"] + P["rx"] * ri, P["czb"] + P["rz"] * ri
        xa, xb = P["eux"] * self.u0, P["eux"] * self.ub
        ya, yb = P["evx"] * self.v0, P["evx"] * self.vb
        mx = (np.abs(cx) + np.maximum(np.abs(xa), np.abs(xb))
              + np.maximum(np.abs(ya), np.abs(yb)))
        xl = _tap_lo(cx + np.minimum(xa, xb) + np.minimum(ya, yb), mx)
        xh = _tap_hi(cx + np.maximum(xa, xb) + np.maximum(ya, yb),
                     mx) - self.shrink
        ga, gb = P["gzx"] * (xl - cx), P["gzx"] * (xh - cx)
        za, zb = P["zav"] * self.v0, P["zav"] * self.vb
        mz = (np.abs(cz) + np.maximum(np.abs(ga), np.abs(gb))
              + np.maximum(np.abs(za), np.abs(zb))
              + np.abs(P["gzx"]) * (np.abs(cx)
                                    + np.maximum(np.abs(xl), np.abs(xh))))
        zl = _tap_lo(cz + np.minimum(ga, gb) + np.minimum(za, zb), mz)
        zh = _tap_hi(cz + np.maximum(ga, gb) + np.maximum(za, zb), mz)
        z0 = zl.astype(np.int64)
        if self.cfg["vec"]:
            z0 &= ~3
        w = np.stack([xl.astype(np.int64), xh.astype(np.int64), z0,
                      zh.astype(np.int64)], -1)
        far = ~((np.maximum(np.abs(xl), np.abs(xh)) < POS_MAX)
                & (np.maximum(np.abs(zl), np.abs(zh)) < POS_MAX))
        empty = (xh < 0) | (xl > nx - 1) | (zh < 0) | (zl > nz - 1)
        big = ((w[:, 1] - w[:, 0] >= self.cfg["sx"])
               | (w[:, 3] - w[:, 2] >= self.cfg["sz"]))
        w[empty & ~far] = (0, -1, 0, EMPTY)
        w[(far | big) & ~empty] = (0, -1, 0, DIRECT)
        return w

    def stage(self, s, w):
        """The ring slot's content for slab s: rows x in [w.x, w.x + sx),
        z in [w.z, w.z + sz), zeros outside the volume and outside the
        window (nothing reads there when the windows hold)."""
        nx, ny, nz = self.vol.shape
        sx, sz = self.cfg["sx"], self.cfg["sz"]
        if s >= ny:
            return np.zeros((len(w), sx, sz))
        xs = w[:, 0, None] + np.arange(sx)[None, :]
        zs = w[:, 2, None] + np.arange(sz)[None, :]
        inx = (xs >= 0) & (xs < nx) & (xs <= w[:, 1, None])
        inz = (zs >= 0) & (zs < nz) & (zs <= w[:, 3, None])
        vals = self.vol[np.clip(xs, 0, nx - 1)[:, :, None], s,
                        np.clip(zs, 0, nz - 1)[:, None, :]]
        fast = w[:, 3] >= 0
        return np.where(fast[:, None, None] & inx[:, :, None]
                        & inz[:, None, :], vals, 0.0)

    def pass_a(self, s, w, buf):
        """T[x - w.x][lane] for T's columns (sx of them; columns past w.y
        unused); a tap outside the staged rows of an active lane is a
        miss."""
        nx, _, nz = self.vol.shape
        sx, sz = self.cfg["sx"], self.cfg["sz"]
        P = self.p
        cx = (P["cxb"] + P["rx"] * s)[:, None, None]
        cz = (P["czb"] + P["rz"] * s)[:, None, None]
        xq = (w[:, 0, None, None] + np.arange(sx)[None, :, None]).astype(
            np.float64)
        zeta = cz + self.col("gzx") * (xq - cx) + self.col("zav") * self.lane_v
        act = ((w[:, 3] >= 0)[:, None, None]
               & (np.arange(sx)[None, :, None]
                  <= (w[:, 1] - w[:, 0])[:, None, None]) & self.lane_in)
        bi = np.arange(len(w))[:, None, None]
        xl = np.arange(sx)[None, :, None]

        def get(k):
            kl = k - w[:, 2, None, None]
            inside = (kl >= 0) & (k <= w[:, 3, None, None])
            self.stats["miss"] += int((act & ~inside).sum())
            return buf[bi, xl, np.clip(kl, 0, sz - 1)]

        f = np.floor(zeta)
        k = f.astype(np.int64)
        wz = zeta - f
        # the staged rows carry the zeros outside the volume: no tap test
        T = (1.0 - wz) * get(k) + wz * get(k + 1)
        self.stats["pass_a"] += int(act.sum())
        return np.where(act, T, 0.0)

    def direct(self, ri, on):
        """The one-thread-per-ray code for slab ri where ``on`` (batch)."""
        nx, ny, nz = self.vol.shape
        c = self.col
        cx, cz = c("cxb") + c("rx") * ri, c("czb") + c("rz") * ri
        X = cx + c("eux") * self.u + c("evx") * self.v
        x0 = np.floor(X)
        wx = X - x0
        out = np.zeros(self.u.shape)
        for o in (0, 1):
            xi = x0.astype(np.int64) + o
            ok = (xi >= 0) & (xi < nx) & self.pix & on[:, None, None]
            zeta = cz + c("gzx") * (xi - cx) + c("zav") * self.v
            xc = np.clip(xi, 0, nx - 1)
            val = _lerp_z(zeta, nz,
                          lambda k: self.vol[xc, ri, np.clip(k, 0, nz - 1)])
            out += np.where(ok, (wx if o else 1.0 - wx) * val, 0.0)
        return out

    def run(self):
        """→ (V, nu, nv)."""
        nx, ny, nz = self.vol.shape
        n = len(self.u0)
        nwin, half = self.cfg["win"], self.cfg["win"] // 2
        c = self.col
        st = self.stats
        # window slots (step held, window), the ring (slab held, rows) and
        # the two tables (step held, values)
        win = [(s, self.window(s)) for s in range(nwin)]

        def read_win(s):
            held, w = win[s % nwin]
            if held != s:
                st["stale"] += 1
            return w

        ring = [(-1, None)] * RING
        tabs = [(-1, None), (-1, None)]

        def stage(s):
            ring[s % RING] = (s, self.stage(s, read_win(s)))

        def a_step(s, w):
            held, buf = ring[s % RING]
            if held != s:
                st["stale"] += 1
            tabs[s & 1] = (s, self.pass_a(s, w, buf))

        # the kernel's order: windows, the first kRing slabs, pass A of
        # slab 0; then per iteration r the window of r + 1, slab r + kRing
        # into the slot of slab r, pass A of r + 1, pass B of r (with the
        # window read the iteration before), and every half block of
        # steps the windows of the next half block
        for s in range(RING):
            stage(s)
        w_a = read_win(0)
        if ny > 0:
            a_step(0, w_a)
        acc = np.zeros(self.u.shape)
        bi = np.arange(n)[:, None, None]
        lane = np.arange(self.cfg["tile"][1])[None, None, :]
        for ri in range(ny):
            w, w_a = w_a, read_win(ri + 1)
            stage(ri + RING)
            if ri + 1 < ny:
                a_step(ri + 1, w_a)
            fast, dirc = w[:, 3] >= 0, w[:, 3] == DIRECT
            empty = w[:, 3] == EMPTY
            # a skipped slab must lose nothing
            st["empty_abs"] = max(st["empty_abs"], float(
                np.abs(self.direct(ri, empty)).max(initial=0.0)))
            st["direct"] += int(dirc.sum())
            st["fast"] += int(fast.sum())
            acc += self.direct(ri, dirc)
            held, T = tabs[ri & 1]
            if held != ri:
                st["stale"] += 1
            cx = c("cxb") + c("rx") * ri
            X = cx + c("eux") * self.u + c("evx") * self.v
            f = np.floor(X)
            wx = X - f
            on = fast[:, None, None] & self.pix
            nq = (w[:, 1] - w[:, 0] + 1)[:, None, None]
            vals = []
            for o in (0, 1):
                xl = f.astype(np.int64) + o - w[:, 0, None, None]
                st["miss"] += int((on & ((xl < 0) | (xl >= nq))).sum())
                vals.append(T[bi, np.clip(xl, 0, self.cfg["sx"] - 1), lane])
            acc += np.where(on, (1.0 - wx) * vals[0] + wx * vals[1], 0.0)
            if ri % half == 0 and ri > 0:
                for s in range(ri + half, ri + nwin):
                    win[s % nwin] = (s, self.window(s))
        out = acc * self.scale[:, None, None]
        V, ntu, ntv = self.shape
        TU, TV = self.cfg["tile"]
        out = out.reshape(V, ntu, ntv, TU, TV).transpose(0, 1, 3, 2, 4)
        return out.reshape(V, ntu * TU, ntv * TV)


def _new_stats():
    return dict(miss=0, stale=0, empty_abs=0.0, direct=0, fast=0, pass_a=0)


def _emulate(tg, tv, vol, cfg, shrink=0):
    """Per orientation group: (gstruct entry, emulated (V, nu, nv), plain
    (V, nu, nv)); and the stats."""
    stats = _new_stats()
    gstruct, scalars = tsp.scalar_groups(tg, tv, "plane", dtype=torch.float64)
    nu, nv = tg.det_shape
    v = torch.as_tensor(vol)
    out = []
    for g, sc in zip(gstruct, scalars):
        vol_or = tsp.orient_volume(v, tg, g[1], g[2]).contiguous()
        got = _March(vol_or.numpy(), sc.numpy(), tg, cfg, stats,
                     shrink).run()[:, :nu, :nv]
        out.append((g, got, tsp.forward_oriented(vol_or, sc, tg).numpy()))
    return out, stats


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module",
                params=[(1.0, "kernel"), (0.7, "kernel"), (1.0, "small"),
                        (0.7, "small")],
                ids=lambda p: f"pix{p[0]}-{p[1]}")
def case(request):
    det_pix, tile = request.param
    jg, jv, tg, tv, vol = _problem(det_pix)
    groups, stats = _emulate(tg, tv, vol, KERNEL if tile == "kernel"
                             else SMALL)
    return dict(jg=jg, jv=jv, tg=tg, vol=vol, groups=groups, stats=stats,
                small=tile == "small")


def test_split_matches_plain_forward_per_group(case):
    for _, got, want in case["groups"]:
        assert _rel(got, want) < 1e-12


def test_split_matches_tomojax_project_scalars(case):
    jg, tg = case["jg"], case["tg"]
    nu, nv = tg.det_shape
    sino = np.zeros((tg.n_proj, nu, nv))
    for (idx, _, _, uf), got, _ in case["groups"]:
        sino[list(idx)] = got[:, ::-1] if uf else got
    gstruct, scalars = jsp.scalar_groups(jg, case["jv"], "plane",
                                         jnp.float64)
    want = jsp.project_scalars(jnp.asarray(case["vol"]), jg, gstruct,
                               scalars, quad="plane", dtype=jnp.float64)
    assert _rel(sino.reshape(tg.n_proj, -1), np.asarray(want)) < 1e-12


def test_split_windows_hold_every_tap_and_nothing_is_stale(case):
    s = case["stats"]
    assert s["miss"] == 0
    assert s["stale"] == 0
    assert s["empty_abs"] == 0.0
    assert len(case["groups"]) == 4
    assert any(uf for (_, _, _, uf), _, _ in case["groups"])
    assert s["fast"] > 0 and s["pass_a"] > 0
    # small capacities send some slabs the direct way; the kernel's hold
    # every window at this size
    assert (s["direct"] > 0) == case["small"]


def test_narrowed_window_misses_taps():
    """A mutated x window one column too narrow at the top: taps fall
    outside the tables, and the miss count shows it."""
    _, _, tg, tv, vol = _problem(1.0)
    _, stats = _emulate(tg, tv, vol, KERNEL, shrink=1)
    assert stats["miss"] > 0

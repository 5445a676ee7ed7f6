"""The bf16 tier's forwards K1b (plane) and K3b (arc), their dataflows
emulated in float64 on the CPU, against the port's plain versions and
tomojax's project_scalars.

K1b (``slab_plane.cu::fwd_bf16_kernel``) and K3b
(``slab_arc.cu::arc_fwd_bf16_kernel``) run on the card only. A CTA owns one
view and a tile of detector (u, v) and marches the slabs.

K1b takes one slab a barrier: between two barriers it issues the copies
of slab r + 2 into ring slot r & 1, runs pass A for slab r + 1 into one
table and pass B for slab r from the other. Its windows are K1's (from the
tile's corners, widened by a rounding slack; z aligned down to a 16-byte
copy of 8 values), kept in slots that are refilled half at a time. A table holds pair
words: word c = (T[c], T[c + 1]) in bf16, so pass B reads both taps of a
pixel in one load. Pass A is K1's, warp-strided (column c = warp + warps
i): each column rounds T[c] once and stores it twice, as the low half of
word c and the high half of word c - 1. A slab whose windows exceed the
capacities runs the direct way (per sample, rows and T rounded as the
tables hold them); one that no tap reaches is skipped.

K3b marches the source slabs r = -1 .. ny-1 with K3's windows, staged
windows, branch skips, step order and samples. Its tables (per branch
b < 2) hold per (x, v) the pair (h0, h1) of the side slabs' z-lerps,
rounded to bf16, in column x - x0 + 1; columns 0, nq + 1 and nq + 2 hold
zeros, and pass B clamps X into [x0 - 1, x1 + 1], so a sample whose taps
leave the window reads zeros (its taps lie outside the volume) without a
test. The windows of a chunk of steps are computed at its start. A step
beyond the capacities, or a march with a third branch, runs the direct
way.

This file runs both dataflows in float64 numpy, at the kernels' tiles and
capacities and at small ones (every capacity, window refill, run boundary
and volume edge is crossed, and some slabs run direct). A tap that the
tables or staged rows would not hold, a table half that no warp wrote for
its slab, and a ring slot, table or window slot read before it holds what
its reader wants (or in the iteration that refills it) are counted. With
the rounding off the result is held to the plain version at 1e-12
relative; with the bf16 rounding at the kernels' points (the volume's rows,
T or h0/h1) to ``slab_project_plain(prec="bf16")`` in float64, also at
1e-12 (both round the same float64 values at the same points; the
positions' order differs from the plain version's by ~1e-16, far from a
bf16 rounding boundary at these sizes); and to tomojax's fp32
``project_scalars`` within the tier's 3e-3, and at least 1e-6 from it (the
rounding happened). A window one column too narrow is caught. Geometries:
17³ × 12 jittered views over the full circle (every orientation group,
u-flip included), detector 19 × 15, detector pitch 1 and 0.7; K3b also at
march step 0.5 (three branches: every step direct).
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
from tomojax_torch.kernels import slab as tslabk
from tomojax_torch.utils import interop

torch.set_num_threads(1)

TOL_SPLIT = 1e-12      # the emulation against the plain version, float64
TOL_CONTRACT = 3e-3    # the bf16 tier against tomojax's fp32 forward
N, DET, N_PROJ = 17, (19, 15), 12
EMPTY, DIRECT = -1, -2
POS_MAX = 2.0 ** 21
# K1b: the kernel's tile, capacities, window slots and warps (slab_plane.cu:
# kFU, kFV, kSX, kHSZ, kWin, kFwdWarps), and a small set (direct slabs,
# refills, three warps)
K1B_KERNEL = dict(tile=(32, 32), sx=56, sz=48, win=128, warps=8)
K1B_SMALL = dict(tile=(8, 8), sx=8, sz=16, win=12, warps=3)
# K3b: the kernel's tile and capacities (slab_arc.cu: kFU, kFV, kSX, kSZ of
# bf16, kQX, kChunk), and a small set whose tables some windows exceed
K3B_KERNEL = dict(tile=(32, 32), sx=52, sz=48, qx=52, chunk=64)
K3B_SMALL = dict(tile=(8, 8), sx=52, sz=48, qx=12, chunk=3)


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).to(torch.float64).numpy()


def _exact(a):
    return np.asarray(a, np.float64)


def _problem(det_pix, step=1.0):
    rng = np.random.default_rng(13)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=DET,
                       det_pix=(det_pix, det_pix), step_size=step)
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-1.5, 1.5, (N_PROJ, 3)), dtype=jnp.float64)
    vol = rng.random((N,) * 3) + 0.25
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, vol


def _new_stats():
    return dict(miss=0, stale=0, unwritten=0, empty_abs=0.0, skipped_abs=0.0,
                direct=0, fast=0, pass_a=0, clamped=0, branch1=0)


class _Tiles:
    """Every (view, u tile, v tile) of a group on a leading batch axis."""

    def __init__(self, sc, geom, tile):
        nu, nv = geom.det_shape
        TU, TV = tile
        ntu, ntv = -(-nu // TU), -(-nv // TV)
        V = sc.shape[0]
        bv, bu, bw = np.meshgrid(np.arange(V), np.arange(ntu),
                                 np.arange(ntv), indexing="ij")
        self.shape = (V, ntu, ntv)
        self.bv, self.u0, self.v0 = bv.ravel(), bu.ravel() * TU, bw.ravel() * TV
        self.row = np.asarray(sc)[self.bv]
        self.p = {k: np.asarray(v, np.float64)
                  for k, v in tsp.params_from_scalars(self.row).items()}
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
        self.tile = tile

    def col(self, name):
        return self.p[name][:, None, None]

    def untile(self, acc, geom):
        nu, nv = geom.det_shape
        V, ntu, ntv = self.shape
        TU, TV = self.tile
        out = acc.reshape(V, ntu, ntv, TU, TV).transpose(0, 1, 3, 2, 4)
        return out.reshape(V, ntu * TU, ntv * TV)[:, :nu, :nv]


# ---- K1b --------------------------------------------------------------


def _tap_lo_plane(lo, mag):
    return np.floor(lo - (1e-3 + 4e-6 * mag))


def _tap_hi_plane(hi, mag):
    return np.floor(hi + (1e-3 + 4e-6 * mag)) + 1.0


class _K1b:
    """K1b over one orientation group: rows ``vol`` (already rounded by
    ``rnd``) and scalars ``sc`` float64."""

    def __init__(self, vol, sc, geom, cfg, rnd, stats, shrink=0):
        self.vol, self.geom, self.cfg, self.rnd = vol, geom, cfg, rnd
        self.stats, self.shrink = stats, shrink
        self.t = _Tiles(sc, geom, cfg["tile"])
        self.zav = self.t.row[:, tsp.S_ZAV]
        self.scale = self.t.row[:, tsp.S_SCALE]

    def window(self, ri):
        """step_window<kHSZ, 8>: (x0, x1, z0, z1) per batch item; z1 =
        EMPTY or DIRECT marks a step without windows."""
        nx, ny, nz = self.vol.shape
        t, P, sz = self.t, self.t.p, self.cfg["sz"]
        n = len(t.u0)
        if ri >= ny:
            return np.tile([0, -1, 0, EMPTY], (n, 1))
        cx, cz = P["cxb"] + P["rx"] * ri, P["czb"] + P["rz"] * ri
        xa, xb = P["eux"] * t.u0, P["eux"] * t.ub
        ya, yb = P["evx"] * t.v0, P["evx"] * t.vb
        mx = (np.abs(cx) + np.maximum(np.abs(xa), np.abs(xb))
              + np.maximum(np.abs(ya), np.abs(yb)))
        xl = _tap_lo_plane(cx + np.minimum(xa, xb) + np.minimum(ya, yb), mx)
        xh = _tap_hi_plane(cx + np.maximum(xa, xb) + np.maximum(ya, yb),
                           mx) - self.shrink
        ga, gb = P["gzx"] * (xl - cx), P["gzx"] * (xh - cx)
        za, zb = self.zav * t.v0, self.zav * t.vb
        mz = (np.abs(cz) + np.maximum(np.abs(ga), np.abs(gb))
              + np.maximum(np.abs(za), np.abs(zb))
              + np.abs(P["gzx"]) * (np.abs(cx)
                                    + np.maximum(np.abs(xl), np.abs(xh))))
        zl = _tap_lo_plane(cz + np.minimum(ga, gb) + np.minimum(za, zb), mz)
        zh = _tap_hi_plane(cz + np.maximum(ga, gb) + np.maximum(za, zb), mz)
        w = np.stack([xl.astype(np.int64), xh.astype(np.int64),
                      zl.astype(np.int64) & ~7, zh.astype(np.int64)], -1)
        far = ~((np.maximum(np.abs(xl), np.abs(xh)) < POS_MAX)
                & (np.maximum(np.abs(zl), np.abs(zh)) < POS_MAX))
        empty = (xh < 0) | (xl > nx - 1) | (zh < 0) | (zl > nz - 1)
        big = ((w[:, 1] - w[:, 0] >= self.cfg["sx"])
               | (w[:, 3] - w[:, 2] >= sz))
        w[empty & ~far] = (0, -1, 0, EMPTY)
        w[(far | big) & ~empty] = (0, -1, 0, DIRECT)
        return w

    def stage(self, s, w):
        """The ring slot's rows for slab s: x in [w.x, w.x + sx), z in
        [w.z, w.z + sz), zeros outside the volume and the window."""
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
        on = (w[:, 3] >= 0)[:, None, None] & inx[:, :, None] & inz[:, None, :]
        return np.where(on, vals, 0.0)

    def zc(self, s):
        """zeta(x, v) = gzx*x + zc: the lane's constant of slab s."""
        P, t = self.t.p, self.t
        cx, cz = P["cxb"] + P["rx"] * s, P["czb"] + P["rz"] * s
        return ((cz - P["gzx"] * cx)[:, None, None]
                + t.lane_v * self.zav[:, None, None])

    def pass_a(self, s, w, buf):
        """The pair table of slab s: (lo, hi, written_lo, written_hi), each
        (batch, sx, lanes), written column by column in the kernel's
        warp-strided order: T[c] as the low half of word c and, but for
        warp 0's first column, the high half of word c - 1."""
        sx, sz, nwarps = self.cfg["sx"], self.cfg["sz"], self.cfg["warps"]
        t = self.t
        n_b, TV = len(w), self.cfg["tile"][1]
        lo, hi = np.zeros((n_b, sx, TV)), np.zeros((n_b, sx, TV))
        wlo = np.zeros((n_b, sx, TV), bool)
        whi = np.zeros((n_b, sx, TV), bool)
        fast = (w[:, 3] >= 0)
        nq = w[:, 1] - w[:, 0] + 1
        zc = self.zc(s)
        gzx = t.col("gzx")
        bi = np.arange(n_b)[:, None]
        lane = np.arange(TV)[None, :]
        act_lane = t.lane_in[:, 0, :]                      # (batch, lanes)

        def put(arr, wr, on, col, val):
            cl = np.clip(col, 0, sx - 1)[:, None]
            arr[bi, cl, lane] = np.where(on, val, arr[bi, cl, lane])
            wr[bi, cl, lane] |= on

        for wp in range(nwarps):
            for i in range(-(-sx // nwarps)):
                c = np.full(n_b, wp + nwarps * i)
                act = (fast & (c < nq))[:, None] & act_lane
                x = (w[:, 0] + c).astype(np.float64)[:, None]
                zeta = gzx[:, :, 0] * x + zc[:, 0, :]      # (batch, lanes)
                f = np.floor(zeta)
                k = f.astype(np.int64) - w[:, 2, None]
                wz = zeta - f
                inside = (k >= 0) & (k + 1 <= (w[:, 3] - w[:, 2])[:, None])
                self.stats["miss"] += int((act & ~inside).sum())
                cc = np.clip(c, 0, sx - 1)[:, None]
                a = buf[bi, cc, np.clip(k, 0, sz - 1)]
                b = buf[bi, cc, np.clip(k + 1, 0, sz - 1)]
                T = self.rnd(a + wz * (b - a))
                self.stats["pass_a"] += int(act.sum())
                put(lo, wlo, act, c, T)
                put(hi, whi, act & (i > 0 or wp > 0), c - 1, T)
        return lo, hi, wlo, whi

    def direct(self, ri, on):
        """Per sample on the rows (rounded), T rounded, where ``on``."""
        nx, ny, nz = self.vol.shape
        t, c = self.t, self.t.col
        cx = c("cxb") + c("rx") * ri
        X = (cx + c("evx") * t.v) + c("eux") * t.u
        x0 = np.floor(X)
        wx = X - x0
        zc = self.zc(ri)
        out = np.zeros(t.u.shape)
        for o in (0, 1):
            xi = x0.astype(np.int64) + o
            ok = (xi >= 0) & (xi < nx) & t.pix & on[:, None, None]
            zeta = c("gzx") * xi + zc
            zf = np.floor(zeta)
            k = zf.astype(np.int64)
            xc = np.clip(xi, 0, nx - 1)
            a = np.where((k >= 0) & (k < nz),
                         self.vol[xc, ri, np.clip(k, 0, nz - 1)], 0.0)
            b = np.where((k + 1 >= 0) & (k + 1 < nz),
                         self.vol[xc, ri, np.clip(k + 1, 0, nz - 1)], 0.0)
            T = self.rnd(a + (zeta - zf) * (b - a))
            out += np.where(ok, (wx if o else 1.0 - wx) * T, 0.0)
        return out

    def run(self):
        nx, ny, nz = self.vol.shape
        cfg, st, t = self.cfg, self.stats, self.t
        nwin = cfg["win"]
        half = nwin // 2
        bi = np.arange(len(t.u0))[:, None, None]
        lane = np.arange(cfg["tile"][1])[None, None, :]
        # (step held, window, the iteration that refilled the slot)
        win = [(s, self.window(s), -2) for s in range(nwin)]
        it = [-1]                       # the iteration now running

        def read_win(s):
            held, w, refilled = win[s % nwin]
            if held != s or refilled == it[0]:
                st["stale"] += 1
            return w

        # ring slot and table r & 1 of slab r: (slab held, contents)
        ring = [(-1, None)] * 2
        tabs = [(-1, None)] * 2

        def stage(s):
            ring[s & 1] = (s, self.stage(s, read_win(s)))

        def pass_a(s):
            w = read_win(s)
            held, buf = ring[s & 1]
            if held != s:
                st["stale"] += 1
            tabs[s & 1] = (s, self.pass_a(s, w, buf))

        stage(0)
        stage(1)
        pass_a(0)
        acc = np.zeros(t.u.shape)
        c = t.col
        for ri in range(ny):
            it[0] = ri
            if ri % half == 0 and ri > 0:
                for s in range(ri + half, ri + nwin):
                    win[s % nwin] = (s, self.window(s), ri)
            stage(ri + 2)
            pass_a(ri + 1)
            w = read_win(ri)
            fast, dirc = w[:, 3] >= 0, w[:, 3] == DIRECT
            empty = w[:, 3] == EMPTY
            st["empty_abs"] = max(st["empty_abs"], float(
                np.abs(self.direct(ri, empty)).max(initial=0.0)))
            st["direct"] += int(dirc.sum())
            st["fast"] += int(fast.sum())
            acc += self.direct(ri, dirc)
            held, tab = tabs[ri & 1]
            if held != ri:
                st["stale"] += 1
            lo, hi, wlo, whi = tab
            cx = c("cxb") + c("rx") * ri
            X = (cx + c("evx") * t.v) + c("eux") * t.u
            f = np.floor(X)
            wx = X - f
            on = fast[:, None, None] & t.pix
            word = f.astype(np.int64) - w[:, 0, None, None]
            nw = (w[:, 1] - w[:, 0])[:, None, None]
            st["miss"] += int((on & ((word < 0) | (word >= nw))).sum())
            wc = np.clip(word, 0, cfg["sx"] - 1)
            st["unwritten"] += int((on & ~(wlo[bi, wc, lane]
                                           & whi[bi, wc, lane])).sum())
            acc += np.where(on, (1.0 - wx) * lo[bi, wc, lane]
                            + wx * hi[bi, wc, lane], 0.0)
        return t.untile(acc * self.scale[:, None, None], self.geom)


# ---- K3b --------------------------------------------------------------


def _tap_lo_arc(lo):
    return np.floor(lo - (1e-3 + 1e-5 * np.abs(lo)))


def _tap_hi_arc(hi):
    return np.floor(hi + (1e-3 + 1e-5 * np.abs(hi))) + 1.0


def _lerp(a, c, w):
    """The plain version's lerp, (1 - w) a + w c."""
    return (1.0 - w) * a + w * c


class _K3b:
    """K3b over one orientation group: rows ``vol`` (already rounded by
    ``rnd``) and scalars ``sc`` float64."""

    def __init__(self, vol, sc, geom, cfg, rnd, stats, shrink=0):
        self.vol, self.geom, self.cfg, self.rnd = vol, geom, cfg, rnd
        self.stats, self.shrink = stats, shrink
        t = self.t = _Tiles(sc, geom, cfg["tile"])
        self.nb = tsp._n_branch(geom.step_size)
        P = t.p
        zav = P["evz"] - P["gzx"] * P["evx"]

        def span(*pairs):
            return (sum(np.minimum(a, b) for a, b in pairs),
                    sum(np.maximum(a, b) for a, b in pairs))

        zero = np.zeros_like(t.ub)
        self.xlo, self.xhi = span((t.u0 * P["eux"], t.ub * P["eux"]),
                                  (t.v0 * P["evx"], t.vb * P["evx"]),
                                  (zero, P["edx"] * self.nb))
        self.zlo, self.zhi = span((t.v0 * zav, t.vb * zav),
                                  (zero, P["edz"] * self.nb))
        ylo, yhi = span((t.u0 * P["euy"], t.ub * P["euy"]),
                        (t.v0 * P["evy"], t.vb * P["evy"]))
        self.ylo, self.yhi = P["b1"] + ylo, P["b1"] + yhi

    def step_window(self, ri):
        nx, ny, nz = self.vol.shape
        P = self.t.p
        n = len(self.t.u0)
        if ri < -1 or ri >= ny:
            return np.tile([0, -1, 0, -1], (n, 1))
        cx, cz = P["cxb"] + P["rx"] * ri, P["czb"] + P["rz"] * ri
        xl = _tap_lo_arc(cx + self.xlo)
        xh = _tap_hi_arc(cx + self.xhi) - self.shrink
        x0, x1 = np.maximum(0, xl), np.minimum(nx - 1, xh)
        ga, gb = P["gzx"] * (x0 - cx), P["gzx"] * (x1 - cx)
        zl = _tap_lo_arc(cz + np.minimum(ga, gb) + self.zlo)
        zh = _tap_hi_arc(cz + np.maximum(ga, gb) + self.zhi)
        z0, z1 = np.maximum(0, zl), np.minimum(nz - 1, zh)
        empty = (xh < 0) | (xl > nx - 1) | (zh < 0) | (zl > nz - 1)
        w = np.stack([x0, x1, z0, z1], -1).astype(np.int64)
        w[empty] = (0, -1, 0, -1)
        return w

    def stage_window(self, s):
        """Slab s's staged window: the union of steps s - 1 and s, z
        aligned down to 8, clamped to the ring's capacity."""
        n = len(self.t.u0)
        if s < 0 or s >= self.vol.shape[1]:
            return np.tile([0, -1, 0, -1], (n, 1))
        a, b = self.step_window(s - 1), self.step_window(s)
        ea, eb = a[:, 0] > a[:, 1], b[:, 0] > b[:, 1]
        w = np.stack([np.minimum(a[:, 0], b[:, 0]),
                      np.maximum(a[:, 1], b[:, 1]),
                      np.minimum(a[:, 2], b[:, 2]),
                      np.maximum(a[:, 3], b[:, 3])], -1)
        w = np.where(ea[:, None], b, np.where(eb[:, None], a, w))
        w[:, 2] &= ~7
        w[:, 1] = np.minimum(w[:, 1], w[:, 0] + self.cfg["sx"] - 1)
        w[:, 3] = np.minimum(w[:, 3], w[:, 2] + self.cfg["sz"] - 1)
        w[w[:, 0] > w[:, 1]] = (0, -1, 0, -1)
        return w

    def live(self, ri, w):
        P = self.t.p
        jlo = (ri - self.yhi) / P["edy"]
        jhi = (ri - self.ylo) / P["edy"]
        m = 1e-3 + 1e-5 * np.maximum(np.abs(jlo), np.abs(jhi))
        clo, chi = np.ceil(jlo - m), np.ceil(jhi + m)
        cf_min = np.where(clo == chi, chi - (jhi + m), 0.0)
        out = []
        for b in range(self.nb):
            ok = ~((chi + b < 0) | (clo + b >= self.geom.n_steps))
            out.append(ok & (P["edy"] * (b + cf_min) < 1.0001))
        return np.stack(out, -1) & (w[:, :1] <= w[:, 1:2])

    def entry(self, e):
        """Entry e: step e - 1's window, live branches and fast flag, and
        slab e's staged window."""
        ny = self.vol.shape[1]
        rs = e - 1
        w = self.step_window(rs)

        def holds(st):
            return ((st[:, 0] <= w[:, 0]) & (w[:, 1] <= st[:, 1])
                    & (st[:, 2] <= w[:, 2]) & (w[:, 3] <= st[:, 3]))

        fast = ((w[:, 1] - w[:, 0] < self.cfg["qx"]) & (self.nb <= 2)
                & ((rs < 0) | holds(self.stage_window(rs)))
                & ((rs + 1 >= ny) | holds(self.stage_window(rs + 1))))
        return dict(w=w, live=self.live(rs, w), fast=fast,
                    stage=self.stage_window(e))

    def grid(self, ri, x, v):
        c = self.t.col
        cx, cz = c("cxb") + c("rx") * ri, c("czb") + c("rz") * ri
        d = x - cx - v * c("evx")
        jr = (ri - (c("b1") + d * (1.0 / c("eux")) * c("euy")
                    + v * c("evy"))) / c("edy")
        return np.ceil(jr) - jr, cz + c("gzx") * d + v * c("evz")

    def stage(self, s, st):
        """Slab s's staged rows over window st (zeros elsewhere)."""
        nx, ny, nz = self.vol.shape
        sx, sz = self.cfg["sx"], self.cfg["sz"]
        xs = st[:, 0, None] + np.arange(sx)[None, :]
        zs = st[:, 2, None] + np.arange(sz)[None, :]
        inx = xs <= st[:, 1, None]
        inz = (zs <= st[:, 3, None]) & (zs < nz)
        vals = self.vol[np.clip(xs, 0, nx - 1)[:, :, None], s,
                        np.clip(zs, 0, nz - 1)[:, None, :]]
        return st, np.where(inx[:, :, None] & inz[:, None, :], vals, 0.0)

    def side(self, staged, x, zeta, act):
        """The rounded-rows z-lerp of a staged side at zeta (column x); an
        active read of a volume tap outside the staged window is a miss."""
        nz = self.vol.shape[2]
        if staged is None:
            return np.zeros(zeta.shape)
        st, buf = staged
        sx, sz = self.cfg["sx"], self.cfg["sz"]
        f = np.floor(zeta)
        k = f.astype(np.int64)
        w = zeta - f
        xl = np.clip(x - st[:, 0, None, None], 0, sx - 1)
        bi = np.arange(len(st))[:, None, None]

        def fetch(kk):
            inv = (kk >= 0) & (kk < nz)
            inw = ((x >= st[:, 0, None, None]) & (x <= st[:, 1, None, None])
                   & (kk >= st[:, 2, None, None])
                   & (kk <= st[:, 3, None, None]))
            self.stats["miss"] += int((act & inv & ~inw).sum())
            zl = np.clip(kk - st[:, 2, None, None], 0, sz - 1)
            return np.where(inv, buf[bi, xl, zl], 0.0)

        return _lerp(fetch(k), fetch(k + 1), w)

    def direct_side(self, s, x, zeta):
        nx, ny, nz = self.vol.shape
        if s < 0 or s >= ny:
            return np.zeros(zeta.shape)
        f = np.floor(zeta)
        k = f.astype(np.int64)
        xc = np.clip(x, 0, nx - 1)

        def fetch(kk):
            return np.where((kk >= 0) & (kk < nz),
                            self.vol[xc, s, np.clip(kk, 0, nz - 1)], 0.0)

        return self.rnd(_lerp(fetch(k), fetch(k + 1), zeta - f))

    def run(self):
        nx, ny, nz = self.vol.shape
        cfg, stt, t, c = self.cfg, self.stats, self.t, self.t.col
        chunk = cfg["chunk"]
        TV = cfg["tile"][1]
        bi = np.arange(len(t.u0))[:, None, None]
        lane = np.arange(TV)[None, None, :]
        # a chunk's window slots: (entry held, its values), (slab held,
        # its staged window)
        c_step = [(-2, None)] * chunk
        c_stage = [(-2, None)] * chunk

        def ent(e):
            held, d = c_step[e % chunk]
            if held != e:
                stt["stale"] += 1
            return d

        def stage_win(s):
            held, st = c_stage[s % chunk]
            if held != s:
                stt["stale"] += 1
            return st

        # the ring: slab s in slot (s + 1) % 3
        ring = [(-2, None)] * 3

        def stage(s, st):
            if 0 <= s < ny:
                ring[(s + 1) % 3] = (s, self.stage(s, st))

        def staged(s):
            if s < 0 or s >= ny:
                return None
            held, data = ring[(s + 1) % 3]
            if held != s:
                stt["stale"] += 1
            return data

        stage(0, self.stage_window(0))
        acc = np.zeros(t.u.shape)
        for ri in range(-1, ny):
            if (ri + 1) % chunk == 0:
                for i in range(chunk):
                    e = ri + 1 + i
                    c_step[e % chunk] = (e, self.entry(e))
                    c_stage[(ri + 2 + i) % chunk] = (
                        ri + 2 + i, self.stage_window(ri + 2 + i))
            stage(ri + 2, stage_win(ri + 2))
            d = ent(ri + 1)
            w, live, fast = d["w"], d["live"], d["fast"]
            nq = w[:, 1] - w[:, 0] + 1
            # pass A into the tables (fast steps)
            qx = cfg["qx"]
            xl = np.arange(qx)[None, :, None]
            xq = w[:, 0, None, None] + xl
            act = ((live.any(-1) & fast)[:, None, None]
                   & (xl < nq[:, None, None]) & t.lane_in)
            cf, za = self.grid(ri, xq.astype(np.float64), t.lane_v)
            s0, s1 = staged(ri), staged(ri + 1)
            tab = np.zeros((2, len(w), qx + 3, TV, 2))
            for b in range(min(self.nb, 2)):
                zeta = za + c("edz") * (cf + b)
                on = act & live[:, b, None, None]
                h0 = self.rnd(self.side(s0, xq, zeta, on))
                h1 = self.rnd(self.side(s1, xq, zeta, on))
                val = np.stack([h0, h1], -1)
                tab[b, :, 1:qx + 1] = np.where(on[..., None], val, 0.0)
            stt["pass_a"] += int(act.sum())
            stt["fast"] += int((live.any(-1) & fast).sum())
            stt["direct"] += int((live.any(-1) & ~fast).sum())
            # pass B
            cx = c("cxb") + c("rx") * ri
            jreal = (ri - (c("b1") + t.u * c("euy")
                           + t.v * c("evy"))) / c("edy")
            for b in range(self.nb):
                j = np.ceil(jreal) + b
                cfb = j - jreal
                fy = c("edy") * cfb
                ok = ((j >= 0) & (j < self.geom.n_steps) & (fy < 1.0)
                      & t.pix)
                X = cx + t.u * c("eux") + t.v * c("evx") + c("edx") * cfb
                on = live[:, b, None, None]
                if b == 1:
                    stt["branch1"] += int((ok & on).sum())
                tabled = fast[:, None, None] & on & ok
                # the direct way, for every sample (kept where not tabled;
                # a skipped branch must contribute nothing)
                xf = np.floor(X)
                wx = X - xf
                dval = np.zeros(t.u.shape)
                for o in (0, 1):
                    xi = xf.astype(np.int64) + o
                    inv = (xi >= 0) & (xi < nx)
                    # a volume tap of a fast sample outside the window
                    stt["miss"] += int((tabled & inv & (
                        (xi < w[:, 0, None, None])
                        | (xi > w[:, 1, None, None]))).sum())
                    cfg_, za_ = self.grid(ri, xi.astype(np.float64), t.v)
                    zeta = za_ + c("edz") * (cfg_ + b)
                    h0 = self.direct_side(ri, xi, zeta)
                    h1 = self.direct_side(ri + 1, xi, zeta)
                    dval += np.where(inv, (wx if o else 1.0 - wx)
                                     * ((1.0 - fy) * h0 + fy * h1), 0.0)
                skipped = np.where(~on & ok, dval, 0.0)
                stt["skipped_abs"] = max(stt["skipped_abs"],
                                         float(np.abs(skipped).max()))
                acc += np.where(on & ok & ~fast[:, None, None], dval, 0.0)
                if b >= 2:
                    continue
                # the tables: X clamped into [x0 - 1, x1 + 1], slots k - x0
                # + 1 and + 2 (zero columns 0, nq + 1, nq + 2)
                lo_x = (w[:, 0] - 1.0)[:, None, None]
                hi_x = (w[:, 1] + 1.0)[:, None, None]
                Xc = np.clip(X, lo_x, hi_x)
                stt["clamped"] += int((tabled & (Xc != X)).sum())
                kc = np.floor(Xc)
                wxc = Xc - kc
                sl = kc.astype(np.int64) - w[:, 0, None, None] + 1
                # only T's columns and the zero columns may be read
                stt["miss"] += int((tabled & ((sl < 0) | (
                    sl + 1 > nq[:, None, None] + 2))).sum())
                slc = np.clip(sl, 0, qx + 1)
                t0 = tab[b][bi, slc, lane]
                t1 = tab[b][bi, slc + 1, lane]
                val = ((1.0 - wxc) * ((1.0 - fy) * t0[..., 0]
                                      + fy * t0[..., 1])
                       + wxc * ((1.0 - fy) * t1[..., 0] + fy * t1[..., 1]))
                acc += np.where(tabled, val, 0.0)
        return t.untile(acc, self.geom)


# ---- the cases ----------------------------------------------------------


def _emulate(kind, tg, tv, vol, cfg, rnd, shrink=0):
    """Per orientation group: (gstruct entry, emulated (V, nu, nv), oriented
    volume, scalars); and the stats."""
    stats = _new_stats()
    quad = "plane" if kind == "k1b" else "arc"
    gstruct, scalars = tsp.scalar_groups(tg, tv, quad, dtype=torch.float64)
    v = torch.as_tensor(vol)
    cls = _K1b if kind == "k1b" else _K3b
    out = []
    for g, sc in zip(gstruct, scalars):
        vol_or = tsp.orient_volume(v, tg, g[1], g[2]).contiguous()
        got = cls(rnd(vol_or.numpy()), sc.numpy(), tg, cfg, rnd, stats,
                  shrink).run()
        out.append((g, got, vol_or, sc))
    return out, stats


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _sinogram(groups, tg):
    nu, nv = tg.det_shape
    sino = np.zeros((tg.n_proj, nu, nv))
    for (idx, _, _, uf), got, _, _ in groups:
        sino[list(idx)] = got[:, ::-1] if uf else got
    return sino.reshape(tg.n_proj, -1)


CASES = {
    "k1b-pix1-kernel": ("k1b", 1.0, 1.0, K1B_KERNEL),
    "k1b-pix0.7-kernel": ("k1b", 0.7, 1.0, K1B_KERNEL),
    "k1b-pix1-small": ("k1b", 1.0, 1.0, K1B_SMALL),
    "k1b-pix0.7-small": ("k1b", 0.7, 1.0, K1B_SMALL),
    "k3b-pix1-kernel": ("k3b", 1.0, 1.0, K3B_KERNEL),
    "k3b-pix0.7-kernel": ("k3b", 0.7, 1.0, K3B_KERNEL),
    "k3b-step0.5-kernel": ("k3b", 1.0, 0.5, K3B_KERNEL),
    "k3b-pix1-small": ("k3b", 1.0, 1.0, K3B_SMALL),
}


# tomojax's fp32 forward compiles per geometry: the contract is read on the
# kernels' configurations, one per geometry but the detector pitch 0.7 arc
CONTRACT = ["k1b-pix1-kernel", "k1b-pix0.7-kernel", "k3b-pix1-kernel",
            "k3b-step0.5-kernel"]
_CASES = {}


def _case(key):
    if key not in _CASES:
        kind, det_pix, step, cfg = CASES[key]
        jg, jv, tg, tv, vol = _problem(det_pix, step)
        out = dict(kind=kind, quad="plane" if kind == "k1b" else "arc",
                   jg=jg, jv=jv, tg=tg, vol=vol, small=cfg["tile"][0] < 32,
                   step=step)
        for name, rnd in (("exact", _exact), ("bf16", _bf16)):
            groups, stats = _emulate(kind, tg, tv, vol, cfg, rnd)
            out[name] = dict(groups=groups, stats=stats)
        _CASES[key] = out
    return _CASES[key]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(request.param)


def test_split_matches_plain_per_group(case):
    for _, got, vol_or, sc in case["exact"]["groups"]:
        want = tsp.forward_oriented(vol_or, sc, case["tg"], case["quad"])
        assert _rel(got, want.numpy()) < TOL_SPLIT


def test_split_with_bf16_rounding_matches_plain_bf16(case):
    for _, got, vol_or, sc in case["bf16"]["groups"]:
        want = tslabk.slab_project_plain(vol_or, sc, case["tg"], case["quad"],
                                         prec="bf16")
        assert _rel(got, want.numpy()) < TOL_SPLIT


@pytest.mark.parametrize("key", CONTRACT)
def test_split_within_tomojax_contract(key):
    """The bf16 emulation against tomojax's fp32 forward: within the tier's
    3e-3 and at least 1e-6 from it (the exact one equals the port's plain
    forward, which the slab tests hold to tomojax's)."""
    case = _case(key)
    jg, tg = case["jg"], case["tg"]
    gstruct, sc32 = jsp.scalar_groups(jg, case["jv"], case["quad"],
                                      jnp.float32)
    want32 = jsp.project_scalars(jnp.asarray(case["vol"], jnp.float32), jg,
                                 gstruct, sc32, quad=case["quad"],
                                 dtype=jnp.float32)
    rel = _rel(_sinogram(case["bf16"]["groups"], tg),
               np.asarray(want32, np.float64))
    assert 1e-6 <= rel <= TOL_CONTRACT, rel


def test_split_windows_hold_every_tap_and_nothing_is_stale(case):
    for name in ("exact", "bf16"):
        s = case[name]["stats"]
        assert s["miss"] == 0, s
        assert s["stale"] == 0, s
        assert s["unwritten"] == 0, s
        assert s["empty_abs"] == 0.0 and s["skipped_abs"] == 0.0, s
    s = case["exact"]["stats"]
    assert len(case["exact"]["groups"]) == 4
    assert any(uf for (_, _, _, uf), *_ in case["exact"]["groups"])
    tables = case["step"] == 1.0
    assert (s["fast"] > 0) == tables and (s["pass_a"] > 0) == tables
    if case["kind"] == "k1b":
        # the small capacities send some slabs the direct way; the kernel's
        # hold every window at this size
        assert (s["direct"] > 0) == case["small"]
    else:
        assert s["branch1"] > 0
        assert (s["direct"] > 0) == (case["small"] or not tables)
        if tables:
            assert s["clamped"] > 0


@pytest.mark.parametrize("kind", ["k1b", "k3b"])
def test_narrowed_window_misses_taps(kind):
    """A mutated x window one column too narrow at the top: taps fall
    outside the tables or staged rows, and the miss count shows it."""
    _, _, tg, tv, vol = _problem(1.0)
    cfg = K1B_SMALL if kind == "k1b" else K3B_SMALL
    _, stats = _emulate(kind, tg, tv, vol, cfg, _bf16, shrink=1)
    assert stats["miss"] > 0

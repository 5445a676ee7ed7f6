"""The arc forward K3 and the fused Jacobian K5 as the card runs them,
emulated in float64 on the CPU, against the port's plain passes and
tomojax.

K3 and K5 (``arc_march_kernel`` in ``tomojax_torch/kernels/csrc/
slab_arc.cu``) run on the card only. A CTA owns one view and a tile of
detector (u, v) and marches the source slabs r = -1 .. ny-1. Per slab it
bounds, from the tile's corners, the x window and the z window that the
tile's samples can reach, and skips a branch b for the whole tile where
the corner interval of the march index proves that no sample passes the
mask (or the whole slab where no branch is live or a window is empty). It
stages the rows of slabs r and r + 1 over the union of the two steps'
windows that read each slab, runs pass A once per (x, v) of the window
(the grid sawtooth, and for branches 0 and 1 the z-lerps of both sides
and their derivatives into tables), and pass B per (u, v): one march
index for all branches, the sample mask and X per live branch, and both
x-taps from the tables. A step whose windows exceed the tables or the
staged rows, or a march with a third branch, runs pass B the direct way
per sample.

This file runs that dataflow in float64 numpy, at the kernel's tile and
capacities and at a smaller tile (more tiles, windows and skips per view):
the windows from the corners, the staged rows and tables, the skips and
the direct steps. A tap that a table step would need outside its staged
rows or tables (the kernel would drop or misread it) is counted as a
miss, and every sample that a skip passes over is evaluated the direct
way and must contribute exactly zero. The results must equal the port's plain
passes (``forward_oriented``, ``jac_passes_oriented``) and tomojax's
``project_scalars`` and ``forward_view_jac`` to 1e-10 relative, with no
miss: a window one column too narrow is caught
(``test_narrowed_window_misses_taps``). Geometries: 24³ with a 26 × 22
detector, 16 jittered views over the full circle (every orientation group)
plus views within 0.01 rad of an axis (edy near 1, where the tile skip of
branch 1 fires), march steps 1 and 0.5 (2 and 3 branches: the latter all
direct; branch 1 carries samples wherever edy < 1; slab -1 carries side
r + 1).
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
from tomojax_torch.core.geometry import Views
from tomojax_torch.utils import interop

torch.set_num_threads(1)

N, DET = 24, (26, 22)
# the kernel's tile and capacities (slab_arc.cu: kFU, kFV, kSX, kSZ, kQX)
KERNEL = dict(tile=(32, 32), sx=52, sz=44, qx=52)
# more tiles, and tables narrower than some windows: those steps run direct
SMALL = dict(tile=(8, 8), sx=52, sz=44, qx=12)
PHI = np.concatenate([0.3 + np.linspace(0, 2 * np.pi, 12, endpoint=False),
                      [0.004, np.pi / 2 + 0.003, np.pi - 0.002,
                       1.5 * np.pi + 0.001]])


def _problem(step):
    n_proj = PHI.size
    rng = np.random.default_rng(7)
    jg = jgeo.Geometry(n_proj=n_proj, vox_shape=(N,) * 3, det_shape=DET,
                       step_size=step)
    jv = jgeo.Views.create(n_proj, phi=PHI,
                           alpha=rng.uniform(-0.01, 0.01, n_proj),
                           beta=rng.uniform(-0.01, 0.01, n_proj),
                           t=rng.uniform(-1.5, 1.5, (n_proj, 3)),
                           dtype=jnp.float64)
    vol = rng.random((N,) * 3) + 0.5
    tg = interop.geometry(dataclasses.asdict(jg))
    tv = interop.views(jax.tree.map(np.asarray, jv))
    return jg, jv, tg, tv, vol


def _taps(pos, fetch, n):
    """Lerp and d/dpos of ``pos`` over a row of n values: tap floor(pos)
    weighs 1 - w, the next w, taps outside [0, n) zero (``taps_of``)."""
    f = np.floor(pos)
    k = f.astype(np.int64)
    w = pos - f
    a = np.where((k >= 0) & (k < n), fetch(k), 0.0)
    c = np.where((k + 1 >= 0) & (k + 1 < n), fetch(k + 1), 0.0)
    return (1.0 - w) * a + w * c, c - a


def _tap_lo(lo):
    """The lowest tap of positions >= lo, less a slack for rounding."""
    return np.floor(lo - (1e-3 + 1e-5 * np.abs(lo)))


def _tap_hi(hi):
    """The highest tap (floor + 1) of positions <= hi, plus the slack."""
    return np.floor(hi + (1e-3 + 1e-5 * np.abs(hi))) + 1.0


class _March:
    """The kernel's march over one orientation group: ``vol`` (nx, ny, nz)
    and ``sc`` (V, NS) float64, every (view, u tile, v tile) at once on a
    leading batch axis."""

    def __init__(self, vol, sc, geom, cfg, stats, shrink=0):
        self.vol, self.geom, self.cfg, self.stats = vol, geom, cfg, stats
        self.shrink = shrink            # a mutation: windows too narrow
        nx, ny, nz = vol.shape
        nu, nv = geom.det_shape
        TU, TV = cfg["tile"]
        ntu, ntv = -(-nu // TU), -(-nv // TV)
        V = sc.shape[0]
        # batch axis: (view, u tile, v tile), flattened
        bv, bu, bw = np.meshgrid(np.arange(V), np.arange(ntu),
                                 np.arange(ntv), indexing="ij")
        bv, self.u0, self.v0 = bv.ravel(), bu.ravel() * TU, bw.ravel() * TV
        p = tsp.params_from_scalars(np.asarray(sc))
        self.p = {k: np.asarray(val, np.float64)[bv] for k, val in p.items()}
        self.nb = tsp._n_branch(geom.step_size)
        ub = np.minimum(self.u0 + TU, nu) - 1.0
        vb = np.minimum(self.v0 + TV, nv) - 1.0
        P = self.p
        zav = P["evz"] - P["gzx"] * P["evx"]

        def span(*pairs):
            lo = sum(np.minimum(a, b) for a, b in pairs)
            hi = sum(np.maximum(a, b) for a, b in pairs)
            return lo, hi

        zero = np.zeros_like(ub)
        self.xlo, self.xhi = span((self.u0 * P["eux"], ub * P["eux"]),
                                  (self.v0 * P["evx"], vb * P["evx"]),
                                  (zero, P["edx"] * self.nb))
        self.zlo, self.zhi = span((self.v0 * zav, vb * zav),
                                  (zero, P["edz"] * self.nb))
        ylo, yhi = span((self.u0 * P["euy"], ub * P["euy"]),
                        (self.v0 * P["evy"], vb * P["evy"]))
        self.ylo, self.yhi = P["b1"] + ylo, P["b1"] + yhi
        # pixels (batch, TU, TV) and table lanes
        ul, vl = np.arange(TU)[:, None], np.arange(TV)[None, :]
        self.u, self.v = np.broadcast_arrays(
            (self.u0[:, None, None] + ul).astype(np.float64),
            (self.v0[:, None, None] + vl).astype(np.float64))
        self.pix = (self.u < nu) & (self.v < nv)
        self.lane_v = (self.v0[:, None, None]
                       + np.arange(TV)[None, None, :]).astype(np.float64)

    def col(self, name):
        return self.p[name][:, None, None]

    def step_window(self, ri):
        """(x0, x1, z0, z1) per batch item, empty where x0 > x1."""
        nx, _, nz = self.vol.shape
        P = self.p
        cx, cz = P["cxb"] + P["rx"] * ri, P["czb"] + P["rz"] * ri
        xl = _tap_lo(cx + self.xlo)
        xh = _tap_hi(cx + self.xhi) - self.shrink
        x0, x1 = np.maximum(0, xl), np.minimum(nx - 1, xh)
        ga, gb = P["gzx"] * (x0 - cx), P["gzx"] * (x1 - cx)
        zl = _tap_lo(cz + np.minimum(ga, gb) + self.zlo)
        zh = _tap_hi(cz + np.maximum(ga, gb) + self.zhi)
        z0, z1 = np.maximum(0, zl), np.minimum(nz - 1, zh)
        empty = (xh < 0) | (xl > nx - 1) | (zh < 0) | (zl > nz - 1)
        w = np.stack([x0, x1, z0, z1], -1).astype(np.int64)
        w[empty] = (0, -1, 0, -1)
        return w

    def stage_window(self, a, b):
        """Union of two steps' windows, z aligned down to 4, clamped to
        the ring's capacity."""
        ea, eb = a[:, 0] > a[:, 1], b[:, 0] > b[:, 1]
        w = np.stack([np.minimum(a[:, 0], b[:, 0]),
                      np.maximum(a[:, 1], b[:, 1]),
                      np.minimum(a[:, 2], b[:, 2]),
                      np.maximum(a[:, 3], b[:, 3])], -1)
        w = np.where(ea[:, None], b, np.where(eb[:, None], a, w))
        w[:, 2] &= ~3
        w[:, 1] = np.minimum(w[:, 1], w[:, 0] + self.cfg["sx"] - 1)
        w[:, 3] = np.minimum(w[:, 3], w[:, 2] + self.cfg["sz"] - 1)
        w[w[:, 0] > w[:, 1]] = (0, -1, 0, -1)
        return w

    def live(self, ri, w):
        """(batch, n_branch): branch b can hold a valid sample in the
        tile (``branch_live``)."""
        P = self.p
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

    def side(self, s, w, x, zeta, active):
        """z-lerp and derivative of rows (x, s) at zeta; a read by an
        ``active`` lane outside the step's window ``w`` (None: a direct
        read) counts as a miss."""
        nx, ny, nz = self.vol.shape
        if s < 0 or s >= ny:
            return np.zeros(zeta.shape), np.zeros(zeta.shape)
        xc = np.clip(x, 0, nx - 1)

        def fetch(k):
            if w is not None:
                inw = ((x >= w[:, 0, None, None]) & (x <= w[:, 1, None, None])
                       & (k >= w[:, 2, None, None])
                       & (k <= w[:, 3, None, None]))
                read = active & (k >= 0) & (k < nz)
                self.stats["miss"] += int((read & ~inw).sum())
            return self.vol[xc, s, np.clip(k, 0, nz - 1)]

        return _taps(zeta, fetch, nz)

    def grid(self, ri, x, v):
        """grid_at: the grid sawtooth cf and ζ's affine part at (x, v)."""
        c = self.col
        cx, cz = c("cxb") + c("rx") * ri, c("czb") + c("rz") * ri
        d = x - cx - v * c("evx")
        jr = (ri - (c("b1") + d * (1.0 / c("eux")) * c("euy")
                    + v * c("evy"))) / c("edy")
        return np.ceil(jr) - jr, cz + c("gzx") * d + v * c("evz")

    def run(self):
        """→ (V, 12, nu, nv): the 12 building blocks, JAC_PASSES order."""
        nx, ny, nz = self.vol.shape
        nu, nv = self.geom.det_shape
        c = self.col
        TU, TV = self.cfg["tile"]
        acc = np.zeros((12,) + self.u.shape)
        empty = np.array([[0, -1, 0, -1]] * len(self.u0))
        w_r, w_r1 = self.step_window(-1), self.step_window(0)
        st_r, st_r1 = empty, self.stage_window(w_r, w_r1)
        bi = np.arange(len(self.u0))[:, None, None]
        lane = np.arange(TV)[None, None, :]
        for ri in range(-1, ny):
            w_r2 = self.step_window(ri + 2) if ri + 2 < ny else empty
            st_r2 = self.stage_window(w_r1, w_r2) if ri + 2 < ny else empty
            live = self.live(ri, w_r)
            # branches >= 1 skipped by the interval test (window not empty)
            self.stats["branch_skips"] += int(
                (~live[:, 1:] & live[:, :1]).sum())
            nq = w_r[:, 1] - w_r[:, 0] + 1

            def holds(st):
                return ((st[:, 0] <= w_r[:, 0]) & (w_r[:, 1] <= st[:, 1])
                        & (st[:, 2] <= w_r[:, 2]) & (w_r[:, 3] <= st[:, 3]))

            fast = ((nq <= self.cfg["qx"]) & (self.nb <= 2)
                    & (holds(st_r) | (ri < 0))
                    & (holds(st_r1) | (ri + 1 >= ny)))
            self.stats["direct_steps"] += int((live.any(-1) & ~fast).sum())
            # pass A (fast steps), once per (x, v) of the window; a staged
            # read outside the step's window is a miss
            xl = np.arange(max(int(nq.max()), 1))[None, :, None]
            xq = (w_r[:, 0, None, None] + xl).astype(np.float64)
            act = ((live.any(-1) & fast)[:, None, None]
                   & (xl < nq[:, None, None]) & (self.lane_v < nv))
            cfq, zaq = self.grid(ri, xq, self.lane_v)
            xqi = xq.astype(np.int64)
            tables = []
            for b in range(min(self.nb, 2)):
                zeta = zaq + c("edz") * (cfq + b)
                on = act & live[:, b, None, None]
                h0, d0 = self.side(ri, w_r, xqi, zeta, on)
                h1, d1 = self.side(ri + 1, w_r, xqi, zeta, on)
                tables.append((h0, h1, d0, d1))
            self.stats["pass_a"] += int(act.sum())
            # pass B, per (u, v)
            cx = c("cxb") + c("rx") * ri
            jreal = (ri - (c("b1") + self.u * c("euy")
                           + self.v * c("evy"))) / c("edy")
            for b in range(self.nb):
                j = np.ceil(jreal) + b
                cfb = j - jreal
                fy = c("edy") * cfb
                ok = ((j >= 0) & (j < self.geom.n_steps) & (fy < 1.0)
                      & self.pix)
                X = (cx + self.u * c("eux") + self.v * c("evx")
                     + c("edx") * cfb)
                on = live[:, b, None, None]
                tabled = fast[:, None, None] & (b < 2)
                if b == 1:
                    self.stats["branch1"] += int((ok & on).sum())
                x0 = np.floor(X)
                wx = X - x0
                fields = np.zeros_like(acc)
                for o in (0, 1):
                    xi = x0.astype(np.int64) + o
                    tap = ok & (xi >= 0) & (xi < nx)
                    lx = xi - w_r[:, 0, None, None]
                    in_q = (lx >= 0) & (lx < nq[:, None, None])
                    # a fast step reads the tables alone: a tap in the
                    # volume outside them would be dropped
                    self.stats["miss"] += int((tap & on & tabled
                                               & ~in_q).sum())
                    cf, za = self.grid(ri, xi.astype(np.float64), self.v)
                    cfg = cf + b
                    zeta = za + c("edz") * cfg
                    h0, d0 = self.side(ri, None, xi, zeta, None)
                    h1, d1 = self.side(ri + 1, None, xi, zeta, None)
                    if b < 2:
                        lxc = np.clip(lx, 0, xl.shape[1] - 1)
                        h0, h1, d0, d1 = (
                            np.where(tabled, t[bi, lxc, lane], d)
                            for t, d in zip(tables[b], (h0, h1, d0, d1)))
                        cfg = np.where(tabled, cfq[bi, lxc, lane] + b, cfg)
                        tap = np.where(tabled, ok & in_q, tap)
                    w_h = wx if o else 1.0 - wx
                    w_d = 1.0 if o else -1.0
                    mom = wx * (1.0 - wx) * (1.0 if o else -1.0)
                    lerp_h = (1.0 - fy) * h0 + fy * h1
                    lerp_d = (1.0 - fy) * d0 + fy * d1
                    terms = (w_h * lerp_h, w_d * lerp_h, w_h * (h1 - h0),
                             w_h * lerp_d)
                    for f, t in enumerate(terms):
                        fields[f] += np.where(tap, t, 0.0)
                    fields[10] += np.where(tap, mom * lerp_d, 0.0)
                    fields[11] += np.where(tap, w_h * lerp_d * cfg, 0.0)
                for f in (1, 2, 3):
                    fields[f + 3] = j * fields[f]
                    fields[f + 6] = ri * fields[f]
                # a skipped (tile, slab, branch) must contribute nothing
                skipped = np.where(~on, fields, 0.0)
                self.stats["skipped_abs"] = max(self.stats["skipped_abs"],
                                                float(np.abs(skipped).max()))
                acc += np.where(on, fields, 0.0)
            w_r, w_r1, st_r, st_r1 = w_r1, w_r2, st_r1, st_r2
        # scatter the tiles back: (V, 12, nu, nv)
        ntu, ntv = -(-nu // TU), -(-nv // TV)
        V = len(self.u0) // (ntu * ntv)
        out = acc.reshape(12, V, ntu, ntv, TU, TV).transpose(1, 0, 2, 4, 3,
                                                             5)
        out = out.reshape(V, 12, ntu * TU, ntv * TV)
        return out[:, :, :nu, :nv]


def _new_stats():
    return dict(miss=0, branch1=0, branch_skips=0, pass_a=0,
                direct_steps=0, skipped_abs=0.0)


def _emulate(tg, tv, vol, cfg, shrink=0):
    """Per orientation group: (gstruct entry, emulated (V, 12, nu, nv),
    plain (V, 12, nu, nv)); and the stats."""
    stats = _new_stats()
    gstruct, scalars = tsp.scalar_groups(tg, tv, "arc", dtype=torch.float64)
    out = []
    v = torch.as_tensor(vol)
    for g, sc in zip(gstruct, scalars):
        vol_or = tsp.orient_volume(v, tg, g[1], g[2]).contiguous()
        got = _March(vol_or.numpy(), sc.numpy(), tg, cfg, stats,
                     shrink).run()
        out.append((g, got, tsp.jac_passes_oriented(vol_or, sc, tg).numpy()))
    return out, stats


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module",
                params=[(1.0, "kernel"), (0.5, "kernel"), (1.0, "small")],
                ids=lambda p: f"step{p[0]}-{p[1]}")
def case(request):
    step, tile = request.param
    jg, jv, tg, tv, vol = _problem(step)
    groups, stats = _emulate(tg, tv, vol,
                             KERNEL if tile == "kernel" else SMALL)
    return dict(jg=jg, jv=jv, tg=tg, vol=vol, groups=groups, stats=stats,
                tables=tsp._n_branch(step) <= 2, small=tile == "small")


def test_march_matches_plain_passes(case):
    for _, got, want in case["groups"]:
        for f in range(12):
            assert _rel(got[:, f], want[:, f]) < 1e-10, tsp.JAC_PASSES[f]


def test_march_k3_matches_tomojax_project_scalars(case):
    jg, tg = case["jg"], case["tg"]
    nu, nv = tg.det_shape
    sino = np.zeros((tg.n_proj, nu, nv))
    for (idx, _, _, uf), got, _ in case["groups"]:
        val = got[:, 0]
        sino[list(idx)] = val[:, ::-1] if uf else val
    gstruct, scalars = jsp.scalar_groups(jg, case["jv"], "arc", jnp.float64)
    want = jsp.project_scalars(jnp.asarray(case["vol"]), jg, gstruct,
                               scalars, quad="arc", dtype=jnp.float64)
    assert _rel(sino.reshape(tg.n_proj, -1), np.asarray(want)) < 1e-10


def test_march_k5_matches_tomojax_forward_view_jac():
    """One view in the swapped, y-flipped group (phi 2.1): the 12 emulated
    blocks assembled into the value and the 6-DoF Jacobian, against
    tomojax's."""
    jg, jv, tg, tv, vol = _problem(1.0)
    phi, t, cor = 2.1, np.array([0.7, -0.3, -0.4]), np.array([0.2, 0, 0])
    al, be = 0.011, -0.008
    th = torch.as_tensor(np.concatenate([t, [phi, al, be]]))[None]
    sw, yf, uf = (bool(f[0]) for f in tsp.orient_flags(
        Views.from_theta6(th), tg))
    assert (sw, yf, uf) == (True, True, False)
    cor_t = torch.as_tensor(cor)[None]
    sc = tsp.slab_scalars_t(tg, th, cor_t, sw, yf, False)
    vol_or = tsp.orient_volume(torch.as_tensor(vol), tg, sw, yf)
    stats = _new_stats()
    blocks = torch.as_tensor(_March(vol_or.numpy(), sc.numpy(), tg, KERNEL,
                                    stats).run())
    jac = tsp.assemble_jacobian(blocks, sc, tsp.param_jacobian(
        tg, th, cor_t, sw, yf, False), tg)[0].reshape(6, -1)
    v_j, j_j = jsp.forward_view_jac(jnp.asarray(vol), jg, phi, al, be,
                                    jnp.asarray(t), jnp.asarray(cor),
                                    dtype=jnp.float64)
    assert stats["miss"] == 0
    assert _rel(blocks[0, 0].reshape(-1).numpy(), np.asarray(v_j)) < 1e-10
    for k in range(6):
        assert _rel(jac[k].numpy(), np.asarray(j_j[k])) < 1e-10, k


def test_march_windows_hold_every_tap_and_skips_lose_nothing(case):
    s = case["stats"]
    assert s["miss"] == 0
    assert s["skipped_abs"] == 0.0
    assert len(case["groups"]) >= 4
    assert s["branch1"] > 0 and s["branch_skips"] > 0
    # the tables serve two branches; narrow tables send some steps direct
    assert (s["pass_a"] > 0) == case["tables"]
    assert (s["direct_steps"] > 0) == (not case["tables"] or case["small"])


def test_narrowed_window_misses_taps():
    """A mutated x window one column too narrow at the top: taps fall
    outside the staged rows and tables, and the miss count shows it."""
    _, _, tg, tv, vol = _problem(1.0)
    _, stats = _emulate(tg, tv, vol, SMALL, shrink=1)
    assert stats["miss"] > 0

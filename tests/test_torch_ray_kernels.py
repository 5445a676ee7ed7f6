"""The exact ray family's kernels R1, R2 and R3 (``kernels/ray.py``,
``csrc/ray.cu``) on the CPU: their entries in the build, their step and
candidate searches emulated in float32 (and R1's step range in double, as
the kernel computes it) against the plain march, and R3's sums emulated
(float32 per sample, double over the steps and in the epilogue) against
the plain march in float64.

R2 is a gather: for each voxel q and view it searches the candidate rays
and steps that :func:`~tomojax_torch.kernels.ray.gather_map`'s inverse map
and margins give, recomputes each candidate's sample as the march does and
keeps it where q is one of its corners. The emulation follows the kernel
step by step; the test holds that the pairs (ray, step, corner) it keeps
are exactly those the plain ``_corner_indices_weights`` produces, each
found once and with the same weight to the bit. Views: random jitter
(tilts up to ±1°, shifts ±2 px), plus the lattice-aligned pose φ = 0 (rays
through voxel centres, a direction along an axis) and φ = π/2.
"""

import math
import re

import numpy as np
import pytest
import torch

from tomojax_torch.core import projector as rp
from tomojax_torch.core.geometry import Geometry
from tomojax_torch.kernels import _build
from tomojax_torch.kernels import ray as rayk

torch.set_num_threads(1)

F32 = torch.float32
VOX, DET, NP = (9, 8, 7), (11, 10), 6


def test_build_declares_the_ray_entries():
    """``ray.cu`` is built and its two entries are declared (R1: 4
    pointers, 6 ints, the step; R2: 8 pointers, 9 ints, the step, the
    detector pitch in double); its map layout and margins are the
    wrapper's."""
    import ctypes
    assert _build.CSRC / "ray.cu" in _build.SOURCES
    fwd, adj = _build._SIGNATURES["ray_fwd"], _build._SIGNATURES["ray_adj"]
    assert len(fwd) == 12 and fwd[-2] is ctypes.c_float
    assert len(adj) == 21 and adj[-4:-1] == [ctypes.c_float, ctypes.c_double,
                                             ctypes.c_double]
    text = (_build.CSRC / "ray.cu").read_text()
    consts = dict(re.findall(r"constexpr int (NM|M_\w+) = (\d+);", text))
    for name in ("NM", "M_P", "M_AU", "M_AW", "M_IU", "M_IW", "M_ISD",
                 "M_HU", "M_HW", "M_BOX"):
        assert int(consts[name]) == getattr(rayk, name), name
    assert float(re.search(r"kMargin = ([\d.e-]+);", text).group(1)) \
        == rayk.MARGIN
    assert float(re.search(r"kStepSlack = ([\d.e-]+)f;", text).group(1)) \
        == rayk.STEP_SLACK


def test_ray_wrappers_take_only_cuda_float32():
    """A CPU tensor never reaches a kernel: the wrappers raise, and the
    projector's CPU path is the plain march (no launch counted)."""
    geom = Geometry(n_proj=2, vox_shape=VOX, det_shape=DET)
    setup = rp._ray_setup(geom, *_views(2, 0), F32, False)
    vol = torch.zeros(VOX)
    with pytest.raises(ValueError, match="CUDA"):
        rayk.ray_fwd(vol, setup.p0, setup.d_hat, geom)
    before = (rayk.ray_fwd.launches, rayk.ray_adj.launches)
    args = _views(2, 0)
    a = rp.forward_views(torch.rand(VOX), geom, *args)
    rp.backproject_views(a, VOX, geom, *args)
    assert (rayk.ray_fwd.launches, rayk.ray_adj.launches) == before


def test_build_declares_r3():
    """R3's entry is declared as ``ray.cu`` defines it: 8 pointers, 6
    ints, the step in float, 1 / ray length in double, the stream."""
    import ctypes
    sig = _build._SIGNATURES["ray_jac"]
    text = (_build.CSRC / "ray.cu").read_text()
    params = re.search(r"^int ray_jac\(([^)]*)\)", text, re.M).group(1)
    ctype = {"float*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float,
             "double": ctypes.c_double}
    want = [ctype[" ".join(p.split()[:-1]).replace("const ", "")]
            for p in params.split(",")]
    assert sig == want and len(sig) == 17


def test_ray_jac_takes_only_cuda_float32():
    """R3's wrapper raises on CPU tensors, float32 or float64, without
    counting a launch: ``forward_views_jac`` takes the plain march on the
    CPU, and nothing falls back on the card."""
    geom = Geometry(n_proj=2, vox_shape=VOX, det_shape=DET)
    before = rayk.ray_jac.launches
    for dtype in (F32, torch.float64):
        setup = rp._ray_setup(geom, *_views(2, 0), dtype, True)
        with pytest.raises(ValueError, match="CUDA"):
            rayk.ray_jac(torch.zeros(VOX, dtype=dtype), setup.p0,
                         setup.d_hat, setup.rpa, setup.der_ang,
                         setup.der_dir, geom)
    rp.forward_views_jac(torch.rand(VOX), geom, *_views(2, 0))
    assert rayk.ray_jac.launches == before


@pytest.mark.parametrize("dtype", [F32, torch.float64])
def test_forward_views_jac_plain_is_the_cpu_path(dtype):
    """On the CPU ``forward_views_jac`` is the plain march:
    ``forward_views_jac_plain`` gives its bits, in either dtype."""
    geom = Geometry(n_proj=3, vox_shape=VOX, det_shape=DET)
    vol = torch.rand(VOX, generator=torch.Generator().manual_seed(3),
                     dtype=dtype)
    views = [a.to(dtype) for a in _views(3, 4)]
    det, jac = rp.forward_views_jac(vol, geom, *views, dtype=dtype)
    det_p, jac_p = rp.forward_views_jac_plain(vol, geom, *views, dtype=dtype)
    assert det.dtype == jac.dtype == dtype and jac.shape == (3, 6, geom.n_det)
    assert torch.equal(det, det_p) and torch.equal(jac, jac_p)


def _r3_emulated(vol, setup, geom):
    """R3's sums on the plain march's float32 samples: per sample the
    value and the masked weight gradient summed over the corners in
    float32 in corner order, the steps summed in double (the gradient
    also weighted by c_j), contracted with the setup's parts in double."""
    vol_flat = vol.reshape(-1)
    V, _, R = setup.p0.shape
    f64 = torch.float64
    acc = torch.zeros(V, R, dtype=f64)
    g_sum = torch.zeros(3, V, R, dtype=f64)
    g_step = torch.zeros(3, V, R, dtype=f64)
    for c, p in rp._step_blocks(setup, geom, F32):
        idx, w, parts, mask = rp._corner_indices_weights(p, geom.vox_shape)
        vals = torch.take(vol_flat, idx)
        dw = rp._corner_weight_gradients(parts)
        s = torch.zeros(p.shape[1:], dtype=F32)
        g = torch.zeros((3,) + p.shape[1:], dtype=F32)
        for c8 in range(8):
            s = s + w[c8] * vals[c8]
            g = g + (vals[c8] * mask[c8]) * dw[c8]
        acc += s.double().sum(-1)
        g_sum += g.double().sum(-1)
        g_step += (g.double() * c.double()).sum(-1)
    jt = torch.einsum("vdp,dvr->vpr", setup.rpa.double(), g_sum)
    ja = (torch.einsum("vpdr,dvr->vpr", setup.der_ang.double(), g_sum)
          + torch.einsum("vpd,dvr->vpr", setup.der_dir.double(), g_step)
          / geom.ray_length)
    return acc.float(), torch.cat([jt, ja], 1).float()


def _per_view_rel(x, ref):
    """Relative L2 distance of each view's rows (its det, or its whole
    Jacobian) from the reference's."""
    x, ref = x.double().flatten(1), ref.flatten(1)
    return torch.linalg.norm(x - ref, dim=1) / torch.linalg.norm(ref, dim=1)


def test_r3_sums_track_float64_as_the_plain_march():
    """R3's arithmetic, emulated, lies no further from the float64 plain
    march than the float32 plain march does, per view, within the factor
    1.5 that the card test holds R3 to (both take the same float32
    samples, whose rounding makes most of the distance; R3 sums in double
    where the plain march sums in float32)."""
    geom = Geometry(n_proj=NP, vox_shape=VOX, det_shape=DET)
    views = _views(NP, 5)
    vol = torch.rand(VOX, generator=torch.Generator().manual_seed(6))
    setup = rp._ray_setup(geom, *views, F32, True)
    det, jac = _r3_emulated(vol, setup, geom)
    d64, j64 = rp.forward_views_jac_plain(
        vol.double(), geom, *(a.double() for a in views),
        dtype=torch.float64)
    d32, j32 = rp.forward_views_jac_plain(vol, geom, *views)
    for x, x32, ref in ((det, d32, d64), (jac, j32, j64)):
        e, e32 = _per_view_rel(x, ref), _per_view_rel(x32, ref)
        assert bool((e <= 1.5 * e32 + 1e-9).all()), (e, e32)
        assert float(e.max()) < 1e-5


def _views(n, seed, aligned=False):
    """(phi, alpha, beta, t, cor) of ``n`` float32 views: random jitter, or
    with ``aligned`` the first two views at φ = 0 and π/2 with none."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, n)
    ab = rng.uniform(-1, 1, (2, n)) * math.radians(1.0)
    t = rng.uniform(-2, 2, (n, 3))
    cor = np.zeros((n, 3))
    cor[:, 0] = rng.uniform(-0.5, 0.5, n)
    if aligned:
        phi[:2] = (0.0, np.pi / 2)
        ab[:, :2] = 0.0
        t[:2] = 0.0
        cor[:2] = 0.0
    return tuple(torch.as_tensor(a, dtype=F32)
                 for a in (phi, ab[0], ab[1], t, cor))


def _plain_pairs(setup, geom):
    """Codes ``((v·R + k)·S + j)·n_vox + q`` and weights of every (view,
    ray, step, corner) the plain march keeps (in-bounds corners)."""
    V, _, R = setup.p0.shape
    S = geom.n_steps
    codes, weights = [], []
    for c, p in rp._step_blocks(setup, geom, F32):
        j = torch.round(c / torch.tensor(geom.step_size, dtype=F32))
        idx, w, _, mask = rp._corner_indices_weights(p, geom.vox_shape)
        vv = torch.arange(V)[:, None, None]
        kk = torch.arange(R)[None, :, None]
        jj = j.long()[None, None, :]
        base = ((vv * R + kk) * S + jj) * geom.n_vox
        keep = mask.bool()
        codes.append((base[None] + idx)[keep])
        weights.append(w[keep])
    return torch.cat(codes), torch.cat(weights)


def _gather_pairs(gmap, setup, geom, rays):
    """The codes and weights of the pairs ``ray_adj_kernel`` keeps: its
    candidate rays and steps per (voxel, view), then its exact test."""
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    V, _, R = setup.p0.shape
    S = geom.n_steps
    r_off, _ = rayk.ray_block(geom, rays)
    u_first, w_first = divmod(r_off, nv)
    u_last = (r_off + R - 1) // nv
    step = torch.tensor(geom.step_size, dtype=F32)
    q = torch.stack(torch.meshgrid(torch.arange(nx), torch.arange(ny),
                                   torch.arange(nz), indexing="ij"),
                    -1).reshape(-1, 3)
    qf = q.to(F32)
    q_lin = (q[:, 0] * ny + q[:, 1]) * nz + q[:, 2]
    codes, weights = [], []
    for v in range(V):
        m = gmap[v]

        def row(i):
            return m[i:i + 3]

        r = qf - row(rayk.M_P)
        cu = u_first + (r * row(rayk.M_IU)).sum(-1)
        cw = w_first + (r * row(rayk.M_IW)).sum(-1)
        ua = torch.ceil(torch.clamp(cu - m[rayk.M_HU], min=-1)).long()
        ua = ua.clamp(min=u_first)
        ub = torch.floor(torch.clamp(cu + m[rayk.M_HU], max=nu)).long()
        ub = ub.clamp(max=u_last)
        wa = torch.ceil(torch.clamp(cw - m[rayk.M_HW], min=-1)).long()
        wa = wa.clamp(min=0)
        wb = torch.floor(torch.clamp(cw + m[rayk.M_HW], max=nv)).long()
        wb = wb.clamp(max=nv - 1)
        n_u = int((ub - ua).max()) + 1
        n_w = int((wb - wa).max()) + 1
        if n_u <= 0 or n_w <= 0:
            continue
        U = ua[:, None, None] + torch.arange(n_u)[None, :, None]
        W = wa[:, None, None] + torch.arange(n_w)[None, None, :]
        k = U * nv + W - r_off
        ok = ((U <= ub[:, None, None]) & (W <= wb[:, None, None]) & (k >= 0)
              & (k < R))
        du = (U - u_first).to(F32)
        dw = (W - w_first).to(F32)
        lo = torch.zeros(k.shape, dtype=F32)
        hi = torch.full(k.shape, float(S - 1), dtype=F32)
        box = m[rayk.M_BOX]
        for a in range(3):
            P = m[rayk.M_P + a] + du * m[rayk.M_AU + a] + dw * m[rayk.M_AW + a]
            qa = qf[:, a, None, None]
            isd = m[rayk.M_ISD + a]
            if float(isd) == 0.0:
                ok &= (qa - P).abs() <= box
                continue
            t0, t1 = (qa - box - P) * isd, (qa + box - P) * isd
            lo = torch.maximum(lo, torch.minimum(t0, t1))
            hi = torch.minimum(hi, torch.maximum(t0, t1))
        ok &= lo <= hi
        slack = torch.tensor(rayk.STEP_SLACK, dtype=F32)
        j0 = torch.ceil(lo - slack).long().clamp(min=0)
        j1 = torch.floor(hi + slack).long().clamp(max=S - 1)
        n_j = int(torch.where(ok, j1 - j0, 0).max()) + 1
        J = j0[..., None] + torch.arange(n_j)
        ok = ok[..., None] & (J <= j1[..., None])
        kc = k.clamp(0, R - 1)[..., None].expand(J.shape)
        c = J.to(F32) * step
        w = torch.ones(J.shape, dtype=F32)
        parts = []
        for a in range(3):
            pa = setup.p0[v, a][kc] + c * setup.d_hat[v, a]
            f = torch.floor(pa)
            t = pa - f
            qa = qf[:, a, None, None, None]
            ok &= (f == qa) | (f == qa - 1)
            parts.append(torch.where(f == qa, 1.0 - t, t))
        w = parts[0] * parts[1] * parts[2]
        code = ((v * R + kc) * S + J) * geom.n_vox + q_lin[:, None, None,
                                                          None]
        codes.append(code[ok])
        weights.append(w[ok])
    return torch.cat(codes), torch.cat(weights)


def _fwd_step_ranges(setup, geom):
    """``step_range`` of R1 (in double, as the kernel): ``(j0, j1)`` per
    (view, ray)."""
    p = setup.p0.double()
    s = float(np.float32(geom.step_size))
    sd = (setup.d_hat.double() * s)[:, :, None].expand(p.shape)
    m = 1e-4 * (1 + p.abs().sum(1) + geom.n_steps * s)
    lo = torch.zeros(m.shape, dtype=torch.float64)
    hi = torch.full(m.shape, geom.n_steps - 1.0, dtype=torch.float64)
    hit = torch.ones(m.shape, dtype=torch.bool)
    for a, n in enumerate(geom.vox_shape):
        lo_b, hi_b = -1.0 - m, n + m
        flat = sd[:, a].abs() < 1e-30
        hit &= ~flat | ((p[:, a] >= lo_b) & (p[:, a] <= hi_b))
        d = torch.where(flat, 1.0, sd[:, a])
        t0, t1 = (lo_b - p[:, a]) / d, (hi_b - p[:, a]) / d
        lo = torch.where(flat, lo, torch.maximum(lo, torch.minimum(t0, t1)))
        hi = torch.where(flat, hi, torch.minimum(hi, torch.maximum(t0, t1)))
    hit &= lo <= hi
    j0 = torch.where(hit, (torch.floor(lo).long() - 1).clamp(min=0), 0)
    j1 = torch.where(hit, (torch.ceil(hi).long() + 2).clamp(max=geom.n_steps),
                     0)
    return j0, j1


@pytest.mark.parametrize("step,rays", [(1.0, slice(None)),
                                       (0.7, slice(None)),
                                       (1.0, slice(23, 71)),
                                       (0.7, slice(23, 71))])
def test_gather_map_finds_every_corner_pair_once(step, rays):
    """R2's candidate search, emulated in float32, keeps exactly the plain
    march's (ray, step, corner) pairs, each once and with the plain
    weight to the bit; R1's step range holds every step that reaches a
    corner."""
    geom = Geometry(n_proj=NP, vox_shape=VOX, det_shape=DET, step_size=step)
    views = _views(NP, 1 if rays.start is None else 2, aligned=True)
    setup = rp._ray_setup(geom, *views, F32, False, rays)
    gmap = rayk.gather_map(setup.p0, setup.d_hat, *views[:3], geom, rays)
    assert gmap.shape == (NP, rayk.NM) and gmap.dtype == F32
    want, w_want = _plain_pairs(setup, geom)
    got, w_got = _gather_pairs(gmap, setup, geom, rays)
    assert len(want) > 1000
    assert len(torch.unique(got)) == len(got), "a pair found twice"
    order_w, order_g = torch.argsort(want), torch.argsort(got)
    assert torch.equal(want[order_w], got[order_g])
    assert torch.equal(w_want[order_w], w_got[order_g])
    # every kept step of a ray lies in R1's range
    j0, j1 = _fwd_step_ranges(setup, geom)
    S = geom.n_steps
    vk = want // geom.n_vox // S
    j = want // geom.n_vox % S
    assert bool(((j >= j0.reshape(-1)[vk]) & (j < j1.reshape(-1)[vk])).all())

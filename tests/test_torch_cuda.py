"""The CUDA kernels K1-K5, K7 and K8, the bf16 tier's K1b-K4b and the
exact ray family's R1/R2/R3 against their plain PyTorch versions,
on the card, and the plain-PyTorch modules (cross-correlation, the
regularized solvers, the exact ray family's LM) and the CV driver on the
card against the CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on the card it runs without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances are tomojax's own bars for its TPU kernel
(tests/test_slab_kernel.py): 5e-4 relative per view forward and for the
adjoint, 2e-3 per view for the Jacobian building blocks; the adjoint
identity holds to float32 summation rounding (1e-5). The resample kernels
K7/K8 choose the plain version's taps to the last bit, so they agree with
it to float32 summation rounding (1e-5 relative).
"""

import ctypes
import hashlib
import time

import numpy as np
import pytest
import torch

from tomojax_torch.align import cc
from tomojax_torch.align.pipeline import align_reconstruct_cv
from tomojax_torch.align.refine import gradient_descent_views, refine_views
from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.kernels import _build
from tomojax_torch.kernels import ray as rp_kernels
from tomojax_torch.kernels import resample as rs
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.recon import cgls, fista_tv, lasso_fista, tikhonov_gd
from tomojax_torch.recon.fista_tv import estimate_lipschitz
from tomojax_torch.tools import bf16_gate, trace_cost

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (an NVIDIA GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(n=48, n_proj=12, seed=0):
    """Jittered views over the full circle at generic angles: all four
    reachable orientation groups are present."""
    rng = np.random.default_rng(seed)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n + 8))
    views = Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, n_proj),
        beta=rng.uniform(-0.02, 0.02, n_proj),
        t=rng.uniform(-2, 2, (n_proj, 3)))
    vol = phantom.shepp3d(n) + 0.1 * rng.random((n,) * 3, np.float32)
    return geom, views, vol, rng


def _groups(geom, views, vol, device, quad="plane"):
    gstruct, scalars = sp.scalar_groups(geom, views, quad,
                                        dtype=torch.float32, device=device)
    assert len(gstruct) == 4
    v = torch.as_tensor(vol, device=device)
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        yield sp.orient_volume(v, geom, sw, yf).contiguous(), sc


def test_k1_matches_plain(cuda):
    geom, views, vol, _ = _problem()
    for vol_or, sc in _groups(geom, views, vol, cuda):
        ker = slabk.slab_project(vol_or, sc, geom)
        ref = slabk.slab_project_plain(vol_or, sc, geom)
        torch.cuda.synchronize()
        rel = (torch.linalg.norm(ker - ref, dim=(1, 2))
               / torch.linalg.norm(ref, dim=(1, 2)))
        assert float(rel.max()) < 5e-4, rel


def test_k2_matches_plain_vjp(cuda):
    geom, views, vol, rng = _problem()
    nu, nv = geom.det_shape
    for vol_or, sc in _groups(geom, views, vol, cuda):
        g = torch.as_tensor(rng.standard_normal((sc.shape[0], nu, nv)),
                            dtype=torch.float32, device=cuda)
        ker = slabk.slab_backproject(g, sc, geom)
        ref = slabk.slab_backproject_plain(g, sc, geom)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
        assert rel < 5e-4, rel


def test_adjoint_identity(cuda):
    geom, views, vol, rng = _problem()
    nu, nv = geom.det_shape
    for vol_or, sc in _groups(geom, views, vol, cuda):
        ax = slabk.slab_project(vol_or, sc, geom)
        y = torch.as_tensor(rng.standard_normal((sc.shape[0], nu, nv)),
                            dtype=torch.float32, device=cuda)
        aty = slabk.slab_backproject(y, sc, geom)
        lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1), aty.double().reshape(-1))
        bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
            y.double())
        assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def test_autograd_backward_is_k2(cuda):
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    x = torch.as_tensor(vol, device=cuda).requires_grad_(True)
    gstruct, scalars = sp.scalar_groups(geom, views, "plane", device=cuda)
    y = sp.project_scalars(x, geom, gstruct, scalars, "plane")
    g = torch.as_tensor(rng.standard_normal(y.shape), dtype=torch.float32,
                        device=cuda)
    before = slabk.slab_plane_adj.launches
    (gx,) = torch.autograd.grad(y, x, g)
    assert slabk.slab_plane_adj.launches == before + len(gstruct)
    ref = sp.backproject_scalars(g, geom, gstruct, scalars, "plane")
    # the same K2 outputs, summed over the groups in autograd's order
    assert torch.allclose(gx, ref, rtol=1e-6, atol=1e-6)


def test_wrappers_raise_on_bad_input(cuda):
    geom, views, vol, _ = _problem(n=32, n_proj=8)
    vol_or, sc = next(_groups(geom, views, vol, cuda))
    with pytest.raises(TypeError):
        slabk.slab_project(vol_or.double(), sc, geom)
    with pytest.raises(ValueError):
        slabk.slab_project(vol_or.transpose(0, 2), sc, geom)
    with pytest.raises(ValueError):
        slabk.slab_project(vol_or, sc.cpu(), geom)


def test_cgls_on_card_tracks_cpu(cuda):
    geom, views, vol, _ = _problem(n=32, n_proj=16)
    runs = []
    for dev in ("cpu", cuda):
        op = make_operator(geom, views, family="slab_plane", device=dev)
        b = op.A(torch.as_tensor(vol, device=dev))
        runs.append(cgls(op, b, niter=8, ground_truth=vol))
    cpu, card = runs
    rel = float(torch.linalg.norm(card.x.cpu() - cpu.x)
                / torch.linalg.norm(cpu.x))
    assert rel < 1e-4, rel
    assert card.n_iter == cpu.n_iter == 8


def _per_view_rel(ker, ref):
    return (torch.linalg.norm(ker - ref, dim=(-2, -1))
            / torch.linalg.norm(ref, dim=(-2, -1)))


def test_k3_matches_plain(cuda):
    geom, views, vol, _ = _problem(n=64)
    for vol_or, sc in _groups(geom, views, vol, cuda, "arc"):
        ker = slabk.slab_arc_fwd(vol_or, sc, geom)
        ref = slabk.slab_project_plain(vol_or, sc, geom, "arc")
        torch.cuda.synchronize()
        rel = _per_view_rel(ker, ref)
        assert float(rel.max()) < 5e-4, rel


def test_k4_matches_plain_vjp(cuda):
    geom, views, vol, rng = _problem(n=64)
    nu, nv = geom.det_shape
    for vol_or, sc in _groups(geom, views, vol, cuda, "arc"):
        g = torch.as_tensor(rng.standard_normal((sc.shape[0], nu, nv)),
                            dtype=torch.float32, device=cuda)
        ker = slabk.slab_arc_adj(g, sc, geom)
        ref = slabk.slab_backproject_plain(g, sc, geom, "arc")
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
        assert rel < 5e-4, rel


def test_arc_adjoint_identity(cuda):
    geom, views, vol, rng = _problem(n=64)
    nu, nv = geom.det_shape
    for vol_or, sc in _groups(geom, views, vol, cuda, "arc"):
        ax = slabk.slab_arc_fwd(vol_or, sc, geom)
        y = torch.as_tensor(rng.standard_normal((sc.shape[0], nu, nv)),
                            dtype=torch.float32, device=cuda)
        aty = slabk.slab_arc_adj(y, sc, geom)
        lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1), aty.double().reshape(-1))
        bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
            y.double())
        assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def _odd_arc_case(device, det_pix, det=None):
    """An odd-sized arc group: a 40×24×36 oriented volume, nu ≠ nv, 7
    jittered views in one orientation group (|φ| < 0.6 rad: no swap or
    flip). At det_pix 0.5 a K4 tile's u and v windows (~70 and ~80 wide)
    take more than one staged chunk each. ``det`` replaces the detector
    (nu, nv)."""
    rng = np.random.default_rng(4)
    nu, nv = det or ((44, 38) if det_pix == 1.0 else (100, 90))
    geom = Geometry(n_proj=7, vox_shape=(40, 24, 36), det_shape=(nu, nv),
                    det_pix=(det_pix, det_pix))
    views = Views.create(7, phi=np.linspace(-0.6, 0.6, 7),
                         alpha=rng.uniform(-0.02, 0.02, 7),
                         beta=rng.uniform(-0.02, 0.02, 7),
                         t=rng.uniform(-2, 2, (7, 3)))
    gstruct, scalars = sp.scalar_groups(geom, views, "arc", device=device)
    assert [g[1:] for g in gstruct] == [(False, False, False)]
    vol = torch.as_tensor(rng.random(geom.vox_shape), dtype=torch.float32,
                          device=device)
    g = torch.as_tensor(rng.standard_normal((7, nu, nv)),
                        dtype=torch.float32, device=device)
    return geom, scalars[0], vol, g


@pytest.mark.parametrize("det_pix", [1.0, 0.5])
def test_k4_odd_size_matches_plain_vjp_and_repeats(cuda, det_pix):
    geom, sc, _, g = _odd_arc_case(cuda, det_pix)
    ker = slabk.slab_arc_adj(g, sc, geom)
    again = slabk.slab_arc_adj(g, sc, geom)
    ref = slabk.slab_backproject_plain(g, sc, geom, "arc")
    torch.cuda.synchronize()
    assert torch.equal(ker, again)
    rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
    assert rel < 5e-4, rel


@pytest.mark.parametrize("det_pix", [1.0, 0.5])
def test_k4_odd_size_adjoint_identity(cuda, det_pix):
    geom, sc, vol, y = _odd_arc_case(cuda, det_pix)
    ax = slabk.slab_arc_fwd(vol, sc, geom)
    aty = slabk.slab_arc_adj(y, sc, geom)
    lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol.double().reshape(-1), aty.double().reshape(-1))
    bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
        y.double())
    assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def test_k5_fields_match_plain(cuda):
    geom, views, vol, _ = _problem(n=64)
    for vol_or, sc in _groups(geom, views, vol, cuda, "arc"):
        ker = slabk.slab_project_jac(vol_or, sc, geom)
        ref = slabk.slab_project_jac_plain(vol_or, sc, geom)
        torch.cuda.synchronize()
        assert ker.shape == ref.shape == (sc.shape[0], 12, *geom.det_shape)
        rel = _per_view_rel(ker, ref).max(dim=0).values
        assert float(rel.max()) < 2e-3, dict(zip(slabk.JAC_PASSES,
                                                 rel.tolist()))


def test_k6_entry_is_k5_field(cuda):
    geom, views, vol, _ = _problem(n=32, n_proj=8)
    vol_or, sc = next(_groups(geom, views, vol, cuda, "arc"))
    stacked = slabk.slab_project_jac(vol_or, sc, geom)
    for i, (name, dv, jw, rw) in enumerate(sp.JAC_PASSES[1:], start=1):
        before = slabk.slab_project_field.launches
        one = slabk.slab_project(vol_or, sc, geom, "arc", dv, jw, rw)
        assert slabk.slab_project_field.launches == before + 1, name
        assert torch.equal(one, stacked[:, i]), name


def _march_case(device, case):
    """Arc groups that drive the K3/K5 march down each of its paths:
    "circle", views over the full circle (every orientation group);
    "axis", views within 0.01 rad of the axes (edy near 1: branch 1 is
    skipped for whole tiles); "diagonal", views near 45° (edy near
    1/sqrt(2): branch 1 valid for ~40% of the samples); "coarse", a
    detector pitch of 2 (windows beyond the tables: direct steps); "step",
    march step 0.5 (three branches: every step direct)."""
    rng = np.random.default_rng(7)
    n, n_proj, det_pix, step = 48, 12, 1.0, 1.0
    phi = 0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False)
    if case == "axis":
        phi = np.repeat(np.arange(4) * np.pi / 2, 3) + rng.uniform(
            -0.01, 0.01, n_proj)
    elif case == "diagonal":
        phi = np.repeat(np.arange(4) * np.pi / 2 + np.pi / 4, 3) + \
            rng.uniform(-0.05, 0.05, n_proj)
    elif case == "coarse":
        det_pix = 2.0
    elif case == "step":
        step = 0.5
    nd = int(np.ceil(n * 1.5 / det_pix))
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(nd, nd + 6),
                    det_pix=(det_pix, det_pix), step_size=step)
    views = Views.create(n_proj, phi=phi,
                         alpha=rng.uniform(-0.01, 0.01, n_proj),
                         beta=rng.uniform(-0.01, 0.01, n_proj),
                         t=rng.uniform(-2, 2, (n_proj, 3)))
    vol = phantom.shepp3d(n) + 0.1 * rng.random((n,) * 3, np.float32)
    gstruct, scalars = sp.scalar_groups(geom, views, "arc", device=device)
    v = torch.as_tensor(vol, device=device)
    return geom, [(sp.orient_volume(v, geom, sw, yf).contiguous(), sc)
                  for (_, sw, yf, _), sc in zip(gstruct, scalars)]


@pytest.mark.parametrize("case", ["circle", "axis", "diagonal", "coarse",
                                  "step"])
def test_k3_k5_every_ray_matches_plain_and_repeats(cuda, case):
    """Each ray of K3 and of every K5 field against the plain version (a
    tap the march dropped would move its ray by ~1e-3 of its value), and
    two applies of each bit-identical."""
    geom, groups = _march_case(cuda, case)
    for vol_or, sc in groups:
        k3 = slabk.slab_arc_fwd(vol_or, sc, geom)
        k5 = slabk.slab_project_jac(vol_or, sc, geom)
        assert torch.equal(k3, slabk.slab_arc_fwd(vol_or, sc, geom))
        assert torch.equal(k5, slabk.slab_project_jac(vol_or, sc, geom))
        assert torch.equal(k5[:, 0], k3)
        ref = slabk.slab_project_jac_plain(vol_or, sc, geom)
        torch.cuda.synchronize()
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        err = ((k5 - ref).abs() / scale).amax(dim=(0, 2, 3))
        assert float(err[0]) < 2e-5, err
        assert float(err.max()) < 1e-4, dict(zip(slabk.JAC_PASSES,
                                                 err.tolist()))


def test_march_division_is_fdiv_rn(cuda):
    """K3/K5 divide by edy with its correctly rounded reciprocal and one
    fma correction: bit-equal to __fdiv_rn on 2^22 numerators (random bit
    patterns, both signs, magnitudes in [2^-20, 2^13)) for 16 values of
    edy in [1/sqrt(2), 1] and its ends."""
    lib = _build.load()
    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 1 << 22
    bits = torch.randint(107 << 23, 140 << 23, (n,), generator=gen,
                         device=cuda, dtype=torch.int32)
    sign = torch.randint(0, 2, (n,), generator=gen, device=cuda,
                         dtype=torch.int32) << 31
    a = (bits | sign).view(torch.float32)
    q_rcp, q_div = torch.empty_like(a), torch.empty_like(a)
    edys = [1.0, 0.70710677, 0.99999994] + np.random.default_rng(0).uniform(
        0.7071, 1.0, 13).tolist()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for edy in edys:
        assert lib.slab_arc_div_check(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(q_rcp.data_ptr()),
            ctypes.c_void_p(q_div.data_ptr()), n, edy,
            ctypes.c_void_p(stream)) == 0
        assert torch.equal(q_rcp.view(torch.int32), q_div.view(torch.int32))


def test_refine_views_slab_on_card_tracks_cpu(cuda):
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    true = sp.project(torch.as_tensor(vol, dtype=torch.float64), geom,
                      views, dtype=torch.float64, quad="arc")
    th = views.theta6().double().numpy()
    th0 = th.copy()
    th0[:, [0, 2]] += rng.uniform(-0.3, 0.3, (geom.n_proj, 2))
    th0[:, [4, 5]] = 0.0
    init = Views.from_theta6(torch.as_tensor(th0))
    box = np.array([3.0, 3.0, 3.0, np.inf, 0.02, 0.02])
    kw = dict(param_set="xzab", lower=th0 - box, upper=th0 + box,
              max_iter=6)
    cpu = refine_views_slab(torch.as_tensor(vol, dtype=torch.float64), true,
                            geom, init, dtype=torch.float64, **kw)
    before = (slabk.slab_arc_fwd.launches, slabk.slab_project_jac.launches)
    card = refine_views_slab(torch.as_tensor(vol, device=cuda),
                             true.to(cuda), geom, init, **kw)
    assert slabk.slab_arc_fwd.launches > before[0]
    assert slabk.slab_project_jac.launches > before[1]
    err = (card.theta6.cpu().double() - cpu.theta6).abs().max()
    assert float(err) <= 1e-3, err


def _resample_case(device, V=3, R1=40, R2=24, N=96, M=130, seed=0):
    """Strided rows (a block shared by the views and a transposed view),
    offsets reaching past both ends, per-view slopes of both signs and
    |slope| < 1."""
    rng = np.random.default_rng(seed)
    block = torch.as_tensor(rng.random((R2, R1, N)), dtype=torch.float32,
                            device=device)
    rows = block.transpose(0, 1).expand(V, R1, R2, N)
    off = torch.as_tensor(rng.uniform(-N * 0.5, N * 1.3, (V, R1, R2)),
                          dtype=torch.float32, device=device)
    slope = torch.tensor([1.17, -0.61, 0.93], device=device)[:V]
    g = torch.as_tensor(rng.standard_normal((V, R1, R2, M)),
                        dtype=torch.float32, device=device)
    return rows, off, slope, g


def test_k7_k9_match_plain(cuda):
    rows, off, slope, _ = _resample_case(cuda)
    before = rs.resample_rows_raw.launches
    ker = rs.resample_fwd(rows, off, slope, 130)
    raw = rs.resample_rows_raw(rows, off, slope, 130)
    ref = rs.resample_rows_plain(rows, off, slope, 130)
    torch.cuda.synchronize()
    assert rs.resample_rows_raw.launches == before + 1
    assert torch.equal(raw, ker)
    rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
@pytest.mark.parametrize("out_order", [None, (0, 1, 3, 2), (0, 3, 2, 1)],
                         ids=["rows", "a2-inner", "a1-inner"])
def test_k7_output_layouts_bit_equal(cuda, shared, out_order):
    """K7 in each output layout at N = 37 and M = 53 (not multiples of 4:
    rows start off 16-byte alignment and the transpose rounds are ragged)
    and V = 7 (not a multiple of the 4 views a CTA loops over when each
    view has its own rows), with rows shared by all views (stride 0) or
    not."""
    V, R1, R2, N, M = 7, 9, 45, 37, 53
    rng = np.random.default_rng(5)
    if shared:
        rows = torch.as_tensor(rng.random((R1, R2, N)), dtype=torch.float32,
                               device=cuda).expand(V, R1, R2, N)
    else:
        rows = torch.as_tensor(rng.random((V, R2, R1, N)),
                               dtype=torch.float32,
                               device=cuda).transpose(1, 2)
    off = torch.as_tensor(rng.uniform(-N * 0.5, N * 1.3, (V, R1, R2)),
                          dtype=torch.float32, device=cuda)
    slope = torch.as_tensor(rng.uniform(-1.6, 1.6, V), dtype=torch.float32,
                            device=cuda)
    ker = rs.resample_fwd(rows, off, slope, M, out_order)
    ref = rs.resample_rows_plain(rows, off, slope, M)
    torch.cuda.synchronize()
    assert ker.shape == ref.shape
    if out_order is not None:
        assert ker.permute(*out_order).is_contiguous()
    assert torch.equal(ker, ref)
    assert torch.equal(rs.resample_rows_raw(rows, off, slope, M), ker)


def test_resample_rows_backward_through_k8_in_new_layouts(cuda):
    """The fast forward's chain of passes with its output layouts: the
    rows' cotangents reach K8 strided and K8 reads them as they are, and
    every gradient (rows, offsets, slope) matches the plain chain's on the
    CPU."""
    rng = np.random.default_rng(6)
    V, nx, ny, nz, nv, nj = 3, 12, 10, 14, 11, 17
    vol = rng.random((nx, ny, nz))
    off1 = rng.uniform(-3, nz + 3, (V, nx, ny))
    off2 = rng.uniform(-3, ny + 3, (V, nx, nv))
    sl = rng.uniform(0.7, 1.3, (2, V))
    w = rng.standard_normal((V, nx, nv, nj))
    grads = []
    for dev in ("cpu", cuda):
        def t(a, grad=False):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=dev).requires_grad_(grad)
        x, o1, o2 = t(vol, True), t(off1, True), t(off2, True)
        s1, s2 = t(sl[0], True), t(sl[1], True)
        i1 = rs.resample_rows(x.expand(V, nx, ny, nz), o1, s1, nv, 1.6,
                              out_order=(0, 1, 3, 2))
        i2 = rs.resample_rows(i1.transpose(2, 3), o2, s2, nj, 1.6,
                              out_order=(0, 3, 2, 1))
        loss = (i2 * t(w)).sum()
        grads.append([gr.cpu() for gr in torch.autograd.grad(
            loss, (x, o1, o2, s1, s2))])
    for cpu, card in zip(*grads):
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-5)


def test_k8_matches_plain_vjp_and_adjoint_identity(cuda):
    rows, off, slope, g = _resample_case(cuda)
    ker = rs.resample_transpose(g, off, slope, 96)
    ref = rs.resample_rows_transpose_plain(g, off, slope, 96)
    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
    assert rel <= 1e-5, rel
    x = rows.contiguous()
    ax = rs.resample_fwd(x, off, slope, 130)
    lhs = torch.dot(ax.double().reshape(-1), g.double().reshape(-1))
    rhs = torch.dot(x.double().reshape(-1), ker.double().reshape(-1))
    bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
        g.double())
    assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def test_k8_tiny_slopes_hold_k7_entries(cuda):
    """Slopes far below the positions' rounding step (|slope| ~ 1e-7 at
    positions ~10, where float32 spacing is ~1e-6) with offsets a few ulps
    off an integer: K7 still equals its plain version bit for bit, and K8
    still gathers every entry of K7's matrix (elementwise against the plain
    vjp; a missed entry would be off by its weight, ~1e-6)."""
    V, R, N, M = 4, 64, 24, 256
    rng = np.random.default_rng(2)
    base = rng.integers(2, N - 3, (V, R)).astype(np.float32)
    ulps = rng.integers(-4, 5, (V, R)).astype(np.float32)
    off = torch.as_tensor(base + ulps * np.spacing(base), device=cuda)
    slope = torch.tensor([1e-7, -1e-7, 3e-8, -2.5e-6], device=cuda)
    rows = torch.as_tensor(rng.random((V, R, N)), dtype=torch.float32,
                           device=cuda)
    g = torch.as_tensor(rng.random((V, R, M)), dtype=torch.float32,
                        device=cuda)
    assert torch.equal(rs.resample_fwd(rows, off, slope, M),
                       rs.resample_rows_plain(rows, off, slope, M))
    ker = rs.resample_transpose(g, off, slope, N)
    ref = rs.resample_rows_transpose_plain(g, off, slope, N)
    torch.testing.assert_close(ker, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("strided_g", [False, True], ids=["rows", "strided"])
@pytest.mark.parametrize("out_order", [None, (0, 1, 3, 2), (0, 3, 2, 1)],
                         ids=["rows", "a2-inner", "a1-inner"])
def test_k8_layouts_match_plain(cuda, out_order, strided_g):
    """K8 in each output layout, from cotangent rows of contiguous elements
    or of strided elements (the row axes contiguous), at N = 37 and M = 53
    and V = 7 (ragged against the 8 views and 32 rows of a CTA): the plain
    vjp's values, stored in the asked order."""
    V, R1, R2, N, M = 7, 9, 45, 37, 53
    rng = np.random.default_rng(8)
    off = torch.as_tensor(rng.uniform(-N * 0.5, N * 1.3, (V, R1, R2)),
                          dtype=torch.float32, device=cuda)
    slope = torch.as_tensor(rng.uniform(-1.6, 1.6, V), dtype=torch.float32,
                            device=cuda)
    gd = torch.as_tensor(rng.standard_normal((V, M, R1, R2)),
                         dtype=torch.float32, device=cuda)
    g = gd.permute(0, 2, 3, 1) if strided_g else gd.permute(0, 2, 3, 1) \
        .contiguous()
    ker = rs.resample_transpose(g, off, slope, N, out_order)
    ref = rs.resample_rows_transpose_plain(g, off, slope, N)
    torch.cuda.synchronize()
    assert ker.shape == ref.shape
    if out_order is not None:
        assert ker.permute(*out_order).is_contiguous()
    rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("swapped", [False, True], ids=["xy", "yx"])
def test_k8_view_sum_and_accumulate_match_plain(cuda, swapped):
    """The fused view sum added into a given tensor (a transposed view of
    it for x-marching chunks), holding zeros or not: the plain vjp summed
    over the views, added to what the tensor held."""
    V, R1, R2, N, M = 11, 20, 36, 30, 41
    rng = np.random.default_rng(9)
    off = torch.as_tensor(rng.uniform(-5, N + 5, (V, R1, R2)),
                          dtype=torch.float32, device=cuda)
    slope = torch.as_tensor(rng.uniform(0.7, 1.4, V), dtype=torch.float32,
                            device=cuda)
    g = torch.as_tensor(rng.standard_normal((V, R1, R2, M)),
                        dtype=torch.float32, device=cuda)
    base = torch.as_tensor(rng.standard_normal((R1, R2, N)),
                           dtype=torch.float32, device=cuda)
    if swapped:
        base = base.transpose(0, 1).contiguous().transpose(0, 1)
    want = rs.resample_rows_transpose_plain(g, off, slope, N).sum(0)
    for start in (torch.zeros_like(base), base):
        acc = start.clone(memory_format=torch.preserve_format)
        before = rs.resample_transpose.launches
        got = rs.resample_transpose(g, off, slope, N, add_into=acc)
        torch.cuda.synchronize()
        assert got is acc and rs.resample_transpose.launches == before + 1
        ref = want + start
        rel = float(torch.linalg.norm(acc - ref) / torch.linalg.norm(ref))
        assert rel <= 1e-5, rel


def test_resample_rows_backward_makes_no_copy(cuda, monkeypatch):
    """The backward hands K8 the cotangent as it arrives, strided (the
    fast forward's pass-3 broadcast sum and its stored layouts), without a
    ``.contiguous()`` copy."""
    seen, copies = [], []
    k8 = rs.resample_transpose
    contiguous = torch.Tensor.contiguous

    def probe(g, *a, **k):
        seen.append(g.is_contiguous())
        return k8(g, *a, **k)

    probe.launches = 0   # k8 counts on the module's name, now the probe

    def counting(self, *a, **k):
        if not self.is_contiguous(*a, **k):
            copies.append(tuple(self.shape))
        return contiguous(self, *a, **k)

    geom = Geometry(n_proj=6, vox_shape=(24,) * 3, det_shape=(24, 24))
    th = np.zeros((6, 6))
    th[:, 3] = np.linspace(0.1, 3.0, 6)
    E, B = fastp.view_affine(geom, th[:, 3], th[:, 4], th[:, 5], th[:, :3],
                             np.zeros((6, 3)), torch.float32)
    E, B = E.to(cuda).requires_grad_(True), B.to(cuda)
    vol = torch.as_tensor(phantom.shepp3d(24), device=cuda)
    loss = fastp.forward_views(vol, geom, E, B).square().sum()
    monkeypatch.setattr(rs, "resample_transpose", probe)
    monkeypatch.setattr(torch.Tensor, "contiguous", counting)
    (gE,) = torch.autograd.grad(loss, (E,))
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert len(seen) >= 2 and not all(seen), seen
    assert copies == [], copies
    assert torch.isfinite(gE).all()


def test_fast_adjoint_repeats_bit_for_bit(cuda):
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    y = torch.as_tensor(rng.standard_normal((8, geom.n_det)),
                        dtype=torch.float32, device=cuda)
    op = make_operator(geom, views, family="fast", device=cuda)
    assert torch.equal(op.AT(y), op.AT(y))


def _plane_odd_case(device, n=(37, 37, 29), det=(53, 41), det_pix=0.7,
                    n_proj=12):
    """A plane problem at odd sizes over the full circle (every
    orientation group, u-flip included), at a detector pitch ≠ 1."""
    rng = np.random.default_rng(12)
    geom = Geometry(n_proj=n_proj, vox_shape=n, det_shape=det,
                    det_pix=(det_pix, det_pix))
    views = Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, n_proj),
        beta=rng.uniform(-0.02, 0.02, n_proj),
        t=rng.uniform(-2, 2, (n_proj, 3)))
    vol = rng.random(n).astype(np.float32)
    return geom, views, vol, rng


@pytest.mark.parametrize("case", ["256", "odd"])
def test_k2_matches_plain_vjp_identity_and_repeats(cuda, case):
    """K2 at 256³ (8 views) and at odd sizes with det_pix 0.7: within 5e-4
    of the plain vjp, the adjoint identity with K1 to 1e-5, and two
    applies bit-identical (no atomics)."""
    if case == "256":
        geom, views, vol, rng = _problem(n=256, n_proj=8)
    else:
        geom, views, vol, rng = _plane_odd_case(cuda)
    nu, nv = geom.det_shape
    for vol_or, sc in _groups(geom, views, vol, cuda):
        y = torch.as_tensor(rng.standard_normal((sc.shape[0], nu, nv)),
                            dtype=torch.float32, device=cuda)
        ker = slabk.slab_plane_adj(y, sc, geom)
        assert torch.equal(ker, slabk.slab_plane_adj(y, sc, geom))
        ref = slabk.slab_backproject_plain(y, sc, geom)
        rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
        assert rel < 5e-4, rel
        ax = slabk.slab_plane_fwd(vol_or, sc, geom)
        lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1), ker.double().reshape(-1))
        bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
            y.double())
        assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def _plane_k2_case(device, case):
    """Plane groups that drive K2's gathers through each candidate count:
    "coarse", det_pix 2 (one candidate an entry); "tilt", 0.35 rad tilts
    (evx and gzx ≠ 0: the one more candidate differs between the rows and
    columns of a warp, and v chunks split); "fine", det_pix 0.02 × 0.015
    (2/|eux| and 2/|zav| past the chunks' capacities: every entry takes
    its whole chunk, over many u and v chunks)."""
    if case != "fine":
        return _plane_k1_case(device, case)
    rng = np.random.default_rng(4)
    n, n_proj = (10, 10, 11), 4
    geom = Geometry(n_proj=n_proj, vox_shape=n, det_shape=(900, 1000),
                    det_pix=(0.02, 0.015))
    views = Views.create(
        n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj, endpoint=False),
        alpha=rng.uniform(-0.02, 0.02, n_proj),
        beta=rng.uniform(-0.02, 0.02, n_proj),
        t=rng.uniform(-1, 1, (n_proj, 3)))
    vol = rng.random(n).astype(np.float32)
    return geom, list(_groups(geom, views, vol, device))


@pytest.mark.parametrize("case", ["coarse", "tilt", "fine"])
def test_k2_matches_plain_vjp_at_every_candidate_count(cuda, case):
    """K2 with one candidate an entry, with the one more candidate varying
    inside a warp, and past the chunks' capacities: within 5e-4 of the
    plain vjp, two applies bit-identical (no atomics), and the adjoint
    identity with K1 to 1e-5."""
    geom, groups = _plane_k2_case(cuda, case)
    nu, nv = geom.det_shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    for vol_or, sc in groups:
        y = torch.randn((sc.shape[0], nu, nv), generator=gen, device=cuda)
        ker = slabk.slab_plane_adj(y, sc, geom)
        again = slabk.slab_plane_adj(y, sc, geom)
        assert torch.equal(ker.view(torch.int32), again.view(torch.int32))
        ref = slabk.slab_backproject_plain(y, sc, geom)
        rel = float(torch.linalg.norm(ker - ref) / torch.linalg.norm(ref))
        assert rel < 5e-4, rel
        ax = slabk.slab_plane_fwd(vol_or, sc, geom)
        lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1), ker.double().reshape(-1))
        bound = 1e-5 * torch.linalg.norm(ax.double()) * torch.linalg.norm(
            y.double())
        assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def _plane_k1_case(device, case):
    """Plane groups that drive K1 down each of its paths: "odd", odd sizes
    at det_pix 0.7 (every window in the tables, 4-byte staging: nz odd);
    "coarse", det_pix 2 (T's columns exceed the table: the direct way per
    sample); "tilt", 0.35 rad tilts (zeta's rows exceed the ring for part
    of the slabs, so one march mixes table and direct slabs)."""
    if case == "odd":
        geom, views, vol, _ = _plane_odd_case(device)
    else:
        rng = np.random.default_rng(3)
        n, n_proj = 48, 12
        det_pix, tilt = (2.0, 0.02) if case == "coarse" else (1.0, 0.35)
        nd = int(np.ceil(n * 1.5 / det_pix))
        geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3,
                        det_shape=(nd, nd + 4), det_pix=(det_pix, det_pix))
        views = Views.create(
            n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj,
                                          endpoint=False),
            alpha=rng.uniform(-tilt, tilt, n_proj),
            beta=rng.uniform(-tilt, tilt, n_proj),
            t=rng.uniform(-2, 2, (n_proj, 3)))
        vol = rng.random((n,) * 3).astype(np.float32)
    return geom, list(_groups(geom, views, vol, device))


@pytest.mark.parametrize("case", ["odd", "coarse", "tilt"])
def test_k1_matches_plain_repeats_and_transposes_k2(cuda, case):
    """K1 on each of its paths: per-view relative L2 within 5e-4 of the
    plain forward and every ray within 2e-5 of its view's largest value (a
    tap the tables dropped would move a ray by ~1e-3 of it), two applies
    bit-identical, and the adjoint identity with K2 to 1e-5."""
    geom, groups = _plane_k1_case(cuda, case)
    nu, nv = geom.det_shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    for vol_or, sc in groups:
        ker = slabk.slab_plane_fwd(vol_or, sc, geom)
        again = slabk.slab_plane_fwd(vol_or, sc, geom)
        assert torch.equal(ker.view(torch.int32), again.view(torch.int32))
        ref = slabk.slab_project_plain(vol_or, sc, geom)
        torch.cuda.synchronize()
        assert float(_per_view_rel(ker, ref).max()) < 5e-4
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        assert float(((ker - ref).abs() / scale).max()) < 2e-5
        y = torch.randn((sc.shape[0], nu, nv), generator=gen, device=cuda)
        aty = slabk.slab_plane_adj(y, sc, geom)
        lhs = torch.dot(ker.double().reshape(-1), y.double().reshape(-1))
        rhs = torch.dot(vol_or.double().reshape(-1),
                        aty.double().reshape(-1))
        bound = 1e-5 * torch.linalg.norm(ker.double()) * torch.linalg.norm(
            y.double())
        assert float(abs(lhs - rhs)) <= float(bound), (lhs, rhs)


def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in ("resample_rows_plain", "resample_rows_transpose_plain"):
        monkeypatch.setattr(rs, name, refuse)
    rows, off, slope, g = _resample_case(cuda)
    before = (rs.resample_fwd.launches, rs.resample_transpose.launches)
    rs.resample_fwd(rows, off, slope, 130)
    rs.resample_transpose(g, off, slope, 96)
    geom, views, vol, _ = _problem(n=32, n_proj=8)
    x = torch.as_tensor(vol, device=cuda)
    op = make_operator(geom, views, family="fast", device=cuda)
    op.AT(op.A(x))
    assert rs.resample_fwd.launches > before[0] + 1
    assert rs.resample_transpose.launches > before[1] + 1
    with pytest.raises(TypeError):
        rs.resample_fwd(rows.double(), off.double(), slope.double(), 130)
    with pytest.raises(ValueError):
        rs.resample_fwd(rows, off.cpu(), slope, 130)


BF16 = {"plane": (slabk.slab_plane_fwd_bf16, slabk.slab_plane_adj_bf16,
                  slabk.slab_plane_fwd, slabk.slab_plane_adj),
        "arc": (slabk.slab_arc_fwd_bf16, slabk.slab_arc_adj_bf16,
                slabk.slab_arc_fwd, slabk.slab_arc_adj)}


@pytest.mark.parametrize("quad", ["plane", "arc"])
@pytest.mark.parametrize("n", [48, 50])
def test_bf16_kernels_match_plain_and_fp32(cuda, quad, n):
    """K1b-K4b (``prec="bf16"``) at 48³ (16-byte staging: nz, nv multiples
    of 8) and 50³ (nz = 50, nv = 58: the plain-load staging): against their
    plain bf16 versions (5e-4 per view forward, 5e-4 adjoint), within 3e-3
    and at least 1e-6 of the fp32 kernels (tomojax's contract), two applies
    bit-identical, the bf16 pair's mismatch within 5e-3 (tomojax's
    numerator and denominator pooled over 32 standard-normal cotangents,
    and the ratio on the non-negative |y|); each launch counted, the fp32
    kernels' counters untouched."""
    fwd_b, adj_b, fwd_f, adj_f = BF16[quad]
    geom, views, vol, rng = _problem(n=n)
    for vol_or, sc in _groups(geom, views, vol, cuda, quad):
        y = torch.as_tensor(rng.standard_normal(
            (sc.shape[0],) + geom.det_shape), dtype=torch.float32,
            device=cuda)
        before = [f.launches for f in BF16[quad]]
        ker = slabk.slab_project(vol_or, sc, geom, quad, prec="bf16")
        kadj = slabk.slab_backproject(y, sc, geom, quad, prec="bf16")
        assert [f.launches for f in BF16[quad]] == [
            before[0] + 1, before[1] + 1, before[2], before[3]]
        assert torch.equal(ker, fwd_b(vol_or, sc, geom))
        assert torch.equal(kadj, adj_b(y, sc, geom))
        ref = slabk.slab_project_plain(vol_or, sc, geom, quad, prec="bf16")
        rel = (torch.linalg.norm(ker - ref, dim=(1, 2))
               / torch.linalg.norm(ref, dim=(1, 2)))
        assert float(rel.max()) <= 5e-4
        radj = slabk.slab_backproject_plain(y, sc, geom, quad, prec="bf16")
        assert float(torch.linalg.norm(kadj - radj)
                     / torch.linalg.norm(radj)) <= 5e-4
        for b, f in ((ker, fwd_f(vol_or, sc, geom)),
                     (kadj, adj_f(y, sc, geom))):
            r = float(torch.linalg.norm(b - f) / torch.linalg.norm(f))
            assert 1e-6 <= r <= 3e-3
        pooled = bf16_gate.pooled_mismatch(
            ker, vol_or, lambda g: adj_b(g, sc, geom), tuple(y.shape), rng,
            32)
        assert pooled["pooled"] <= 5e-3
        assert bf16_gate.mismatch(ker, y.abs(), vol_or,
                                  adj_b(y.abs(), sc, geom)) <= 5e-3


def _bf16_odd_groups(device, quad, case):
    """Odd-sized groups ``(vol_or, scalars, y)`` for K2b and K4b (x, z
    and ny not multiples of the adjoints' tiles, nu ≠ nv): "plain", nv not
    a multiple of 8 (plain-load staging) at a detector pitch below 1,
    where windows span several staged chunks (plane: 53 × 41 at 0.7, every
    orientation group; arc: 100 × 90 at 0.5); "vec", nv a multiple of 8
    (16-byte staging; plane 53 × 48 at pitch 1, arc 44 × 40)."""
    if quad == "plane":
        geom, views, vol, rng = _plane_odd_case(
            device, det=(53, 41) if case == "plain" else (53, 48),
            det_pix=0.7 if case == "plain" else 1.0)
        groups = list(_groups(geom, views, vol, device))
    else:
        geom, sc, vol_or, _ = _odd_arc_case(
            device, 0.5 if case == "plain" else 1.0,
            None if case == "plain" else (44, 40))
        rng = np.random.default_rng(5)
        groups = [(vol_or, sc)]
    return geom, [(vo, sc, torch.as_tensor(
        rng.standard_normal((sc.shape[0],) + geom.det_shape),
        dtype=torch.float32, device=device)) for vo, sc in groups]


@pytest.mark.parametrize("quad", ["plane", "arc"])
@pytest.mark.parametrize("case", ["plain", "vec"])
def test_bf16_adjoints_at_odd_sizes(cuda, quad, case):
    """K2b and K4b (their own designs) at odd sizes: within 5e-4 of their
    plain bf16 versions, within 3e-3 and at least 1e-6 of the fp32
    adjoints, the bf16 pair's mismatch pooled over 32 standard-normal
    cotangents within 5e-3, and two applies bit-identical (no atomics)."""
    fwd_b, adj_b, _, adj_f = BF16[quad]
    geom, groups = _bf16_odd_groups(cuda, quad, case)
    rng = np.random.default_rng(6)
    for vol_or, sc, y in groups:
        kadj = adj_b(y, sc, geom)
        assert torch.equal(kadj, adj_b(y, sc, geom))
        radj = slabk.slab_backproject_plain(y, sc, geom, quad, prec="bf16")
        rel = float(torch.linalg.norm(kadj - radj) / torch.linalg.norm(radj))
        assert rel <= 5e-4, rel
        f32 = adj_f(y, sc, geom)
        r = float(torch.linalg.norm(kadj - f32) / torch.linalg.norm(f32))
        assert 1e-6 <= r <= 3e-3, r
        pooled = bf16_gate.pooled_mismatch(
            fwd_b(vol_or, sc, geom), vol_or, lambda g: adj_b(g, sc, geom),
            tuple(y.shape), rng, 32)
        assert pooled["pooled"] <= 5e-3, pooled


def _bf16_fwd_case(device, quad, case):
    """Groups that drive K1b and K3b (their own designs) down each of their
    paths: "odd", odd sizes at det_pix 0.7 (nz = 29, not a multiple of 8:
    the plain-load staging); "coarse", det_pix 2 (T's columns exceed the
    tables: the direct way per sample); "tilt", 0.35 rad tilts (windows
    beyond the staged rows for part of the slabs: one march mixes table and
    direct slabs)."""
    if case == "odd":
        geom, views, vol, _ = _plane_odd_case(device)
    else:
        rng = np.random.default_rng(3)
        n, n_proj = 48, 12
        det_pix, tilt = (2.0, 0.02) if case == "coarse" else (1.0, 0.35)
        nd = int(np.ceil(n * 1.5 / det_pix))
        geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3,
                        det_shape=(nd, nd + 4), det_pix=(det_pix, det_pix))
        views = Views.create(
            n_proj, phi=0.3 + np.linspace(0, 2 * np.pi, n_proj,
                                          endpoint=False),
            alpha=rng.uniform(-tilt, tilt, n_proj),
            beta=rng.uniform(-tilt, tilt, n_proj),
            t=rng.uniform(-2, 2, (n_proj, 3)))
        vol = rng.random((n,) * 3).astype(np.float32)
    return geom, list(_groups(geom, views, vol, device, quad))


# K1b's and K3b's bars from their plain bf16 versions per view on these
# cases: twice the largest reading over the three on an NVIDIA H100 80GB
# HBM3 at 700 W (plane 9.90e-6, arc 2.12e-6). Fewer rays a view than at
# 256³, where chip_smoke.py's TOL_BF16_PLAIN holds 1e-5 and 2e-5.
TOL_BF16_FWD_PLAIN = {"plane": 2e-5, "arc": 5e-6}


@pytest.mark.parametrize("quad", ["plane", "arc"])
@pytest.mark.parametrize("case", ["odd", "coarse", "tilt"])
def test_bf16_forwards_match_plain_and_repeat(cuda, quad, case):
    """K1b and K3b on each of their paths: per view within
    TOL_BF16_FWD_PLAIN of their plain bf16 versions and every ray within
    5e-4 of its view's largest value (a dropped tap moves a ray by ~1e-3 of
    it; a table value that rounds the other way, ~1e-4), within 3e-3 and at
    least 1e-6 of the fp32 kernels, two applies bit-identical."""
    fwd_b, _, fwd_f, _ = BF16[quad]
    geom, groups = _bf16_fwd_case(cuda, quad, case)
    for vol_or, sc in groups:
        ker = fwd_b(vol_or, sc, geom)
        assert torch.equal(ker.view(torch.int32),
                           fwd_b(vol_or, sc, geom).view(torch.int32))
        ref = slabk.slab_project_plain(vol_or, sc, geom, quad, prec="bf16")
        rel = float(_per_view_rel(ker, ref).max())
        assert rel <= TOL_BF16_FWD_PLAIN[quad], rel
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        ray = float(((ker - ref).abs() / scale).max())
        assert ray < 5e-4, ray
        f32 = fwd_f(vol_or, sc, geom)
        r = float(torch.linalg.norm(ker - f32) / torch.linalg.norm(f32))
        assert 1e-6 <= r <= 3e-3, r


# SHA-256 of each kernel's outputs on an NVIDIA H100 80GB HBM3. The slab
# kernels on _problem(48)'s orientation groups (the adjoints on seeded
# cotangents): K1 and K3-K5 from c0ab30d's build (the bf16 tier's kernels
# of their own leave them as they were), K2 from its gather schedule's
# build (the same matrix entries as the owner sweeps before it, summed in
# another order), K1b-K4b from c702356's build. K7 and K8 on
# _resample_case, R1 and R2 (its output and its map) on _ray_case("odd"),
# from c702356's build; R3 (its det and its Jacobian) on the same case.
# Every entry gives the same bits on every apply (no atomics; K4's and
# K4b's two sides are added in a fixed order).
SLAB_ENTRIES = {
    "slab_plane_fwd": (slabk.slab_plane_fwd, "plane"),
    "slab_plane_adj": (slabk.slab_plane_adj, "plane"),
    "slab_arc_fwd": (slabk.slab_arc_fwd, "arc"),
    "slab_arc_adj": (slabk.slab_arc_adj, "arc"),
    "slab_arc_jac": (slabk.slab_project_jac, "arc"),
    "slab_plane_fwd_bf16": (slabk.slab_plane_fwd_bf16, "plane"),
    "slab_plane_adj_bf16": (slabk.slab_plane_adj_bf16, "plane"),
    "slab_arc_fwd_bf16": (slabk.slab_arc_fwd_bf16, "arc"),
    "slab_arc_adj_bf16": (slabk.slab_arc_adj_bf16, "arc"),
}
DIGESTS = {
    "slab_plane_fwd":
        "0c51a2f4d986e405472350803eb83b498f54bce573e47ddc4375458605d14cf7",
    "slab_plane_adj":
        "94fb1eb29d04d5eeca2e73d860a9afce2717de8185c5d933d999e4f7244cd4d9",
    "slab_arc_fwd":
        "e7119bebf6ed2f95395c200b86c8b1f75616686aa688f390ec9441cc6660a753",
    "slab_arc_adj":
        "f2d8e89d91adb65ac1980bf9f10cfebc8e49fda21047b8425436c1ec24e22f3e",
    "slab_arc_jac":
        "049049102df4df93d287167b27e0218e40fca45c520ed7f6f6508993911ae7c4",
    "slab_plane_fwd_bf16":
        "95ab780aa9302cc9139e9efef0af7579d5c07248b4404841dec0387f75fbe324",
    "slab_plane_adj_bf16":
        "d05ad4558fcd8be7fbe83a708aee7e34e600881f253ee2278fc0aefc86e52501",
    "slab_arc_fwd_bf16":
        "09e0599e15e4e577bc3c2d8091ed91927270081c3b82bd7ea4a109f5299fc279",
    "slab_arc_adj_bf16":
        "9088266a7c018a64236f03577ce3ea41adfe1936ac7cb27373cf80bc35b46e9a",
    "resample_fwd":
        "25957d0d28ea6bff8a4631588531ffce938f28db7c05271b6060fdab0bb5a0f1",
    "resample_transpose":
        "8d58db298bd2018063800566dbc1d39897c7aded01aaf3aed134be25a86d4480",
    "ray_fwd":
        "b27e10cb7e4f45e61f551b2066ee0b6af984f317602a8c1c6fa418ddca7f101a",
    "ray_adj":
        "1c9ed344aef86a9fd44a097457d000abb54ae2a40f2ee66840c41bda14d9d1ae",
    "ray_jac":
        "2af98b79e9e8bc6505789e538988ef66245d0be0c92caa5f3df4a4835b8e7174",
}


def _sha(*outs):
    h = hashlib.sha256()
    for out in outs:
        h.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _digests(device):
    """Each entry of DIGESTS: the SHA-256 of its outputs on its case."""
    from tomojax_torch.core import projector as rproj
    geom, views, vol, _ = _problem(n=48)
    out = {}
    for entry, (fn, quad) in SLAB_ENTRIES.items():
        gen = np.random.default_rng(21)
        outs = []
        for vol_or, sc in _groups(geom, views, vol, device, quad):
            inp = vol_or
            if "_adj" in entry:
                inp = torch.as_tensor(gen.standard_normal(
                    (sc.shape[0],) + geom.det_shape), dtype=torch.float32,
                    device=device)
            outs.append(fn(inp, sc, geom))
        out[entry] = _sha(*outs)
    rows, off, slope, g = _resample_case(device)
    out["resample_fwd"] = _sha(rs.resample_fwd(rows, off, slope, 130))
    out["resample_transpose"] = _sha(rs.resample_transpose(g, off, slope,
                                                           96))
    geom, rviews, vol, y, rays = _ray_case(device, "odd")
    setup = rproj._ray_setup(geom, *rviews, torch.float32, False, rays)
    out["ray_fwd"] = _sha(rp_kernels.ray_fwd(vol, setup.p0, setup.d_hat,
                                             geom, rays))
    aty = torch.zeros(geom.n_vox, device=device)
    gmap = rp_kernels._adj_launch(y, setup.p0, setup.d_hat, *rviews[:3],
                                  geom, aty, rays)
    out["ray_adj"] = _sha(aty, gmap)
    setup = rproj._ray_setup(geom, *rviews, torch.float32, True)
    out["ray_jac"] = _sha(*rp_kernels.ray_jac(
        vol, setup.p0, setup.d_hat, setup.rpa, setup.der_ang,
        setup.der_dir, geom))
    return out


def test_fp32_kernels_keep_their_bits(cuda):
    """K1-K5, the bf16 tier's K1b-K4b, K7, K8, R1, R2 (its map too) and R3
    give the recorded builds' bits."""
    assert _digests(cuda) == DIGESTS


def test_bf16_wrappers_raise_on_bad_input(cuda):
    """A bf16 entry takes the fp32 operand on the card (its cast is its
    own) and raises on another type; it never runs the plain version."""
    geom, views, vol, _ = _problem(n=32, n_proj=8)
    vol_or, sc = next(_groups(geom, views, vol, cuda))
    with pytest.raises(TypeError):
        slabk.slab_plane_fwd_bf16(vol_or.double(), sc, geom)
    with pytest.raises(TypeError):
        slabk.slab_arc_adj_bf16(vol_or.new_zeros(
            (sc.shape[0],) + geom.det_shape, dtype=torch.bfloat16), sc,
            geom)


def test_bf16_cgls_on_card_tracks_cpu(cuda):
    """CGLS 10 on the bf16 slab_plane operator, card against the CPU's
    plain bf16 versions: the rel-L2 to the phantom within 1e-3."""
    geom, views, vol, _ = _problem(n=32, n_proj=16)
    out = []
    for dev in ("cpu", cuda):
        op = make_operator(geom, views, family="slab_plane", prec="bf16",
                           device=dev)
        x = torch.as_tensor(vol, device=dev)
        r = cgls(op, op.A(x), niter=10, ground_truth=x, reinit_tol=1e-3)
        assert r.stop_reason == 0
        out.append(float(r.rms_error[-1]))
    assert abs(out[0] - out[1]) <= 1e-3


def test_fast_operator_on_card_tracks_cpu(cuda):
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    y = rng.standard_normal((8, geom.n_det))
    out = []
    for dev in ("cpu", cuda):
        op = make_operator(geom, views, family="fast", device=dev)
        out.append((op.A(torch.as_tensor(vol, device=dev)).cpu(),
                    op.AT(torch.as_tensor(y, dtype=torch.float32,
                                          device=dev)).cpu()))
    for cpu, card in zip(*out):
        assert float(torch.linalg.norm(card - cpu)
                     / torch.linalg.norm(cpu)) < 1e-5


def test_gd_fast_on_card_tracks_cpu(cuda):
    geom = Geometry(n_proj=6, vox_shape=(32,) * 3, det_shape=(32, 32))
    rng = np.random.default_rng(0)
    th = np.zeros((6, 6))
    th[:, 3] = np.linspace(0.1, 3.0, 6)
    th[:, [0, 2]] = rng.uniform(-1, 1, (6, 2))
    th[:, [4, 5]] = rng.uniform(-0.01, 0.01, (6, 2))
    vol = torch.as_tensor(phantom.shepp3d(32), dtype=torch.float64)
    meas = fastp.project(vol, geom, Views.from_theta6(torch.as_tensor(th)),
                         dtype=torch.float64)
    th0 = th.copy()
    th0[:, [0, 2]] += 0.3
    th0[:, [4, 5]] = 0.0
    kw = dict(max_iter=4, family="fast")
    cpu = gradient_descent_views(vol, meas, geom, torch.as_tensor(th0),
                                 torch.zeros(6, 3), dtype=torch.float64, **kw)
    before = rs.resample_transpose.launches
    card = gradient_descent_views(vol.float().to(cuda), meas.float().to(cuda),
                                  geom, torch.as_tensor(th0), torch.zeros(6, 3),
                                  **kw)
    assert rs.resample_transpose.launches > before
    err = (card.theta6.cpu().double() - cpu.theta6).abs().max()
    assert float(err) <= 1e-3, err


def test_host_sync_counters_match_the_sync_debug_mode(cuda):
    """Every host sync that CUDA's sync debug mode finds in a CGLS init and
    pair, one CC view, one slab LM step and the exact ray family's SIRT,
    LM step and hook reprojection is one the program counts
    (``host_sync.*``): 6 row copies in the init, the guard and 6 in the
    pair (3 orientation groups), none in the view; in the LM step (3
    groups) the mask, 3 row copies, 3 solves, 4 scalar builds' 3 host
    constants each and 4 swap permutations; on the ray family 3 host
    copies an apply (6 applies and the stop rule in a SIRT solve of 2
    iterations; the mask, 3 applies, the active views and the solve in an
    LM step; 3 chunks of the reprojection)."""
    want = {"cgls_init": 6, "cgls_pair": 7, "cc_view": 0, "lm_step": 47,
            "ray_sirt": 19, "ray_lm_step": 12, "ray_hook": 9}
    for name, fn in trace_cost.census_jobs(64, 32, cuda).items():
        sites, counters = trace_cost.sync_census(fn)
        assert sum(sites.values()) == sum(counters.values()), (
            name, sites, counters)
        if name in want:
            assert sum(counters.values()) == want[name], (name, counters)


def test_a_span_on_the_card_times_its_work(cuda):
    """A span given the card's device reads the device seconds of the work
    inside it (CUDA events at its two ends): above 0, within the host's
    wall around it, and near the same work timed by events alone."""
    from tomojax_torch.utils import profiling
    x = torch.randn(2048, 2048, device=cuda)

    def work():
        y = x
        for _ in range(20):
            y = (y @ x) * 1e-3
        return y

    ms = profiling.cuda_ms(work, 3)
    profiling.reset()
    torch.cuda.synchronize()
    try:
        with profiling.tracing():
            t0 = time.perf_counter()
            with profiling.span("work", cuda):
                work()
            with profiling.span("host"):
                pass
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, _ = profiling.records()
    finally:
        profiling.reset()
    dev_s = spans[0].device_s
    assert spans[1].device_s is None
    assert 0.0 < dev_s <= wall
    assert 0.5 * ms * 1e-3 < dev_s < 2.0 * ms * 1e-3


def test_kernel_times_leave_out_the_programs_spans(cuda, tmp_path):
    """Under the profiler the program's spans are annotations with device
    ranges over their kernels; the kernel table counts each kernel once:
    no span name in it, and its total within the traced wall."""
    from tomojax_torch.recon.cgls import cgls_init, cgls_steps
    from tomojax_torch.utils import profiling
    geom, views, vol, _ = _problem()
    op = make_operator(geom, views, family="slab_plane", device=cuda)
    b = op.A(torch.as_tensor(vol, device=cuda))
    state = cgls_init(op, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        cgls_steps(op, b, state, nsteps=2, niter=3)
    wall_us = 1e6 * (time.perf_counter() - t0)
    kt = profiling.kernel_times(prof)
    assert any("fwd_kernel" in k for k in kt)
    assert not [k for k in kt if k.split(".")[0] in ("op", "cgls",
                                                      "kernel")]
    assert sum(kt.values()) < wall_us


def test_cc_chain_on_card_tracks_cpu(cuda):
    """float32 on the card against float32 on the CPU: each offset within
    one upsampled step (a near-tie of the upsampled correlation may pick a
    neighbouring grid point)."""
    u = 20
    img = torch.as_tensor(phantom.shepp3d(64)[:, 32, :], dtype=torch.float64)
    rng = np.random.default_rng(0)
    s = torch.as_tensor(rng.uniform(-3, 3, (12, 2)))
    stack = cc.fourier_shift(img.expand(12, -1, -1), -s).float()
    cpu, _ = cc.cross_correlation_chain(stack, upsample_factor=u)
    card, aligned = cc.cross_correlation_chain(stack.to(cuda),
                                               upsample_factor=u)
    assert card.device.type == aligned.device.type == cuda.type
    assert aligned.shape == stack.shape
    assert float((card.cpu() - cpu).abs().max()) <= 1.0 / u + 1e-4


@pytest.mark.parametrize("solver", ["fista_tv", "tikhonov", "lasso"])
def test_regularized_solvers_on_card_track_cpu(cuda, solver):
    geom, views, vol, _ = _problem(n=32, n_proj=16)
    runs, lips = [], []
    for dev in ("cpu", cuda):
        op = make_operator(geom, views, family="slab_plane", device=dev)
        b = op.A(torch.as_tensor(vol, device=dev))
        if solver == "fista_tv":
            # each device estimates its own step, from the same start
            lips.append(float(estimate_lipschitz(op)))
            res = fista_tv(op, b, niter=8, hyper=None, beta_tv=0.5)
        elif solver == "tikhonov":
            res = tikhonov_gd(op, b, niter=8, reg_param=0.5,
                              positivity=True)
        else:
            res = lasso_fista(op, b, niter=8, reg_param=0.05)
        runs.append(res)
    cpu, card = runs
    if lips:
        assert abs(lips[1] - lips[0]) <= 1e-4 * lips[0], lips
    assert card.n_iter == cpu.n_iter and card.stop_reason == cpu.stop_reason
    rel = float(torch.linalg.norm(card.x.cpu() - cpu.x)
                / torch.linalg.norm(cpu.x))
    assert rel <= 1e-4, rel


def test_align_to_reprojection_on_card_tracks_cpu(cuda):
    """Out-of-fold (4 folds), 2 rounds at 32³ × 16 views: the card's t
    within one upsampled step per round of the CPU's."""
    n, n_proj, u, rounds = 32, 16, 20, 2
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    rng = np.random.default_rng(1)
    phi = np.linspace(0, np.pi, n_proj, endpoint=False)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-1.5, 1.5, (n_proj, 2))
    meas = make_operator(geom, Views.create(n_proj, phi=phi, t=t),
                         family="slab_plane", device="cpu").A(
        torch.as_tensor(phantom.shepp3d(n)))
    out = []
    for dev in ("cpu", cuda):
        views, sh = cc.align_to_reprojection(
            meas.to(dev), geom, Views.create(n_proj, phi=phi, device=dev),
            rounds=rounds, recon_iters=10, upsample_factor=u, folds=4)
        out.append(views.t.cpu())
    assert float((out[1] - out[0]).abs().max()) <= rounds / u + 1e-4


def test_ray_operator_on_card_tracks_cpu_float64(cuda):
    """The ray family's float32 A and Aᵀ on the card against float64 on the
    CPU, and its adjoint identity on the card."""
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    y = rng.standard_normal((8, geom.n_det))
    ref = make_operator(geom, views, dtype=torch.float64, device="cpu")
    op = make_operator(geom, views, device=cuda)
    assert op.family == "ray" and op.device.type == cuda.type
    x = torch.as_tensor(vol)
    ax = op.A(x.to(cuda))
    aty = op.AT(torch.as_tensor(y, dtype=torch.float32, device=cuda))
    rx = ref.A(x.double())
    rty = ref.AT(torch.as_tensor(y))
    rel_a = (torch.linalg.norm(ax.cpu().double() - rx, dim=1)
             / torch.linalg.norm(rx, dim=1))
    assert float(rel_a.max()) <= 1e-5, rel_a
    assert float(torch.linalg.norm(aty.cpu().double() - rty)
                 / torch.linalg.norm(rty)) <= 1e-5
    lhs = torch.dot(ax.double().reshape(-1),
                    torch.as_tensor(y, device=cuda).reshape(-1))
    rhs = torch.dot(x.double().to(cuda).reshape(-1),
                    aty.double().reshape(-1))
    scale = (torch.linalg.norm(ax.double())
             * float(np.linalg.norm(y)))
    assert float(abs(lhs - rhs) / scale) <= 1e-5


def _ray_case(device, case):
    """``(geom, views (phi, alpha, beta, t, cor), vol, y, rays)`` on the
    card. ``cell``: c1.flagship's shape, 64³ × 90 views of 64² over [0, π]
    with ``cli simulate``'s jitter (tx, tz ±2 px, α, β ±1°). ``odd``: a
    non-cubic volume, a non-square detector wider than it (rays that miss
    the volume), step 0.7, shifts ±6 px. ``block``: one view of ``odd``'s
    geometry at step 1.3, over a block of detector rays."""
    rng = np.random.default_rng({"cell": 0, "odd": 1, "block": 2}[case])
    if case == "cell":
        n_proj, shift = 90, 2.0
        geom = Geometry(n_proj=n_proj, vox_shape=(64,) * 3,
                        det_shape=(64, 64))
        phi = np.linspace(0.0, np.pi, n_proj)
        vol = phantom.shepp3d(64)
        rays = slice(None)
    else:
        n_proj, shift = (7, 6.0) if case == "odd" else (1, 3.0)
        geom = Geometry(n_proj=n_proj, vox_shape=(33, 40, 27),
                        det_shape=(45, 31),
                        step_size=0.7 if case == "odd" else 1.3)
        phi = rng.uniform(0.0, 2 * np.pi, n_proj)
        vol = rng.random(geom.vox_shape, np.float32)
        rays = slice(None) if case == "odd" else slice(200, 1100)
    amax = np.deg2rad(1.0)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-shift, shift, (n_proj, 2))
    views = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (phi, rng.uniform(-amax, amax, n_proj),
                            rng.uniform(-amax, amax, n_proj), t,
                            np.zeros((n_proj, 3))))
    _, R = rp_kernels.ray_block(geom, rays)
    y = torch.as_tensor(rng.standard_normal((n_proj, R)),
                        dtype=torch.float32, device=device)
    return geom, views, torch.as_tensor(vol, device=device), y, rays


@pytest.mark.parametrize("case", ["cell", "odd", "block"])
def test_ray_kernels_match_plain_repeat_and_transpose(cuda, case):
    """R1 and R2 against the plain march on the card, in float32: A per
    view and Aᵀ within 1e-6 relative L2 (R2 against the march's float32
    samples and weights summed in float64: the march's own float atomics
    sit near 1e-6), the adjoint identity within 1e-6, two R2 applies
    bit-identical (a gather, no atomics), R2's map its plain version's
    (``gather_map``), float64 refused."""
    from tomojax_torch.core import projector as rproj
    geom, views, vol, y, rays = _ray_case(cuda, case)
    before = (rp_kernels.ray_fwd.launches, rp_kernels.ray_adj.launches)
    ax = rproj.forward_views(vol, geom, *views, rays=rays)
    aty = rproj.backproject_views(y, geom.vox_shape, geom, *views,
                                  rays=rays)
    assert (rp_kernels.ray_fwd.launches, rp_kernels.ray_adj.launches) == (
        before[0] + 1, before[1] + 1)
    ref = rproj.forward_views_plain(vol, geom, *views, rays=rays)
    setup = rproj._ray_setup(geom, *views, torch.float32, False, rays)
    ref_t = rproj._march_adjoint(
        y.double(), setup, geom, torch.float32,
        torch.zeros(geom.n_vox, dtype=torch.float64, device=cuda))
    rel_a = (torch.linalg.norm(ax.double() - ref.double(), dim=1)
             / torch.linalg.norm(ref.double(), dim=1))
    assert float(rel_a.max()) <= 1e-6, rel_a.max()
    rel_t = float(torch.linalg.norm(aty.double().reshape(-1) - ref_t)
                  / torch.linalg.norm(ref_t))
    assert rel_t <= 1e-6, rel_t
    lhs = torch.dot(ax.double().reshape(-1), y.double().reshape(-1))
    rhs = torch.dot(vol.double().reshape(-1), aty.double().reshape(-1))
    scale = torch.linalg.norm(ax.double()) * torch.linalg.norm(y.double())
    assert float(abs(lhs - rhs) / scale) <= 1e-6
    again = rproj.backproject_views(y, geom.vox_shape, geom, *views,
                                    rays=rays)
    assert torch.equal(again, aty)
    gmap = rp_kernels._adj_launch(y, setup.p0, setup.d_hat, *views[:3], geom,
                                  torch.zeros(geom.n_vox, device=cuda), rays)
    want = rp_kernels.gather_map(setup.p0, setup.d_hat, *views[:3], geom,
                                 rays)
    assert torch.allclose(gmap, want, rtol=1e-6, atol=1e-6), (
        (gmap - want).abs().max())
    with pytest.raises(TypeError, match="float32"):
        rproj.forward_views(vol.double(), geom, *views, rays=rays,
                            dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        rproj.backproject_views(y.double(), geom.vox_shape, geom, *views,
                                rays=rays, dtype=torch.float64)


def _jac_case(device, n, n_proj):
    """Config 1's views at ``n``³ × ``n_proj`` of ``n``² on the card:
    over [0, π] with ``cli simulate``'s jitter (α, β ±1°, tx, tz ±2 px) and
    a nonzero centre-of-rotation shift; the Shepp-Logan phantom."""
    rng = np.random.default_rng(n * 1000 + n_proj)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    amax = np.deg2rad(1.0)
    t = np.zeros((n_proj, 3))
    t[:, [0, 2]] = rng.uniform(-2.0, 2.0, (n_proj, 2))
    cor = np.zeros((n_proj, 3))
    cor[:, 0] = rng.uniform(-0.5, 0.5, n_proj)
    views = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (np.linspace(0.0, np.pi, n_proj),
                            rng.uniform(-amax, amax, n_proj),
                            rng.uniform(-amax, amax, n_proj), t, cor))
    return geom, views, torch.as_tensor(phantom.shepp3d(n), device=device)


def _per_view_rel(x, ref):
    """Relative L2 distance of each view's rows (its det, or its whole
    Jacobian) from the reference's."""
    x, ref = x.double().flatten(1), ref.double().flatten(1)
    return torch.linalg.norm(x - ref, dim=1) / torch.linalg.norm(ref, dim=1)


# R3 against the float64 plain march, per view, at most this factor times
# the float32 plain march's distance from it: both take the same float32
# samples, whose rounding makes most of the distance (a sample within
# float32 rounding of a cell boundary takes the other cell's slope); R3
# sums the steps and the epilogue in double where the plain march sums in
# float32 (its emulation on the CPU read at most 1.06×)
R3_FACTOR = 1.5


@pytest.mark.parametrize("n_proj", [1, 26, 32, 90])
@pytest.mark.parametrize("n", [16, 64])
def test_ray_jac_tracks_float64_as_the_plain_march(cuda, n, n_proj):
    """R3 (``forward_views_jac`` on the card) against the float64 plain
    march: per view, its det and its Jacobian no further than
    :data:`R3_FACTOR` times the float32 plain march's distance; its det
    R1's output to the bit; one launch of R3 and none of R1."""
    from tomojax_torch.core import projector as rproj
    geom, views, vol = _jac_case(cuda, n, n_proj)
    before = (rp_kernels.ray_jac.launches, rp_kernels.ray_fwd.launches)
    det, jac = rproj.forward_views_jac(vol, geom, *views)
    assert (rp_kernels.ray_jac.launches, rp_kernels.ray_fwd.launches) == (
        before[0] + 1, before[1])
    assert jac.shape == (n_proj, 6, geom.n_det) and jac.dtype == torch.float32
    assert torch.equal(det, rproj.forward_views(vol, geom, *views))
    d64, j64 = rproj.forward_views_jac_plain(
        vol.double(), geom, *(a.double() for a in views),
        dtype=torch.float64)
    d32, j32 = rproj.forward_views_jac_plain(vol, geom, *views)
    for name, x, x32, ref in (("det", det, d32, d64), ("jac", jac, j32, j64)):
        e, e32 = _per_view_rel(x, ref), _per_view_rel(x32, ref)
        worst = int(torch.argmax(e / e32.clamp_min(1e-30)))
        assert bool((e <= R3_FACTOR * e32 + 1e-9).all()), (
            name, worst, float(e[worst]), float(e32[worst]))


def test_ray_jac_edge_cases(cuda):
    """Samples on integer coordinates (φ = 0 and π/2, no jitter: x and z
    land on the lattice, so in-bounds corners of weight 0 carry the
    gradient) and a detector wider than the volume (rays that miss it):
    R3 within 1e-5 of the float32 plain march per view (the same samples),
    zero on every missing ray, its det R1's to the bit."""
    from tomojax_torch.core import projector as rproj
    geom = Geometry(n_proj=2, vox_shape=(16,) * 3, det_shape=(24, 20))
    zero = torch.zeros(2, device=cuda)
    views = (torch.tensor([0.0, np.pi / 2], device=cuda), zero, zero,
             torch.zeros((2, 3), device=cuda), torch.zeros((2, 3),
                                                            device=cuda))
    vol = torch.as_tensor(phantom.shepp3d(16), device=cuda)
    det, jac = rproj.forward_views_jac(vol, geom, *views)
    d32, j32 = rproj.forward_views_jac_plain(vol, geom, *views)
    assert float(_per_view_rel(jac, j32).max()) <= 1e-5
    assert float(_per_view_rel(det, d32).max()) <= 1e-5
    assert torch.equal(det, rproj.forward_views(vol, geom, *views))
    miss = j32.abs().sum(1) == 0
    assert int(miss.sum()) > 0
    assert bool((jac.abs().sum(1)[miss] == 0).all())
    assert bool((det[miss] == 0).all())


def test_ray_jac_counts_and_refuses(cuda):
    """Each ``forward_views_jac`` call on the card launches R3 once (an
    exact LM step's Jacobian too); float64 on the card raises, with no
    launch counted and no fallback."""
    from tomojax_torch.align.refine import alignment_costs_grad
    from tomojax_torch.core import projector as rproj
    geom, views, vol = _jac_case(cuda, 16, 5)
    before = rp_kernels.ray_jac.launches
    for _ in range(3):
        rproj.forward_views_jac(vol, geom, *views)
    theta = torch.cat([views[3], torch.stack(views[:3], 1)], 1)
    meas = torch.zeros((5, geom.n_det), device=cuda)
    alignment_costs_grad(vol, meas, geom, theta, views[4])
    assert rp_kernels.ray_jac.launches == before + 4
    with pytest.raises(TypeError, match="float32"):
        rproj.forward_views_jac(vol.double(), geom,
                                *(a.double() for a in views),
                                dtype=torch.float64)
    assert rp_kernels.ray_jac.launches == before + 4


def test_sirt_on_the_ray_operator_launches_the_kernels(cuda):
    """A short SIRT through ``make_operator`` on the card launches R1 and
    R2 once for each apply: the two sums, then one of each an
    iteration."""
    from tomojax_torch.recon import sirt
    geom, views, vol, _ = _problem(n=32, n_proj=12)
    op = make_operator(geom, views, device=cuda)
    assert op.family == "ray"
    b = op.A(torch.as_tensor(vol, device=cuda))
    before = (rp_kernels.ray_fwd.launches, rp_kernels.ray_adj.launches)
    res = sirt(op, b, niter=4, positivity=True)
    after = (rp_kernels.ray_fwd.launches, rp_kernels.ray_adj.launches)
    assert res.n_iter >= 1
    assert after == (before[0] + 1 + res.n_iter, before[1] + 1 + res.n_iter)


def _exact_problem(n=32, n_proj=12, seed=0):
    """Noise-free ray-family data of jittered views over [0.2, π + 0.2),
    float64, and starts ±0.3 px off with zero tilts."""
    rng = np.random.default_rng(seed)
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    th = np.zeros((n_proj, 6))
    th[:, 3] = 0.2 + np.linspace(0, np.pi, n_proj, endpoint=False)
    th[:, [0, 2]] = rng.uniform(-1, 1, (n_proj, 2))
    th[:, [4, 5]] = rng.uniform(-0.01, 0.01, (n_proj, 2))
    vol = torch.as_tensor(phantom.shepp3d(n), dtype=torch.float64)
    meas = make_operator(geom, Views.from_theta6(torch.as_tensor(th)),
                         dtype=torch.float64, device="cpu").A(vol)
    th0 = th.copy()
    th0[:, [0, 2]] += rng.uniform(-0.3, 0.3, (n_proj, 2))
    th0[:, [4, 5]] = 0.0
    return geom, vol, meas, th0


def test_exact_lm_on_card_tracks_cpu_float64(cuda):
    """The exact-family box LM (``refine_method="lm"``) in float32 on the
    card against float64 on the CPU: translations within 1e-3 px, tilts
    within 1e-5 rad."""
    geom, vol, meas, th0 = _exact_problem()
    views = Views.from_theta6(torch.as_tensor(th0))
    box = np.array([3.0, 3.0, 3.0, np.inf, 0.02, 0.02])
    kw = dict(lower=th0 - box, upper=th0 + box, max_iter=12)
    cpu = refine_views(vol, meas, geom, views, dtype=torch.float64, **kw)
    card = refine_views(vol.float().to(cuda), meas.float().to(cuda), geom,
                        views, **kw)
    assert card.theta6.device.type == "cuda"
    err = (card.theta6.cpu().double() - cpu.theta6).abs().max(0).values
    assert float(err[[0, 2]].max()) <= 1e-3, err
    assert float(err[[4, 5]].max()) <= 1e-5, err


def test_align_cv_outer_on_card_tracks_cpu(cuda):
    """One outer of ``align_reconstruct_cv`` (K = 3, arc CGLS on K3/K4,
    slab LM on K5, the moment hook) in float32 on the card against
    float64 on the CPU: θ within 1e-3 (px and rad), the volume within 1e-4
    relative."""
    geom, vol, meas, th0 = _exact_problem(n_proj=12)
    views = Views.from_theta6(torch.as_tensor(th0))
    kw = dict(outer_iters=1, recon_iters=8, refine_iters=4, folds=3)
    cpu = align_reconstruct_cv(meas, geom, views, dtype=torch.float64,
                               device="cpu", **kw)
    before = slabk.slab_project_jac.launches
    card = align_reconstruct_cv(meas.float().to(cuda), geom, views, **kw)
    assert slabk.slab_project_jac.launches > before
    err = (card.views.theta6().cpu().double() - cpu.views.theta6()).abs()
    assert float(err.max()) <= 1e-3, err.max(0)
    rel = (torch.linalg.norm(card.volume.cpu().double() - cpu.volume)
           / torch.linalg.norm(cpu.volume))
    assert float(rel) <= 1e-4, rel


def test_voxel_operator_on_card_tracks_cpu_float64(cuda):
    """The voxel family's float32 A and Aᵀ on the card (the splat's
    ``index_add_`` in float atomics) against float64 on the CPU, and its
    adjoint identity on the card."""
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    y = rng.standard_normal((8, geom.n_det))
    ref = make_operator(geom, views, family="voxel", dtype=torch.float64,
                        device="cpu")
    op = make_operator(geom, views, family="voxel", device=cuda)
    x = torch.as_tensor(vol)
    ax = op.A(x.to(cuda))
    aty = op.AT(torch.as_tensor(y, dtype=torch.float32, device=cuda))
    rx = ref.A(x.double())
    rty = ref.AT(torch.as_tensor(y))
    rel_a = (torch.linalg.norm(ax.cpu().double() - rx, dim=1)
             / torch.linalg.norm(rx, dim=1))
    assert float(rel_a.max()) <= 1e-5, rel_a
    assert float(torch.linalg.norm(aty.cpu().double() - rty)
                 / torch.linalg.norm(rty)) <= 1e-5
    lhs = torch.dot(ax.double().reshape(-1),
                    torch.as_tensor(y, device=cuda).reshape(-1))
    rhs = torch.dot(x.double().to(cuda).reshape(-1),
                    aty.double().reshape(-1))
    scale = torch.linalg.norm(ax.double()) * float(np.linalg.norm(y))
    assert float(abs(lhs - rhs) / scale) <= 1e-5


@pytest.fixture
def nccl_world_of_one(cuda, tmp_path):
    """A process group of one rank over NCCL (one card cannot hold two
    NCCL ranks; the multi-rank paths are held over gloo on the CPU)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    yield dist
    dist.destroy_process_group()


def test_sharded_operators_in_a_nccl_world_of_one(nccl_world_of_one):
    """Over NCCL in a world of one: the angle-sharded slab_plane and ray
    operators equal the unsharded ones to the bit (the ray Aᵀ is R2's
    gather, with no atomics); the volume-sharded slab
    (plane and arc) and voxel operators agree within 1e-5."""
    from tomojax_torch.dist import (make_mesh, make_sharded_operator,
                                    make_volume_sharded_operator,
                                    make_volume_sharded_slab_operator)
    cuda = torch.device("cuda")
    geom, views, vol, rng = _problem(n=32, n_proj=8)
    geom = Geometry(n_proj=8, vox_shape=(32,) * 3, det_shape=(32, 32))
    x = torch.as_tensor(vol, device=cuda)
    y = torch.as_tensor(rng.standard_normal((8, geom.n_det)),
                        dtype=torch.float32, device=cuda)
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.initialized

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    for fam in ("slab_plane", "ray"):
        op = make_operator(geom, views, family=fam, device=cuda)
        ops = make_sharded_operator(geom, views, mesh, family=fam,
                                    device=cuda)
        assert torch.equal(ops.A(x), op.A(x))
        assert torch.equal(ops.AT(y), op.AT(y))
    for quad, fam in (("plane", "slab_plane"), ("arc", "slab")):
        op = make_operator(geom, views, family=fam, device=cuda)
        ops = make_volume_sharded_slab_operator(geom, views, mesh, quad=quad,
                                                halo=16, device=cuda)
        assert rel(ops.A(x), op.A(x)) <= 1e-5
        assert rel(ops.AT(y), op.AT(y)) <= 1e-5
    op = make_operator(geom, views, family="voxel", device=cuda)
    ops = make_volume_sharded_operator(geom, views, mesh, device=cuda)
    assert rel(ops.A(x), op.A(x)) <= 1e-5
    assert rel(ops.AT(y), op.AT(y)) <= 1e-5

"""The CUDA kernels K1-K5 against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so on the card it runs without the JAX conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerances are tomojax's own bars for its TPU kernel
(tests/test_slab_kernel.py): 5e-4 relative per view forward and for the
adjoint, 2e-3 per view for the Jacobian building blocks; the adjoint
identity holds to float32 summation rounding (1e-5).
"""

import numpy as np
import pytest
import torch

from tomojax_torch.align.slab_refine import refine_views_slab
from tomojax_torch.core import phantom
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.kernels import slab as slabk
from tomojax_torch.recon import cgls

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
    gstruct, scalars = sp.scalar_groups(geom, views, device=cuda)
    y = sp.project_scalars(x, geom, gstruct, scalars)
    g = torch.as_tensor(rng.standard_normal(y.shape), dtype=torch.float32,
                        device=cuda)
    before = slabk.slab_plane_adj.launches
    (gx,) = torch.autograd.grad(y, x, g)
    assert slabk.slab_plane_adj.launches == before + len(gstruct)
    ref = sp.backproject_scalars(g, geom, gstruct, scalars)
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
        op = make_operator(geom, views, device=dev)
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

"""The plain reference agrees with the program's plain path at 16³: the
plane operator in both tiers, CGLS, and the chain's registration and
shift (float64 against the program's float32)."""

import importlib

import numpy as np
import pytest
import torch

from benchmark.inputs.phantom import shepp3d
from benchmark.inputs.views import jittered
from benchmark.reference import cc as ref_cc
from benchmark.reference import cgls as ref_cgls
from benchmark.reference.compare import rel
from benchmark.reference.plane import PlaneOperator
from tomojax_torch.core import phantom
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import make_operator

cc = importlib.import_module("tomojax_torch.align.cc")
cgls_mod = importlib.import_module("tomojax_torch.recon.cgls")
N, V = 16, 20
CFG = {"vox_shape": [N] * 3, "det_shape": [N, N], "n_proj": V,
       "phi_end_deg": 180.0, "shift_px": 2.0}
CPU = torch.device("cpu")


def _pair(tier, seed=4):
    phi, t = jittered(CFG, seed)
    geom = Geometry(n_proj=V, vox_shape=(N,) * 3, det_shape=(N, N))
    prog = make_operator(geom, Views.create(V, phi=phi, t=t),
                         family="slab_plane",
                         prec="bf16" if tier == "bf16" else "f32x2",
                         device="cpu")
    return prog, PlaneOperator(CFG, phi, t, CPU, tier)


def test_the_device_phantom_is_the_program_phantom():
    assert torch.equal(shepp3d((N,) * 3, CPU),
                       torch.as_tensor(phantom.shepp3d(N)))


@pytest.mark.parametrize("tier, fwd_tol, adj_tol",
                         [("f32", 2e-6, 5e-6), ("bf16", 2e-6, 3e-4)])
def test_plane_operator_matches_the_plain_path(tier, fwd_tol, adj_tol):
    prog, ref = _pair(tier)
    vol = shepp3d((N,) * 3, CPU)
    g = torch.randn(V, N, N, generator=torch.Generator().manual_seed(3))
    assert rel(prog.A(vol), ref.A(vol).reshape(V, -1)) < fwd_tol
    assert rel(prog.AT(g.reshape(V, -1)), ref.AT(g)) < adj_tol


def test_reference_adjoint_identity():
    _, ref = _pair("f32")
    x = torch.rand(N, N, N, generator=torch.Generator().manual_seed(1))
    y = torch.randn(V, N, N, generator=torch.Generator().manual_seed(2))
    lhs = float((ref.A(x).double() * y.double()).sum())
    rhs = float((x.double() * ref.AT(y).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_cgls_matches_the_program():
    prog, ref = _pair("f32")
    b = ref.A(shepp3d((N,) * 3, CPU)).reshape(V, -1)
    x = cgls_mod.cgls(prog, b, niter=6).x
    assert rel(x, ref_cgls.solve(ref.A, ref.AT, b, 6)) < 1e-5


def test_registration_and_shift_match_the_program():
    rng = np.random.default_rng(5)
    img = torch.as_tensor(rng.random((6, 32, 32)))
    shifts = torch.as_tensor(rng.uniform(-3, 3, (6, 2)))
    moved = ref_cc.fourier_shift(img, shifts)
    got = cc.phase_cross_correlation(img.float(), moved.float(),
                                     upsample_factor=20)
    want = ref_cc.register(img, moved, 20)
    assert torch.allclose(got.double(), want, atol=0.051)
    # the registration recovers the shift to its grid (1/u) and noise
    assert torch.allclose(want, -shifts, atol=1.5 / 20)
    assert torch.allclose(cc.fourier_shift(img, shifts), moved, atol=1e-12)
    off, aligned = cc.cross_correlation_chain(moved.float(),
                                              upsample_factor=20)
    roff, raligned = ref_cc.chain(moved, 20)
    assert torch.allclose(off.double(), roff, atol=0.051)
    assert rel(aligned, raligned) < 1e-3

"""The bf16 bulk tier of the slab family (``prec="bf16"``) on the CPU: the
plain bf16 versions of K1b-K4b against tomojax's contract, their rounding
points, and the tier through the driver and ``cli align``.

One problem (tomojax compiles per shape): 16³ Shepp phantom, 12 views over
the full circle (every orientation group it gives), small jitter, a
cotangent from ``default_rng(1)``; plane and arc, float32 and float64.

Why tolerances and not bits against tomojax: tomojax's bf16 tier exists
only in its Pallas kernel; on the CPU its operators take the XLA path,
which ignores the tier (``scripts/tpu_kernel_check.py:88-89``,
``tomojax/core/slab_projector.py:938-953``), so tomojax's CPU result is
its fp32 operator. The bars are the tier's contract on tomojax's hardware
(``scripts/tpu_kernel_check.py:85-141``): each apply within 3e-3 relative
of the fp32 operator, and the A/Aᵀ mismatch |⟨Ax, y⟩ − ⟨x, Aᵀy⟩| /
max(|⟨Ax, y⟩|, 1) within 5e-3 on a standard-normal cotangent y. One draw
of that ratio divides by ⟨Ax, y⟩, itself a normal sum around 0, so a
single draw reads large whatever the pair: on tomojax's own gate problem
and seed (``tools/bf16_gate.py``) the plain bf16 forward with the exact
fp32 adjoint reads 6.9e-3. The bar is held on the ratio's numerator and
denominator pooled over 32 standard-normal cotangents, and on the
non-negative |y|, where ⟨Ax, |y|⟩ is far from 0. The bits are pinned where
they are defined: with the table's rounding off, the bf16 path on
bf16-exact operands is the fp32 path to the bit.
"""

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.align import pipeline as jpipe
from tomojax.core import geometry as jgeo
from tomojax.core import phantom as jph
from tomojax.core import slab_projector as jsp

from tomojax_torch import cli as tcli
from tomojax_torch.align import pipeline as tpipe
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.kernels import slab as tslabk
from tomojax_torch.tools import bf16_gate
from tomojax_torch.utils import interop

torch.set_num_threads(1)

F64 = torch.float64
N, N_PROJ = 16, 12
TOL_CONTRACT = 3e-3     # each apply against the fp32 operator
TOL_MISMATCH = 5e-3     # |<Ax,y> - <x,A^T y>| / |<Ax,y>|
DRAWS = 32              # cotangents pooled for the mismatch
MIN_ROUNDED = 1e-6      # the bf16 result moved off the fp32 one
QUADS = ("plane", "arc")
DTYPES = (torch.float32, torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    jv = jgeo.Views.create(
        N_PROJ, phi=0.3 + np.linspace(0, 2 * np.pi, N_PROJ, endpoint=False),
        alpha=rng.uniform(-0.01, 0.01, N_PROJ),
        beta=rng.uniform(-0.01, 0.01, N_PROJ),
        t=rng.uniform(-1, 1, (N_PROJ, 3)), dtype=jnp.float64)
    vol = jph.shepp3d(N).astype(np.float64)
    y = np.random.default_rng(1).standard_normal((N_PROJ, N * N))
    return dict(jg=jg, jv=jv, tg=interop.geometry(dataclasses.asdict(jg)),
                tv=interop.views(jax.tree.map(np.asarray, jv)),
                vol=vol, y=y)


@pytest.fixture(scope="module")
def tomojax_f32(prob):
    """tomojax's fp32 XLA path per quadrature: per-view forwards of its
    ``forward_from_scalars_xla`` by orientation group, and
    ``backproject_scalars``."""
    out = {}
    for quad in QUADS:
        jgs, jsc = jsp.scalar_groups(prob["jg"], prob["jv"], quad,
                                     dtype=jnp.float32)
        vol = jnp.asarray(prob["vol"], jnp.float32)
        fwd = []
        for (idx, sw, yf, uf, *_), sc in zip(jgs, jsc):
            vol_or = jsp.orient_volume(vol, prob["jg"], sw, yf)
            fwd.append(np.stack([np.asarray(jsp.forward_from_scalars_xla(
                vol_or, sc[i], prob["jg"], quad)) for i in range(len(idx))]))
        adj = np.asarray(jsp.backproject_scalars(
            jnp.asarray(prob["y"], jnp.float32), prob["jg"], jgs, jsc, quad,
            dtype=jnp.float32))
        out[quad] = dict(fwd=fwd, adj=adj)
    return out


def _groups(prob, quad, dtype):
    """The port's orientation groups: ``(oriented volume, scalars, rows of
    the cotangent, u-flip)`` per group."""
    gs, scs = tsp.scalar_groups(prob["tg"], prob["tv"], quad, dtype=dtype)
    vol = torch.as_tensor(prob["vol"]).to(dtype)
    y = torch.as_tensor(prob["y"]).to(dtype).reshape(N_PROJ, N, N)
    out = []
    for (idx, sw, yf, uf), sc in zip(gs, scs):
        g = y[list(idx)]
        out.append((tsp.orient_volume(vol, prob["tg"], sw, yf).contiguous(),
                    sc, (g.flip(1) if uf else g).contiguous(), uf))
    return gs, out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("quad", QUADS)
def test_forward_within_tomojax_contract(prob, tomojax_f32, quad, dtype):
    """Each view's bf16 forward (K1b/K3b's plain version) within 3e-3 of
    tomojax's fp32 forward, and at least 1e-6 from the port's fp32 one (the
    rounding happened), in every orientation group."""
    gs, groups = _groups(prob, quad, dtype)
    assert len(gs) == 4
    for (vol_or, sc, _, uf), want in zip(groups, tomojax_f32[quad]["fwd"]):
        got = tslabk.slab_project_plain(vol_or, sc, prob["tg"], quad,
                                        prec="bf16")
        f32 = tslabk.slab_project_plain(vol_or, sc, prob["tg"], quad)
        assert got.dtype == dtype
        for v in range(len(sc)):
            assert _rel(got[v], want[v]) <= TOL_CONTRACT
            assert _rel(got[v], f32[v]) >= MIN_ROUNDED


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("quad", QUADS)
def test_adjoint_within_tomojax_contract(prob, tomojax_f32, quad, dtype):
    """The bf16 adjoint (K2b/K4b's plain version) of the seeded cotangent
    over all groups within 3e-3 of tomojax's fp32 ``backproject_scalars``
    and at least 1e-6 from the port's fp32 adjoint; ``backproject_scalars``
    with ``prec="bf16"`` is that sum."""
    gs, scs = tsp.scalar_groups(prob["tg"], prob["tv"], quad, dtype=dtype)
    y = torch.as_tensor(prob["y"]).to(dtype)
    got = tsp.backproject_scalars(y, prob["tg"], gs, scs, quad, dtype,
                                  prec="bf16")
    f32 = tsp.backproject_scalars(y, prob["tg"], gs, scs, quad, dtype)
    assert _rel(got, tomojax_f32[quad]["adj"]) <= TOL_CONTRACT
    assert _rel(got, f32) >= MIN_ROUNDED
    _, groups = _groups(prob, quad, dtype)
    by_group = sum(tsp.unorient_volume(tslabk.slab_backproject_plain(
        g, sc, prob["tg"], quad, prec="bf16"), sw, yf)
        for (_, sc, g, _), (_, sw, yf, _) in zip(groups, gs))
    assert _rel(got, by_group) <= 1e-12


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("quad", QUADS)
def test_bf16_pair_mismatch(prob, quad, dtype):
    """The bf16 pair's mismatch per group on the phantom, within 5e-3:
    tomojax's |<Ax, y> - <x, A^T y>| and |<Ax, y>| each pooled (root mean
    square) over 32 standard-normal cotangents, and the plain ratio on the
    non-negative cotangent |y|."""
    _, groups = _groups(prob, quad, dtype)
    rng = np.random.default_rng(2)
    for vol_or, sc, g, _ in groups:
        ax = tslabk.slab_project_plain(vol_or, sc, prob["tg"], quad,
                                       prec="bf16")

        def adj(y):
            return tslabk.slab_backproject_plain(y, sc, prob["tg"], quad,
                                                 prec="bf16")

        pooled = bf16_gate.pooled_mismatch(ax, vol_or, adj, tuple(g.shape),
                                           rng, DRAWS)
        assert pooled["pooled"] <= TOL_MISMATCH
        assert bf16_gate.mismatch(ax, g.abs(), vol_or, adj(g.abs())) \
            <= TOL_MISMATCH


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("quad", QUADS)
def test_rounding_points(prob, quad, dtype):
    """The plain bf16 versions are the two-pass path with the operand
    rounded and the table hook rounding (``bf16_round`` forward,
    ``round_cotangent`` adjoint), to the bit; on a bf16-exact volume
    (cotangent) that path with no table hook is the fp32 one to the bit,
    so the operand is the only other rounding point. With the hook it
    differs."""
    _, groups = _groups(prob, quad, dtype)
    geom = prob["tg"]
    for vol_or, sc, g, _ in groups:
        vol_b, g_b = tsp.bf16_round(vol_or), tsp.bf16_round(g)
        on = tsp.forward_oriented(vol_b, sc, geom, quad,
                                  table_hook=tsp.bf16_round)
        assert torch.equal(on, tslabk.slab_project_plain(
            vol_or, sc, geom, quad, prec="bf16"))
        f32 = tslabk.slab_project_plain(vol_b, sc, geom, quad)
        assert torch.equal(tsp.forward_oriented(vol_b, sc, geom, quad), f32)
        assert not torch.equal(on, f32)
        on = tsp.adjoint_oriented(g_b, sc, geom, quad,
                                  table_hook=tsp.round_cotangent)
        assert torch.equal(on, tslabk.slab_backproject_plain(
            g, sc, geom, quad, prec="bf16"))
        f32 = tslabk.slab_backproject_plain(g_b, sc, geom, quad)
        assert torch.equal(tsp.adjoint_oriented(g_b, sc, geom, quad), f32)
        assert not torch.equal(on, f32)


@pytest.mark.parametrize("quad", QUADS)
def test_rounding_flips_are_one_ulp(prob, quad):
    """The adjoint's table rounding run in float32 and in float64: a few
    rounded values differ (an fp32 difference across a rounding
    midpoint), most of them by one bf16 ulp, and they move the bf16
    adjoint by more than the fp32 difference moves the fp32 one."""
    _, groups = _groups(prob, quad, torch.float32)
    _, sc, g, _ = groups[0]
    r = bf16_gate.rounding_flips(g, sc, prob["tg"], quad)
    assert 0 < r["flips"] < 0.01
    assert r["one_ulp"] > 0.5
    assert r["gap"] > r["delta"] > 0


def test_tomojax_gate_problem(capsys):
    """``tools/bf16_gate`` on tomojax's gate problem at 16³ on the CPU's
    plain versions: each group's bf16 forward within 3e-3 of the fp32 one,
    the pooled mismatch within 5e-3, the fp32 pair's single-draw mismatch
    within 1e-5; the printed record holds every group's single draw."""
    rec = bf16_gate.main(["--size", "16", "--device", "cpu", "--draws",
                          "16"])
    assert len(rec["groups"]) == 8
    assert rec["worst_fwd_rel"] <= TOL_CONTRACT
    assert rec["worst_pooled"] <= TOL_MISMATCH
    assert max(r["fp32"] for r in rec["groups"]) <= 1e-5
    out = capsys.readouterr().out
    assert out.count("[bf16 ") == 8 and "worst A/At mismatch" in out


def test_tier_dispatch_on_the_cpu(prob, monkeypatch):
    """``resolve_prec`` returns the tier and reads ``TOMOJAX_SLAB_PREC``;
    the kernel entries, the autograd pair and the operators run the plain
    bf16 versions on CPU tensors; the Jacobian blocks have no tier."""
    monkeypatch.delenv("TOMOJAX_SLAB_PREC", raising=False)
    assert tslabk.resolve_prec("bf16") == "bf16"
    monkeypatch.setenv("TOMOJAX_SLAB_PREC", "bf16")
    assert tslabk.resolve_prec() == "bf16"
    monkeypatch.delenv("TOMOJAX_SLAB_PREC")
    with pytest.raises(ValueError, match="recon_prec"):
        tslabk.resolve_prec("fp8", name="recon_prec")
    gs, groups = _groups(prob, "arc", F64)
    vol_or, sc, g, _ = groups[0]
    geom = prob["tg"]
    want = tslabk.slab_project_plain(vol_or, sc, geom, "arc", prec="bf16")
    assert torch.equal(tslabk.slab_project(vol_or, sc, geom, "arc",
                                           prec="bf16"), want)
    assert torch.equal(tslabk.slab_arc_fwd_bf16(vol_or, sc, geom), want)
    x = vol_or.clone().requires_grad_(True)
    out = tslabk.SlabArc.apply(x, sc, geom, "bf16")
    assert torch.equal(out.detach(), want)
    (grad,) = torch.autograd.grad(out, x, g)
    assert torch.equal(grad, tslabk.slab_backproject_plain(
        g, sc, geom, "arc", prec="bf16"))
    with pytest.raises(ValueError, match="no bf16 tier"):
        tslabk.slab_project(vol_or, sc, geom, "arc", "x", prec="bf16")
    op = tpipe.make_operator(geom, prob["tv"], family="slab_plane",
                             dtype=F64, device="cpu", prec="bf16")
    assert op.prec == "bf16"
    x = torch.as_tensor(prob["vol"])
    assert torch.equal(op.A(x), tsp.project(x, geom, prob["tv"], dtype=F64,
                                            quad="plane", prec="bf16"))


def test_resolve_reinit_tol_is_tomojax():
    for args in ((None, "bf16"), (None, "f32x2"), (0.5, "bf16")):
        assert tpipe._resolve_reinit_tol(*args) == \
            jpipe._resolve_reinit_tol(*args)


@pytest.fixture(scope="module")
def align_prob():
    """16³, 12 views over [0, π] with tx, tz in ±1 px
    (``default_rng(5)``), arc data, from zero jitter."""
    rng = np.random.default_rng(5)
    n, n_proj = N, N_PROJ
    geom = Geometry(n_proj=n_proj, vox_shape=(n,) * 3, det_shape=(n, n))
    phi = np.linspace(0, np.pi, n_proj)
    t = np.zeros((n_proj, 3))
    t[:, 0] = rng.uniform(-1.0, 1.0, n_proj)
    t[:, 2] = rng.uniform(-1.0, 1.0, n_proj)
    vol = torch.as_tensor(jph.shepp3d(n).astype(np.float64))
    true = Views.create(n_proj, phi=phi, t=t, dtype=F64)
    proj = tsp.project(vol, geom, true, dtype=F64, quad="arc")
    return dict(geom=geom, vol=vol, proj=proj,
                views0=Views.create(n_proj, phi=phi, dtype=F64))


def _spied_align(monkeypatch, prob, family, recon_prec):
    """Run the driver for 2 outers with every slab kernel entry spied:
    returns ``(state, spy)``; ``spy`` holds the recon operators' tiers,
    the tier of every slab apply inside and outside them, the K5 calls and
    each CGLS chunk's ``(reinit_tol, stop)``."""
    spy = {"ops": [], "recon": [], "other": [], "jac": 0, "cgls": []}
    inside = [False]
    for table in (tslabk._FWD, tslabk._ADJ):
        for key, fn in list(table.items()):
            def wrapped(*a, _fn=fn, _prec=key[1]):
                spy["recon" if inside[0] else "other"].append(_prec)
                return _fn(*a)
            monkeypatch.setitem(table, key, wrapped)
    jac = tslabk.slab_project_jac

    def jac_spy(*a):
        spy["jac"] += 1
        return jac(*a)
    monkeypatch.setattr(tslabk, "slab_project_jac", jac_spy)
    ofs = tpipe.operator_from_scalars

    def recon_op(*a, **k):
        op = ofs(*a, **k)
        spy["ops"].append(op.prec)

        def inside_recon(f):
            def g(x):
                inside[0] = True
                try:
                    return f(x)
                finally:
                    inside[0] = False
            return g
        return dataclasses.replace(op, A=inside_recon(op.A),
                                   AT=inside_recon(op.AT))
    monkeypatch.setattr(tpipe, "operator_from_scalars", recon_op)
    steps = tpipe.cgls_steps

    def cgls_spy(*a, **k):
        out = steps(*a, **k)
        spy["cgls"].append((k["reinit_tol"], out[0].stop))
        return out
    monkeypatch.setattr(tpipe, "cgls_steps", cgls_spy)
    state = tpipe.align_reconstruct(
        prob["proj"], prob["geom"], prob["views0"], outer_iters=2,
        recon="cgls", recon_iters=4, refine_iters=3, family=family,
        refine_method="lm_slab", moment_period=1, debias_period=1,
        recon_prec=recon_prec, ground_truth=prob["vol"], dtype=F64,
        device="cpu")
    return state, spy


@pytest.mark.parametrize("family", ["slab", "slab_plane"])
def test_align_recon_stage_in_bf16(monkeypatch, align_prob, family):
    """``align_reconstruct(recon_prec="bf16")``: the recon stage's
    operators and every apply inside them are bf16; refinement (K5 and its
    forward), the debias stage and the moment hook stay f32x2; CGLS gets
    the tier's guard slack 1e-3 and never ends on the double-reinit quit;
    the final rel-L2 lies within 2% of the port's own f32x2 run.

    Four CGLS iterations per outer keep the solve before its
    semi-convergence turn on misaligned views: past it (6 iterations
    here) CGLS amplifies the data's inconsistency, the iterate turns
    sensitive to any 1e-3 change of the operator, and the bf16 run ends
    ~3% below the fp32 one (fp32 against float64 stays at 1e-4)."""
    state, spy = _spied_align(monkeypatch, align_prob, family, "bf16")
    assert spy["ops"] and set(spy["ops"]) == {"bf16"}
    assert spy["recon"] and set(spy["recon"]) == {"bf16"}
    assert spy["other"] and set(spy["other"]) == {"f32x2"}
    assert spy["jac"] > 0
    assert spy["cgls"] and all(c == (1e-3, 0) for c in spy["cgls"])
    monkeypatch.undo()
    ref, spy32 = _spied_align(monkeypatch, align_prob, family, "f32x2")
    assert set(spy32["recon"]) == {"f32x2"}
    assert all(c == (0.0, 0) for c in spy32["cgls"])
    got, want = state.history["recon_rms"][-1], ref.history["recon_rms"][-1]
    assert abs(got - want) <= 0.02 * want
    assert got != want


def test_cli_align_recon_prec_bf16(tmp_path, monkeypatch):
    """``cli align --recon-prec bf16`` on a small simulated dataset: the
    recon stage's operators are bf16, the volume finite."""
    data, out = tmp_path / "d.npz", tmp_path / "v.npy"
    common = ["--size", "16", "--views", "8", "--device", "cpu"]
    tcli.main(["simulate", *common, "--set", "simulate.family=slab",
               "--set", "simulate.max_angle_deg=0", "-o", str(data)])
    tiers = []
    ofs = tpipe.operator_from_scalars

    def recon_op(*a, **k):
        op = ofs(*a, **k)
        tiers.append(op.prec)
        return op
    monkeypatch.setattr(tpipe, "operator_from_scalars", recon_op)
    with contextlib.redirect_stdout(io.StringIO()):
        r = tcli.main(["align", *common, "-i", str(data), "-o", str(out),
                       "--recon-prec", "bf16",
                       "--set", "align.family=slab",
                       "--set", "align.refine_method=lm_slab",
                       "--set", "align.recon=cgls",
                       "--set", "align.recon_iters=4",
                       "--set", "align.refine_iters=2",
                       "--set", "align.outer_iters=2"])
    assert tiers == ["bf16", "bf16"]
    assert len(r["theta_per_outer"]) == 2
    x = np.load(out)
    assert x.shape == (16, 16, 16) and np.isfinite(x).all()

"""The port's resample kernels' plain versions (K7, K8, the K9 entry)
against tomojax's, on the CPU.

tomojax's Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them) and its XLA path directly. Bars: the forward to 2e-5 in float32
against the Pallas kernel (the JAX kernel's own bar against its XLA path)
and 1e-12 in float64 against the XLA path. The transpose to 5e-5 in
float32: positions reach ~700, whose float32 spacing is 6e-5, and tomojax's
windowed decomposition rounds the lerp weights differently from the direct
lerp. Offset and slope cotangents to 1e-10 in float64 against ``jax.grad``
of the XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax.core.fast_projector import _resample_minor
from tomojax.kernels.resample import (resample_rows_pallas,
                                      resample_rows_transpose)

from tomojax_torch.kernels import resample as rs

torch.set_num_threads(1)

# tests/test_kernels.py's cases, plus a negative slope with |slope| < 1
CASES = [
    (32, 256, 256, 1.03, 1.2),
    (16, 256, 512, 1.45, 1.6),
    (16, 128, 128, -1.02, 1.2),
    (8, 128, 512, 1.55, 1.6),
    (24, 256, 256, 0.72, 1.2),
    (16, 128, 256, -0.55, 1.2),
]


def _inputs(A, N, M, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((A, N)), rng.uniform(-N * 0.5, N * 1.3, (A,)),
            rng.random((A, M)))


def _t(a, dtype):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("A,N,M,slope,ms", CASES)
def test_forward_matches_pallas_and_xla(A, N, M, slope, ms):
    arr, off, _ = _inputs(A, N, M)
    a32, o32 = arr.astype(np.float32), off.astype(np.float32)
    want = np.asarray(resample_rows_pallas(
        jnp.asarray(a32), jnp.asarray(o32), jnp.asarray(slope, jnp.float32),
        M, ms, interpret=True))
    got = rs.resample_rows(_t(a32, torch.float32)[None],
                           _t(o32, torch.float32)[None],
                           torch.tensor([slope]), M, ms)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    want = np.asarray(_resample_minor(
        jnp.asarray(arr)[:, None, :], jnp.asarray(off)[:, None],
        jnp.asarray(slope, jnp.float64), M, ms)).reshape(A, M)
    got = rs.resample_rows(_t(arr, torch.float64)[None],
                           _t(off, torch.float64)[None],
                           torch.tensor([slope], dtype=torch.float64), M, ms)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("A,N,M,slope,ms", CASES)
def test_transpose_matches_pallas(A, N, M, slope, ms):
    _, off, g = _inputs(A, N, M)
    o32, g32 = off.astype(np.float32), g.astype(np.float32)
    want = np.asarray(resample_rows_transpose(
        jnp.asarray(g32), jnp.asarray(o32), jnp.asarray(slope, jnp.float32),
        N, ms, interpret=True))
    got = rs.resample_rows_transpose(_t(g32, torch.float32)[None],
                                     _t(o32, torch.float32)[None],
                                     torch.tensor([slope]), N, ms)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("slope", [1.04, -0.83])
def test_cotangents_match_jax_grad(slope):
    A, N, M, ms = 12, 64, 96, 1.2
    arr, _, g = _inputs(A, N, M, seed=1)
    off = np.random.default_rng(2).uniform(-10, 60, (A,))

    def loss(a, o, s):
        out = _resample_minor(a[:, None, :], o[:, None], s, M, ms)
        return jnp.vdot(out.reshape(A, M), jnp.asarray(g))

    want = [np.asarray(w) for w in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(arr), jnp.asarray(off), jnp.asarray(slope))]
    a = _t(arr, torch.float64)[None].requires_grad_(True)
    o = _t(off, torch.float64)[None].requires_grad_(True)
    s = torch.tensor([slope], dtype=torch.float64, requires_grad=True)
    out = rs.resample_rows(a, o, s, M, ms)
    ga, go, gs = torch.autograd.grad((out * _t(g, torch.float64)).sum(),
                                     (a, o, s))
    np.testing.assert_allclose(ga[0].numpy(), want[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(go[0].numpy(), want[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(float(gs[0]), float(want[2]), rtol=1e-10)


def test_constant_offsets_get_no_cotangent(monkeypatch):
    """Where only the rows ask for a gradient (the solver's adjoint, or a
    θ-gradient's constant volume), the backward is the transpose alone: no
    position cotangent is taken."""
    def refuse(*a, **k):
        raise AssertionError("position cotangents taken without need")

    monkeypatch.setattr(rs, "position_cotangents", refuse)
    arr, off, g = _inputs(8, 64, 64)
    a = _t(arr, torch.float64)[None].requires_grad_(True)
    o = _t(off, torch.float64)[None]
    out = rs.resample_rows(a, o, torch.tensor([1.1], dtype=torch.float64),
                           64, 1.2)
    (ga,) = torch.autograd.grad((out * _t(g, torch.float64)).sum(), (a,))
    np.testing.assert_array_equal(
        ga.numpy(), rs.resample_rows_transpose(
            _t(g, torch.float64)[None], o,
            torch.tensor([1.1], dtype=torch.float64), 64, 1.2).numpy())


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nonfinite_offsets_give_zero_rows(bad):
    A, N, M, ms = 8, 128, 128, 1.2
    arr, off, g = _inputs(A, N, M)
    off = off.astype(np.float32)
    off[[1, 5]] = bad
    a32 = arr.astype(np.float32)
    want = np.asarray(resample_rows_pallas(
        jnp.asarray(a32), jnp.asarray(off), jnp.asarray(1.1, jnp.float32), M,
        ms, interpret=True))
    got = rs.resample_rows(_t(a32, torch.float32)[None],
                           _t(off, torch.float32)[None],
                           torch.tensor([1.1]), M, ms)[0].numpy()
    assert np.all(got[[1, 5]] == 0.0) and np.all(want[[1, 5]] == 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    back = rs.resample_rows_transpose(_t(g, torch.float32)[None],
                                      _t(off, torch.float32)[None],
                                      torch.tensor([1.1]), N, ms)[0].numpy()
    assert np.all(back[[1, 5]] == 0.0) and np.isfinite(back).all()


def test_nonfinite_slope_is_clamped():
    arr, off, _ = _inputs(4, 128, 128)
    a, o = _t(arr, torch.float64)[None], _t(off, torch.float64)[None]
    got = rs.resample_rows(a, o, torch.tensor([np.nan], dtype=torch.float64),
                           128, 1.2)
    want = rs.resample_rows(a, o, torch.tensor([1.2], dtype=torch.float64),
                            128, 1.2)
    assert torch.equal(got, want)


def test_strided_rows_and_view_batches():
    """A volume shared by every view (stride 0) and two row axes give what
    the materialized rows give, one slope per view."""
    rng = np.random.default_rng(3)
    vol = torch.as_tensor(rng.random((6, 5, 32)))
    off = torch.as_tensor(rng.uniform(-5, 30, (3, 6, 5)))
    slope = torch.tensor([0.9, -1.1, 1.3], dtype=torch.float64)
    got = rs.resample_rows(vol.expand(3, 6, 5, 32), off, slope, 40, 1.4)
    for v in range(3):
        one = rs.resample_rows(vol.reshape(1, 30, 32).clone(),
                               off[v].reshape(1, 30), slope[v:v + 1], 40, 1.4)
        assert torch.equal(got[v].reshape(30, 40), one[0])


def test_raw_entry_and_cpu_launch_counts():
    """On the CPU every entry takes the plain version and no kernel
    launch is counted; the raw (K9) entry equals the forward on sane
    inputs."""
    arr, off, g = _inputs(8, 64, 80)
    a, o = _t(arr, torch.float32)[None], _t(off, torch.float32)[None]
    s = torch.tensor([1.05])
    counts = (rs.resample_fwd.launches, rs.resample_transpose.launches,
              rs.resample_rows_raw.launches)
    assert torch.equal(rs.resample_rows_raw(a, o, s, 80),
                       rs.resample_fwd(a, o, s, 80))
    assert torch.equal(rs.resample_fwd(a, o, s, 80),
                       rs.resample_rows_plain(a, o, s, 80))
    gt = _t(g, torch.float32)[None]
    assert torch.equal(rs.resample_transpose(gt, o, s, 64),
                       rs.resample_rows_transpose_plain(gt, o, s, 64))
    assert counts == (rs.resample_fwd.launches,
                      rs.resample_transpose.launches,
                      rs.resample_rows_raw.launches)


def _k8_window(off, slope, n, m, run=4):
    """K8's candidate window (``tap_window`` in ``csrc/resample.cu``) for
    the run of ``run`` outputs that holds each output n, in float32, one
    rounding per operation as the card rounds each: the reciprocal once
    per view, then multiplies. → (lo, hi), each (rows, n)."""
    f32 = torch.float32
    a, b = off.to(f32)[:, None], torch.tensor(slope, dtype=f32)
    c0 = (torch.arange(n) // run * run).to(f32)[None, :]
    c1 = c0 + (run - 1)
    inv_b = 1.0 / b
    slack = ((2.0 * a.abs() + b.abs() * m + torch.maximum(c0.abs(), c1.abs())
              + 2.0) * 4.8e-7 * inv_b.abs())
    t0, t1 = (c0 - 1.0 - a) * inv_b, (c1 + 1.0 - a) * inv_b
    tl = torch.clamp(torch.minimum(t0, t1) - slack, -2.0, m + 1.0)
    th = torch.clamp(torch.maximum(t0, t1) + slack, -2.0, m + 1.0)
    return torch.ceil(tl).long().clamp(min=0), \
        torch.floor(th).long().clamp(max=m - 1)


@pytest.mark.parametrize("slope", [1e-7, -1e-7, 3e-8, 1e-3, -1e-3, 0.93,
                                   -1.02, 1.2, -1.6])
def test_k8_reciprocal_window_holds_every_k7_tap(slope):
    """Every (i, n) where K7's float32 tap of output i lands on element n
    lies in K8's window for the run of n, for offsets over and past the row
    and a few ulps off integers (where the floor is decided by the last
    bit)."""
    R, N, M = 256, 48, 96
    rng = np.random.default_rng(21)
    base = rng.uniform(-N * 0.5, N * 1.3, R).astype(np.float32)
    base[: R // 2] = np.round(base[: R // 2])
    ulps = rng.integers(-4, 5, R).astype(np.float32)
    off = torch.as_tensor(base + ulps * np.spacing(base))
    pos = rs._positions(off[None], torch.tensor([slope]), M)[0]   # (R, M)
    kf = torch.floor(pos)
    lo, hi = _k8_window(off, slope, N, M)                          # (R, N)
    i = torch.arange(M).expand(R, M)
    checked = 0
    for tap in (kf, kf + 1):
        ok = (tap >= 0) & (tap <= N - 1)
        r, ii = torch.nonzero(ok, as_tuple=True)
        n = tap[r, ii].long()
        assert bool(((lo[r, n] <= i[r, ii]) & (i[r, ii] <= hi[r, n])).all())
        checked += r.numel()
    assert checked > R


@pytest.mark.parametrize("nonzero", [False, True])
def test_plain_transpose_view_sum_and_accumulate(nonzero):
    """The plain K8 with ``add_into`` is the per-view vjp summed over the
    views and added to what the tensor held (zeros or not), which it
    returns."""
    rng = np.random.default_rng(22)
    V, R1, R2, N, M = 5, 3, 4, 20, 26
    g = torch.as_tensor(rng.standard_normal((V, R1, R2, M)))
    off = torch.as_tensor(rng.uniform(-4, N + 4, (V, R1, R2)))
    sl = torch.as_tensor(rng.uniform(0.6, 1.5, V))
    base = torch.as_tensor(rng.standard_normal((R2, R1, N))).transpose(0, 1)
    if not nonzero:
        base = torch.zeros_like(base)
    acc = base.clone()
    got = rs.resample_transpose(g, off, sl, N, add_into=acc)
    want = sum(rs.resample_rows_transpose_plain(g[v:v + 1], off[v:v + 1],
                                                sl[v:v + 1], N)[0]
               for v in range(V))
    assert got is acc
    torch.testing.assert_close(acc, want + base, rtol=0, atol=1e-12)

"""tomojax's default calls, keywords and names in the port, held to tomojax
on the CPU in float64.

One problem throughout (tomojax compiles per shape): 16³, 12 views with φ
over [0.2, π + 0.2), small jitter, a white-noise volume and cotangent, all
from ``default_rng(0)``.

- The slab family's default calls (``quad="arc"`` in both packages):
  ``project``, ``backproject``, ``scalar_groups`` + ``project_scalars`` /
  ``backproject_scalars`` and ``group_scalars_for``, to 1e-10 relative.
- Each tomojax keyword the port accepts: against the port's call without
  it, and against tomojax's call with it (1e-10; ``interpret`` against
  tomojax's Pallas interpret mode in float32 to 5e-5, the bar of
  ``tests/test_torch_resample.py``). ``views_chunk=5`` (not a divisor of
  12) leaves a forward equal and an adjoint within 1e-12.
- The names the port now has: the slab ``forward_view``,
  ``slab_scalars_np``, ``SlabParams``/``slab_params``, ``Views.view`` and
  ``fast_projector.swap_flags`` (equal, over the full circle and next to
  ``|ED_x| = |ED_y|``), ``native.AVAILABLE``, ``kernels.slab.NS`` and the
  scalar columns, ``resolve_prec``'s three outcomes and
  ``make_mesh(devices=)`` in a world of one.
"""

import dataclasses
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax import native as jnative
from tomojax.core import fast_projector as jfp
from tomojax.core import geometry as jgeo
from tomojax.core import projector as jray
from tomojax.core import slab_projector as jsp
from tomojax.kernels import resample as jres
from tomojax.kernels import slab as jslabk
from tomojax.utils import roofline as jroof

from tomojax_torch import dist as tdist
from tomojax_torch import native as tnative
from tomojax_torch.core import fast_projector as tfp
from tomojax_torch.core import projector as tray
from tomojax_torch.core import slab_projector as tsp
from tomojax_torch.kernels import resample as tres
from tomojax_torch.kernels import slab as tslabk
from tomojax_torch.utils import interop
from tomojax_torch.utils import roofline as troof

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-10          # against tomojax
TOL_CHUNK = 1e-12    # an adjoint summed in other chunks
N, N_PROJ = 16, 12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    jg = jgeo.Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    phi = 0.2 + np.linspace(0.0, np.pi, N_PROJ, endpoint=False)
    jv = jgeo.Views.create(
        N_PROJ, phi=phi, alpha=rng.uniform(-0.02, 0.02, N_PROJ),
        beta=rng.uniform(-0.02, 0.02, N_PROJ),
        t=rng.uniform(-1.0, 1.0, (N_PROJ, 3)), dtype=jnp.float64)
    vol = rng.standard_normal((N,) * 3)
    y = rng.standard_normal((N_PROJ, N * N))
    return dict(jg=jg, jv=jv, tg=interop.geometry(dataclasses.asdict(jg)),
                tv=interop.views(jax.tree.map(np.asarray, jv)), vol=vol,
                y=y, x=torch.as_tensor(vol), yt=torch.as_tensor(y))


# ---- the slab family's default calls -------------------------------------


def test_default_project_is_tomojax_default(prob):
    want = jsp.project(jnp.asarray(prob["vol"]), prob["jg"], prob["jv"],
                       dtype=jnp.float64)
    got = tsp.project(prob["x"], prob["tg"], prob["tv"], dtype=F64)
    assert _rel(got, want) <= TOL
    # and that default is the arc quadrature
    assert torch.equal(got, tsp.project(prob["x"], prob["tg"], prob["tv"],
                                        dtype=F64, quad="arc"))


def test_default_backproject_is_tomojax_default(prob):
    want = jsp.backproject(jnp.asarray(prob["y"]), prob["jg"], prob["jv"],
                           dtype=jnp.float64)
    got = tsp.backproject(prob["yt"], prob["tg"], prob["tv"], dtype=F64)
    assert _rel(got, want) <= TOL


@pytest.fixture(scope="module")
def groups(prob):
    """Both packages' default ``scalar_groups`` in float64."""
    jgs, jsc = jsp.scalar_groups(prob["jg"], prob["jv"], dtype=jnp.float64)
    tgs, tsc = tsp.scalar_groups(prob["tg"], prob["tv"], dtype=F64)
    assert tgs == tuple(g[:4] for g in jgs)
    return jgs, jsc, tgs, tsc


def test_default_scalar_groups_is_tomojax_default(groups):
    _, jsc, _, tsc = groups
    for a, b in zip(tsc, jsc):
        assert _rel(a, b) <= TOL
        # the arc quadrature's scale column is 1 (the plane's is 1/edy)
        assert torch.all(a[:, tsp.S_SCALE] == 1.0)


def test_default_project_scalars_is_tomojax_default(prob, groups):
    jgs, jsc, tgs, tsc = groups
    want = jsp.project_scalars(jnp.asarray(prob["vol"]), prob["jg"], jgs,
                               jsc, dtype=jnp.float64)
    got = tsp.project_scalars(prob["x"], prob["tg"], tgs, tsc, dtype=F64)
    assert _rel(got, want) <= TOL


def test_default_backproject_scalars_is_tomojax_default(prob, groups):
    jgs, jsc, tgs, tsc = groups
    want = jsp.backproject_scalars(jnp.asarray(prob["y"]), prob["jg"], jgs,
                                   jsc, dtype=jnp.float64)
    got = tsp.backproject_scalars(prob["yt"], prob["tg"], tgs, tsc,
                                  dtype=F64)
    assert _rel(got, want) <= TOL


def test_default_group_scalars_for_is_tomojax_default(prob, groups):
    jgs, _, tgs, _ = groups
    _, want = jsp.group_scalars_for(prob["jg"], prob["jv"], jgs,
                                    dtype=jnp.float64)
    _, got = tsp.group_scalars_for(prob["tg"], prob["tv"], tgs, dtype=F64)
    for a, b in zip(got, want):
        assert _rel(a, b) <= TOL


# ---- the slab keywords ----------------------------------------------------


@pytest.mark.parametrize("kw", [{"views_chunk": 5}, {"prec": "f32x2"},
                                {"strict_bounds": False}],
                         ids=["views_chunk", "prec", "strict_bounds"])
def test_slab_project_keywords(prob, kw):
    base = tsp.project(prob["x"], prob["tg"], prob["tv"], dtype=F64)
    got = tsp.project(prob["x"], prob["tg"], prob["tv"], dtype=F64, **kw)
    assert torch.equal(got, base)
    want = jsp.project(jnp.asarray(prob["vol"]), prob["jg"], prob["jv"],
                       dtype=jnp.float64, **kw)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("kw", [{"views_chunk": 5}, {"prec": "f32x2"},
                                {"strict_bounds": False}],
                         ids=["views_chunk", "prec", "strict_bounds"])
def test_slab_backproject_keywords(prob, kw):
    base = tsp.backproject(prob["yt"], prob["tg"], prob["tv"], dtype=F64)
    got = tsp.backproject(prob["yt"], prob["tg"], prob["tv"], dtype=F64,
                          **kw)
    assert _rel(got, base) <= TOL_CHUNK
    want = jsp.backproject(jnp.asarray(prob["y"]), prob["jg"], prob["jv"],
                           dtype=jnp.float64, **kw)
    assert _rel(got, want) <= TOL


def test_scalar_path_keywords_in_tomojax_order(prob, groups):
    """``(quad, dtype, views_chunk, prec)`` positionally, as tomojax takes
    them."""
    jgs, jsc, tgs, tsc = groups
    args = ("arc", F64, 5, "f32x2")
    jargs = ("arc", jnp.float64, 5, "f32x2")
    fwd = tsp.project_scalars(prob["x"], prob["tg"], tgs, tsc, *args)
    assert torch.equal(fwd, tsp.project_scalars(prob["x"], prob["tg"], tgs,
                                                tsc, dtype=F64))
    assert _rel(fwd, jsp.project_scalars(jnp.asarray(prob["vol"]),
                                         prob["jg"], jgs, jsc, *jargs)) <= TOL
    adj = tsp.backproject_scalars(prob["yt"], prob["tg"], tgs, tsc, *args)
    assert _rel(adj, tsp.backproject_scalars(prob["yt"], prob["tg"], tgs,
                                             tsc, dtype=F64)) <= TOL_CHUNK
    assert _rel(adj, jsp.backproject_scalars(jnp.asarray(prob["y"]),
                                             prob["jg"], jgs, jsc,
                                             *jargs)) <= TOL
    # the dtype: float32 in, float64 out
    assert tsp.project_scalars(prob["x"].float(), prob["tg"], tgs, tsc,
                               *args).dtype == F64


def test_scalar_groups_strict_bounds(prob, groups):
    _, jsc, tgs, tsc = groups
    gs, sc = tsp.scalar_groups(prob["tg"], prob["tv"], "arc", F64, True)
    assert gs == tgs
    assert all(torch.equal(a, b) for a, b in zip(sc, tsc))
    _, jsc2 = jsp.scalar_groups(prob["jg"], prob["jv"], "arc", jnp.float64,
                                True)
    for a, b in zip(sc, jsc2):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("swap, yflip, uflip", [(False, False, False),
                                                (True, True, True)])
def test_orient_affine_dtype(swap, yflip, uflip):
    rng = np.random.default_rng(1)
    E, B = rng.standard_normal((3, 3)), rng.standard_normal(3)
    want = jsp.orient_affine(jnp.asarray(E), jnp.asarray(B), N, swap, yflip,
                             jnp.float64, uflip, N + 2)
    got = tsp.orient_affine(torch.as_tensor(E), torch.as_tensor(B), N, swap,
                            yflip, F64, uflip, N + 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f32 = tsp.orient_affine(torch.as_tensor(E), torch.as_tensor(B), N, swap,
                            yflip, torch.float32, uflip, N + 2)
    assert all(a.dtype == torch.float32 for a in f32)


# ---- the fast and ray families' keywords ---------------------------------


def test_fast_views_chunk(prob):
    base = tfp.project(prob["x"], prob["tg"], prob["tv"], dtype=F64)
    got = tfp.project(prob["x"], prob["tg"], prob["tv"], dtype=F64,
                      views_chunk=5)
    assert torch.equal(got, base)
    want = jax.jit(lambda v: jfp.project(v, prob["jg"], prob["jv"],
                                         dtype=jnp.float64, views_chunk=5))(
        jnp.asarray(prob["vol"]))
    assert _rel(got, want) <= TOL
    base = tfp.backproject(prob["yt"], prob["tg"], prob["tv"], dtype=F64)
    got = tfp.backproject(prob["yt"], prob["tg"], prob["tv"], dtype=F64,
                          views_chunk=5)
    assert _rel(got, base) <= TOL_CHUNK
    want = jax.jit(lambda y: jfp.backproject(y, prob["jg"], prob["jv"],
                                             dtype=jnp.float64,
                                             views_chunk=5))(
        jnp.asarray(prob["y"]))
    assert _rel(got, want) <= TOL


def _view(views, i):
    return (views.phi[i], views.alpha[i], views.beta[i], views.t[i],
            views.cor[i])


def test_ray_project_unroll(prob):
    base = tray.project(prob["x"], prob["tg"], prob["tv"], dtype=F64)
    got = tray.project(prob["x"], prob["tg"], prob["tv"], dtype=F64,
                       unroll=2)
    assert torch.equal(got, base)
    want = jray.project(jnp.asarray(prob["vol"]), prob["jg"], prob["jv"],
                        dtype=jnp.float64, unroll=2)
    assert _rel(got, want) <= TOL
    got = tray.backproject(prob["yt"], prob["tg"].vox_shape, prob["tg"],
                           prob["tv"], dtype=F64, unroll=2)
    assert torch.equal(got, tray.backproject(
        prob["yt"], prob["tg"].vox_shape, prob["tg"], prob["tv"],
        dtype=F64))
    want = jray.backproject(jnp.asarray(prob["y"]), prob["jg"].vox_shape,
                            prob["jg"], prob["jv"], dtype=jnp.float64,
                            unroll=2)
    assert _rel(got, want) <= TOL


def test_ray_forward_view_jac_unroll(prob):
    args = (prob["tg"], *_view(prob["tv"], 3))
    base = tray.forward_view_jac(prob["x"], *args, dtype=F64)
    got = tray.forward_view_jac(prob["x"], *args, dtype=F64, unroll=4)
    want = jray.forward_view_jac(jnp.asarray(prob["vol"]), prob["jg"],
                                 *_view(prob["jv"], 3), dtype=jnp.float64,
                                 unroll=4)
    for a, b, w in zip(got, base, want):
        assert torch.equal(a, b)
        assert _rel(a, w) <= TOL


@pytest.mark.parametrize("block", [(None, None), (37, 50), (None, 40),
                                   (240, 40)],
                         ids=["all", "offset", "from0", "clamped"])
def test_ray_view_ray_block(prob, block):
    """``ray_offset``/``ray_count``: the detector rays of a block, the
    offset clamped into the detector as tomojax's ``dynamic_slice`` does;
    with ``unroll`` beside them."""
    off, count = block
    tw, jw = _view(prob["tv"], 5), _view(prob["jv"], 5)
    got = tray.forward_view(prob["x"], prob["tg"], *tw, dtype=F64, unroll=2,
                            ray_offset=off, ray_count=count)
    want = jray.forward_view(jnp.asarray(prob["vol"]), prob["jg"], *jw,
                             dtype=jnp.float64, unroll=2, ray_offset=off,
                             ray_count=count)
    assert got.shape == ((count or N * N),)
    assert _rel(got, want) <= TOL
    if count is None:
        assert torch.equal(got, tray.forward_view(prob["x"], prob["tg"],
                                                  *tw, dtype=F64))
    g = prob["yt"][5, :got.shape[0]]
    got = tray.backproject_view(g, prob["tg"].vox_shape, prob["tg"], *tw,
                                dtype=F64, unroll=2, ray_offset=off,
                                ray_count=count)
    want = jray.backproject_view(jnp.asarray(g.numpy()),
                                 prob["jg"].vox_shape, prob["jg"], *jw,
                                 dtype=jnp.float64, unroll=2,
                                 ray_offset=off, ray_count=count)
    assert _rel(got, want) <= TOL


def test_resample_rows_transpose_interpret():
    """``interpret`` does nothing in the port; tomojax's Pallas interpret
    mode computes the same transpose, held in float32 to 5e-5 as
    ``tests/test_torch_resample.py`` holds K8's plain version to it (the
    Pallas kernel's windowed decomposition rounds its weights otherwise)."""
    rng = np.random.default_rng(2)
    A, n_data, m_out, slope = 6, 128, 100, 0.7   # the Pallas kernel's N
    g = rng.standard_normal((A, m_out)).astype(np.float32)
    off = rng.uniform(-3.0, 60.0, A).astype(np.float32)
    args = (torch.as_tensor(g)[None], torch.as_tensor(off)[None],
            torch.tensor([slope]), n_data, 1.5)
    got = tres.resample_rows_transpose(*args, interpret=True)[0]
    assert torch.equal(got, tres.resample_rows_transpose(*args)[0])
    want = jres.resample_rows_transpose(jnp.asarray(g), jnp.asarray(off),
                                        jnp.asarray(slope, jnp.float32),
                                        n_data, 1.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


# ---- roofline: tomojax's argument order ----------------------------------


def test_roofline_in_tomojax_order(prob):
    tg, jg = prob["tg"], prob["jg"]
    got = troof.roofline(tg, "arc", "f32x2", 1e-3, 2e-3)
    assert got == troof.roofline(tg, "arc", prec="f32x2", t_fwd_s=1e-3,
                                 t_adj_s=2e-3)
    want = jroof.roofline(jg, "arc", "f32x2", 1e-3, 2e-3)
    for d, t in (("fwd", 1e-3), ("adj", 2e-3)):
        assert got[d]["time_s"] == want[d]["time_s"] == t
    kind = "NVIDIA H100 80GB HBM3"
    assert troof.roofline(tg, "arc", "f32x2", 1e-3, 2e-3, N_PROJ,
                          kind) == got
    m = troof.slab_apply_model(tg, "plane", "f32x2", 8)
    assert m == troof.slab_apply_model(tg, "plane", n_views=8)
    assert m["views"] == jroof.slab_apply_model(
        jg, "plane", "f32x2", 8)["config"]["V"] == 8
    # the bf16 tier computes the same function through the same fp32
    # interface: its model and bound are f32x2's
    assert troof.slab_apply_model(tg, "plane", "bf16", 8) == m
    assert troof.slab_bound(tg, "arc", "bf16") == troof.slab_bound(tg, "arc")


def test_device_peaks_by_kind(monkeypatch):
    monkeypatch.delenv("TOMOJAX_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("TOMOJAX_PEAK_BW", raising=False)
    h100 = (troof.H100_F32_FLOPS, troof.H100_HBM_BYTES_PER_S)
    assert troof.device_peaks("NVIDIA H100 80GB HBM3") == h100
    # any other kind takes the default, as tomojax falls back to its own
    assert troof.device_peaks("another card") == h100
    assert troof.device_peaks() == h100
    assert jroof.device_peaks("another card") == jroof.device_peaks()


# ---- the names the port now has ------------------------------------------


@pytest.mark.parametrize("quad", ["arc", "plane"])
def test_slab_forward_view(prob, quad):
    """Every view (all four orientation groups, u-flipped ones too), flags
    from the host, at tomojax's default quadrature and at the plane."""
    kw = {} if quad == "arc" else {"quad": quad}
    flags = tsp.orient_flags(prob["tv"], prob["tg"])
    assert flags[2].any() and not flags[2].all()
    for i in range(N_PROJ):
        got = tsp.forward_view(prob["x"], prob["tg"], *_view(prob["tv"], i),
                               dtype=F64, **kw)
        want = jsp.forward_view(jnp.asarray(prob["vol"]), prob["jg"],
                                *_view(prob["jv"], i), dtype=jnp.float64,
                                **kw)
        assert got.shape == (N * N,)
        assert _rel(got, want) <= TOL, i
    # given flags: the view's own
    sw, yf = bool(flags[0][4]), bool(flags[1][4])
    got = tsp.forward_view(prob["x"], prob["tg"], *_view(prob["tv"], 4),
                           dtype=F64, swap=sw, yflip=yf, **kw)
    want = jsp.forward_view(jnp.asarray(prob["vol"]), prob["jg"],
                            *_view(prob["jv"], 4), dtype=jnp.float64,
                            swap=sw, yflip=yf, **kw)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("quad", ["arc", "plane"])
def test_slab_scalars_np(prob, groups, quad):
    _, _, tgs, _ = groups
    jv = jax.tree.map(np.asarray, prob["jv"])
    for idx, sw, yf, uf in tgs:
        idx = list(idx)
        got = tsp.slab_scalars_np(prob["tg"], prob["tv"].take(idx), sw, yf,
                                  uf, quad)
        want = jsp.slab_scalars_np(prob["jg"],
                                   jax.tree.map(lambda a: a[idx], jv), sw,
                                   yf, uf, quad)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        assert got.shape == (len(idx), tslabk.NS)
        assert _rel(got, want) <= TOL


def test_slab_params(prob):
    rng = np.random.default_rng(3)
    E = rng.standard_normal((3, 3)) + 2 * np.eye(3)
    B = rng.standard_normal(3)
    got = tsp.slab_params(torch.as_tensor(E), torch.as_tensor(B), F64)
    want = jsp.slab_params(jnp.asarray(E), jnp.asarray(B), jnp.float64)
    assert isinstance(got, tsp.SlabParams)
    assert tsp.SlabParams._fields == jsp.SlabParams._fields
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= TOL * max(1.0, abs(float(b)))
    # batched over leading dimensions, row by row the same
    Eb = torch.as_tensor(np.stack([E, E.T]))
    Bb = torch.as_tensor(np.stack([B, -B]))
    batch = tsp.slab_params(Eb, Bb)
    for k, (a, b) in enumerate(zip(batch, got)):
        assert float(a[0]) == float(b), tsp.SlabParams._fields[k]


def test_views_view(prob):
    for i in (0, 7, -1):
        got, want = prob["tv"].view(i), prob["jv"].view(i)
        assert isinstance(got, type(prob["tv"]))
        for f in ("phi", "alpha", "beta", "t", "cor"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))


def test_swap_flags_over_the_full_circle():
    """Equal to tomojax's, on a full circle and on poses within 1e-9 and
    1e-13 rad of the octant boundaries |ED_x| = |ED_y| (with and without
    α), where a second copy of the rule would be most likely to differ."""
    k = np.arange(8) * np.pi / 4 + np.pi / 8
    phi = [np.linspace(0.0, 2 * np.pi, 97)]
    for eps in (0.0, 1e-9, -1e-9, 1e-13, -1e-13):
        phi.append(np.arange(1, 8, 2) * np.pi / 4 + eps)
    phi = np.concatenate(phi + [k])
    rng = np.random.default_rng(4)
    for alpha in (np.zeros_like(phi), rng.uniform(-0.05, 0.05, phi.size)):
        jv = jgeo.Views.create(phi.size, phi=phi, alpha=alpha,
                               beta=rng.uniform(-0.05, 0.05, phi.size),
                               dtype=jnp.float64)
        tv = interop.views(jax.tree.map(np.asarray, jv))
        got, want = tfp.swap_flags(tv), jfp.swap_flags(jv)
        assert got.dtype == np.bool_ and 0 < got.sum() < phi.size
        np.testing.assert_array_equal(got, want)


def test_native_available_follows_is_available():
    """``AVAILABLE`` starts False, as tomojax's, and the first load sets it
    to ``is_available()``."""
    def fresh(module):
        spec = importlib.util.spec_from_file_location(
            f"_fresh_{module.__name__.replace('.', '_')}", module.__file__)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    assert fresh(jnative).AVAILABLE is False
    fresh = fresh(tnative)
    assert fresh.AVAILABLE is False
    ok = fresh.is_available()
    assert fresh.AVAILABLE is ok
    assert tnative.is_available() is tnative.AVAILABLE


def test_kernels_slab_scalar_layout():
    assert tslabk.NS == jslabk.NS
    for name in dir(jslabk):
        if name.startswith("S_"):
            assert getattr(tslabk, name) == getattr(jslabk, name), name


def test_resolve_prec_outcomes(monkeypatch):
    """tomojax's three outcomes: the default tier, the bf16 tier (given or
    read from ``TOMOJAX_SLAB_PREC``, which then reaches the operators), and
    ``ValueError`` for an unknown tier."""
    monkeypatch.delenv("TOMOJAX_SLAB_PREC", raising=False)
    assert tslabk.resolve_prec() == tslabk.resolve_prec("f32x2") == "f32x2"
    assert jslabk.resolve_prec() == "f32x2"
    assert tslabk.resolve_prec("bf16") == jslabk.resolve_prec("bf16")
    with pytest.raises(ValueError):
        tslabk.resolve_prec("fp8")
    with pytest.raises(ValueError):
        jslabk.resolve_prec("fp8")
    geom = interop.geometry(dataclasses.asdict(jgeo.Geometry(
        n_proj=2, vox_shape=(N,) * 3, det_shape=(N, N))))
    views = {"phi": np.array([0.3, 1.2]), "alpha": np.zeros(2),
             "beta": np.zeros(2), "t": np.zeros((2, 3)),
             "cor": np.zeros((2, 3))}
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((N,) * 3))
    bf16 = tsp.project(x, geom, views, dtype=F64, prec="bf16")
    assert not torch.equal(bf16, tsp.project(x, geom, views, dtype=F64))
    # the environment's tier, as tomojax reads it
    monkeypatch.setenv("TOMOJAX_SLAB_PREC", "bf16")
    assert jslabk.resolve_prec() == tslabk.resolve_prec() == "bf16"
    assert torch.equal(tsp.project(x, geom, views, dtype=F64), bf16)


def test_make_mesh_devices_in_a_world_of_one():
    mesh = tdist.make_mesh(devices=[0])
    assert (mesh.n_proj, mesh.n_ray, mesh.index("proj")) == (1, 1, 0)
    assert mesh.members() == [0]
    assert tdist.make_mesh(1, 1, (0,)).shape == tdist.make_mesh().shape
    for bad, match in (([1], "the world has ranks"), ([0, 0], "repeats"),
                       ([], "empty")):
        with pytest.raises(ValueError, match=match):
            tdist.make_mesh(devices=bad)

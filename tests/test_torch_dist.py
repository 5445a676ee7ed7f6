"""``tomojax_torch.dist`` in a gloo world of 4 CPU ranks against the port's
unsharded operators and tomojax's 8-device mesh (the conftest's), all in
float64, on ``tests/test_dist.py``'s problem (16³, 16 views).

One spawn of 4 ranks (``tests/_torch_dist_ranks.py``, which imports no
JAX) computes every sharded operator's A and Aᵀ, CGLS, SIRT and FISTA-TV
on the sharded ray operator and ``sharded_refine_views``, and writes each
rank's results to a file; this process holds them to:

- every rank's results equal rank 0's (the collectives give every rank
  the same bits);
- the port's unsharded operators and single-process runs: 1e-12 for the
  angle-sharded operators, 1e-10 for the volume-sharded ones (at halos 8
  and 6 over z blocks of 8 planes), the solvers and the refinement (sums
  taken in another order), with the adjoint identity across the ranks to
  1e-12;
- tomojax's result on its 8-device mesh (4 × 2) for the ray family over
  views × detector rays and the voxel family over x blocks, to 1e-8, and
  for the volume-sharded slab operator (plane, halo 8) to 2e-6: tomojax
  rounds that operator's scalars to float32 at any dtype, which puts its
  float64 result 2.3e-7 (A) and 8.1e-7 (Aᵀ) from its own unsharded
  operator here; the bound is 16 float32 ulps of 1 (1.9e-6). Each of
  tomojax's sharded programs takes ~30-60 s to compile on XLA:CPU, so the
  others (the angle-sharded fast and slab families, the arc quadrature
  and halo 6, the solvers and the refinement) are held to tomojax through
  the port's unsharded operators and solvers, which their own parity
  files hold to tomojax's.

A second spawn of 4 ranks builds meshes over part of the world on every
rank (``make_mesh(devices=[2, 0])``, ``make_mesh(1, 2, [3, 1])``): the
angle-sharded slab_plane operator, fp32 and bf16, on ranks 2 and 0 and the
volume-sharded plane operator on ranks 3 and 1 equal the port's unsharded
operators of the same tier to 1e-12 in float64; the ranks outside a mesh
get ``ValueError`` from its operators, before any collective.

One card cannot hold two NCCL ranks; the multi-rank paths are held here
over gloo, and a world of one over NCCL in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tomojax import dist as jdist
from tomojax.core import geometry as jgeo

from tests import _torch_dist_ranks as ranks
from tomojax_torch import dist as tdist
from tomojax_torch.align.refine import PARAM_SETS, refine_views
from tomojax_torch.core.geometry import Views
from tomojax_torch.core.operators import make_operator
from tomojax_torch.recon import cgls, fista_tv, sirt

torch.set_num_threads(1)

F64 = torch.float64
WORLD = 4
TOL_EQ = 1e-12      # angle-sharded against unsharded
TOL_VOL = 1e-10     # volume-sharded and solvers against unsharded
TOL_JAX = 1e-8      # against tomojax's mesh
TOL_JAX_F32 = 16 * 2.0 ** -23   # tomojax's float32 slab scalars


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    ranks.spawn(ranks.dist_rank, WORLD, tmp, str(tmp))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def submesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("submesh")
    ranks.spawn(ranks.submesh_rank, WORLD, tmp, str(tmp))
    return [dict(np.load(tmp / f"sub{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def prob():
    vol, geom, views, kw, y = ranks.problem()
    return dict(vol=vol, geom=geom, views=views, kw=kw, y=y,
                x=torch.as_tensor(vol), yt=torch.as_tensor(y))


def _op(prob, family):
    return make_operator(prob["geom"], prob["views"], family=family,
                         dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh(prob):
    """tomojax's ray family sharded over views × detector rays on its
    4 × 2 CPU mesh, float64: ``(A x, Aᵀ y)``."""
    n = prob["geom"].n_proj
    jg = jgeo.Geometry(n_proj=n, vox_shape=prob["geom"].vox_shape,
                       det_shape=prob["geom"].det_shape)
    jv = jgeo.Views.create(n, **prob["kw"], dtype=jnp.float64)
    op = jdist.make_sharded_operator(jg, jv, jdist.make_mesh(4, 2),
                                     dtype=jnp.float64)
    return (np.asarray(op.A(jnp.asarray(prob["vol"]))),
            np.asarray(op.AT(jnp.asarray(prob["y"]))))


@pytest.fixture(scope="module")
def jax_volume(prob):
    """tomojax's volume-sharded operators on its 4 × 2 mesh, float64: the
    slab operator (plane, halo 8) and the voxel operator, each ``(A x,
    Aᵀ y)``."""
    n = prob["geom"].n_proj
    jg = jgeo.Geometry(n_proj=n, vox_shape=prob["geom"].vox_shape,
                       det_shape=prob["geom"].det_shape)
    jv = jgeo.Views.create(n, **prob["kw"], dtype=jnp.float64)
    mesh = jdist.make_mesh(4, 2)
    ops = {"slab_plane": jdist.make_volume_sharded_slab_operator(
               jg, jv, mesh, quad="plane", dtype=jnp.float64, halo=8),
           "voxel": jdist.make_volume_sharded_operator(
               jg, jv, mesh, dtype=jnp.float64)}
    x, y = jnp.asarray(prob["vol"]), jnp.asarray(prob["y"])
    return {k: (np.asarray(op.A(x)), np.asarray(op.AT(y)))
            for k, op in ops.items()}


def test_every_rank_holds_the_same_results(results):
    for r in range(1, WORLD):
        assert results[r].keys() == results[0].keys()
        for k, v in results[0].items():
            np.testing.assert_array_equal(results[r][k], v, err_msg=k)


@pytest.mark.parametrize("name, family", [
    ("ray4x1", "ray"), ("ray2x2", "ray"), ("fast", "fast"),
    ("slab", "slab"), ("slab_plane", "slab_plane")])
def test_angle_sharded_operator(results, prob, name, family):
    """Views over ``proj`` (and for the ray family the detector over
    ``ray``): A and Aᵀ equal the unsharded operator's."""
    res = results[0]
    op = _op(prob, family)
    assert _rel(res[f"{name}_A"], op.A(prob["x"])) <= TOL_EQ
    assert _rel(res[f"{name}_AT"], op.AT(prob["yt"])) <= TOL_EQ


@pytest.mark.parametrize("key", ["ray2x2", "vol_arc_h6"])
def test_mesh_in_another_rank_order(results, key):
    """``make_mesh(2, 2, devices=(3, 1, 0, 2))`` lays the ranks out in that
    order: the ray family over views × rays and the volume-sharded arc
    operator (halo 6) give the rank-order mesh's A and Aᵀ."""
    res = results[0]
    for d in ("A", "AT"):
        assert _rel(res[f"perm_{key}_{d}"], res[f"{key}_{d}"]) <= TOL_EQ


def test_ray_sharding_matches_tomojax_mesh(results, jax_mesh):
    """The ray family over views × detector rays (2 × 2 ranks) against
    tomojax's 4 × 2 mesh."""
    assert _rel(results[0]["ray2x2_A"], jax_mesh[0]) <= TOL_JAX
    assert _rel(results[0]["ray2x2_AT"], jax_mesh[1]) <= TOL_JAX


@pytest.mark.parametrize("halo", ranks.VOL_HALOS)
@pytest.mark.parametrize("quad, family", [("plane", "slab_plane"),
                                          ("arc", "slab")])
def test_volume_sharded_slab_operator(results, prob, quad, family, halo):
    """z blocks of 8 planes with an 8- or 6-plane halo over ``ray``, views
    over ``proj`` (2 × 2): A and Aᵀ equal the unsharded slab operator's,
    and Aᵀ is A's adjoint across the ranks (the halo cotangents sent back;
    at halo 6 into part of the neighbour's block)."""
    res = results[0]
    key = f"vol_{quad}_h{halo}"
    op = _op(prob, family)
    assert _rel(res[f"{key}_A"], op.A(prob["x"])) <= TOL_VOL
    assert _rel(res[f"{key}_AT"], op.AT(prob["yt"])) <= TOL_VOL
    assert abs(res[f"{key}_dot"]) <= TOL_EQ


@pytest.mark.parametrize("family, key, tol", [
    ("slab_plane", "vol_plane_h8", TOL_JAX_F32),
    ("voxel", "voxel", TOL_JAX)])
def test_volume_sharded_operator_matches_tomojax_mesh(results, jax_volume,
                                                      family, key, tol):
    """The volume-sharded slab (plane, halo 8; 2 × 2 ranks) and voxel
    operators against tomojax's on its 4 × 2 mesh."""
    assert _rel(results[0][f"{key}_A"], jax_volume[family][0]) <= tol
    assert _rel(results[0][f"{key}_AT"], jax_volume[family][1]) <= tol


def test_volume_sharded_voxel_operator(results, prob):
    """x blocks of the voxel family over ``ray``, views over ``proj``."""
    res = results[0]
    op = _op(prob, "voxel")
    assert _rel(res["voxel_A"], op.A(prob["x"])) <= TOL_VOL
    assert _rel(res["voxel_AT"], op.AT(prob["yt"])) <= TOL_VOL
    assert abs(res["voxel_dot"]) <= TOL_EQ


@pytest.mark.parametrize("solver", ["cgls", "sirt", "fista"])
def test_solvers_on_the_sharded_operator(results, prob, solver):
    """CGLS (4 × 1), SIRT (2 × 2) and FISTA-TV (4 × 1) run unmodified on
    the sharded ray operator: equal to the single-process run."""
    op = _op(prob, "ray")
    b = op.A(prob["x"])
    if solver == "cgls":
        want = cgls(op, b, niter=10)
        np.testing.assert_allclose(results[0]["cgls_conv"],
                                   want.convergence.numpy(), rtol=TOL_VOL)
    elif solver == "sirt":
        want = sirt(op, b, niter=15, positivity=True)
    else:
        want = fista_tv(op, b, niter=5, hyper=None, beta_tv=0.005,
                        niter_tv=5)
    assert _rel(results[0][f"{solver}_x"], want.x) <= TOL_VOL


def test_sharded_refine_views(results, prob):
    """Each ``proj`` index refines its own views: θ and the costs equal
    ``refine_views`` over all views."""
    op = _op(prob, "ray")
    b = op.A(prob["x"])
    want = refine_views(prob["x"], b, prob["geom"],
                        Views.create(prob["geom"].n_proj, dtype=F64),
                        mask=PARAM_SETS["xz"], max_iter=8, dtype=F64)
    np.testing.assert_allclose(results[0]["refine_theta"],
                               want.theta6.numpy(), rtol=0, atol=TOL_VOL)
    np.testing.assert_allclose(results[0]["refine_cost"],
                               want.cost.numpy(), rtol=TOL_VOL)


@pytest.mark.parametrize("halo", [8, 32])
def test_volume_sharded_slab_frame_in_float64(halo):
    """In a world of one the volume-sharded plane operator differs from the
    unsharded one only by its frame, z moved by the halo: in float64 on
    config 5's views (32³, white noise) A and Aᵀ agree to rounding, so its
    fp32 distance at 512³ (``chip_smoke.py`` 12c) is rounding of z in that
    frame and not an error in the frame's offset."""
    from tomojax_torch.tools import config5
    geom, phi, t, rng = config5.problem(32, 16)
    views = Views.create(16, phi=phi, t=t, dtype=F64)
    x = torch.as_tensor(rng.standard_normal(geom.vox_shape))
    op = make_operator(geom, views, family="slab_plane", dtype=F64,
                       device="cpu")
    ops = tdist.make_volume_sharded_slab_operator(
        geom, views, tdist.make_mesh(), quad="plane", halo=halo, dtype=F64,
        device="cpu")
    y = op.A(x)
    assert _rel(ops.A(x), y) <= TOL_EQ
    assert _rel(ops.AT(y), op.AT(y)) <= TOL_EQ


def test_a_world_of_one_without_a_process_group(prob):
    """Without ``init_process_group`` the mesh is one rank and the sharded
    operators are the unsharded ones; a mesh that does not fit the world
    raises."""
    mesh = tdist.make_mesh()
    assert mesh.size == 1 and not mesh.initialized
    with pytest.raises(ValueError, match="ranks"):
        tdist.make_mesh(2, 1)
    for family in ("ray", "slab_plane"):
        ops = tdist.make_sharded_operator(prob["geom"], prob["views"], mesh,
                                          family=family, dtype=F64,
                                          device="cpu")
        op = _op(prob, family)
        assert torch.equal(ops.A(prob["x"]), op.A(prob["x"]))
        assert _rel(ops.AT(prob["yt"]), op.AT(prob["yt"])) <= TOL_EQ
    with pytest.raises(ValueError, match="'proj' only"):
        tdist.make_sharded_operator(prob["geom"], prob["views"],
                                    tdist.Mesh(1, 2, 0, False, {}),
                                    family="slab", device="cpu")


@pytest.mark.parametrize("name, members, family, kw", [
    ("angle", (2, 0), "slab_plane", {}),
    ("angle_bf16", (2, 0), "slab_plane", {"prec": "bf16"}),
    ("vol", (3, 1), "slab_plane", {})])
def test_mesh_over_part_of_the_world(submesh, prob, name, members, family,
                                     kw):
    """A mesh over part of the 4-rank world (tomojax's device list): the
    members' A and Aᵀ are the same bits on each member and equal the
    unsharded operator of the same tier to 1e-12; every other rank was
    refused with ``ValueError`` and joined no collective."""
    op = make_operator(prob["geom"], prob["views"], family=family,
                       dtype=F64, device="cpu", **kw)
    first = submesh[members[0]]
    assert _rel(first[f"{name}_A"], op.A(prob["x"])) <= TOL_EQ
    assert _rel(first[f"{name}_AT"], op.AT(prob["yt"])) <= TOL_EQ
    for r in range(WORLD):
        if r in members:
            for d in ("A", "AT"):
                np.testing.assert_array_equal(submesh[r][f"{name}_{d}"],
                                              first[f"{name}_{d}"])
        else:
            assert submesh[r][f"{name}_refused"] == 1
            assert f"{name}_A" not in submesh[r]

"""Rank programs of the ``torch.distributed`` tests (gloo on the CPU),
started by ``torch.multiprocessing.spawn`` from the test files. This module
imports no JAX: the ranks run only the port, and hand their results back
through ``.npz`` files; the pytest process compares them with tomojax."""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64
N, N_PROJ = 16, 16
# the volume-sharded slab operator's halos over 2 z blocks of 8 planes: a
# whole block, and 6, the least that holds this problem's z offsets (up to
# 5.06 planes), so each neighbour sends only part of its block
VOL_HALOS = (8, 6)


def problem():
    """``tests/test_dist.py``'s problem in float64: 16³ Shepp, 16 views,
    tx, tz in ±1 px, α, β in ±0.01 rad (``default_rng(0)``), and a random
    cotangent (``default_rng(3)``)."""
    from tomojax_torch.core import phantom
    from tomojax_torch.core.geometry import Geometry, Views
    vol = phantom.shepp3d(N).astype(np.float64)
    geom = Geometry(n_proj=N_PROJ, vox_shape=(N,) * 3, det_shape=(N, N))
    rng = np.random.default_rng(0)
    t = np.zeros((N_PROJ, 3))
    t[:, 0] = rng.uniform(-1, 1, N_PROJ)
    t[:, 2] = rng.uniform(-1, 1, N_PROJ)
    kw = dict(alpha=rng.uniform(-0.01, 0.01, N_PROJ),
              beta=rng.uniform(-0.01, 0.01, N_PROJ), t=t)
    y = np.random.default_rng(3).standard_normal((N_PROJ, N * N))
    return vol, geom, Views.create(N_PROJ, **kw, dtype=F64), kw, y


def _dot(op, x, y):
    """<A x, y> − <x, Aᵀ y>, relative to ‖A x‖ ‖y‖."""
    ax, aty = op.A(x), op.AT(y)
    return float((torch.dot(ax.reshape(-1), y.reshape(-1))
                  - torch.dot(x.reshape(-1), aty.reshape(-1)))
                 / (torch.linalg.norm(ax) * torch.linalg.norm(y)))


def dist_rank(rank, world, store, out_dir):
    """Every sharded operator of ``dist/sharding.py``, the solvers on the
    sharded ray operator and ``sharded_refine_views``; each rank writes its
    results to ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from tomojax_torch.align.refine import PARAM_SETS
    from tomojax_torch.core.geometry import Views
    from tomojax_torch.core.operators import make_operator
    from tomojax_torch.dist import (make_mesh, make_sharded_operator,
                                    make_volume_sharded_operator,
                                    make_volume_sharded_slab_operator,
                                    sharded_refine_views)
    from tomojax_torch.recon import cgls, fista_tv, sirt

    vol, geom, views, _, y = problem()
    x, y = torch.as_tensor(vol), torch.as_tensor(y)
    kw = dict(dtype=F64, device="cpu")
    out = {}
    m41, m22 = make_mesh(4, 1), make_mesh(2, 2)
    for name, mesh in (("ray4x1", m41), ("ray2x2", m22)):
        op = make_sharded_operator(geom, views, mesh, **kw)
        out[f"{name}_A"], out[f"{name}_AT"] = op.A(x), op.AT(y)
    for fam in ("fast", "slab", "slab_plane"):
        op = make_sharded_operator(geom, views, m41, family=fam, **kw)
        out[f"{fam}_A"], out[f"{fam}_AT"] = op.A(x), op.AT(y)
    for quad, halo in itertools.product(("plane", "arc"), VOL_HALOS):
        op = make_volume_sharded_slab_operator(geom, views, m22, quad=quad,
                                               halo=halo, **kw)
        key = f"vol_{quad}_h{halo}"
        out[f"{key}_A"], out[f"{key}_AT"] = op.A(x), op.AT(y)
        out[f"{key}_dot"] = _dot(op, x, y)
    # the 2 x 2 grid with the ranks laid out in another order
    mp = make_mesh(2, 2, devices=(3, 1, 0, 2))
    op = make_sharded_operator(geom, views, mp, **kw)
    out["perm_ray2x2_A"], out["perm_ray2x2_AT"] = op.A(x), op.AT(y)
    op = make_volume_sharded_slab_operator(geom, views, mp, quad="arc",
                                           halo=6, **kw)
    out["perm_vol_arc_h6_A"], out["perm_vol_arc_h6_AT"] = op.A(x), op.AT(y)
    op = make_volume_sharded_operator(geom, views, m22, **kw)
    out["voxel_A"], out["voxel_AT"] = op.A(x), op.AT(y)
    out["voxel_dot"] = _dot(op, x, y)

    b = make_operator(geom, views, family="ray", **kw).A(x)
    r = cgls(make_sharded_operator(geom, views, m41, **kw), b, niter=10)
    out["cgls_x"], out["cgls_conv"] = r.x, r.convergence
    r = sirt(make_sharded_operator(geom, views, m22, **kw), b, niter=15,
             positivity=True)
    out["sirt_x"] = r.x
    r = fista_tv(make_sharded_operator(geom, views, m41, **kw), b, niter=5,
                 hyper=None, beta_tv=0.005, niter_tv=5)
    out["fista_x"] = r.x
    theta, cost = sharded_refine_views(x, b, geom, Views.create(N_PROJ,
                                                                dtype=F64),
                                       m41, mask=PARAM_SETS["xz"],
                                       max_iter=8, dtype=F64)
    out["refine_theta"], out["refine_cost"] = theta, cost
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(torch.as_tensor(v)) for k, v in out.items()})
    dist.destroy_process_group()


def submesh_rank(rank, world, store, out_dir):
    """Meshes over part of the world, built on every rank:
    ``make_mesh(devices=[2, 0])`` runs the angle-sharded slab_plane
    operator (f32x2 and bf16) on ranks 2 and 0, ``make_mesh(1, 2, [3, 1])``
    the volume-sharded plane operator (halo 8) on ranks 3 and 1; each rank
    outside a mesh records that the operator refused it. Each rank writes
    ``out_dir/sub<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from tomojax_torch.dist import (make_mesh, make_sharded_operator,
                                    make_volume_sharded_slab_operator)

    vol, geom, views, _, y = problem()
    x, y = torch.as_tensor(vol), torch.as_tensor(y)
    kw = dict(dtype=F64, device="cpu")
    angle, volume = make_mesh(devices=[2, 0]), make_mesh(1, 2, [3, 1])
    builds = {
        "angle": lambda **k: make_sharded_operator(
            geom, views, angle, family="slab_plane", **kw, **k),
        "angle_bf16": lambda **k: make_sharded_operator(
            geom, views, angle, family="slab_plane", prec="bf16", **kw, **k),
        "vol": lambda **k: make_volume_sharded_slab_operator(
            geom, views, volume, quad="plane", halo=8, **kw, **k)}
    out = {}
    for name, build in builds.items():
        try:
            op = build()
        except ValueError:
            out[f"{name}_refused"] = 1
            continue
        out[f"{name}_A"], out[f"{name}_AT"] = op.A(x), op.AT(y)
    np.savez(os.path.join(out_dir, f"sub{rank}.npz"),
             **{k: np.asarray(torch.as_tensor(v)) for k, v in out.items()})
    dist.destroy_process_group()


def main_rank(rank, world, store, module, argv):
    """``module.main(argv)`` (a module of the port with a command line) as
    one rank of a gloo world."""
    import importlib
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    importlib.import_module(module).main(argv)
    dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, world, store, *args)`` in ``world`` processes."""
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(world, str(tmp_path / "store"), *args), nprocs=world,
             join=True)

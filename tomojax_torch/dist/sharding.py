"""Projection-angle (+ detector-ray, + volume-block) parallelism over
``torch.distributed`` (counterpart of ``tomojax.dist.sharding``).

SPMD: one process per device, started by ``torchrun`` or
``torch.multiprocessing.spawn``, NCCL between cards and gloo between CPU
processes. :func:`make_mesh` lays ranks of the default group out as
(``proj``, ``ray``), row-major (layout position = proj index · n_ray + ray
index): every rank in rank order, or the ranks its ``devices`` lists, in
that order — part of the world, as tomojax's device list may be. A mesh
over part of the world runs its collectives in a process group of its own
members; the sharded operators refuse a rank outside it.

Every rank holds the whole volume, as tomojax's replicated ``P()`` input
does. An operator's ``A`` computes the rank's own part of the sinogram and
``all_gather``s the parts into the whole sinogram; ``AT`` backprojects the
rank's own rows and sums the ranks' volumes with ``all_reduce(SUM)`` — the
reference's volume-sized Allreduce (``sirt_mpi.py:103``), tomojax's
``psum``. Both give every rank the same result, so every solver in
``tomojax_torch.recon`` runs unmodified and the same on every rank. The
sinogram is replicated on every rank (tomojax keeps it sharded).

- :func:`make_sharded_operator` — views over ``proj``; the ray family also
  splits each view's detector rays over ``ray``; the fast family and the
  slab families shard over ``proj`` only (the slab family groups its
  views by orientation at build time and pads each group to a multiple of
  the ``proj`` axis).
- :func:`make_volume_sharded_slab_operator` — the slab family with the
  volume's z axis and the detector's v axis split over ``ray`` (z blocks
  read an ``H``-plane halo of their neighbours'), views over ``proj``.
- :func:`make_volume_sharded_operator` — the voxel family with the
  volume's x axis split over ``ray`` (no halo), views over ``proj``.
- :func:`sharded_refine_views` — each ``proj`` index refines its own
  views; θ and the costs are gathered.

Without an initialized process group everything runs as a world of one.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from tomojax_torch.core import fast_projector as fastp
from tomojax_torch.core import projector as ray_proj
from tomojax_torch.core import slab_projector as sp
from tomojax_torch.core import voxel_projector as vox
from tomojax_torch.core.geometry import Geometry, Views
from tomojax_torch.core.operators import (QUADS, TomoOperator,
                                          resolve_device)
from tomojax_torch.kernels.slab import resolve_prec


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks of the default group as an ``(n_proj, n_ray)`` grid;
    ``layout`` holds the rank at each grid position, row-major (None: rank
    order), ``groups`` this rank's process group along each axis and
    ``group`` the whole mesh's (None: the default group), and ``member``
    whether this rank is in the mesh."""

    n_proj: int
    n_ray: int
    rank: int
    initialized: bool
    groups: dict
    layout: tuple | None = None
    group: object = None
    member: bool = True

    @property
    def shape(self) -> dict:
        return {"proj": self.n_proj, "ray": self.n_ray}

    @property
    def size(self) -> int:
        return self.n_proj * self.n_ray

    @property
    def position(self) -> int:
        """This rank's position in the grid, row-major."""
        _check_member(self)
        return self.rank if self.layout is None else self.layout.index(
            self.rank)

    def rank_at(self, position: int) -> int:
        """The rank at a grid position."""
        return position if self.layout is None else self.layout[position]

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.position // self.n_ray if axis == "proj" else (
            self.position % self.n_ray)

    def members(self, axis=None) -> list:
        """The ranks along ``axis`` through this rank (None: every rank),
        in grid order."""
        P, R = self.n_proj, self.n_ray
        if axis is None:
            return [self.rank_at(i) for i in range(P * R)]
        if axis == "proj":
            return [self.rank_at(p * R + self.index("ray")) for p in range(P)]
        return [self.rank_at(self.index("proj") * R + r) for r in range(R)]


def init_from_env(device) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``WORLD_SIZE`` > 1, ``RANK``, ``MASTER_ADDR``/``PORT``):
    NCCL on the card, with this rank's card from ``LOCAL_RANK``, gloo on
    the CPU. Returns whether a process group is initialized."""
    if _initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def make_mesh(n_proj_shards: int | None = None, n_ray_shards: int = 1,
              devices=None) -> Mesh:
    """Lay ranks of the default group out as (``proj``, ``ray``);
    defaults to every rank on ``proj`` (the reference's angle
    data-parallelism). The second axis doubles as the volume axis of the
    volume-sharded operators. Every rank must call it, in the same order,
    members of the mesh or not (``torch.distributed.new_group`` needs
    every rank).

    :param devices: the ranks the mesh lays out, in its order, row-major
        (tomojax's device list): any non-empty list of distinct existing
        ranks, whose count is ``n_proj_shards × n_ray_shards``; None: every
        rank in rank order. A mesh over part of the world gets a process
        group of its members, and its axes subgroups inside it."""
    init = _initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    layout = (tuple(range(world)) if devices is None
              else tuple(int(d) for d in devices))
    if not layout:
        raise ValueError("devices is empty: a mesh needs ranks")
    if len(set(layout)) != len(layout):
        raise ValueError(f"devices {list(layout)} repeats a rank")
    if not all(0 <= d < world for d in layout):
        raise ValueError(f"devices {list(layout)}: the world has ranks "
                         f"0 .. {world - 1}")
    n = len(layout)
    if n_proj_shards is None:
        n_proj_shards = n // n_ray_shards
    if n_proj_shards * n_ray_shards != n:
        raise ValueError(f"{n_proj_shards} x {n_ray_shards} != {n} ranks")
    P, R = n_proj_shards, n_ray_shards
    # the whole mesh's group: the default group for the whole world
    group = (dist.new_group(sorted(layout))
             if init and n < world else None)
    groups = {"proj": None, "ray": None}
    if init:
        for axis, lists in (
                ("proj", [[layout[p * R + r] for p in range(P)]
                          for r in range(R)]),
                ("ray", [[layout[p * R + r] for r in range(R)]
                         for p in range(P)])):
            if len(lists[0]) == n:
                groups[axis] = group
            elif len(lists[0]) > 1:
                groups[axis] = dist.new_subgroups_by_enumeration(lists)[0]
    return Mesh(n_proj=P, n_ray=R, rank=rank, initialized=init,
                groups=groups, layout=layout, group=group,
                member=rank in layout)


def _check_member(mesh: Mesh):
    """Raise ``ValueError`` on a rank outside ``mesh`` (before any
    collective: a rank outside a group never joins its collectives)."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is not in the mesh's devices "
                         f"{list(mesh.layout)}")


def _skip(mesh: Mesh, axis) -> bool:
    """No collective is needed: no process group, or a size-1 axis of a
    larger world. (A world of one still runs its collectives.)"""
    n = mesh.size if axis is None else mesh.shape[axis]
    return not mesh.initialized or (n == 1 and mesh.size > 1)


def _gather(t, mesh: Mesh, axis=None) -> list:
    """``all_gather`` along ``axis`` (None: every rank) → the tensors in
    index order (a group gathers in rank order; the mesh's layout may
    order its members otherwise)."""
    if _skip(mesh, axis):
        return [t]
    n = mesh.size if axis is None else mesh.shape[axis]
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=mesh.group if axis is None else
                    mesh.groups[axis])
    members = mesh.members(axis)
    in_rank_order = sorted(members)
    return [out[in_rank_order.index(m)] for m in members]


def _sum(t, mesh: Mesh, axis=None):
    """``all_reduce(SUM)`` along ``axis`` (None: every rank)."""
    if _skip(mesh, axis):
        return t
    t = t.contiguous()
    dist.all_reduce(t, group=mesh.group if axis is None else
                    mesh.groups[axis])
    return t


def _gather_blocks(local, mesh: Mesh, dim: int):
    """Every rank's block: ``proj`` blocks along dim 0, ``ray`` blocks
    along ``dim``."""
    blocks = _gather(local, mesh)
    R = mesh.n_ray
    return torch.cat([torch.cat(blocks[p * R:(p + 1) * R], dim=dim)
                      for p in range(mesh.n_proj)])


def _block(n: int, shards: int, i: int) -> slice:
    size = n // shards
    return slice(i * size, (i + 1) * size)


def shard_views(views: Views, mesh: Mesh) -> Views:
    """This rank's views: its block of the ``proj`` axis."""
    return views.take(_block(views.n_proj, mesh.n_proj, mesh.index("proj")))


def _check_divides(n: int, shards: int, what: str):
    if n % shards:
        raise ValueError(f"{what} {n} is not a multiple of {shards} shards")


def make_sharded_operator(geom: Geometry, views: Views, mesh: Mesh, *,
                          dtype=torch.float32,
                          views_chunk: int | None = None,
                          family: str = "ray", prec: str | None = None,
                          device=None) -> TomoOperator:
    """Angle(+ray)-sharded operator with the reference's MPI semantics:
    each rank projects its views (``proj``) over its detector rays
    (``ray``, the ray family only); ``A`` gathers the sinogram, ``AT``
    sums the ranks' backprojections. ``n_proj`` must divide over ``proj``
    and ``n_det`` over ``ray``. ``prec`` is the slab families' tier
    (:func:`~tomojax_torch.kernels.slab.resolve_prec`); the others ignore
    it, as tomojax's. A rank outside ``mesh`` raises ``ValueError``."""
    prec = resolve_prec(prec)
    _check_member(mesh)
    device = resolve_device(device)
    if family in QUADS:
        if mesh.n_ray != 1:
            raise ValueError("the slab family shards over 'proj' only")
        return _make_slab_sharded(geom, views, mesh, QUADS[family], dtype,
                                  device, family, prec)
    if family not in ("ray", "fast"):
        raise ValueError(f"unknown projector family: {family!r}")
    if family == "fast" and mesh.n_ray != 1:
        raise ValueError("the fast family shards over 'proj' only")
    _check_divides(geom.n_proj, mesh.n_proj, "n_proj")
    _check_divides(geom.n_det, mesh.n_ray, "n_det")
    local = shard_views(views, mesh)
    local = Views(**{f: getattr(local, f).to(device)
                     for f in ("phi", "alpha", "beta", "t", "cor")})
    rows = _block(geom.n_proj, mesh.n_proj, mesh.index("proj"))
    rays = _block(geom.n_det, mesh.n_ray, mesh.index("ray"))

    if family == "fast":
        def fwd(x):
            return fastp.project(x, geom, local, dtype=dtype)

        def adj(y):
            return fastp.backproject(y, geom, local, dtype=dtype)
    else:
        def fwd(x):
            return ray_proj.project(x, geom, local, dtype=dtype,
                                    views_chunk=views_chunk, rays=rays)

        def adj(y):
            return ray_proj.backproject(y, geom.vox_shape, geom, local,
                                        dtype=dtype, views_chunk=views_chunk,
                                        rays=rays)

    def A(x):
        return _gather_blocks(fwd(x.reshape(geom.vox_shape).to(dtype)),
                              mesh, dim=1)

    def AT(y):
        y = y.reshape(geom.n_proj, geom.n_det).to(dtype)
        return _sum(adj(y[rows, rays].contiguous()), mesh)

    return TomoOperator(geom=geom, views=views, A=A, AT=AT,
                        family=f"{family}-sharded", dtype=dtype,
                        device=device)


def _padded_groups(geom: Geometry, views: Views, quad: str, n_shards: int,
                   shard: int):
    """Orientation groups of ``views`` (float64 host scalars) padded to a
    multiple of ``n_shards`` rows by repeating the last: per group
    ``(idx, swap, yflip, uflip, scalars (Vg + pad, NS), this shard's
    rows)``."""
    gstruct, scalars = sp.scalar_groups(geom, views, quad,
                                        dtype=torch.float64)
    out = []
    for (idx, sw, yf, uf), sc in zip(gstruct, scalars):
        pad = (-len(idx)) % n_shards
        if pad:
            sc = torch.cat([sc, sc[-1:].expand(pad, -1)])
        out.append((idx, sw, yf, uf, sc,
                    _block(sc.shape[0], n_shards, shard)))
    return out


def _make_slab_sharded(geom: Geometry, views: Views, mesh: Mesh, quad: str,
                       dtype, device, family: str, prec: str) -> TomoOperator:
    """Angle-sharded slab operator: views grouped by orientation at build
    time, each group padded to a multiple of ``proj``; each rank applies
    K1/K2 (plane) or K3/K4 (arc), or their bf16 variants, to its scalar
    rows."""
    from tomojax_torch.kernels import slab as slabk
    sp._check_square(geom)
    nu, nv = geom.det_shape
    groups = [(idx, sw, yf, uf, sc[rows].to(dtype=dtype, device=device),
               len(idx))
              for idx, sw, yf, uf, sc, rows in _padded_groups(
                  geom, views, quad, mesh.n_proj, mesh.index("proj"))]
    n = views.n_proj

    def A(x):
        vol = x.reshape(geom.vox_shape).to(dtype)
        out = vol.new_zeros((n, nu, nv))
        for idx, sw, yf, uf, sc, vg in groups:
            vol_or = sp.orient_volume(vol, geom, sw, yf).contiguous()
            sino = _gather_blocks(
                slabk.slab_project(vol_or, sc, geom, quad, prec=prec), mesh,
                dim=1)[:vg]
            if uf:
                sino = sino.flip(1)
            out[torch.as_tensor(idx, device=out.device)] = sino
        return out.reshape(n, geom.n_det)

    def AT(y):
        y = y.reshape(n, nu, nv).to(dtype)
        vol = y.new_zeros(geom.vox_shape)
        for idx, sw, yf, uf, sc, vg in groups:
            g = _pad_rows(y[torch.as_tensor(idx, device=y.device)], uf, vg,
                          sc.shape[0] * mesh.n_proj)
            g = g[_block(g.shape[0], mesh.n_proj, mesh.index("proj"))]
            vb = slabk.slab_backproject(g.contiguous(), sc, geom, quad, prec)
            vol += sp.unorient_volume(vb, sw, yf)
        return _sum(vol, mesh)

    return TomoOperator(geom=geom, views=views, A=A, AT=AT,
                        family=f"{family}-sharded", dtype=dtype,
                        device=device, prec=prec)


def _pad_rows(g, uflip: bool, n_valid: int, n_rows: int):
    """A group's cotangent rows (u-flipped for its frame), zero rows up to
    ``n_rows``."""
    if uflip:
        g = g.flip(1)
    if n_rows > n_valid:
        g = torch.cat([g, g.new_zeros((n_rows - n_valid, *g.shape[1:]))])
    return g


def make_volume_sharded_slab_operator(geom: Geometry, views: Views,
                                      mesh: Mesh, *, quad: str = "arc",
                                      dtype=torch.float32, halo: int = 32,
                                      prec: str | None = None,
                                      device=None) -> TomoOperator:
    """Volume-sharded slab operator: the volume's z axis and the
    detector's v axis split over the mesh's second axis, views over
    ``proj``.

    The slab decomposition maps z to v along a near-unit diagonal (the
    march axis lies in the x-y plane), so detector block ``[v0, v0 +
    nvl)`` reads only volume planes ``[v0 − H, v0 + nvl + H)``: each rank
    applies the kernels to its ``(nx, ny, nzl + 2H)`` block (zero beyond
    the volume) with its scalars shifted to the block's (v, z) frame. The
    adjoint returns each block's halo cotangents to the neighbours that
    own those planes (point to point), sums over ``proj`` and gathers the
    z blocks. Every view's z-v offset must stay inside the halo (checked
    here). ``prec`` is the kernels' tier; a rank outside ``mesh`` raises
    ``ValueError``."""
    from tomojax_torch.kernels import slab as slabk
    prec = resolve_prec(prec)
    _check_member(mesh)
    sp._check_quad(quad)
    sp._check_square(geom)
    device = resolve_device(device)
    nV = mesh.n_ray
    nx, ny, nz = geom.vox_shape
    nu, nv = geom.det_shape
    _check_divides(nz, nV, "nz")
    _check_divides(nv, nV, "nv")
    nzl, nvl = nz // nV, nv // nV
    H = min(halo, nzl)
    i = mesh.index("ray")
    # the y extent (ray length, march steps) is the whole volume's
    local_geom = Geometry(n_proj=geom.n_proj, vox_shape=(nx, ny, nzl + 2 * H),
                          det_shape=(nu, nvl), vox_pix=geom.vox_pix,
                          det_pix=geom.det_pix, step_size=geom.step_size)
    v0, z0 = i * nvl, i * nzl
    groups = []
    for idx, sw, yf, uf, sc, rows in _padded_groups(
            geom, views, quad, mesh.n_proj, mesh.index("proj")):
        zoff = (sc[:, sp.S_CZB].abs() + sc[:, sp.S_RZ].abs() * ny
                + (sc[:, sp.S_ZAV] - 1.0).abs() * nv + 4)
        if not bool(torch.all(zoff < H)):
            raise ValueError(f"halo {H} too small for per-view z offsets "
                             f"up to {float(zoff.max()):.1f}")
        sc = sc[rows].clone()
        # the block's frame: detector v from v0, volume z from z0 - H (only
        # the offsets move; every other column depends on E alone)
        sc[:, sp.S_CXB] += v0 * sc[:, sp.S_EVX]
        sc[:, sp.S_CZB] += v0 * sc[:, sp.S_EVZ] + (H - z0)
        sc[:, sp.S_B1] += v0 * sc[:, sp.S_EVY]
        groups.append((idx, sw, yf, uf, sc.to(dtype=dtype, device=device),
                       len(idx)))
    n = views.n_proj
    lo, hi = max(0, z0 - H), min(nz, z0 + nzl + H)

    def A(x):
        vol = x.reshape(geom.vox_shape).to(dtype)
        blk = vol.new_zeros(local_geom.vox_shape)
        blk[:, :, lo - (z0 - H):hi - (z0 - H)] = vol[:, :, lo:hi]
        out = vol.new_zeros((n, nu, nv))
        for idx, sw, yf, uf, sc, vg in groups:
            vol_or = sp.orient_volume(blk, local_geom, sw, yf).contiguous()
            sino = _gather_blocks(
                slabk.slab_project(vol_or, sc, local_geom, quad, prec=prec),
                mesh, dim=2)[:vg]
            if uf:
                sino = sino.flip(1)
            out[torch.as_tensor(idx, device=out.device)] = sino
        return out.reshape(n, geom.n_det)

    def AT(y):
        y = y.reshape(n, nu, nv).to(dtype)
        blk = y.new_zeros(local_geom.vox_shape)
        for idx, sw, yf, uf, sc, vg in groups:
            g = _pad_rows(y[torch.as_tensor(idx, device=y.device)], uf, vg,
                          sc.shape[0] * mesh.n_proj)
            g = g[_block(g.shape[0], mesh.n_proj, mesh.index("proj")),
                  :, v0:v0 + nvl]
            vb = slabk.slab_backproject(g.contiguous(), sc, local_geom, quad,
                                        prec)
            blk += sp.unorient_volume(vb, sw, yf)
        own = _return_halos(blk, H, nzl, mesh)
        own = _sum(own, mesh, "proj")
        return torch.cat(_gather(own, mesh, "ray"), dim=2)

    return TomoOperator(geom=geom, views=views, A=A, AT=AT,
                        family=f"slab-volume-sharded-{quad}", dtype=dtype,
                        device=device, prec=prec)


def _return_halos(blk, H: int, nzl: int, mesh: Mesh):
    """The adjoint of reading the neighbours' planes: send the cotangent
    of each halo to the rank that owns those planes and add what the
    neighbours send into this block's own planes → ``(nx, ny, nzl)``."""
    own = blk[:, :, H:H + nzl].clone()
    i, nV = mesh.index("ray"), mesh.n_ray
    if not mesh.initialized or nV == 1:
        return own
    reqs, recv = [], {}
    for side, peer, halo in ((0, i - 1, blk[:, :, :H]),
                             (1, i + 1, blk[:, :, H + nzl:])):
        if 0 <= peer < nV:
            rank = mesh.rank_at(mesh.position + (peer - i))
            recv[side] = torch.empty_like(halo)
            reqs.append(dist.isend(halo.contiguous(), rank))
            reqs.append(dist.irecv(recv[side], rank))
    for r in reqs:
        r.wait()
    if 0 in recv:       # the left neighbour's right halo: my first planes
        own[:, :, :H] += recv[0]
    if 1 in recv:       # the right neighbour's left halo: my last planes
        own[:, :, nzl - H:] += recv[1]
    return own


def sharded_refine_views(vol, projections, geom: Geometry, views: Views,
                         mesh: Mesh, *, mask=None, lower=None, upper=None,
                         max_iter: int = 20, dtype=torch.float32):
    """Per-view 6-DoF box LM sharded over ``proj``: each rank refines its
    own views (``align.refine.refine_views``); returns the gathered ``(θ
    (n_proj, 6), cost (n_proj,))`` on every rank."""
    from tomojax_torch.align.refine import PARAM_SETS, refine_views
    _check_member(mesh)
    if mask is None:
        mask = PARAM_SETS["xzab"]
    n = views.n_proj
    _check_divides(n, mesh.n_proj, "n_proj")
    rows = _block(n, mesh.n_proj, mesh.index("proj"))
    proj = torch.as_tensor(projections).reshape(n, -1)[rows]
    res = refine_views(vol, proj, geom, shard_views(views, mesh), mask=mask,
                       lower=lower, upper=upper, max_iter=max_iter,
                       dtype=dtype)
    return (torch.cat(_gather(res.theta6, mesh, "proj")),
            torch.cat(_gather(res.cost, mesh, "proj")))


def make_volume_sharded_operator(geom: Geometry, views: Views, mesh: Mesh,
                                 *, dtype=torch.float32,
                                 device=None) -> TomoOperator:
    """Volume-sharded voxel-family operator: the volume's x axis split
    over the mesh's second axis, views over ``proj``. Each voxel's work is
    its own, so no halo is needed: ``A`` sums the blocks' splats over
    ``ray`` and gathers the views over ``proj``; ``AT`` gathers each
    block's voxels from the detector, sums its views over ``proj`` and
    gathers the blocks over ``ray``. Requires ``nx`` and ``n_proj`` to
    divide over their axes; a rank outside ``mesh`` raises
    ``ValueError``."""
    _check_member(mesh)
    device = resolve_device(device)
    nx = geom.vox_shape[0]
    _check_divides(nx, mesh.n_ray, "nx")
    _check_divides(geom.n_proj, mesh.n_proj, "n_proj")
    xs = _block(nx, mesh.n_ray, mesh.index("ray"))
    rows = _block(geom.n_proj, mesh.n_proj, mesh.index("proj"))
    local = shard_views(views, mesh)

    def A(x):
        blk = x.reshape(geom.vox_shape).to(dtype)[xs]
        part = _sum(vox.project(blk, geom, local, dtype=dtype, xs=xs), mesh,
                    "ray")
        return torch.cat(_gather(part, mesh, "proj"))

    def AT(y):
        y = y.reshape(geom.n_proj, geom.n_det).to(dtype)[rows]
        part = _sum(vox.backproject(y, geom, local, dtype=dtype, xs=xs),
                    mesh, "proj")
        return torch.cat(_gather(part, mesh, "ray"))

    return TomoOperator(geom=geom, views=views, A=A, AT=AT,
                        family="voxel-volume-sharded", dtype=dtype,
                        device=device)

"""Parallel-beam acquisition geometry and per-view rigid parameters.

Counterpart of ``tomojax.core.geometry``:

- ``Geometry`` is the same immutable dataclass of static scalars, with the
  same grid conventions (voxel centers on ``linspace(-s/2, s/2, n,
  endpoint=False) + 0.5`` per axis; ``vox_origin`` the minimum corner;
  source plane at ``y = -vox_size_y``, detector plane at ``+vox_size_y``).
  Grids are host numpy in float64 (``*_np``), or tensors of a given dtype
  and device from the accessors of the same names.
- ``Views`` is a dataclass of tensors with leading axis ``n_proj`` (tomojax
  uses a pytree NamedTuple).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _as_tuple(x, n, cast):
    if np.isscalar(x):
        return (cast(x),) * n
    t = tuple(cast(v) for v in np.asarray(x).ravel())
    if len(t) != n:
        raise ValueError(f"expected {n} entries, got {t}")
    return t


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static parallel-beam setup (hashable).

    :param n_proj: number of projection views.
    :param vox_shape: ``(nx, ny, nz)`` voxel grid shape.
    :param det_shape: ``(nu, nv)`` detector shape; ``u`` maps to volume x
        and ``v`` to volume z.
    :param vox_pix: voxel pitch per axis.
    :param det_pix: detector pitch per axis.
    :param step_size: ray-march step.
    """

    n_proj: int
    vox_shape: tuple
    det_shape: tuple
    vox_pix: tuple = (1.0, 1.0, 1.0)
    det_pix: tuple = (1.0, 1.0)
    step_size: float = 1.0
    vox_ds: tuple = (1.0, 1.0, 1.0)

    def __post_init__(self):
        object.__setattr__(self, "n_proj", int(self.n_proj))
        object.__setattr__(self, "vox_shape", _as_tuple(self.vox_shape, 3, int))
        object.__setattr__(self, "det_shape", _as_tuple(self.det_shape, 2, int))
        object.__setattr__(self, "vox_pix", _as_tuple(self.vox_pix, 3, float))
        object.__setattr__(self, "det_pix", _as_tuple(self.det_pix, 2, float))
        object.__setattr__(self, "step_size", float(self.step_size))
        object.__setattr__(self, "vox_ds", _as_tuple(self.vox_ds, 3, float))

    @property
    def n_vox(self) -> int:
        nx, ny, nz = self.vox_shape
        return nx * ny * nz

    @property
    def n_det(self) -> int:
        nu, nv = self.det_shape
        return nu * nv

    @property
    def vox_size(self) -> tuple:
        return tuple(n * p for n, p in zip(self.vox_shape, self.vox_pix))

    @property
    def det_size(self) -> tuple:
        return tuple(n * p for n, p in zip(self.det_shape, self.det_pix))

    @property
    def ray_length(self) -> float:
        """Source-to-detector distance = 2 × voxel y-extent."""
        return 2.0 * self.vox_size[1]

    @property
    def n_steps(self) -> int:
        """Samples per ray: ``int(ray_length / step_size)``."""
        return int(self.ray_length / self.step_size)

    @property
    def factor(self) -> tuple:
        """Voxel→detector downsampling factors for the voxel-driven path."""
        sx = float(self.vox_shape[0] / self.det_shape[0])
        sz = float(self.vox_shape[2] / self.det_shape[1])
        return (sx, 1.0, sz)

    # ---- derived grids: host numpy float64, and tensors by accessor ----
    def _axis_centers(self, n: int, size: float) -> np.ndarray:
        return np.linspace(-size / 2.0, size / 2.0, n, endpoint=False) + 0.5

    def vox_centers_np(self) -> np.ndarray:
        """(3, n_vox) voxel centers, x-major/z-minor raveling ('ij')."""
        (nx, ny, nz), (sx, sy, sz) = self.vox_shape, self.vox_size
        X, Y, Z = np.meshgrid(self._axis_centers(nx, sx),
                              self._axis_centers(ny, sy),
                              self._axis_centers(nz, sz), indexing="ij")
        return np.array([X.ravel(), Y.ravel(), Z.ravel()])

    def vox_origin_np(self) -> np.ndarray:
        nx, ny, nz = self.vox_shape
        sx, sy, sz = self.vox_size
        return np.array([self._axis_centers(nx, sx).min(),
                         self._axis_centers(ny, sy).min(),
                         self._axis_centers(nz, sz).min()])

    def det_grid_np(self):
        """(xd, zd) raveled detector coordinates, 'ij' meshgrid (u-major)."""
        (nu, nv), (su, sv) = self.det_shape, self.det_size
        XD, ZD = np.meshgrid(self._axis_centers(nu, su),
                             self._axis_centers(nv, sv), indexing="ij")
        return XD.ravel(), ZD.ravel()

    def source_centers_np(self) -> np.ndarray:
        """(3, n_det) source points: detector grid at y = -vox_size_y."""
        xd, zd = self.det_grid_np()
        return np.array([xd, -self.vox_size[1] * np.ones_like(xd), zd])

    def det_centers_np(self) -> np.ndarray:
        """(3, n_det) detector points: detector grid at y = +vox_size_y."""
        xd, zd = self.det_grid_np()
        return np.array([xd, self.vox_size[1] * np.ones_like(xd), zd])

    def det_orig_np(self) -> np.ndarray:
        """Minimum (x, y, z) of the detector grid, y from the *voxel*
        grid."""
        (nu, nv), (su, sv) = self.det_shape, self.det_size
        return np.array([self._axis_centers(nu, su).min(),
                         self._axis_centers(self.vox_shape[1],
                                            self.vox_size[1]).min(),
                         self._axis_centers(nv, sv).min()])

    def vox_centers(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.vox_centers_np(), dtype=dtype,
                               device=device)

    def vox_origin(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.vox_origin_np(), dtype=dtype,
                               device=device)

    def source_centers(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.source_centers_np(), dtype=dtype,
                               device=device)

    def det_centers(self, dtype=torch.float32, device=None):
        return torch.as_tensor(self.det_centers_np(), dtype=dtype,
                               device=device)


@dataclasses.dataclass(frozen=True)
class Views:
    """Per-view rigid parameters, tensors with leading axis ``n_proj``.

    A view's ray transform is ``R_z(phi) R_x(alpha) (R_y(beta) p + t)``;
    the 6-DoF parameter order is ``(tx, ty, tz, phi, alpha, beta)``.
    """

    phi: torch.Tensor    # (n_proj,) tomographic angle about Z
    alpha: torch.Tensor  # (n_proj,) jitter about X
    beta: torch.Tensor   # (n_proj,) jitter about Y
    t: torch.Tensor      # (n_proj, 3) translations
    cor: torch.Tensor    # (n_proj, 3) center-of-rotation shift

    @classmethod
    def create(cls, n_proj, phi=None, alpha=None, beta=None, t=None,
               cor=None, dtype=torch.float32, *, device=None) -> "Views":
        """Views with defaults as ``tomojax.core.geometry.Views.create``:
        phi over ``[0, π]`` (endpoint included), zero jitter. Array-likes
        are cast to ``dtype`` (float32 by default, as tomojax)."""
        def arr(val, shape, default):
            if val is None:
                return torch.full(shape, default, dtype=dtype, device=device)
            return torch.as_tensor(np.asarray(val) if not torch.is_tensor(val)
                                   else val, dtype=dtype,
                                   device=device).broadcast_to(shape
                                                               ).contiguous()

        if phi is None:
            phi = torch.linspace(0.0, math.pi, n_proj, dtype=dtype,
                                 device=device)
        else:
            phi = arr(phi, (n_proj,), 0.0)
        return cls(phi=phi, alpha=arr(alpha, (n_proj,), 0.0),
                   beta=arr(beta, (n_proj,), 0.0),
                   t=arr(t, (n_proj, 3), 0.0),
                   cor=arr(cor, (n_proj, 3), 0.0))

    @property
    def n_proj(self) -> int:
        return self.phi.shape[0]

    def view(self, i) -> "Views":
        """The view ``i`` as a ``Views`` whose fields are that view's
        (``phi`` 0-d, ``t`` (3,) for an integer ``i``), as tomojax's."""
        return Views(**{f.name: getattr(self, f.name)[i]
                        for f in dataclasses.fields(self)})

    def numpy(self) -> dict:
        """Host float64 copies of the fields (for the host-side scalars)."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                .astype(np.float64) for f in dataclasses.fields(self)}

    def take(self, idx) -> "Views":
        """The views at ``idx`` (an index array or slice)."""
        if not isinstance(idx, slice):
            idx = torch.as_tensor(np.asarray(idx), device=self.phi.device)
        return Views(**{f.name: getattr(self, f.name)[idx]
                        for f in dataclasses.fields(self)})

    def theta6(self) -> torch.Tensor:
        """(n_proj, 6) parameter matrix in the order (tx, ty, tz, phi,
        alpha, beta)."""
        return torch.cat([self.t, self.phi[:, None], self.alpha[:, None],
                          self.beta[:, None]], dim=1)

    @classmethod
    def from_theta6(cls, theta, cor=None) -> "Views":
        """Views from an (n_proj, 6) parameter matrix; ``cor`` defaults to
        zeros of θ's dtype and device."""
        theta = torch.as_tensor(theta)
        if cor is None:
            cor = torch.zeros((theta.shape[0], 3), dtype=theta.dtype,
                              device=theta.device)
        return cls(phi=theta[:, 3], alpha=theta[:, 4], beta=theta[:, 5],
                   t=theta[:, :3], cor=cor)

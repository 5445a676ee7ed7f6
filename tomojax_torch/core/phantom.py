"""Analytic ellipsoid phantoms (3-D Shepp-Logan and random ellipsoid scenes).

A numpy copy of ``tomojax.core.phantom`` (bit-equal output). Functional
equivalent of the reference's ``utilities/generate_phantom.py``
(itself adapted from tomopy). Host-side data generation — plain numpy, used
once per experiment; the standard modified Shepp-Logan ellipsoid table is
public-domain parameter data.

The evaluation convention matches the reference (:112-144): normalized
coordinates in [-1, 1]^3, each ellipsoid rotated by ZXZ Euler angles
(phi, theta, psi, degrees), voxels inside the unit ball after the inverse
affine map accumulate the ellipsoid's amplitude ``A``.
"""

from __future__ import annotations

import numpy as np

# Columns: A, a, b, c, x0, y0, z0, phi, theta, psi  (degrees)
# Standard modified 3-D Shepp-Logan parameters (as used by tomopy and the
# reference's _get_shepp_array, utilities/generate_phantom.py:194-209).
SHEPP_PARAMS = np.array(
    [
        [1.0, 0.6900, 0.920, 0.810, 0.0, 0.0, 0.0, 90.0, 90.0, 90.0],
        [-0.8, 0.6624, 0.874, 0.780, 0.0, -0.0184, 0.0, 90.0, 90.0, 90.0],
        [-0.2, 0.1100, 0.310, 0.220, 0.22, 0.0, 0.0, -108.0, 90.0, 100.0],
        [-0.2, 0.1600, 0.410, 0.280, -0.22, 0.0, 0.0, 108.0, 90.0, 100.0],
        [0.1, 0.2100, 0.250, 0.410, 0.0, 0.35, -0.15, 90.0, 90.0, 90.0],
        [0.1, 0.0460, 0.046, 0.050, 0.0, 0.1, 0.25, 90.0, 90.0, 90.0],
        [0.1, 0.0460, 0.046, 0.050, 0.0, -0.1, 0.25, 90.0, 90.0, 90.0],
        [0.1, 0.0460, 0.023, 0.050, -0.08, -0.605, 0.0, 90.0, 90.0, 90.0],
        [0.1, 0.0230, 0.023, 0.020, 0.0, -0.606, 0.0, 90.0, 90.0, 90.0],
        [0.1, 0.0230, 0.046, 0.020, 0.06, -0.605, 0.0, 90.0, 90.0, 90.0],
    ]
)


def _euler_zxz(phi_deg, theta_deg, psi_deg):
    """ZXZ Euler rotation used by the tomopy/reference convention
    (utilities/generate_phantom.py:147-166)."""
    cphi, sphi = np.cos(np.radians(phi_deg)), np.sin(np.radians(phi_deg))
    cth, sth = np.cos(np.radians(theta_deg)), np.sin(np.radians(theta_deg))
    cpsi, spsi = np.cos(np.radians(psi_deg)), np.sin(np.radians(psi_deg))
    return np.array(
        [
            [cpsi * cphi - cth * sphi * spsi, cpsi * sphi + cth * cphi * spsi, spsi * sth],
            [-spsi * cphi - cth * sphi * cpsi, -spsi * sphi + cth * cphi * cpsi, cpsi * sth],
            [sth * sphi, -sth * cphi, cth],
        ]
    )


def _ellipsoid_bbox(row, axes):
    """Conservative per-axis index bounds of one ellipsoid's support.

    The inside test below is |diag(1/a,1/b,1/c) (R x - t)| <= 1, i.e. the
    support is {R^T (D u + t) : |u| <= 1} with D = diag(a, b, c); its
    axis-i extent is center sum_j R[j,i] t_j ± sum_j |R[j,i] d_j| (box
    bound — a superset of the ball bound, so always safe).  Returns
    [lo, hi) index slices into the global ``linspace(-1, 1, n)`` grids,
    padded by one sample against floating-point edge effects.
    """
    A, a, b, c, x0, y0, z0, phi_d, th_d, psi_d = row
    R = _euler_zxz(phi_d, th_d, psi_d)
    d = np.array([a, b, c])
    t = np.array([x0, y0, z0])
    center = R.T @ t
    half = np.abs(R.T * d[None, :]).sum(axis=1)
    sls = []
    for i, g in enumerate(axes):
        lo = int(np.searchsorted(g, center[i] - half[i])) - 1
        hi = int(np.searchsorted(g, center[i] + half[i])) + 1
        sls.append(slice(max(lo, 0), min(hi, len(g))))
    return sls


def phantom(shape, params, dtype=np.float32):
    """Accumulate ellipsoids over a [-1,1]^3 grid.

    Each ellipsoid is evaluated only on its bounding sub-box (exact: the
    per-voxel arithmetic is identical to a full-grid evaluation, the
    coordinate set is just sliced from the same global ``linspace``), which
    makes 512^3 generation seconds instead of minutes.

    :param shape: (nx, ny, nz)
    :param params: (n_ellipsoids, 10) array, columns
        ``A, a, b, c, x0, y0, z0, phi, theta, psi``.
    """
    shape = tuple(int(s) for s in np.atleast_1d(shape)) if np.ndim(shape) else (int(shape),) * 3
    if len(shape) == 1:
        shape = shape * 3
    out = np.zeros(shape, dtype=dtype)
    axes = [np.linspace(-1.0, 1.0, n) for n in shape]
    for row in np.asarray(params):
        A, a, b, c, x0, y0, z0, phi_d, th_d, psi_d = row
        R = _euler_zxz(phi_d, th_d, psi_d)
        sx, sy, sz = _ellipsoid_bbox(row, axes)
        grids = np.meshgrid(axes[0][sx], axes[1][sy], axes[2][sz],
                            indexing="ij")
        sub_shape = grids[0].shape
        coords = np.stack([g.ravel() for g in grids])
        p = R @ coords
        p -= np.array([[x0], [y0], [z0]])
        p /= np.array([[a], [b], [c]])
        inside = ((p**2).sum(axis=0) <= 1.0).reshape(sub_shape)
        out[sx, sy, sz] += np.where(inside, dtype(A), dtype(0)).astype(dtype)
    return out


def shepp3d(size=128, dtype=np.float32):
    """3-D modified Shepp-Logan phantom, clipped to non-negative values
    (reference: utilities/generate_phantom.py:28-46)."""
    size = (size, size, size) if np.isscalar(size) else tuple(size)
    return np.clip(phantom(size, SHEPP_PARAMS, dtype), 0.0, None)


def arbitrary_phantom(size=128, n_features=20, dtype=np.float32, seed=0):
    """Random ellipsoid scene (reference: utilities/generate_phantom.py:49-78),
    seeded for reproducibility."""
    rng = np.random.default_rng(seed)
    params = np.zeros((n_features, 10))
    params[:, 0] = rng.integers(-100, 100, n_features) / 100.0  # amplitude
    params[:, 1:4] = rng.random((n_features, 3))  # semi-axes in (0, 1)
    params[:, 4:7] = rng.integers(-200, 200, (n_features, 3)) / 200.0  # centers
    params[:, 7:] = np.degrees(rng.random((n_features, 3)) * np.pi)  # angles
    # avoid degenerate zero semi-axes
    params[:, 1:4] = np.maximum(params[:, 1:4], 5e-2)
    return np.clip(phantom(size, params, dtype), 0.0, None)

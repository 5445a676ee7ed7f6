"""Dataset IO — the HDF5 layout of ``tomojax.utils.io``: datasets
``data/projections``, ``data/phi``, ``data/alpha``, ``data/beta``,
``data/xyz`` and optionally ``data/phantom``, so datasets are
interchangeable between the two packages.

A path ending in ``.npz`` holds the same arrays under the same names in a
numpy archive instead, for machines without ``h5py`` (:data:`HAVE_H5PY`
says whether it is installed).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from tomojax_torch.core.geometry import Views

HAVE_H5PY = importlib.util.find_spec("h5py") is not None


def _is_npz(path) -> bool:
    return os.fspath(path).endswith(".npz")


def save_dataset(path, *, projections, phi, alpha, beta, xyz, phantom=None,
                 extra=None):
    """Write the dataset layout (HDF5, or ``.npz`` by suffix)."""
    arrays = dict(projections=projections, phi=phi, alpha=alpha, beta=beta,
                  xyz=xyz, **({} if phantom is None else {"phantom": phantom}),
                  **(extra or {}))
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if _is_npz(path):
        np.savez(path, **arrays)
        return
    import h5py
    with h5py.File(path, "w") as f:
        g = f.create_group("data")
        for k, v in arrays.items():
            g.create_dataset(k, data=v)


def load_dataset(path) -> dict:
    """Read the dataset layout (HDF5, or ``.npz`` by suffix) → dict of
    numpy arrays."""
    if _is_npz(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    import h5py
    with h5py.File(path, "r") as f:
        return {k: v[()] for k, v in f["data"].items()}


def views_from_dataset(d, *, device=None) -> Views:
    """Views (float32, as tomojax) from a loaded dataset dict."""
    return Views.create(len(d["phi"]), phi=d["phi"], alpha=d["alpha"],
                        beta=d["beta"], t=d["xyz"], device=device)


def save_volume(path, volume):
    """``np.save`` of the volume."""
    if hasattr(volume, "detach"):
        volume = volume.detach().cpu().numpy()
    np.save(path, np.asarray(volume))


def load_volume(path):
    return np.load(path)

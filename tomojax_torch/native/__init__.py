"""Native (C++) host runtime: the exact ray projector in float64 on the CPU
(counterpart of ``tomojax.native``).

ctypes bindings over the port's own copy of ``tomonative.cpp`` (this
directory), built at first use with ``g++ -O2 -shared -fPIC`` into
``build/native/`` at the repository root (listed in ``.gitignore``), named
by a hash of the source and flags so an edited source is rebuilt. Without
a compiler :func:`is_available` is False and the entry points raise.
:data:`AVAILABLE` follows :func:`is_available` once the library has been
asked for (False before, as tomojax's).

The functions take and return host float64 numpy arrays, with tomojax's
signatures: :func:`forward_view`, :func:`backproject_view` and
:func:`sparse_view_coo` (the explicit COO system matrix of one view).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "tomonative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC")

AVAILABLE = False


def library_path() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"tomonative_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless the hashed library exists; returns its
    path (written through a temporary file and ``os.replace``, so
    concurrent builders never load a partial library)."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: cannot build tomonative")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded library with each entry point's signature, or None when
    it cannot be built; sets :data:`AVAILABLE`."""
    global AVAILABLE
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        AVAILABLE = False
        return None
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ray_forward_f64.argtypes = [pd, pd, pd, i64, i64, i64, i64, i64,
                                    f64, pd]
    lib.ray_forward_f64.restype = None
    lib.ray_adjoint_f64.argtypes = [pd, pd, pd, i64, i64, i64, i64, i64,
                                    f64, pd]
    lib.ray_adjoint_f64.restype = None
    lib.ray_sparse_coo_f64.argtypes = [pd, pd, i64, i64, i64, i64, i64, f64,
                                       pi, pi, pd]
    lib.ray_sparse_coo_f64.restype = i64
    AVAILABLE = True
    return lib


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("tomonative unavailable (no compiler?)")
    return lib


def is_available() -> bool:
    return _load() is not None


def _view_setup(geom, phi, alpha, beta, t, cor):
    """Host float64 ray setup of one view, the ray family's
    (``core.projector._ray_setup``) in numpy: ``(p0 (3, n_rays), d_hat
    (3,))``."""

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([(c, -s, 0.0), (s, c, 0.0), (0.0, 0.0, 1.0)])

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([(1.0, 0.0, 0.0), (0.0, c, -s), (0.0, s, c)])

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([(c, 0.0, s), (0.0, 1.0, 0.0), (-s, 0.0, c)])

    src = geom.source_centers_np().copy()
    det = geom.det_centers_np().copy()
    cor = np.asarray(cor, np.float64)
    src[0] += cor[0]
    det[0] += cor[0]
    rpa = rot_z(phi) @ rot_x(alpha)
    R = rpa @ rot_y(beta)
    t = np.asarray(t, np.float64)
    origin = geom.vox_origin_np()
    p0 = rpa @ (rot_y(beta) @ src + t[:, None]) - origin[:, None]
    v = det[:, 0] - src[:, 0]
    d_hat = (R @ v) / geom.ray_length
    return np.ascontiguousarray(p0), np.ascontiguousarray(d_hat)


def forward_view(vol, geom, phi, alpha, beta, t, cor=np.zeros(3)):
    """Exact float64 forward projection of one view → ``(n_det,)``."""
    lib = _lib()
    p0, d_hat = _view_setup(geom, phi, alpha, beta, t, cor)
    nx, ny, nz = geom.vox_shape
    out = np.zeros(geom.n_det, np.float64)
    lib.ray_forward_f64(p0, d_hat,
                        np.ascontiguousarray(vol, np.float64).ravel(),
                        nx, ny, nz, geom.n_det, geom.n_steps,
                        geom.step_size, out)
    return out


def backproject_view(y, geom, phi, alpha, beta, t, cor=np.zeros(3)):
    """Exact transpose of :func:`forward_view` → ``vox_shape``."""
    lib = _lib()
    p0, d_hat = _view_setup(geom, phi, alpha, beta, t, cor)
    nx, ny, nz = geom.vox_shape
    out = np.zeros(nx * ny * nz, np.float64)
    lib.ray_adjoint_f64(p0, d_hat,
                        np.ascontiguousarray(y, np.float64).ravel(),
                        nx, ny, nz, geom.n_det, geom.n_steps,
                        geom.step_size, out)
    return out.reshape(geom.vox_shape)


def sparse_view_coo(geom, phi, alpha, beta, t, cor=np.zeros(3)):
    """COO ``(det_inds, dat_inds, wts)`` of one view's system matrix."""
    lib = _lib()
    p0, d_hat = _view_setup(geom, phi, alpha, beta, t, cor)
    nx, ny, nz = geom.vox_shape
    cap = 8 * geom.n_det * geom.n_steps
    det_inds = np.zeros(cap, np.int32)
    dat_inds = np.zeros(cap, np.int32)
    wts = np.zeros(cap, np.float64)
    n = lib.ray_sparse_coo_f64(p0, d_hat, nx, ny, nz, geom.n_det,
                               geom.n_steps, geom.step_size, det_inds,
                               dat_inds, wts)
    return det_inds[:n], dat_inds[:n], wts[:n]

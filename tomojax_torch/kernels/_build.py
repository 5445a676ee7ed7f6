"""Build ``csrc/*.cu`` with nvcc into a shared library and load it (ctypes).

The library has a plain C interface, so it builds in seconds (no PyTorch
headers); each source compiles in its own nvcc process, all started
together, so the build takes as long as its slowest source, and one more
nvcc links them. It goes into ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source is rebuilt and never loaded stale. nvcc is
``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the one
on ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "slab_plane.cu", CSRC / "slab_arc.cu",
           CSRC / "resample.cu", CSRC / "ray.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# int fn(const float* in, const float* scalars, float* out,
#        int V, int nx, int ny, int nz, int nu, int nv, cudaStream_t);
# the arc kernels take (int n_steps, int n_branch) before the stream, and
# the arc adjoint a scratch volume after its output; the bf16 entries
# (*_bf16) take their first operand in bf16
_PLANE = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_ARC = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_ARC_ADJ = [_P, *_ARC]
# int fn(const float* rows, const float* off, const float* slope, float* out,
#        int V, int R1, int R2, int N, int M, long long sv, long long s1,
#        long long s2, [long long si,] long long fv, long long f1,
#        long long f2, long long ov, long long o1, long long o2,
#        long long oi, cudaStream_t);
# the bracketed argument is the transpose's: its rows' element stride
_RESAMPLE_FWD = [_P, _P, _P, _P, *[_I] * 5, *[_L] * 10, _P]
_RESAMPLE_T = [_P, _P, _P, _P, *[_I] * 5, *[_L] * 11, _P]
# int fn(const float* a, float* q_rcp, float* q_div, int n, float edy,
#        cudaStream_t): the march's division against __fdiv_rn (a test hook)
_DIV_CHECK = [_P, _P, _P, _I, ctypes.c_float, _P]
# int ray_fwd(const float* vol, const float* p0, const float* d_hat,
#             float* out, int V, int R, int nx, int ny, int nz, int n_steps,
#             float step, cudaStream_t);
# int ray_adj(const float* y, const float* p0, const float* d_hat,
#             const float* phi, const float* alpha, const float* beta,
#             float* map, float* out, int V, int R, int nu, int nv,
#             int r_off, int nx, int ny, int nz, int n_steps, float step,
#             double du, double dv, cudaStream_t)
_RAY_FWD = [_P, _P, _P, _P, *[_I] * 6, ctypes.c_float, _P]
_RAY_ADJ = [*[_P] * 8, *[_I] * 9, ctypes.c_float, ctypes.c_double,
            ctypes.c_double, _P]
_SIGNATURES = {
    "slab_plane_fwd": _PLANE,
    "slab_plane_adj": _PLANE,
    "slab_plane_fwd_bf16": _PLANE,
    "slab_plane_adj_bf16": _PLANE,
    "slab_arc_fwd": _ARC,
    "slab_arc_adj": _ARC_ADJ,
    "slab_arc_fwd_bf16": _ARC,
    "slab_arc_adj_bf16": _ARC_ADJ,
    "slab_arc_jac": _ARC,
    "slab_arc_div_check": _DIV_CHECK,
    "resample_fwd": _RESAMPLE_FWD,
    "resample_transpose": _RESAMPLE_T,
    "ray_fwd": _RAY_FWD,
    "ray_adj": _RAY_ADJ,
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtomojax_torch_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands in parallel; raise with the output of any that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources unless the hashed library exists; returns its
    path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = BUILD_DIR / f"{tag}.tmp"
    nvcc = _nvcc()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare each entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib

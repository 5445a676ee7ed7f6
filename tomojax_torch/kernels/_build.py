"""Build ``csrc/*.cu`` with nvcc into a shared library and load it (ctypes).

The one module that knows how ``csrc/`` is compiled: the kernel library
here, and the tools' builds of other texts (``tools/adj_split``,
``tools/fmad_check``) through :func:`compile_libraries`. The library has a
plain C interface, so it builds in seconds (no PyTorch headers); each
source compiles in its own nvcc process, all started together, so the
build takes as long as its slowest source, and one more nvcc links them.
Every compile gets ``-I csrc/`` for the headers the sources include
(``common.cuh``). The library goes into ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of the flags,
the sources and the headers they include, so an edited source or header is
rebuilt and never loaded stale. nvcc is ``$CUDA_HOME/bin/nvcc``, else
``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "slab_plane.cu", CSRC / "slab_arc.cu",
           CSRC / "resample.cu", CSRC / "ray.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)
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
#             double du, double dv, cudaStream_t);
# int ray_jac(const float* vol, const float* p0, const float* d_hat,
#             const float* rpa, const float* der_ang, const float* der_dir,
#             float* det, float* jac, int V, int R, int nx, int ny, int nz,
#             int n_steps, float step, double inv_rlen, cudaStream_t)
_RAY_FWD = [_P, _P, _P, _P, *[_I] * 6, ctypes.c_float, _P]
_RAY_ADJ = [*[_P] * 8, *[_I] * 9, ctypes.c_float, ctypes.c_double,
            ctypes.c_double, _P]
_RAY_JAC = [*[_P] * 8, *[_I] * 6, ctypes.c_float, ctypes.c_double, _P]
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
    "ray_jac": _RAY_JAC,
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


def files(*sources: Path) -> list[Path]:
    """The sources and every header they include with quotes (found beside
    the source that includes it), each once."""
    out, todo = [], list(sources)
    while todo:
        f = todo.pop(0)
        if f not in out:
            out.append(f)
            todo += [f.parent / name
                     for name in _INCLUDE.findall(f.read_text())]
    return out


def texts(*sources: Path) -> dict[str, str]:
    """``{file name: text}`` of :func:`files`."""
    return {f.name: f.read_text() for f in files(*sources)}


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in files(*SOURCES):
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtomojax_torch_{h.hexdigest()[:16]}.so"


def _run(cmds) -> list[str]:
    """Run the commands in parallel → the output of each; raise with the
    output of any that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return outs


def compile_libraries(libs: dict[str, dict[str, str]], out_dir: Path,
                      extra=(), csrc: Path = CSRC) -> dict[str, str]:
    """Build each library ``libs[name]``, given as ``{file name: text}``,
    into ``out_dir/<name>.so``: the texts are written to ``out_dir/<name>/``
    (a header among them is found there before ``csrc``'s), and each
    ``.cu`` text compiles with ``NVCC_FLAGS``, ``extra`` and ``-I csrc`` in
    its own nvcc process, all libraries' at once, then one nvcc a library
    links. Returns each library's compiler output."""
    nvcc = _nvcc()
    compiles, links = [], []
    for name, srcs in libs.items():
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        objs = []
        for fname, text in srcs.items():
            (d / fname).write_text(text)
            if fname.endswith(".cu"):
                objs.append(d / f"{fname[:-3]}.o")
                compiles.append((name, [
                    nvcc, *NVCC_FLAGS, *extra, "-I", str(csrc), "-c", "-o",
                    str(objs[-1]), str(d / fname)]))
        links.append([nvcc, *NVCC_FLAGS, *extra, "-shared", "-o",
                      str(out_dir / f"{name}.so"), *map(str, objs)])
    outs = dict.fromkeys(libs, "")
    for (name, _), out in zip(compiles, _run([c for _, c in compiles])):
        outs[name] += out
    _run(links)
    return outs


def build() -> Path:
    """Compile the sources unless the hashed library exists; returns its
    path."""
    out = library_path()
    if out.exists():
        return out
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    try:
        compile_libraries({"lib": texts(*SOURCES)}, tmp)
        os.replace(tmp / "lib.so", out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the signature of each entry point
    it exports."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library."""
    return load_library(build())

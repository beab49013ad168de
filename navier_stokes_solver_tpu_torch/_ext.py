"""Build and load the package's CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds with ``nvcc`` alone (no PyTorch headers).  The build runs at first
use, from the sources in the checkout, into ``build/`` next to this file
(listed in ``.gitignore``): one ``nvcc -c`` per source, all started
together, then one link into a shared library, loaded with ctypes.  The
library's name carries a hash of the sources, the header they share
and the flags, so an edited source is never served by a stale build.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

__all__ = ["BUILD_DIR", "SOURCES", "HEADERS", "build", "load", "error_string"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(
    os.path.join(_PKG, "csrc", name) for name in ("cell_apply_f.cu", "scatter_v.cu", "apply_f_fused.cu")
)
# included by the sources: part of the build's hash
HEADERS = (os.path.join(_PKG, "csrc", "cell_apply_f.cuh"),)
BUILD_DIR = os.path.join(_PKG, "build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_c_ptr, _c_int, _c_double = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> str:
    """Wait for every process, then raise on the first that failed."""
    logs = [proc.communicate()[0] for _, proc in procs]
    for (cmd, proc), out in zip(procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}"
            )
    return "".join(logs)


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def build() -> tuple[str, str]:
    """Compile the kernels if this version is not built yet.

    Returns ``(library path, compiler log)``; the log holds ptxas's
    register and shared-memory report when this call compiled, else "".
    """
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"libnstt_kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in SOURCES]
    log = _run([_start([nvcc, *NVCC_FLAGS, "-c", s, "-o", o]) for s, o in zip(SOURCES, objs)])
    tmp = f"{path}.{tag}"
    _run([_start([nvcc, *ARCH, "-shared", "-o", tmp, *objs])])
    for o in objs:
        os.remove(o)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, log


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    lib = ctypes.CDLL(build()[0])
    lib.nstt_cell_apply_f.argtypes = [
        _c_int, _c_int, _c_int,  # is_f64, k, stokes
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int,  # x, 6 strides, lattice
        _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # uq, guq, w, tabs
        _c_double, _c_ptr, _c_double,  # nu, per-member nu (or null), inv_dt
        _c_ptr, _c_int, _c_int, _c_int, _c_ptr,  # y, nx, ny, members, stream
    ]
    lib.nstt_cell_apply_f.restype = _c_int
    lib.nstt_scatter_v.argtypes = [
        _c_int, _c_int,  # is_f64, k
        _c_ptr, _c_int, _c_int,  # loc, nx, ny
        _c_ptr, _c_int, _c_int, _c_int, _c_int,  # x, its 4 strides
        _c_ptr, _c_ptr, _c_ptr,  # diag, dirichlet, active
        _c_ptr, _c_int, _c_ptr,  # out, members, stream
    ]
    lib.nstt_scatter_v.restype = _c_int
    lib.nstt_apply_f_fused.argtypes = [
        _c_int, _c_int, _c_int,  # is_f64, k, stokes
        _c_ptr, _c_int, _c_int, _c_int, _c_int,  # x, its 4 strides
        _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # uq, guq, w, tabs
        _c_double, _c_ptr, _c_double,  # nu, per-member nu (or null), inv_dt
        _c_ptr, _c_ptr, _c_ptr,  # diag (or null), dirichlet, active
        _c_ptr, _c_int, _c_int, _c_int,  # out, nx, ny, members
        _c_int, _c_ptr,  # block shape, stream
    ]
    lib.nstt_apply_f_fused.restype = _c_int
    lib.nstt_error_string.argtypes = [_c_int]
    lib.nstt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err}: {load().nstt_error_string(err).decode()}"

"""Native (C++) host IO: the VTU writer and the gmsh reader, through ctypes.

The port's copy of the JAX package's ``native/``.  ``src/nstpu_io.cpp`` has
a plain C interface; at first use it is compiled with the system ``g++``
(``-O3 -std=c++17 -shared -fPIC``) into ``build/`` next to the package's
CUDA kernels (listed in ``.gitignore``), under a name that carries a hash
of the source and flags, so an edited source is never served by a stale
build.  Without a toolchain the library is unavailable and the callers
take their pure-Python versions (``io/vtu.py``, ``io/msh.py``), which
write and return the same bytes and arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["get_lib", "native_available", "write_vtu_native", "read_msh_native"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "src", "nstpu_io.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path() -> str:
    """Where this version of the source is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnstt_io-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile into a temporary name, then rename: a concurrent loader sees
    all of the library or none of it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


@functools.cache
def get_lib():
    """The native library, built on first use; None if it cannot be built."""
    path = library_path()
    if not os.path.exists(path) and not _build(path):
        return None
    lib = ctypes.CDLL(path)
    lib.nstpu_write_vtu.restype = ctypes.c_int
    lib.nstpu_write_vtu.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.nstpu_msh_open.restype = ctypes.c_void_p
    lib.nstpu_msh_open.argtypes = [ctypes.c_char_p]
    lib.nstpu_msh_counts.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)] * 5
    lib.nstpu_msh_fill.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)] + [
        ctypes.POINTER(ctypes.c_int32)
    ] * 8
    lib.nstpu_msh_close.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return get_lib() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def write_vtu_native(
    path: str,
    points: np.ndarray,
    conn: np.ndarray,
    velocity: np.ndarray,
    pressure: np.ndarray,
    partitioning: np.ndarray,
) -> bool:
    """C++ single-piece quad VTU writer. Returns False if the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    points = np.ascontiguousarray(points, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    velocity = np.ascontiguousarray(velocity, dtype=np.float64)
    pressure = np.ascontiguousarray(pressure, dtype=np.float64)
    partitioning = np.ascontiguousarray(partitioning, dtype=np.float64)
    rc = lib.nstpu_write_vtu(
        path.encode(),
        _dptr(points), points.shape[0],
        _iptr(conn), conn.shape[0],
        _dptr(velocity), _dptr(pressure), _dptr(partitioning),
    )
    if rc != 0:
        raise OSError(f"nstpu_write_vtu failed with code {rc} for {path!r}")
    return True


def read_msh_native(path: str):
    """C++ gmsh MSH1/MSH2/MSH4.1 parser.

    Returns dict(nodes_xy [n,2], tri [t,3], tri_tag [t], quad [q,4],
    quad_tag [q], edges [e,2], edge_tag [e], tet [k,4], tet_tag [k]) or
    None if the library is unavailable.  Raises ValueError on a parse
    failure.
    """
    lib = get_lib()
    if lib is None:
        return None
    h = lib.nstpu_msh_open(path.encode())
    if not h:
        raise ValueError(f"failed to parse gmsh file {path!r}")
    try:
        counts = [ctypes.c_int64() for _ in range(5)]
        lib.nstpu_msh_counts(h, *[ctypes.byref(c) for c in counts])
        n_nodes, n_tri, n_quad, n_edges, n_tet = (c.value for c in counts)
        out = dict(
            nodes_xy=np.empty((n_nodes, 2), dtype=np.float64),
            tri=np.empty((n_tri, 3), dtype=np.int32),
            tri_tag=np.empty(n_tri, dtype=np.int32),
            quad=np.empty((n_quad, 4), dtype=np.int32),
            quad_tag=np.empty(n_quad, dtype=np.int32),
            edges=np.empty((n_edges, 2), dtype=np.int32),
            edge_tag=np.empty(n_edges, dtype=np.int32),
            tet=np.empty((n_tet, 4), dtype=np.int32),
            tet_tag=np.empty(n_tet, dtype=np.int32),
        )
        lib.nstpu_msh_fill(h, _dptr(out["nodes_xy"]), *(_iptr(a) for k, a in out.items() if k != "nodes_xy"))
    finally:
        lib.nstpu_msh_close(h)
    return out

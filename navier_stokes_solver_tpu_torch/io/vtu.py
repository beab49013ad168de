"""VTU / PVTU output of (velocity, pressure) fields.

The port of the JAX package's ``io/vtu.py``, the equivalent of the
reference's ``DataOut::write_vtu_with_pvtu_record`` (NSSolver.cpp:761-797):
one quad patch per active cell with fields sampled at the cell-corner
vertices (deal.II ``build_patches()`` with the default single subdivision),
a per-cell ``partitioning`` field, and a ``.pvtu`` master record grouping
per-piece files with a 3-digit counter (NSSolver.cpp:789).  Binary
(base64) data arrays; host NumPy arrays in, files out.

Quad pieces go through the native C++ writer (``native/``) when it is
built, else through the Python writer here, which writes the same bytes:
the native file's layout, ending in a newline.  (The JAX package's Python
writer leaves that last newline out, so its files differ by one byte with
and without its native library.)  Triangle pieces (the ``-M`` backend)
always use the Python writer, as in the JAX package, with no final
newline.  ``write_vtu_tri_record`` (a decomposed simplex) waits for the
port of ``dist/`` (ROADMAP.md A.D9).
"""

from __future__ import annotations

import base64
import os
import re
import struct

import numpy as np

from navier_stokes_solver_tpu_torch.geometry.space import FESpace
from navier_stokes_solver_tpu_torch.native import write_vtu_native

__all__ = ["write_vtu", "write_vtu_record", "write_vtu_tri", "read_vtu"]

_VTK_TYPES = {"Float64": "<f8", "Int32": "<i4", "UInt8": "u1"}
_DATA_ARRAY = re.compile(r'<DataArray type="(\w+)"(?: Name="(\w+)")?(?: NumberOfComponents="(\d+)")? '
                         r'format="binary">([^<]*)</DataArray>')


def _b64_block(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def _piece(points, conn, offsets, types, vel, pres, partitioning) -> str:
    """One UnstructuredGrid piece as VTU text (lines joined by newlines,
    none after the last)."""
    n_pts, n_cells = points.shape[0], types.shape[0]
    array = lambda head, a: f"<DataArray {head} format=\"binary\">{_b64_block(a)}</DataArray>"
    return "\n".join([
        '<?xml version="1.0"?>',
        '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
        "<UnstructuredGrid>",
        f'<Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">',
        "<Points>",
        array('type="Float64" NumberOfComponents="3"', points.astype("<f8")),
        "</Points>",
        "<Cells>",
        array('type="Int32" Name="connectivity"', conn.astype("<i4")),
        array('type="Int32" Name="offsets"', offsets.astype("<i4")),
        array('type="UInt8" Name="types"', types),
        "</Cells>",
        '<PointData Vectors="velocity">',
        array('type="Float64" Name="velocity" NumberOfComponents="3"', vel.astype("<f8")),
        array('type="Float64" Name="pressure"', pres.astype("<f8")),
        "</PointData>",
        "<CellData>",
        array('type="Float64" Name="partitioning"', np.asarray(partitioning, dtype="<f8")),
        "</CellData>",
        "</Piece>",
        "</UnstructuredGrid>",
        "</VTKFile>",
    ])


def read_vtu(path: str) -> dict[str, np.ndarray]:
    """The data arrays of one VTU piece written here: ``points`` [n, 3],
    ``connectivity``, ``offsets``, ``types``, ``velocity`` [n, 3],
    ``pressure`` [n] and ``partitioning`` [cells], decoded bit for bit."""
    out = {}
    with open(path) as f:
        text = f.read()
    for vtk_type, name, ncomp, data in _DATA_ARRAY.findall(text):
        raw = base64.b64decode(data)
        (n,) = struct.unpack("<I", raw[:4])
        a = np.frombuffer(raw[4 : 4 + n], dtype=_VTK_TYPES[vtk_type])
        out[name or "points"] = a.reshape(-1, int(ncomp)) if ncomp else a
    return out


def _corner_fields(space: FESpace, u: np.ndarray, p: np.ndarray):
    """Sample velocity and pressure at the cell-corner vertex lattice."""
    kv, kp = space.deg_v, space.deg_p
    return u[:, ::kv, ::kv], p[::kp, ::kp]  # [2, ny+1, nx+1], [ny+1, nx+1]


def write_vtu(
    space: FESpace,
    u: np.ndarray,
    p: np.ndarray,
    path: str,
    *,
    partitioning: np.ndarray | None = None,
    cell_range: tuple[int, int, int, int] | None = None,
) -> str:
    """Write one VTU piece.

    ``cell_range = (y0, y1, x0, x1)``: restrict to that cell sub-rectangle
    (a decomposition tile); vertex lattices of adjacent pieces share their
    seam row/column, matching deal.II's per-rank pieces without ghost
    cells.  Default: the whole grid as one piece.
    """
    geo = space.geo
    y0c, y1c, x0c, x1c = cell_range or (0, geo.ny, 0, geo.nx)
    ny, nx = y1c - y0c, x1c - x0c
    act = geo.cell_active[y0c:y1c, x0c:x1c]

    # vertex lattice (corners) of the sub-rectangle
    xs = geo.x0 + (x0c + np.arange(nx + 1)) * geo.hx
    ys = geo.y0 + (y0c + np.arange(ny + 1)) * geo.hy
    X, Y = np.meshgrid(xs, ys)
    n_pts = (nx + 1) * (ny + 1)
    points = np.zeros((n_pts, 3))
    points[:, 0] = X.ravel()
    points[:, 1] = Y.ravel()

    def vid(iy, ix):
        return iy * (nx + 1) + ix

    iy, ix = np.nonzero(act)
    conn = np.stack(
        [vid(iy, ix), vid(iy, ix + 1), vid(iy + 1, ix + 1), vid(iy + 1, ix)],
        axis=1,
    ).astype(np.int32)
    n_cells = conn.shape[0]

    u_c, p_c = _corner_fields(space, np.asarray(u), np.asarray(p))
    u_c = u_c[:, y0c : y1c + 1, x0c : x1c + 1]
    p_c = p_c[y0c : y1c + 1, x0c : x1c + 1]
    vel = np.zeros((n_pts, 3))
    vel[:, 0] = u_c[0].ravel()
    vel[:, 1] = u_c[1].ravel()
    pres = p_c.ravel()
    if partitioning is None:
        partitioning = np.zeros(n_cells)
    elif np.ndim(partitioning) == 0:
        partitioning = np.full(n_cells, float(partitioning))
    else:
        partitioning = np.asarray(partitioning, dtype=np.float64)[y0c:y1c, x0c:x1c][act]

    if write_vtu_native(path, points, conn, vel, pres, partitioning):
        return path
    offsets = (np.arange(n_cells, dtype=np.int32) + 1) * 4
    types = np.full(n_cells, 9, dtype=np.uint8)  # VTK_QUAD
    with open(path, "w") as f:
        f.write(_piece(points, conn, offsets, types, vel, pres, partitioning) + "\n")
    return path


def write_vtu_tri(
    disc,
    u: np.ndarray,
    p: np.ndarray,
    path: str,
    *,
    partitioning: np.ndarray | None = None,
) -> str:
    """VTU output for the unstructured P2/P1 backend (triangle cells,
    fields sampled at the vertices).  ``disc`` needs ``coords_p``
    [n_vertices, 2] and ``dofs_p`` [n_tri, 3] (tensors or arrays)."""
    host = lambda a: a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    coords = host(disc.coords_p)
    tri = host(disc.dofs_p).astype(np.int32)
    n_pts = coords.shape[0]
    n_cells = tri.shape[0]
    points = np.zeros((n_pts, 3))
    points[:, :2] = coords
    vel = np.zeros((n_pts, 3))
    vel[:, 0] = np.asarray(u)[0, :n_pts]
    vel[:, 1] = np.asarray(u)[1, :n_pts]
    if partitioning is None:
        partitioning = np.zeros(n_cells)
    offsets = (np.arange(n_cells, dtype=np.int32) + 1) * 3
    types = np.full(n_cells, 5, dtype=np.uint8)  # VTK_TRIANGLE
    with open(path, "w") as f:
        f.write(_piece(points, tri, offsets, types, vel, np.asarray(p), partitioning))
    return path


def write_vtu_record(
    space: FESpace,
    u: np.ndarray,
    p: np.ndarray,
    *,
    directory: str = ".",
    basename: str = "output",
    counter: int = 0,
    partitioning: np.ndarray | None = None,
    tiles: tuple[int, int] | None = None,
) -> str:
    """Write per-piece ``output_NNN.R.vtu`` files + the ``.pvtu`` master
    record (3-digit grouping, NSSolver.cpp:789-793).

    ``tiles = (x_tiles, y_tiles)``: one piece per decomposition tile (the
    reference writes one piece per MPI rank) with ``partitioning`` = tile
    id (DataOut partitioning field, NSSolver.cpp:781-784).  Default: one
    piece, partitioning zero (a single-rank run).
    """
    os.makedirs(directory, exist_ok=True)
    geo = space.geo
    n_x, n_y = tiles or (1, 1)
    if geo.nx % n_x or geo.ny % n_y:
        raise ValueError(
            f"tiles {n_x}x{n_y} must divide the {geo.nx}x{geo.ny} grid "
            "(pieces would silently drop trailing cell rows/columns)"
        )
    nxl, nyl = geo.nx // n_x, geo.ny // n_y
    pieces = []
    for iy in range(n_y):
        for ix in range(n_x):
            rank = iy * n_x + ix
            piece = f"{basename}_{counter:03d}.{rank}.vtu"
            pieces.append(piece)
            write_vtu(
                space,
                u,
                p,
                os.path.join(directory, piece),
                partitioning=float(rank) if tiles is not None else partitioning,
                cell_range=(
                    None if tiles is None else (iy * nyl, (iy + 1) * nyl, ix * nxl, (ix + 1) * nxl)
                ),
            )
    pvtu = os.path.join(directory, f"{basename}_{counter:03d}.pvtu")
    _write_pvtu(pvtu, pieces)
    return pvtu


def _write_pvtu(path: str, pieces: list[str]):
    with open(path, "w") as f:
        f.write(
            "\n".join(
                [
                    '<?xml version="1.0"?>',
                    '<VTKFile type="PUnstructuredGrid" version="0.1" '
                    'byte_order="LittleEndian">',
                    '<PUnstructuredGrid GhostLevel="0">',
                    "<PPoints>",
                    '<PDataArray type="Float64" NumberOfComponents="3"/>',
                    "</PPoints>",
                    '<PPointData Vectors="velocity">',
                    '<PDataArray type="Float64" Name="velocity" '
                    'NumberOfComponents="3"/>',
                    '<PDataArray type="Float64" Name="pressure"/>',
                    "</PPointData>",
                    "<PCellData>",
                    '<PDataArray type="Float64" Name="partitioning"/>',
                    "</PCellData>",
                ]
                + [f'<Piece Source="{pc}"/>' for pc in pieces]
                + [
                    "</PUnstructuredGrid>",
                    "</VTKFile>",
                ]
            )
        )

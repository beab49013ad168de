"""Structured quad mesh of the Schaefer-Turek channel with voxelized cylinder.

Replicates the reference's internal mesh generator exactly
(NSSolver.cpp:6-112 / NSSolverStationary.cpp:6-112):

  * channel [0, 2.2] x [0, 0.41], subdivided into ``nx`` x ``ny`` quads;
  * cells whose *center* lies inside the circle of radius 0.05 centered at
    (0.2, 0.205) are deleted (NSSolver.cpp:43-44) -- a voxelized cylinder;
  * cells whose center distance to the circle center lies within
    radius +- diameter/2 (cell diagonal / 2) are tagged material_id = 10
    ("ring" cells, NSSolver.cpp:53-57);
  * boundary faces get ids: 7 = inlet (x = 0), 8 = outlet (x = 2.2),
    10 = faces of ring cells, 6 = every other boundary face
    (NSSolver.cpp:84-92).

Instead of deleting cells we keep the full rectangular cell array with an
``cell_active`` mask: inactive lanes are masked inside the matrix-free cell
kernels (fixed shapes keep every cell array dense and regular).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ChannelGeometry",
    "make_channel_geometry",
    "BOUNDARY_WALL",
    "BOUNDARY_INLET",
    "BOUNDARY_OUTLET",
    "BOUNDARY_CYLINDER",
    "INTERIOR",
]

# Boundary ids, matching the reference (NSSolver.cpp:84-92).
BOUNDARY_WALL = 6
BOUNDARY_INLET = 7
BOUNDARY_OUTLET = 8
BOUNDARY_CYLINDER = 10
INTERIOR = -1

# Face ordering convention shared with elements.taylor_hood: W, E, S, N.
N_FACES = 4


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """Static (NumPy, host-side) description of the channel mesh.

    Cell arrays are indexed ``[iy, ix]`` (row = y, column = x).
    """

    nx: int
    ny: int
    x0: float
    y0: float
    x1: float
    y1: float
    circle_center: tuple[float, float]
    circle_radius: float
    with_cylinder: bool

    cell_active: np.ndarray  # [ny, nx] bool
    cell_ring: np.ndarray  # [ny, nx] bool (material_id == 10)
    # face_id[f, iy, ix]: boundary id of face f (W,E,S,N) of cell (iy,ix),
    # INTERIOR if the face is shared by two active cells or the cell is
    # inactive.
    face_id: np.ndarray  # [4, ny, nx] int
    # Shape of the boundary-id-7 Dirichlet data as a function of y:
    # "parabola" = the reference's 4*u*y*(H-y)/H^2 inlet (NSSolver.hpp:71),
    # "constant" = uniform value u (moving lid of the driven-cavity case).
    inlet_kind: str = "parabola"

    @property
    def hx(self) -> float:
        return (self.x1 - self.x0) / self.nx

    @property
    def hy(self) -> float:
        return (self.y1 - self.y0) / self.ny

    @property
    def n_active_cells(self) -> int:
        return int(self.cell_active.sum())

    def cell_centers(self) -> tuple[np.ndarray, np.ndarray]:
        cx = self.x0 + (np.arange(self.nx) + 0.5) * self.hx
        cy = self.y0 + (np.arange(self.ny) + 0.5) * self.hy
        return cx, cy


def make_channel_geometry(
    nx: int,
    ny: int,
    *,
    x0: float = 0.0,
    y0: float = 0.0,
    x1: float = 2.2,
    y1: float = 0.41,
    circle_center: tuple[float, float] | None = None,
    circle_radius: float = 0.05,
    with_cylinder: bool = True,
) -> ChannelGeometry:
    """Build the channel geometry with the reference's exact cell selection.

    Defaults replicate NSSolver.cpp:13-27: bottom-left (0,0), top-right
    (2.2, 0.41), circle center (x0 + 0.2, (y0 + y1)/2) = (0.2, 0.205),
    radius 0.05.  ``with_cylinder=False`` gives a plain channel (used by the
    Poiseuille golden tests).
    """
    if circle_center is None:
        circle_center = (x0 + 0.2, (y0 + y1) / 2.0)

    hx = (x1 - x0) / nx
    hy = (y1 - y0) / ny
    cxs = x0 + (np.arange(nx) + 0.5) * hx
    cys = y0 + (np.arange(ny) + 0.5) * hy
    CX, CY = np.meshgrid(cxs, cys)  # [ny, nx]
    dist = np.hypot(CX - circle_center[0], CY - circle_center[1])
    diam = np.hypot(hx, hy)  # deal.II quad cell->diameter() = diagonal

    if with_cylinder:
        # NSSolver.cpp:43-44 -- delete cells with center strictly inside.
        cell_active = ~(dist < circle_radius)
        # NSSolver.cpp:53-57 -- ring tagging (applied to surviving cells).
        cell_ring = (
            cell_active
            & (dist < circle_radius + diam / 2.0)
            & (dist > circle_radius - diam / 2.0)
        )
    else:
        cell_active = np.ones((ny, nx), dtype=bool)
        cell_ring = np.zeros((ny, nx), dtype=bool)

    # Boundary faces: a face of an active cell is at the boundary if it lies
    # on the domain boundary or its neighbor cell is inactive.
    face_id = np.full((N_FACES, ny, nx), INTERIOR, dtype=np.int32)

    pad = np.zeros((ny + 2, nx + 2), dtype=bool)
    pad[1:-1, 1:-1] = cell_active
    nbr_w = pad[1:-1, 0:-2]
    nbr_e = pad[1:-1, 2:]
    nbr_s = pad[0:-2, 1:-1]
    nbr_n = pad[2:, 1:-1]

    def _assign(fidx: int, at_boundary: np.ndarray, face_on_inlet: np.ndarray,
                face_on_outlet: np.ndarray) -> None:
        """NSSolver.cpp:77-95 priority: inlet, outlet, ring->10, else 6."""
        b = cell_active & at_boundary
        ids = np.where(
            face_on_inlet,
            BOUNDARY_INLET,
            np.where(
                face_on_outlet,
                BOUNDARY_OUTLET,
                np.where(cell_ring, BOUNDARY_CYLINDER, BOUNDARY_WALL),
            ),
        )
        face_id[fidx][b] = ids[b]

    col = np.arange(nx)[None, :] * np.ones((ny, 1), dtype=int)
    first_col = col == 0
    last_col = col == nx - 1
    false = np.zeros((ny, nx), dtype=bool)

    _assign(0, first_col | ~nbr_w, first_col, false)  # W faces
    _assign(1, last_col | ~nbr_e, false, last_col)  # E faces
    _assign(2, (np.arange(ny)[:, None] == 0) | ~nbr_s, false, false)  # S
    _assign(3, (np.arange(ny)[:, None] == ny - 1) | ~nbr_n, false, false)  # N

    return ChannelGeometry(
        nx=nx,
        ny=ny,
        x0=x0,
        y0=y0,
        x1=x1,
        y1=y1,
        circle_center=circle_center,
        circle_radius=circle_radius,
        with_cylinder=with_cylinder,
        cell_active=cell_active,
        cell_ring=cell_ring,
        face_id=face_id,
    )

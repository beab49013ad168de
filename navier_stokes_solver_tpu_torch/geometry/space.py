"""Structured Taylor-Hood function-space layout on the channel grid.

Plays the role of deal.II's ``DoFHandler`` + block renumbering + index sets
(NSSolver.cpp:212-247), re-designed for dense accelerator arrays: instead
of a global sparse DoF numbering, velocity DoFs live on a dense node lattice ``[2, NVy, NVx]`` and
pressure DoFs on ``[NPy, NPx]`` (the natural "blocks").  Nodes interior to
the voxelized cylinder hole do not exist in the reference triangulation; here
they are lanes masked out of every inner product and constrained to zero
(``u_active`` / ``p_active``).

Dirichlet data replicates NSSolver.cpp:564-598: velocity components only
(``ComponentMask({true,true,false})``) on boundary ids 7 (inlet: parabolic
profile on the very first assembly, zero afterwards -- increment
formulation), 6 (walls) and 10 (cylinder).  Outlet (id 8) is a Neumann
boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navier_stokes_solver_tpu_torch.elements import TaylorHoodTables, make_taylor_hood
from navier_stokes_solver_tpu_torch.geometry.channel import (
    BOUNDARY_CYLINDER,
    BOUNDARY_INLET,
    BOUNDARY_WALL,
    ChannelGeometry,
)

__all__ = ["FESpace", "make_fe_space"]

_DIRICHLET_IDS = (BOUNDARY_WALL, BOUNDARY_INLET, BOUNDARY_CYLINDER)

# local node index ranges covered by each face (W, E, S, N) of a cell, for a
# degree-k lattice: (rows, cols) as (slice over 0..k).
def _face_nodes(k: int, face: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.arange(k + 1)
    zero = np.zeros(k + 1, dtype=int)
    if face == 0:  # W: col 0
        return rng, zero
    if face == 1:  # E: col k
        return rng, zero + k
    if face == 2:  # S: row 0
        return zero, rng
    return zero + k, rng  # N: row k


def _node_coords(n_cells: int, h: float, origin: float, nodes1d: np.ndarray) -> np.ndarray:
    """Physical coordinates of the degree-k node lattice along one axis."""
    k = len(nodes1d) - 1
    out = np.empty(k * n_cells + 1)
    for g in range(k * n_cells + 1):
        c = min(g // k, n_cells - 1)
        a = g - c * k
        out[g] = origin + (c + nodes1d[a]) * h
    return out


def _lattice_active(cell_active: np.ndarray, k: int) -> np.ndarray:
    """Mark lattice nodes touched by at least one active cell."""
    ny, nx = cell_active.shape
    acc = np.zeros((k * ny + 1, k * nx + 1), dtype=bool)
    for a in range(k + 1):
        for b in range(k + 1):
            rows = k * np.arange(ny) + a
            cols = k * np.arange(nx) + b
            acc[np.ix_(rows, cols)] |= cell_active
    return acc


def _boundary_node_mask(
    face_id: np.ndarray, k: int, ids: tuple[int, ...]
) -> np.ndarray:
    """Mark degree-k lattice nodes lying on faces with the given boundary ids."""
    _, ny, nx = face_id.shape
    acc = np.zeros((k * ny + 1, k * nx + 1), dtype=bool)
    for f in range(4):
        sel = np.isin(face_id[f], ids)
        iy, ix = np.nonzero(sel)
        if iy.size == 0:
            continue
        rows_loc, cols_loc = _face_nodes(k, f)
        for a, b in zip(rows_loc, cols_loc):
            acc[k * iy + a, k * ix + b] = True
    return acc


@dataclasses.dataclass(frozen=True)
class FESpace:
    """Host-side static description of the discrete (u, p) space."""

    geo: ChannelGeometry
    tables: TaylorHoodTables

    # Lattice sizes
    NVx: int
    NVy: int
    NPx: int
    NPy: int

    # Node coordinates
    x_v: np.ndarray  # [NVx]
    y_v: np.ndarray  # [NVy]
    x_p: np.ndarray  # [NPx]
    y_p: np.ndarray  # [NPy]

    # Masks
    u_active: np.ndarray  # [NVy, NVx] bool: node exists in the triangulation
    p_active: np.ndarray  # [NPy, NPx]
    u_dirichlet: np.ndarray  # [NVy, NVx] bool: ids {6, 7, 10}
    u_inlet: np.ndarray  # [NVy, NVx] bool: id 7

    @property
    def deg_v(self) -> int:
        return self.tables.deg_v

    @property
    def deg_p(self) -> int:
        return self.tables.deg_p

    @property
    def n_dofs_velocity(self) -> int:
        """Matches the reference's 'velocity =' DoF printout (NSSolver.cpp:244)."""
        return 2 * int(self.u_active.sum())

    @property
    def n_dofs_pressure(self) -> int:
        return int(self.p_active.sum())

    @property
    def n_dofs(self) -> int:
        return self.n_dofs_velocity + self.n_dofs_pressure

    def inlet_profile(self, u_max: float, H: float = 0.41) -> np.ndarray:
        """Parabolic inlet profile 4*u*y*(H-y)/H^2 at velocity-node rows.

        NSSolver.hpp:71 (unsteady, u = U_m = 0.3) and
        NSSolverStationary.hpp:75 (stationary, rampable u).  ``H`` is the
        hardcoded 0.41 from the reference, independent of the actual domain.
        Returns an [NVy] array (x-velocity; y-velocity is zero).

        For ``geo.inlet_kind == "constant"`` (driven-cavity lid) the profile
        is uniform ``u_max`` -- the boundary-id-7 mask selects the lid row,
        so the broadcast assigns u_x = u_max on the whole moving wall.
        """
        y = self.y_v
        if self.geo.inlet_kind == "constant":
            return np.full_like(y, u_max)
        return 4.0 * u_max * y * (H - y) / (H * H)


def make_fe_space(
    geo: ChannelGeometry, deg_v: int = 3, deg_p: int = 2
) -> FESpace:
    """Build the Taylor-Hood space over the channel geometry.

    Reference defaults: generated-mesh path uses Q3/Q2 (test.cpp:26-27);
    the file-mesh path switches to degree (2,1) (test.cpp:66-70).
    """
    tables = make_taylor_hood(deg_v, deg_p)
    kv, kp = deg_v, deg_p
    nx, ny = geo.nx, geo.ny

    u_active = _lattice_active(geo.cell_active, kv)
    p_active = _lattice_active(geo.cell_active, kp)
    u_dir = _boundary_node_mask(geo.face_id, kv, _DIRICHLET_IDS)
    u_inlet = _boundary_node_mask(geo.face_id, kv, (BOUNDARY_INLET,))

    return FESpace(
        geo=geo,
        tables=tables,
        NVx=kv * nx + 1,
        NVy=kv * ny + 1,
        NPx=kp * nx + 1,
        NPy=kp * ny + 1,
        x_v=_node_coords(nx, geo.hx, geo.x0, tables.nodes_v),
        y_v=_node_coords(ny, geo.hy, geo.y0, tables.nodes_v),
        x_p=_node_coords(nx, geo.hx, geo.x0, tables.nodes_p),
        y_p=_node_coords(ny, geo.hy, geo.y0, tables.nodes_p),
        u_active=u_active,
        p_active=p_active,
        u_dirichlet=u_dir,
        u_inlet=u_inlet,
    )

"""Lid-driven cavity geometry on the structured quad lattice.

The reference solves only the Schaefer-Turek channel; the north-star
fidelity gate (BASELINE.json) additionally names the lid-driven cavity.
This builds the standard singular cavity -- unit box, moving top lid
u = (U, 0) including the corner nodes (the formulation benchmarked by
Ghia, Ghia & Shin, J. Comput. Phys. 48 (1982) 387-411) -- reusing the
channel machinery: the lid is tagged with the Dirichlet boundary id 7
("inlet") and carries a *constant* profile (``inlet_kind="constant"``),
every other wall is id 6 (no-slip).  There is no outlet, so the pressure
is defined only up to a constant: the saddle system is singular but
consistent (the lid velocity is tangential, so the discrete divergence
data has no constant-pressure component) and the Krylov solvers converge
on it unchanged; normalize the pressure mean for output if needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from navier_stokes_solver_tpu_torch.geometry.channel import (
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    INTERIOR,
    ChannelGeometry,
    make_channel_geometry,
)

__all__ = ["make_cavity_geometry"]


def make_cavity_geometry(
    nx: int,
    ny: int | None = None,
    *,
    lx: float = 1.0,
    ly: float = 1.0,
) -> ChannelGeometry:
    """Unit (or ``lx`` x ``ly``) cavity: all walls no-slip, top lid id 7."""
    if ny is None:
        ny = nx
    geo = make_channel_geometry(
        nx, ny, x0=0.0, y0=0.0, x1=lx, y1=ly, with_cylinder=False
    )
    fid = geo.face_id.copy()
    # Every boundary face becomes a wall, then the top boundary (N faces of
    # the last cell row) becomes the moving lid.
    fid[fid != INTERIOR] = BOUNDARY_WALL
    north = fid[3]
    north[-1, :] = np.where(
        north[-1, :] != INTERIOR, BOUNDARY_INLET, north[-1, :]
    )
    assert not np.any(fid == BOUNDARY_OUTLET)
    return dataclasses.replace(geo, face_id=fid, inlet_kind="constant")

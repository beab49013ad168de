"""Structured channel and cavity geometry and function space layout (NumPy,
host-side)."""

from navier_stokes_solver_tpu_torch.geometry.channel import (
    BOUNDARY_CYLINDER,
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    BOUNDARY_WALL,
    INTERIOR,
    ChannelGeometry,
    make_channel_geometry,
)
from navier_stokes_solver_tpu_torch.geometry.cavity import make_cavity_geometry
from navier_stokes_solver_tpu_torch.geometry.space import FESpace, make_fe_space

__all__ = [
    "ChannelGeometry",
    "make_channel_geometry",
    "make_cavity_geometry",
    "FESpace",
    "make_fe_space",
    "BOUNDARY_WALL",
    "BOUNDARY_INLET",
    "BOUNDARY_OUTLET",
    "BOUNDARY_CYLINDER",
    "INTERIOR",
]

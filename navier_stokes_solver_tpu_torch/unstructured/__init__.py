"""Unstructured P2/P1 simplex backend (the reference's ``-M`` path)."""

from navier_stokes_solver_tpu_torch.unstructured.tri import (
    SimplexDisc,
    make_simplex_disc,
    triangulate_channel,
    triangulate_channel_curved,
)

__all__ = [
    "SimplexDisc",
    "make_simplex_disc",
    "triangulate_channel",
    "triangulate_channel_curved",
]

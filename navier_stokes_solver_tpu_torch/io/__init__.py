"""Host-side I/O: gmsh ``.msh`` import and export, checkpoints."""

from navier_stokes_solver_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_time_state,
    save_checkpoint,
    save_time_state,
)
from navier_stokes_solver_tpu_torch.io.msh import read_msh, write_msh

__all__ = [
    "read_msh",
    "write_msh",
    "save_checkpoint",
    "load_checkpoint",
    "save_time_state",
    "load_time_state",
]

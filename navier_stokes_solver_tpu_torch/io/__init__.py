"""Host-side I/O: VTU/PVTU output, gmsh ``.msh`` import and export,
checkpoints."""

from navier_stokes_solver_tpu_torch.io.checkpoint import (
    load_checkpoint,
    load_time_state,
    save_checkpoint,
    save_time_state,
)
from navier_stokes_solver_tpu_torch.io.msh import read_msh, write_msh
from navier_stokes_solver_tpu_torch.io.vtu import (
    write_vtu,
    write_vtu_record,
    write_vtu_tri,
    write_vtu_tri_record,
)

__all__ = [
    "write_vtu",
    "write_vtu_record",
    "write_vtu_tri",
    "write_vtu_tri_record",
    "read_msh",
    "write_msh",
    "save_checkpoint",
    "load_checkpoint",
    "save_time_state",
    "load_time_state",
]

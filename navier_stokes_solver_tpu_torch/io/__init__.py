"""Host-side I/O: gmsh ``.msh`` import and export."""

from navier_stokes_solver_tpu_torch.io.msh import read_msh, write_msh

__all__ = ["read_msh", "write_msh"]

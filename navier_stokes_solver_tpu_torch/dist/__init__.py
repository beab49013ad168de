"""Domain decomposition over ``torch.distributed``: one process per tile.

The reference's only parallelism is MPI domain decomposition of the mesh
cells with ghost exchange; the JAX package runs it as one program over a
device mesh inside ``shard_map``.  Here each tile is a rank (SPMD, the MPI
analog): ``dist.halo`` builds this rank's tile of the structured channel,
the operators exchange seam slabs with the neighbour ranks where the JAX
package ``ppermute``s, and products ``all_reduce`` where it ``psum``s
(``dist.mesh.Mesh``).  The host-driven solvers (``api``), the fused step
(``timeloop``) and every preconditioner then run unchanged on each rank:
every decision they take (convergence, line search, Newton stop) reads an
all-reduced scalar, the same bits on every rank.  So there is no
``DistKernels`` counterpart: ``api.kernels`` is the tile's kernel module
as it stands (and the direct LU, which needs the whole Jacobian, is
ineligible on a tile).

The ``-M`` simplex mesh decomposes into 1-D x-strips instead
(``dist.simplex``: ``decompose_simplex_disc`` builds every strip's tables,
``simplex_strip`` lowers this rank's), one strip per rank of a
``make_dd_mesh(n, 1)``; its operators exchange their seams with the left
and right neighbours (``Mesh.strip_seam_sum``).  ``make_mesh``'s ``'ens'``
axis shards an ensemble's members instead (``ensemble.run_sweep(mesh=...)``).
``launch`` spawns the ranks.
"""

from navier_stokes_solver_tpu_torch.dist.halo import (
    all_gather_blocks,
    decompose_disc,
    gather_blocks,
    scatter_blocks,
    tile_blocks,
)
from navier_stokes_solver_tpu_torch.dist.simplex import (
    DecomposedSimplex,
    all_gather_simplex_blocks,
    decompose_simplex_disc,
    gather_simplex_blocks,
    scatter_simplex_blocks,
    simplex_strip,
    strip_blocks,
)
from navier_stokes_solver_tpu_torch.dist.mesh import (
    Mesh,
    backend_for,
    launch,
    make_dd_mesh,
    make_mesh,
    rank_device,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_dd_mesh",
    "launch",
    "rank_device",
    "backend_for",
    "decompose_disc",
    "scatter_blocks",
    "gather_blocks",
    "all_gather_blocks",
    "tile_blocks",
    "DecomposedSimplex",
    "decompose_simplex_disc",
    "simplex_strip",
    "scatter_simplex_blocks",
    "gather_simplex_blocks",
    "strip_blocks",
    "all_gather_simplex_blocks",
]

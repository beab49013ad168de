"""Gather / scatter between node lattices and the cell-local layout.

Local node m = a * (k+1) + b of cell (iy, ix) sits at lattice position
(k*iy + a, k*ix + b) of a degree-k lattice [..., k*ny + 1, k*nx + 1].  The
gather is one strided view and one copy; the scatter is the JAX package's
ordered sum, bit for bit.  The velocity block's kernels read the strided
view (``ops/cell_kernel.py``) and do the ordered sum
(``ops/scatter_kernel.py``) themselves on the card.

On a tile of a domain decomposition (``Disc.decomposed``) the scatters
end with the seam exchange (``_seam_sum``): a tile's cells give only
their part of a seam node's sum, and the neighbour tiles add theirs.
"""

from __future__ import annotations

import torch

from navier_stokes_solver_tpu_torch.ops.disc import Disc

__all__ = [
    "lattice_view",
    "_gather",
    "_scatter",
    "_gather_v",
    "_gather_p",
    "_scatter_v",
    "_scatter_p",
    "_seam_sum",
]


def lattice_view(x: torch.Tensor, k: int, ny: int, nx: int) -> torch.Tensor:
    """The cell-local view of a degree-k lattice, without a copy.

    ``x``: [..., NY, NX] -> [k+1, k+1, ..., ny, nx], element
    ``[a, b, ..., iy, ix]`` = ``x[..., k*iy + a, k*ix + b]``.  Neighbouring
    cells share their edge nodes, so the view overlaps itself.
    """
    lead = x.shape[:-2]
    sY, sX = x.stride()[-2:]
    return x.as_strided(
        (k + 1, k + 1) + lead + (ny, nx),
        (sY, sX) + x.stride()[:-2] + (k * sY, k * sX),
        x.storage_offset(),
    )


def _gather(x: torch.Tensor, k: int, ny: int, nx: int) -> torch.Tensor:
    """Gather cell-local DoFs from a degree-k lattice.

    ``x``: [..., NY, NX] -> [n_loc, ..., ny, nx] (contiguous): the
    ``lattice_view`` and one copy.
    """
    return lattice_view(x, k, ny, nx).reshape(((k + 1) ** 2,) + x.shape[:-2] + (ny, nx))


def _scatter(loc: torch.Tensor, k: int, ny: int, nx: int) -> torch.Tensor:
    """Scatter-add cell-local contributions onto the degree-k lattice.

    ``loc``: [n_loc, ..., ny, nx] -> [..., NY, NX].  Every lattice node sums
    its (at most four) contributions in ascending local index m, as the
    JAX package's sum of dilated pads does -- so the result is the same
    ordered sum, bit for bit, and the same on every run (no atomics).  The
    local nodes are added in four groups -- (a < k, b < k), (a < k, b = k),
    (a = k, b < k), (a = k, b = k) -- each one strided in-place add: within
    a group no two contributions meet, and across groups the order at
    every node is ascending m.
    """
    lead = loc.shape[1:-2]
    out = loc.new_zeros(lead + (k * ny + 1, k * nx + 1))
    L = loc.reshape((k + 1, k + 1) + lead + (ny, nx))
    nd = len(lead)
    # loc axes after the reshape: (a, b, *lead, iy, ix)
    lead_ax = tuple(range(2, 2 + nd))
    iy, ix = 2 + nd, 3 + nd
    inner = out[..., : k * ny, : k * nx]
    # (a < k, b < k): lattice (k*iy + a, k*ix + b) inside the lower-left block
    inner.unflatten(-1, (nx, k)).unflatten(-3, (ny, k)).add_(
        L[:k, :k].permute(lead_ax + (iy, 0, ix, 1))
    )
    # (a < k, b = k): columns k*(ix+1)
    out[..., : k * ny, k::k].unflatten(-2, (ny, k)).add_(
        L[:k, k].permute(tuple(a - 1 for a in lead_ax) + (iy - 1, 0, ix - 1))
    )
    # (a = k, b < k): rows k*(iy+1)
    out[..., k::k, : k * nx].unflatten(-1, (nx, k)).add_(
        L[k, :k].permute(tuple(a - 1 for a in lead_ax) + (iy - 1, ix - 1, 0))
    )
    # (a = k, b = k)
    out[..., k::k, k::k].add_(L[k, k])
    return out


def _gather_v(disc: Disc, u: torch.Tensor) -> torch.Tensor:
    return _gather(u, disc.deg_v, disc.ny, disc.nx)  # [n_v, 2, ny, nx]


def _gather_p(disc: Disc, p: torch.Tensor) -> torch.Tensor:
    return _gather(p, disc.deg_p, disc.ny, disc.nx)  # [n_p, ny, nx]


def _seam_sum(disc: Disc, y: torch.Tensor) -> torch.Tensor:
    """Complete the seam nodes' partial sums of a tile's lattice tensor
    ``y`` [..., NY, NX] with the neighbour tiles' (``dist.Mesh.seam_sum``:
    the x-exchange, then the y-exchange); ``y`` itself on a disc that is
    not decomposed."""
    if not disc.decomposed:
        return y
    if disc.mesh is None:
        raise ValueError("a tile built without a process mesh cannot exchange its seams")
    return disc.mesh.seam_sum(y)


def _scatter_v(disc: Disc, loc: torch.Tensor) -> torch.Tensor:
    return _seam_sum(disc, _scatter(loc, disc.deg_v, disc.ny, disc.nx))


def _scatter_p(disc: Disc, loc: torch.Tensor) -> torch.Tensor:
    return _seam_sum(disc, _scatter(loc, disc.deg_p, disc.ny, disc.nx))

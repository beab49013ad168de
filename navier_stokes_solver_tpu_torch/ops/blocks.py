"""Block vectors (u, p) -- the analog of Trilinos ``MPI::BlockVector``.

Velocity ``[2, NVy, NVx]`` and pressure ``[NPy, NPx]`` tensors; an
ensemble's (``ensemble/``) carry a leading member axis, ``[B, 2, NVy, NVx]``
and ``[B, NPy, NPx]``, with per-member products (``krylov.bvdot``).  Inner
products are plain global sums: every vector is zero on lattice nodes that
do not exist in the reference triangulation (cylinder-hole interior), so no
masking is needed in reductions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Blocks", "vdot", "norm", "axpy", "is_batched", "per_member"]


class Blocks(NamedTuple):
    """A (velocity, pressure) block vector."""

    u: torch.Tensor  # [2, NVy, NVx]
    p: torch.Tensor  # [NPy, NPx]


def vdot(x: Blocks, y: Blocks) -> torch.Tensor:
    return torch.dot(x.u.reshape(-1), y.u.reshape(-1)) + torch.dot(
        x.p.reshape(-1), y.p.reshape(-1)
    )


def norm(x: Blocks) -> torch.Tensor:
    """l2 norm over all blocks (Trilinos BlockVector::l2_norm semantics)."""
    return torch.sqrt(vdot(x, x))


def axpy(a, x: Blocks, y: Blocks) -> Blocks:
    """a * x + y."""
    return Blocks(u=a * x.u + y.u, p=a * x.p + y.p)


def is_batched(nu) -> bool:
    """True for an ensemble's viscosities: a [B] tensor (a number or a
    0-dim tensor is one run's)."""
    return isinstance(nu, torch.Tensor) and nu.dim() == 1


def per_member(v, ndim: int, axis: int):
    """``v`` as it scales a tensor of ``ndim`` dimensions whose member axis
    is ``axis``: a number or 0-dim tensor as given, a [B] tensor reshaped to
    broadcast along that axis."""
    if not is_batched(v):
        return v
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


"""Dense pressure-Schur legs for the ``-M`` simplex backend.

The port of the JAX package's ``unstructured/dense.py``.  The simplex
pressure space is small (P1 vertices: 2.5k at the 60x40 triangulation,
13.2k on the reference's finest shipped mesh, new_mesh.msh), while its
Schur solves would otherwise be nested iterations on every outer iteration
(a Jacobi-CG on the pressure mass, and a Jacobi-preconditioned FGMRES on
the pressure Laplacian: this backend has no pressure V-cycle).  The
(constant per-mesh) pressure mass and pressure Laplacian are assembled once
and inverted, and each leg becomes one matrix-vector product with the
inverse -- an exact solve, strictly stronger than the reference's ILU/CG
inner solves (NSSolver.hpp:228-236).

Assembly mirrors ``unstructured.ops`` exactly:

* ``Mp_raw`` -- the unscaled pressure mass, no boundary mask
  (``apply_Mp`` = ``Mp_raw / nu``);
* ``Lp``     -- the pressure Laplacian with identity rows / columns on the
  outlet nodes (``apply_Lp``'s convention).

The element matrices are summed into the dense matrix on the host (numpy,
f64, ``np.add.at``: a fixed order).  The inverse is taken in f64 on the
disc's device (``torch.linalg.inv``; the JAX package inverts with numpy on
the host: at 13.2k pressure nodes that is tens of seconds of host time,
on the card a fraction of a second) and stored in f32, as in the JAX
package -- the two inverses agree to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.unstructured.elements import make_simplex_tables

__all__ = ["DENSE_SCHUR_MAX_NP", "attach_dense_schur", "assemble_Mp_raw", "assemble_Lp"]

# Above this pressure-space size the inverses stop being small (n_p^2 * 4
# bytes each: 16,384 -> 1 GiB per matrix); the nested iterative legs apply.
DENSE_SCHUR_MAX_NP = 16_384


def _element_tables(disc):
    """Host f64 copies of the P1 element quantities of the pressure
    operators."""
    t = make_simplex_tables()
    invJ = disc.invJ.cpu().numpy().astype(np.float64)  # [T, 2, 2]
    detJ = disc.detJ.cpu().numpy().astype(np.float64)  # [T]
    wdet = t.w_q[:, None] * detJ[None, :]  # [n_q, T]
    return t.phi_p, t.dphi_p, invJ, wdet, disc.dofs_p.cpu().numpy()


def _scatter_elem_matrices(Ke, dofs_p, n, free=None):
    """Accumulate per-element 3x3 matrices into a dense [n, n] array.

    ``free``: optional node mask; constrained rows / columns become
    identity (``apply_Lp``'s elimination)."""
    A = np.zeros((n, n), dtype=np.float64)
    rows = np.repeat(dofs_p, 3, axis=1).reshape(-1)  # [T*9]
    cols = np.tile(dofs_p, (1, 3)).reshape(-1)
    np.add.at(A, (rows, cols), Ke.transpose(0, 2, 1).reshape(-1))
    if free is not None:
        A[~free, :] = 0.0
        A[:, ~free] = 0.0
        idx = np.nonzero(~free)[0]
        A[idx, idx] = 1.0
    # orphan nodes (touching no element, e.g. lattice points inside the
    # voxelized cylinder hole of triangulate_channel) have exactly-zero rows
    # in the matrix-free operator; identity keeps the matrix invertible.
    # Krylov vectors are identically zero there, so the legs agree.
    orphan = np.nonzero(np.diag(A) == 0.0)[0]
    A[orphan, orphan] = 1.0
    return A


def assemble_Mp_raw(disc) -> np.ndarray:
    """Dense unscaled pressure mass (``apply_Mp`` times nu; no boundary
    mask, NSSolver.hpp:228-236 semantics), f64 on the host."""
    phi_p, _, _, wdet, dofs_p = _element_tables(disc)
    Ke = np.einsum("qi,qj,qt->tij", phi_p, phi_p, wdet)
    return _scatter_elem_matrices(Ke, dofs_p, disc.n_nodes_p)


def assemble_Lp(disc) -> np.ndarray:
    """Dense pressure Laplacian with ``apply_Lp``'s elimination convention
    (identity on the outlet nodes), f64 on the host."""
    _, dphi_p, invJ, wdet, dofs_p = _element_tables(disc)
    gpsi = np.einsum("qnd,tdk->qnkt", dphi_p, invJ)  # physical grads
    Ke = np.einsum("qikt,qjkt,qt->tij", gpsi, gpsi, wdet)
    free = disc.p_free.cpu().numpy()
    return _scatter_elem_matrices(Ke, dofs_p, disc.n_nodes_p, free=free)


def _inverse_f32(a: np.ndarray, device) -> torch.Tensor:
    m = torch.as_tensor(a, dtype=torch.float64, device=device)
    return torch.linalg.inv(m).to(torch.float32)


def attach_dense_schur(disc, max_np: int = DENSE_SCHUR_MAX_NP):
    """``disc`` with the f32 dense inverses of the pressure mass and the
    pressure Laplacian attached (``dense_mp_raw_inv`` / ``dense_lp_inv``),
    or unchanged when the pressure space has more than ``max_np`` nodes or
    the disc is an x-strip (its operators are seam-partial, not the global
    matrices: the legs iterate)."""
    if disc.n_nodes_p > max_np or disc.decomposed:
        return disc
    return disc.replace(
        dense_mp_raw_inv=_inverse_f32(assemble_Mp_raw(disc), disc.device),
        dense_lp_inv=_inverse_f32(assemble_Lp(disc), disc.device),
    )

"""P2 -> P1 p-multigrid for the simplex velocity block.

The port of the JAX package's ``unstructured/pmg.py``.  On
an unstructured triangulation the coarse space is the order-reduced P1
space on the same triangles (p-coarsening):

  * prolongation = nodal P1 evaluation at the P2 nodes: identity on
    vertices, an edge midpoint takes the mean of its endpoints (exact on
    P1; two gathers);
  * restriction = its transpose, a padded gather-sum over each vertex's
    adjacent midpoints (deterministic);
  * coarse operator = the same weak form rediscretized with the P1 basis on
    the same triangles, the linearized convection evaluated from the
    vertex-injected state;
  * smoothing = fixed-step Jacobi-preconditioned GMRES
    (``precond.mg._gmres_smooth``);
  * coarse solve = Jacobi-preconditioned GMRES to a loose tolerance.

Reference behaviour tied: the inner-solve preconditioner role of
NSSolverStationary.hpp:225-231 (AMG on the velocity block) /
NSSolver.hpp:183-189 (ILU).

An ensemble's [B] ``nu`` builds one V-cycle for its B members (vectors
[B, 2, n]): the transfers are shared, the element matrices and diagonals
per member (``unstructured.ops``), the fine smoothing the batched GMRES
smoother, the coarse solve the batched GMRES with a per-member stop.

On an x-strip (``dist/simplex.py``) the transfers run through the strip's
local tables: prolongation is pointwise (the seam copies stay equal with no
exchange), restriction weighs each midpoint's contribution by its copy's
1 / multiplicity and completes the vertex sums with the pressure-space seam
exchange, the coarse operator's scatter ends with that exchange, and the
smoother and the coarse GMRES take the strip's seam-weighted product.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as Fn

from navier_stokes_solver_tpu_torch.krylov import bnorm, gmres, gmres_batched, norm_of
from navier_stokes_solver_tpu_torch.ops.blocks import is_batched
from navier_stokes_solver_tpu_torch.ops.matfree import LinearizationQ
from navier_stokes_solver_tpu_torch.precond.mg import _gmres_smooth, as_dtype_scalar
from navier_stokes_solver_tpu_torch.unstructured import ops as sops
from navier_stokes_solver_tpu_torch.unstructured.tri import SimplexDisc

__all__ = ["make_p_vcycle", "prolong", "restrict", "apply_F1", "make_apply_F1", "diag_F1"]


def prolong(disc: SimplexDisc, xc: torch.Tensor) -> torch.Tensor:
    """[(B,) 2, n_verts] P1 nodal -> [(B,) 2, n_nodes_v] P2 nodal (exact on
    P1)."""
    pad = Fn.pad(xc, (0, 1))
    vert = pad[..., disc.pmg_vert]
    mid = 0.5 * (pad[..., disc.pmg_edge[:, 0]] + pad[..., disc.pmg_edge[:, 1]])
    return torch.where(disc.pmg_vert < disc.n_nodes_p, vert, mid)


def _vertex_values(disc: SimplexDisc, u: torch.Tensor) -> torch.Tensor:
    """[..., n_nodes_v] -> its values at the P1 nodes [..., n_verts] (0 on a
    strip's padding)."""
    return Fn.pad(u, (0, 1))[..., disc.pmg_vert_v]


def restrict(disc: SimplexDisc, rf: torch.Tensor) -> torch.Tensor:
    """Transpose of ``prolong``: [(B,) 2, n_nodes_v] -> [(B,) 2, n_verts].
    On a strip an edge two strips share is summed by both, so each copy of
    a midpoint adds its 1 / multiplicity share, and the vertex sums are
    completed by the seam exchange; the vertex part is pointwise."""
    mid = 0.5 * rf
    if disc.seam_v is not None:
        mid = mid * disc.seam_v.weight
    add = Fn.pad(mid, (0, 1))[..., disc.pmg_mid].sum(dim=-1)
    add = sops._seam_sum(disc, disc.seam_p, add)
    return _vertex_values(disc, rf) + add


def _eval_v1(disc: SimplexDisc, u: torch.Tensor):
    """P1 velocity values / physical gradients at the volume quadrature
    points ([(B,) 2, n_verts] in; layouts of ``unstructured.ops``)."""
    return sops._eval_loc(disc.phi_p, disc.Dp, u.transpose(-1, -2)[..., disc.dofs_p, :])


def make_apply_F1(disc, nu, inv_dt, linq1, *, stokes, bc_diag):
    """``x -> F1 x``: the P1 rediscretization of the velocity block (the
    weak form of ``unstructured.ops.apply_F`` with the P1 basis), element
    matrices assembled once."""
    if stokes:
        elem = sops._stokes_apply(disc.Lpe, nu)
    else:
        Fe = sops._velocity_elem(disc.phi_p, disc.PWp, disc.Dp, disc.Lpe, disc.Mpe, nu, inv_dt, linq1)
        shape = Fe.shape[:-2]  # [(B,) T]
        elem = lambda loc: sops._elem_mv(Fe, loc.reshape(*shape, 6, 1)).reshape(*shape, 3, 2)

    def apply(x):
        y = sops._scatter_p1(disc, elem(x.transpose(-1, -2)[..., disc.dofs_p, :]))
        return torch.where(disc.u_dirichlet_p1, bc_diag * x, y)

    return apply


def apply_F1(disc, nu, inv_dt, linq1, x, *, stokes, bc_diag):
    return make_apply_F1(disc, nu, inv_dt, linq1, stokes=stokes, bc_diag=bc_diag)(x)


def diag_F1(disc, nu, inv_dt, linq1, *, stokes):
    loc = sops._velocity_diag(
        disc.phi_p, disc.PWp, disc.Dp, disc.Lpe, disc.Mpe, nu, inv_dt, linq1, stokes
    )
    d = sops._scatter_p1(disc, loc)
    return torch.where(d == 0.0, 1.0, d)


def make_p_vcycle(
    disc: SimplexDisc,
    nu,
    inv_dt,
    state_u,
    *,
    stokes: bool,
    diag_f: torch.Tensor,
    smooth_degree: int = 3,
    coarse_iters: int = 60,
    coarse_rtol: float = 5e-2,
    dtype: torch.dtype | None = None,
):
    """``M(b) -> x``: one two-level V-cycle for the P2 velocity block (fine
    GMRES smoothing, P1 coarse correction by GMRES to ``coarse_rtol``).

    ``diag_f``: the (post-BC) fine-level diagonal of the caller's
    linearization.  ``dtype``: compute precision of the cycle.  A [B]
    ``nu``: the cycle of an ensemble's B members (``state_u``, ``diag_f``
    and the vectors [B, 2, n]).
    """
    batched = is_batched(nu)
    out_dtype = disc.dtype
    if dtype is not None and dtype != disc.dtype:
        disc = disc.to(dtype)
        diag_f = diag_f.to(dtype)
        if state_u is not None:
            state_u = state_u.to(dtype)
        nu = as_dtype_scalar(nu, dtype)
        inv_dt = as_dtype_scalar(inv_dt, dtype)

    dir_fine = disc.u_dirichlet
    dir_coarse = disc.u_dirichlet_p1
    if stokes or state_u is None:
        linq = linq1 = None
    else:
        vals, grads = sops._eval_v(disc, state_u)
        linq = LinearizationQ(u=vals, gradu=grads, p=None)
        v1, g1 = _eval_v1(disc, _vertex_values(disc, state_u))  # vertex injection
        linq1 = LinearizationQ(u=v1, gradu=g1, p=None)

    A = sops.make_apply_F(disc, nu, inv_dt, linq, stokes=stokes, bc_diag=diag_f)
    d1 = diag_F1(disc, nu, inv_dt, linq1, stokes=stokes)
    A1 = make_apply_F1(disc, nu, inv_dt, linq1, stokes=stokes, bc_diag=d1)

    dinv = 1.0 / diag_f
    dinv1 = 1.0 / d1

    # the seam-weighted, all-reduced product on a strip (None: the plain one)
    dot = sops.make_dot(disc) if disc.decomposed else None
    if batched:
        coarse, norm_ = gmres_batched, bnorm
    else:
        coarse, norm_ = functools.partial(gmres, dot=dot), norm_of(dot)

    def M(b):
        b = b.to(disc.dtype)
        x = _gmres_smooth(A, dinv, b, torch.zeros_like(b), smooth_degree, batched=batched, dot=dot)
        r = torch.where(dir_fine, 0.0, b - A(x))
        rc = torch.where(dir_coarse, 0.0, restrict(disc, r))
        xc, _ = coarse(
            A1, rc, torch.zeros_like(rc), tol=coarse_rtol * norm_(rc),
            maxiter=coarse_iters, M=lambda v: dinv1 * v, basis=coarse_iters,
        )
        x = x + torch.where(dir_fine, 0.0, prolong(disc, xc))
        x = _gmres_smooth(A, dinv, b, x, smooth_degree, batched=batched, dot=dot)
        return x.to(out_dtype)

    return M

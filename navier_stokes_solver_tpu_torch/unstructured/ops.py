"""Matrix-free P2/P1 operators on unstructured triangle meshes.

The port of the JAX package's ``unstructured/ops.py``: the weak form of
``ops.matfree`` (NSSolver.cpp:313-599 / NSSolverStationary.cpp:317-577) and
its Dirichlet row-elimination semantics for the ``-M`` simplex path, on
P2/P1 triangles with per-element affine maps.

The JAX package evaluates each operand at the quadrature points and
projects back (a chain of einsums per call).  Here the linear operators
apply per-element dense matrices assembled from the same weak form
(``SimplexDisc.Kv``, ``Be``, ``Lpe`` ... and, per linearization, the Newton
velocity block of ``_velocity_elem``): gather the element DoFs, one batched
matrix product, scatter -- a handful of launches per application.  The
scatter goes through the precomputed scatter inverse (``gather_v`` /
``gather_p``): a padded gather plus a sum over the padded axis,
deterministic and free of atomics.  The nonlinear residual keeps the
quadrature-point pipeline.  ``make_apply_F`` / ``make_apply_jacobian``
assemble the element matrices once per linearization; ``apply_F`` /
``apply_jacobian`` (the JAX package's signatures) assemble per call.

Layouts: vectors are ``u [2, n_nodes_v]`` and ``p [n_nodes_p]`` as in the
JAX package; element-local velocity is ``[T, 6 (m), 2 (c)]`` (flattened
(m, c)); quadrature values ``[T, n_q, 2]`` and gradients ``[T, 2 (d/dx_k),
n_q, 2 (c)]`` -- the ``LinearizationQ`` of this backend.

The Jacobian apply of ``make_apply_jacobian`` takes a leading batch axis
(``u [..., 2, n_nodes_v]``, ``p [..., n_nodes_p]``): the direct-LU matrix
build applies it to a batch of one-hot columns at once
(``precond.blocks.dense_jacobian``).

Member axis (an ensemble, ``ensemble/``).  Every operator also takes B
members at once: ``nu`` a [B] tensor, vectors ``u [B, 2, n_nodes_v]`` and
``p [B, n_nodes_p]``, and every element-local, quadrature and element-matrix
tensor with a leading member axis (``[B, T, ...]``; ``LINQ_MEMBER_AXIS``).
The mesh, masks and tables are shared; ``dirichlet_values``, ``diag_Lp``
and the pressure operators without ``nu`` do not depend on the member.  A
member's arithmetic is the unbatched call's, up to the rounding of the
batched products.

X-strips (``dist/simplex.py``).  On a strip of a decomposed mesh
(``disc.decomposed``) every scatter ends with the seam sum with the
neighbour strips (``dist.mesh.Mesh.strip_seam_sum``), the inner product
weighs the seam nodes by 1 / multiplicity and sums over the ranks
(``make_dot``), and lift and drag sum over the ranks; the pointwise steps
need nothing, since every copy of a seam node holds the same value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from navier_stokes_solver_tpu_torch.krylov import tvdot
from navier_stokes_solver_tpu_torch.krylov.solvers import WeightedDot
from navier_stokes_solver_tpu_torch.ops.blocks import Blocks, per_member
from navier_stokes_solver_tpu_torch.ops.matfree import LinearizationQ
from navier_stokes_solver_tpu_torch.unstructured.tri import SimplexDisc

__all__ = [
    "eval_state",
    "apply_F",
    "apply_B",
    "apply_Bt",
    "apply_Mp",
    "apply_Mp_raw",
    "apply_Lp",
    "apply_Fp",
    "diag_Lp",
    "apply_jacobian",
    "residual",
    "diag_F",
    "diag_Mp",
    "lift_drag_forces",
    "dirichlet_values",
    "make_dot",
    "make_apply_F",
    "make_apply_jacobian",
]

# ``make_apply_jacobian``'s apply takes a leading batch axis
JACOBIAN_BATCH_AXIS = True
# the member axis of an ensemble's linearization: leading
LINQ_MEMBER_AXIS = 0


# ---------------------------------------------------------------------------
# Gather / scatter, evaluation / projection
# ---------------------------------------------------------------------------


def _gather_v(disc: SimplexDisc, u: torch.Tensor) -> torch.Tensor:
    """[..., 2, Nv] -> element-local [..., T, 6, 2]."""
    return u.transpose(-1, -2)[..., disc.dofs_v, :]


def _sum_rows(flat: torch.Tensor, table: torch.Tensor, comps: bool) -> torch.Tensor:
    """Node sums of flat element contributions through a scatter-inverse
    table (the sentinel gathers an appended zero): ``[..., S]`` ->
    ``[..., N]``, or with ``comps`` ``[..., S, 2]`` -> ``[..., 2, N]``."""
    if comps:
        flat = Fn.pad(flat, (0, 0, 0, 1)).transpose(-1, -2)
    else:
        flat = Fn.pad(flat, (0, 1))
    g = torch.index_select(flat, -1, table.reshape(-1))
    return g.reshape(*flat.shape[:-1], *table.shape).sum(dim=-1)


def _strip_mesh(disc: SimplexDisc):
    if disc.mesh is None:
        raise ValueError("a strip built without a process mesh cannot exchange its seams")
    return disc.mesh


def _seam_sum(disc: SimplexDisc, seam, y: torch.Tensor) -> torch.Tensor:
    """Complete a strip's partial sums ``y`` [..., n_loc] with the neighbour
    strips (``seam``: the space's ``SeamTables``); ``y`` itself on the
    whole mesh."""
    return y if seam is None else _strip_mesh(disc).strip_seam_sum(y, seam)


def _scatter_v(disc: SimplexDisc, loc: torch.Tensor) -> torch.Tensor:
    """[..., T, 6, 2] element contributions -> [..., 2, Nv]."""
    y = _sum_rows(loc.reshape(*loc.shape[:-3], -1, 2), disc.gather_v, True)
    return _seam_sum(disc, disc.seam_v, y)


def _scatter_p(disc: SimplexDisc, loc: torch.Tensor) -> torch.Tensor:
    """[..., T, 3] -> [..., Np]."""
    y = _sum_rows(loc.reshape(*loc.shape[:-2], -1), disc.gather_p, False)
    return _seam_sum(disc, disc.seam_p, y)


def _scatter_p1(disc: SimplexDisc, loc: torch.Tensor) -> torch.Tensor:
    """[..., T, 3, 2] P1 velocity contributions -> [..., 2, Np] (the
    p-multigrid's coarse space)."""
    y = _sum_rows(loc.reshape(*loc.shape[:-3], -1, 2), disc.gather_p, True)
    return _seam_sum(disc, disc.seam_p, y)


def _eval_loc(phi, D, loc):
    """Values [(B,) T, n_q, 2] and physical gradients [(B,) T, 2, n_q, 2] of
    the element-local field ``loc`` [(B,) T, n, 2] (``phi`` [n_q, n], ``D``
    [T, 2, n_q, n])."""
    T, _, n_q, n = D.shape
    vals = torch.matmul(phi, loc)
    grads = torch.matmul(D.reshape(T, 2 * n_q, n), loc).reshape(*loc.shape[:-3], T, 2, n_q, 2)
    return vals, grads


def _eval_v(disc: SimplexDisc, u: torch.Tensor):
    return _eval_loc(disc.phi_v, disc.Dv, _gather_v(disc, u))


def _eval_p(disc: SimplexDisc, p: torch.Tensor) -> torch.Tensor:
    """[(B,) Np] -> values [(B,) T, n_q]."""
    return p[..., disc.dofs_p] @ disc.phi_p.T


def make_dot(disc: SimplexDisc):
    """Inner product over (u, p) block vectors: the plain global sum
    (``tvdot``) on the whole mesh; on a strip the seam-weighted local sum,
    all-reduced over the ranks (the Trilinos owned-DoF dot allreduce).  The
    weights follow each vector's last extent: velocity-space (``n_nodes_v``)
    or pressure-space (``n_nodes_p``, also the p-multigrid's coarse
    velocity), which the decomposition keeps apart."""
    if not disc.decomposed:
        return tvdot
    wv, wp = disc.seam_v.weight, disc.seam_p.weight
    return WeightedDot({wv.shape[-1]: wv, wp.shape[-1]: wp}, _strip_mesh(disc).all_reduce)


def _project_v(disc: SimplexDisc, f_val, f_grad) -> torch.Tensor:
    """loc[t,m,c] = sum_q w_q detJ_t (f_val[t,q,c] phi_m + sum_k
    f_grad[t,k,q,c] d phi_m / d x_k), scattered to [2, Nv]."""
    T, n_q = disc.wq.shape
    f = torch.cat([f_val, f_grad.reshape(*f_grad.shape[:-4], T, 2 * n_q, 2)], dim=-2)
    return _scatter_v(disc, torch.matmul(disc.PDWv, f))


def _project_p(disc: SimplexDisc, f_val) -> torch.Tensor:
    return _scatter_p(disc, torch.matmul(disc.PWp, f_val[..., None])[..., 0])


def eval_state(disc: SimplexDisc, st: Blocks) -> LinearizationQ:
    vals, grads = _eval_v(disc, st.u)
    return LinearizationQ(u=vals, gradu=grads, p=_eval_p(disc, st.p))


# ---------------------------------------------------------------------------
# Element matrices of the velocity block
# ---------------------------------------------------------------------------


def _scaled(nu, K):
    """``nu * K`` for per-element tensors ``K`` [T, ...]: [B, T, ...] for an
    ensemble's [B] ``nu``."""
    return per_member(nu, K.dim() + 1, 0) * K


def _velocity_elem(phi, PW, D, K, M, nu, inv_dt, lin):
    """The Newton-regime velocity block per element, [(B,) T, 2n, 2n] with
    rows and columns (node, component): viscosity nu K, the time term
    inv_dt M, the linearized convection (u_k . grad) du (same component)
    and (du . grad) u_k (coupling the components)."""
    T, n = K.shape[0], K.shape[1]
    a = torch.einsum("...tql,tlqn->...tqn", lin.u, D)  # u_k . grad phi_n
    same = _scaled(nu, K) + inv_dt * M + torch.matmul(PW, a)  # [(B,) T, n, n]
    # (du . grad) u_k: phi_m phi_n d u_k,c / d x_l at row (m, c), column (n, l)
    cross = torch.einsum("tmq,qn,...tlqc->...tmcnl", PW, phi, lin.gradu)
    eye = torch.eye(2, dtype=K.dtype, device=K.device)
    F = cross + same[..., :, :, None, :, None] * eye[None, None, :, None, :]
    return F.reshape(*F.shape[:-5], T, 2 * n, 2 * n)


def _elem_mv(mat: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Per-element matrix times element-local vectors: [T, i, j] x
    [..., T, j, c] -> [..., T, i, c], one product batched over the elements
    (a leading batch folds into its free dimension; without one, ``bmm``,
    whose host cost is half the einsum's); an ensemble's per-member
    matrices [B, T, i, j] x [B, T, j, c] as one batched product."""
    if mat.dim() == 4 or loc.dim() == 3:
        return torch.matmul(mat, loc)
    return torch.einsum("tij,...tjc->...tic", mat, loc)


def _stokes_apply(K, nu):
    """The Stokes velocity block (the components decouple): nu K per
    component on element-local [(B,) T, n, 2]."""
    Kn = _scaled(nu, K)
    return lambda loc: _elem_mv(Kn, loc)


def _F_elem_apply(disc, nu, inv_dt, linq, stokes):
    """Element-local apply of the velocity block, [(B,) T, 6, 2] -> the
    same."""
    if stokes:
        return _stokes_apply(disc.Kv, nu)
    Fe = _velocity_elem(disc.phi_v, disc.PWv, disc.Dv, disc.Kv, disc.Mv, nu, inv_dt, linq)
    shape = Fe.shape[:-2]  # [(B,) T]
    return lambda loc: _elem_mv(Fe, loc.reshape(*shape, 12, 1)).reshape(*shape, 6, 2)


def make_apply_F(disc, nu, inv_dt, linq, *, stokes, bc_diag=None):
    """``x_u -> F x_u`` with the element matrices assembled once."""
    elem = _F_elem_apply(disc, nu, inv_dt, linq, stokes)

    def apply(x_u):
        y = _scatter_v(disc, elem(_gather_v(disc, x_u)))
        if bc_diag is not None:
            y = torch.where(disc.u_dirichlet, bc_diag * x_u, y)
        return y

    return apply


def apply_F(disc, nu, inv_dt, linq, x_u, *, stokes, bc_diag=None):
    return make_apply_F(disc, nu, inv_dt, linq, stokes=stokes, bc_diag=bc_diag)(x_u)


def make_apply_jacobian(disc, nu, inv_dt, linq, bc_diag, *, stokes):
    """``x -> J x`` (``Blocks``) with the element matrices assembled once:
    the velocity rows [F | B^T] and the continuity rows -/+ B (Stokes /
    Newton regime), Dirichlet velocity rows ``bc_diag * x``.  One run's
    apply takes a leading batch axis of vectors; an ensemble's, its
    members."""
    T = disc.n_tri
    if stokes:  # nu K (x) I2: rows and columns (node, component)
        Kn = _scaled(nu, disc.Kv)
        eye = torch.eye(2, dtype=disc.dtype, device=disc.device)
        Fe = (Kn[..., :, None, :, None] * eye[:, None, :]).reshape(*Kn.shape[:-2], 12, 12)
    else:
        Fe = _velocity_elem(disc.phi_v, disc.PWv, disc.Dv, disc.Kv, disc.Mv, nu, inv_dt, linq)
    Bt = -disc.Be.transpose(1, 2)
    Ju = torch.cat([Fe, Bt.expand(*Fe.shape[:-2], 12, 3)], dim=-1)  # [(B,) T, 12, 15]
    Jp = -disc.Be if stokes else disc.Be  # [T, 3, 12]

    def apply(x: Blocks) -> Blocks:
        lead = x.p.shape[:-1]
        lu = _gather_v(disc, x.u).reshape(*lead, T, 12, 1)
        loc = torch.cat([lu, x.p[..., disc.dofs_p, None]], dim=-2)
        yu = _scatter_v(disc, _elem_mv(Ju, loc).reshape(*lead, T, 6, 2))
        yp = _scatter_p(disc, _elem_mv(Jp, lu)[..., 0])
        return Blocks(u=torch.where(disc.u_dirichlet, bc_diag * x.u, yu), p=yp)

    return apply


def apply_jacobian(disc, nu, inv_dt, linq, bc_diag, x: Blocks, *, stokes):
    return make_apply_jacobian(disc, nu, inv_dt, linq, bc_diag, stokes=stokes)(x)


# ---------------------------------------------------------------------------
# Block operators (signatures mirror ops.matfree)
# ---------------------------------------------------------------------------


def apply_Bt(disc, x_p, *, zero_dirichlet_rows=False):
    loc = _elem_mv(disc.Be.transpose(1, 2), x_p[..., disc.dofs_p][..., None])
    y = _scatter_v(disc, -loc)
    if zero_dirichlet_rows:
        y = torch.where(disc.u_dirichlet, 0.0, y)
    return y


def apply_B(disc, x_u, *, stokes):
    T = disc.n_tri
    loc = _elem_mv(disc.Be, _gather_v(disc, x_u).reshape(*x_u.shape[:-2], T, 12, 1))[..., 0]
    return _scatter_p(disc, -loc if stokes else loc)


def _p_elem(disc, mat, x_p):
    return _elem_mv(mat, x_p[..., disc.dofs_p][..., None])[..., 0]


def apply_Mp(disc, nu, x_p):
    y = _scatter_p(disc, _p_elem(disc, disc.Mpe, x_p))
    return y / per_member(nu, y.dim(), 0)


def apply_Lp(disc: SimplexDisc, x_p: torch.Tensor) -> torch.Tensor:
    """Pressure Laplacian (grad psi_j, grad psi_i) on P1 nodes, the
    Cahouet-Chabard / PCD leg.  Outlet rows AND columns are eliminated
    (identity rows), so the operator stays exactly symmetric."""
    free = disc.p_free
    y = _scatter_p(disc, _p_elem(disc, disc.Lpe, torch.where(free, x_p, 0.0)))
    return torch.where(free, y, x_p)


def apply_Fp(disc: SimplexDisc, nu, inv_dt, linq, x_p: torch.Tensor) -> torch.Tensor:
    """Pressure convection-diffusion operator (the PCD middle factor),
    Fp = inv_dt * Mp_raw + nu * Lp + N_p(u_k), with ``apply_Lp``'s
    elimination convention."""
    free = disc.p_free
    mat = _scaled(nu, disc.Lpe) + inv_dt * disc.Mpe
    if linq is not None:
        mat = mat + torch.matmul(disc.PWp, torch.einsum("...tql,tlqn->...tqn", linq.u, disc.Dp))
    y = _scatter_p(disc, _p_elem(disc, mat, torch.where(free, x_p, 0.0)))
    return torch.where(free, y, x_p)


def apply_Mp_raw(disc: SimplexDisc, x_p: torch.Tensor) -> torch.Tensor:
    """Unscaled pressure mass with ``apply_Lp``'s elimination convention."""
    free = disc.p_free
    y = _scatter_p(disc, _p_elem(disc, disc.Mpe, torch.where(free, x_p, 0.0)))
    return torch.where(free, y, x_p)


def dirichlet_values(disc, inlet_amp):
    gx = torch.where(disc.u_inlet, inlet_amp * disc.inlet_profile1, 0.0)
    return torch.stack([gx, torch.zeros_like(gx)])


def residual(
    disc, nu, inv_dt, st, u_old, bc_diag, *, stokes, inlet_amp, p_out=1.0,
    consistent=False,
):
    """Residual with the Dirichlet rows set to ``bc_diag * g``.
    ``consistent`` flips the Newton-regime continuity rhs to the
    Jacobian-consistent -(q, div u_k) (see ``ops.matfree.residual``)."""
    if stokes:
        ru = p_out * disc.neumann_rhs1
        rp = torch.zeros_like(st.p)
    else:
        linq = eval_state(disc, st)
        u_old_q = torch.matmul(disc.phi_v, _gather_v(disc, u_old))
        conv = torch.einsum("...tql,...tlqc->...tqc", linq.u, linq.gradu)
        f_val = -inv_dt * (linq.u - u_old_q) - conv
        eye = torch.eye(2, dtype=disc.dtype, device=disc.device)
        f_grad = (-per_member(nu, linq.gradu.dim(), 0) * linq.gradu
                  + linq.p[..., :, None, :, None] * eye[None, :, None, :])
        ru = _project_v(disc, f_val, f_grad) + p_out * disc.neumann_rhs1
        div = linq.gradu[..., 0, :, 0] + linq.gradu[..., 1, :, 1]
        rp = _project_p(disc, -div if consistent else div)
    g = dirichlet_values(disc, inlet_amp)
    ru = torch.where(disc.u_dirichlet, bc_diag * g, ru)
    return Blocks(u=ru, p=rp)


# ---------------------------------------------------------------------------
# Diagonals
# ---------------------------------------------------------------------------


def _velocity_diag(phi, PW, D, K, M, nu, inv_dt, lin, stokes):
    """Element diagonals [(B,) T, n, 2] of the velocity block (the diagonal
    of ``_velocity_elem``)."""
    visc = _scaled(nu, torch.diagonal(K, dim1=1, dim2=2))
    if stokes:
        return visc[..., None].expand(*visc.shape, 2)
    a = torch.einsum("...tql,tlqn->...tqn", lin.u, D)
    same = visc + inv_dt * torch.diagonal(M, dim1=1, dim2=2) + torch.einsum("tnq,...tqn->...tn", PW, a)
    # phi_n^2 d u_k,c / d x_c for component c
    dcc = torch.stack([lin.gradu[..., 0, :, 0], lin.gradu[..., 1, :, 1]], dim=-1)  # [(B,) T, q, 2]
    return same[..., None] + torch.matmul(PW * phi.T[None], dcc)


def diag_F(disc, nu, inv_dt, linq, *, stokes):
    loc = _velocity_diag(disc.phi_v, disc.PWv, disc.Dv, disc.Kv, disc.Mv, nu, inv_dt, linq, stokes)
    d = _scatter_v(disc, loc)
    return torch.where(d == 0.0, 1.0, d)


def diag_Lp(disc):
    """Diagonal of the pressure Laplacian; eliminated (outlet) rows get 1."""
    d = _scatter_p(disc, torch.diagonal(disc.Lpe, dim1=1, dim2=2))
    d = torch.where(disc.p_free, d, 1.0)
    return torch.where(d == 0.0, 1.0, d)


def diag_Mp(disc, nu):
    d = _scatter_p(disc, torch.diagonal(disc.Mpe, dim1=1, dim2=2))
    d = d / per_member(nu, d.dim() + 1, 0)
    return torch.where(d == 0.0, 1.0, d)


# ---------------------------------------------------------------------------
# Lift / drag (edge integral over boundary id 10, NSSolver.cpp:839-938)
# ---------------------------------------------------------------------------


def lift_drag_forces(disc, nu, st: Blocks):
    """(drag, lift) forces: the stress integrated over the (curved-mesh
    polygon) cylinder edges, 0-dim tensors ([B] for an ensemble's).  On a
    strip, the sum over the ranks (Utilities::MPI::sum, NSSolver.cpp:933-934),
    strips without cylinder edges included."""
    if disc.cyl_tri.shape[0] == 0:
        z = torch.zeros((*st.p.shape[:-1], 2), dtype=disc.dtype, device=disc.device)
        if disc.decomposed:
            z = _strip_mesh(disc).all_reduce(z)
        return z[..., 0], z[..., 1]
    dphi_e = disc.dphi_v_edge[disc.cyl_edge]  # [E, qe, 6, 2]
    phip_e = disc.phi_p_edge[disc.cyl_edge]  # [E, qe, 3]
    u_loc = st.u[..., :, disc.dofs_v[disc.cyl_tri]]  # [(B,) 2, E, 6]
    p_loc = st.p[..., disc.dofs_p[disc.cyl_tri]]  # [(B,) E, 3]
    invJ_e = disc.invJ[disc.cyl_tri]  # [E, 2, 2]

    gref = torch.einsum("eqmd,...cem->...eqcd", dphi_e, u_loc)
    grad = torch.einsum("...eqcd,edk->...eqck", gref, invJ_e)  # [(B,) E, qe, 2, 2]
    pv = torch.einsum("eqn,...en->...eq", phip_e, p_loc)

    sig = per_member(nu, grad.dim(), 0) * (grad + grad.transpose(-2, -1))
    sig = sig - pv[..., None, None] * torch.eye(2, dtype=disc.dtype, device=disc.device)
    # force[c] = -sum_e sum_q w_q * len_e * sig[c, d] n_e[d]
    force = -torch.einsum("...eqcd,ed,q,e->...c", sig, disc.cyl_normal, disc.w_e, disc.cyl_len)
    if disc.decomposed:
        force = _strip_mesh(disc).all_reduce(force)
    return force[..., 0], force[..., 1]

"""Geometric multigrid on the velocity block (the AMG/ILU equivalence layer).

The port of the JAX package's ``precond/mg.py`` on the slice's path: the
rediscretization hierarchy (the channel regenerated at semi-coarsened cell
counts, dense 1-D tensor-factor transfers) and the V-cycle with the
fixed-step Jacobi-preconditioned GMRES smoother.  The reference
preconditions its stationary velocity-block inner solves with Trilinos
``PreconditionAMG`` (NSSolverStationary.hpp:225-231).  Dirichlet rows and
non-existent lattice lanes are identity/diagonal rows; transfers zero them
so coarse corrections stay in the interior subspace.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.elements import make_taylor_hood
from navier_stokes_solver_tpu_torch.elements.taylor_hood import lagrange_values
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.krylov import cg, gmres, tvdot
from navier_stokes_solver_tpu_torch.ops.disc import Disc, MGEdge, make_disc
from navier_stokes_solver_tpu_torch.ops.matfree import (
    LinearizationQ,
    _eval_v,
    apply_F,
    diag_F,
)

__all__ = ["attach_mg", "make_mg_vcycle", "mg_level_shapes", "as_dtype_scalar"]


def as_dtype_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (a Python float), so that a cast context's
    scalars carry exactly the precision of its tensors."""
    return float(torch.tensor(v, dtype=dtype))


# ---------------------------------------------------------------------------
# Host-side hierarchy construction
# ---------------------------------------------------------------------------


def _interp_1d(n_src: int, n_dst: int, deg: int, nodes: np.ndarray) -> np.ndarray:
    """[N_dst, N_src] evaluation of a degree-``deg`` piecewise-Lagrange
    function on an ``n_src``-cell unit grid at the nodes of an ``n_dst``-cell
    grid (grids need not be nested)."""
    N_dst = deg * n_dst + 1
    N_src = deg * n_src + 1
    P = np.zeros((N_dst, N_src))
    for g in range(N_dst):
        c = min(g // deg, n_dst - 1)
        a = g - c * deg
        x = (c + nodes[a]) / n_dst
        j = int(np.clip(np.floor(x * n_src - 1e-12), 0, n_src - 1))
        t = x * n_src - j
        P[g, j * deg : (j + 1) * deg + 1] = lagrange_values(nodes, np.array([t]))[0]
    return P


def _coarse_shape(nx: int, ny: int, hx: float, hy: float) -> tuple[int, int]:
    """Aspect-aware (semi-)coarsening: halve only the direction with the
    smaller cell size while the anisotropy exceeds 1.5x, both otherwise
    (the bench channel has hx/hy = 3.76 at 100x70; point-smoothed MG
    needs the strongly coupled direction coarsened first)."""
    if hy < hx / 1.5:
        return nx, -(-ny // 2)
    if hx < hy / 1.5:
        return -(-nx // 2), ny
    return -(-nx // 2), -(-ny // 2)


def attach_mg(disc: Disc, *, min_cells: int = 48, max_levels: int = 8) -> Disc:
    """Attach a multigrid chain of the reference channel to ``disc``."""
    tables = make_taylor_hood(disc.deg_v, disc.deg_p, disc.n_q1d)
    nodes = tables.nodes_v
    deg = disc.deg_v
    W, H = disc.hx * disc.nx, disc.hy * disc.ny
    put = lambda a: torch.as_tensor(a, device=disc.device).to(disc.dtype)

    def build(nx: int, ny: int, level: int) -> MGEdge | None:
        nxc, nyc = _coarse_shape(nx, ny, W / nx, H / ny)
        if level >= max_levels or nxc * nyc < min_cells or nyc < 2:
            return None
        space_c = make_fe_space(make_channel_geometry(nxc, nyc), disc.deg_v, disc.deg_p)
        disc_c = make_disc(space_c, disc.dtype, disc.device)
        edge_down = build(nxc, nyc, level + 1)
        if edge_down is not None:
            disc_c = disc_c.replace(mg=edge_down)
        return MGEdge(
            coarse=disc_c,
            Pvx=put(_interp_1d(nxc, nx, deg, nodes)),
            Pvy=put(_interp_1d(nyc, ny, deg, nodes)),
            Evx=put(_interp_1d(nx, nxc, deg, nodes)),
            Evy=put(_interp_1d(ny, nyc, deg, nodes)),
        )

    edge = build(disc.nx, disc.ny, 0)
    return disc.replace(mg=edge) if edge is not None else disc


def mg_level_shapes(disc: Disc) -> list[tuple[int, int]]:
    out = [(disc.nx, disc.ny)]
    while disc.mg is not None:
        disc = disc.mg.coarse
        out.append((disc.nx, disc.ny))
    return out


# ---------------------------------------------------------------------------
# V-cycle
# ---------------------------------------------------------------------------


def _zero_constrained(disc: Disc, x):
    return torch.where(disc.u_active & ~disc.u_dirichlet, x, 0.0)


def _gmres_smooth(A, dinv, b, x, k: int):
    """``k`` fixed steps of Jacobi-preconditioned GMRES as a smoother.

    Chebyshev assumes a real positive spectrum; the Jacobi-normalized
    convection-dominated velocity block has eigenvalues far off the real
    axis, where Chebyshev smoothing diverges.  A fixed-k minimal-residual
    polynomial adapts to the actual spectrum and cannot increase the
    residual.  The smoother is (mildly) nonlinear; every consumer is a
    flexible method, so that is safe.  No host synchronization: the
    (k+1) x k least-squares problem is solved on the device.
    """
    r0 = b - A(x)
    tiny = torch.finfo(r0.dtype).tiny
    beta = torch.sqrt(tvdot(r0, r0))
    V = [r0 * (1.0 / torch.clamp_min(beta, tiny))]
    Z = []
    H = r0.new_zeros((k + 1, k))
    for j in range(k):
        z = dinv * V[j]
        Z.append(z)
        w = A(z)
        for i in range(j + 1):
            hij = tvdot(V[i], w)
            w = w - hij * V[i]
            H[i, j] = hij
        hj1 = torch.sqrt(tvdot(w, w))
        H[j + 1, j] = hj1
        V.append(w / torch.clamp_min(hj1, tiny))
    # least squares min || beta e1 - H y ||  via normal equations on the
    # tiny (k+1) x k Hessenberg (well-conditioned for a smoother; k <= 4);
    # solve_ex skips the error-check synchronization, the isfinite guard
    # below covers a singular system
    HtH = H.T @ H + tiny * torch.eye(k, dtype=H.dtype, device=H.device)
    y, _ = torch.linalg.solve_ex(HtH, H[0] * beta)
    y = torch.where(torch.isfinite(y), y, 0.0)
    dx = y[0] * Z[0]
    for j in range(1, k):
        dx = dx + y[j] * Z[j]
    return x + dx


def make_mg_vcycle(
    disc: Disc,
    nu: float,
    inv_dt: float,
    state_u: torch.Tensor | None,
    *,
    stokes: bool,
    smooth_degree: int = 2,
    coarse_iters: int = 48,
    coarse_rtol: float = 5e-2,
    dtype: torch.dtype | None = None,
    smoother: str = "gmres",
):
    """Build ``M(b) -> x``: one V(smooth_degree, smooth_degree) cycle for the
    velocity block F at the current linearization.

    ``state_u`` is the fine-level velocity field (None in the Stokes
    regime); it is restricted through the chain to rediscretize the
    linearized convection on every level.  ``dtype``: compute precision of
    the cycle (disc, state, and the scalars ``nu`` and ``inv_dt`` are all
    cast to it); the result is cast back to the input dtype.
    """
    if smoother != "gmres":
        raise NotImplementedError(
            f"mg_smoother={smoother!r} is not ported yet; only 'gmres' is "
            "(ROADMAP.md A.D3: _chebyshev and _estimate_lmax)"
        )
    out_dtype = disc.dtype
    if dtype is not None and dtype != disc.dtype:
        disc = disc.to(dtype)
        if state_u is not None:
            state_u = state_u.to(dtype)
        nu = as_dtype_scalar(nu, dtype)
        inv_dt = as_dtype_scalar(inv_dt, dtype)

    # ---- walk the chain, building per-level operators ----
    levels = []  # (disc, A, dinv, edge)
    d = disc
    u = state_u
    while True:
        if stokes or u is None:
            linq = None
        else:
            vals, grads = _eval_v(d, u)
            linq = LinearizationQ(u=vals, gradu=grads, p=None)
        diag = diag_F(d, nu, inv_dt, linq, stokes=stokes)

        def A(x, _d=d, _l=linq, _dg=diag):
            return apply_F(_d, nu, inv_dt, _l, x, stokes=stokes, bc_diag=_dg)

        levels.append((d, A, 1.0 / diag, d.mg))
        if d.mg is None:
            break
        edge = d.mg
        if u is not None and not stokes:
            # state restriction: nodal evaluation of the (continuous) fine
            # function at coarse nodes
            u = torch.einsum("Yy,cyx,Xx->cYX", edge.Evy, u, edge.Evx)
        d = edge.coarse

    def restrict(edge: MGEdge, r):
        return torch.einsum("yY,cyx,xX->cYX", edge.Pvy, r, edge.Pvx)

    def prolong(edge: MGEdge, x):
        return torch.einsum("Yy,cyx,Xx->cYX", edge.Pvy, x, edge.Pvx)

    def vcycle(li: int, b):
        d, A, dinv, edge = levels[li]
        if li == len(levels) - 1:
            # CG is only valid on the SPD Stokes block; the NS-regime F is
            # nonsymmetric (convection), so the coarse solve is GMRES there
            solver = cg if (stokes or state_u is None) else gmres
            x, _ = solver(
                A,
                b,
                torch.zeros_like(b),
                tol=coarse_rtol * torch.sqrt(tvdot(b, b)),
                maxiter=coarse_iters,
                M=lambda r: dinv * r,
            )
            return x
        x = _gmres_smooth(A, dinv, b, torch.zeros_like(b), smooth_degree)
        r = _zero_constrained(d, b - A(x))
        bc = _zero_constrained(edge.coarse, restrict(edge, r))
        xc = vcycle(li + 1, bc)
        x = x + _zero_constrained(d, prolong(edge, xc))
        return _gmres_smooth(A, dinv, b, x, smooth_degree)

    def M(b):
        return vcycle(0, b.to(disc.dtype)).to(out_dtype)

    return M

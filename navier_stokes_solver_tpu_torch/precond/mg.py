"""Geometric multigrid on the velocity block (the AMG/ILU equivalence layer).

The port of the JAX package's ``precond/mg.py`` on the slice's path: the
rediscretization hierarchy (the fine level's geometry regenerated at
semi-coarsened cell counts, dense 1-D tensor-factor transfers over the
velocity and pressure lattices), the velocity V-cycle with its three smoothers (the fixed-step
Jacobi-preconditioned GMRES smoother, Chebyshev-Jacobi, and Chebyshev
over the cell-block additive Schwarz sweep of ``precond/schwarz.py``),
and the pressure-Laplacian V-cycle of the Cahouet-Chabard Schur leg with
Chebyshev-Jacobi smoothing.  The reference
preconditions its stationary velocity-block inner solves with Trilinos
``PreconditionAMG`` (NSSolverStationary.hpp:225-231).  Dirichlet rows and
non-existent lattice lanes are identity/diagonal rows; transfers zero them
so coarse corrections stay in the interior subspace.

Both V-cycles also run an ensemble's B members at once (a [B] ``nu``,
batched vectors): the hierarchy (geometry, transfers, the Lp cycle's
spectral estimate) is shared, the per-level diagonals and linearizations
are per member, the GMRES smoother solves one least-squares problem per
member, the Chebyshev smoothers take one spectral estimate per member
and the Schwarz sweep one set of cell matrices per member, and the
coarse solves are the batched Krylov solvers.

On a tile of a domain decomposition (``dist.decompose_disc`` builds its
chain, tile by tile) the products are the seam-weighted, all-reduced ones
(``ops.matfree.make_dot``), and a restriction weighs the fine seams, then
completes the coarse seams with the seam exchange: prolongation and state
restriction are nodal evaluations of a continuous function, tile-local
exact.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.elements import make_taylor_hood
from navier_stokes_solver_tpu_torch.elements.taylor_hood import lagrange_values
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.krylov import bnorm, bvdot, cg, cg_batched, gmres, gmres_batched, tvdot
from navier_stokes_solver_tpu_torch.ops.blocks import is_batched
from navier_stokes_solver_tpu_torch.ops.disc import Disc, MGEdge, make_disc
from navier_stokes_solver_tpu_torch.ops.matfree import (
    LinearizationQ,
    _eval_v,
    apply_F,
    apply_Lp,
    diag_F,
    diag_Lp,
    make_dot,
)
from navier_stokes_solver_tpu_torch.ops.lattice import _seam_sum
from navier_stokes_solver_tpu_torch.precond.schwarz import make_schwarz_smoother

__all__ = [
    "SMOOTHERS",
    "attach_mg",
    "make_mg_vcycle",
    "make_lp_vcycle",
    "mg_level_shapes",
    "as_dtype_scalar",
]


SMOOTHERS = ("gmres", "jacobi", "schwarz")


def as_dtype_scalar(v, dtype: torch.dtype):
    """``v`` rounded to ``dtype`` (a Python float), so that a cast context's
    scalars carry exactly the precision of its tensors; an ensemble's [B]
    viscosities are cast as a tensor (the same rounding, member by
    member)."""
    if is_batched(v):
        return v.to(dtype)
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


def attach_mg(
    disc: Disc,
    make_geometry=make_channel_geometry,
    *,
    min_cells: int = 48,
    max_levels: int = 8,
) -> Disc:
    """Attach a multigrid chain to ``disc``: every coarse level is
    ``make_geometry(nx, ny)``, the maker of the fine level's own geometry
    (the reference channel, or ``make_cavity_geometry`` for the cavity, so
    that its coarse operators are a cavity's too).  A tile's chain comes
    from ``dist.decompose_disc``."""
    if disc.decomposed:
        raise ValueError("attach_mg: a decomposed tile's chain comes from dist.decompose_disc")
    tables = make_taylor_hood(disc.deg_v, disc.deg_p, disc.n_q1d)
    nodes = tables.nodes_v
    deg = disc.deg_v
    W, H = disc.hx * disc.nx, disc.hy * disc.ny
    put = lambda a: torch.as_tensor(a, device=disc.device).to(disc.dtype)

    def build(nx: int, ny: int, level: int) -> MGEdge | None:
        nxc, nyc = _coarse_shape(nx, ny, W / nx, H / ny)
        if level >= max_levels or nxc * nyc < min_cells or nyc < 2:
            return None
        space_c = make_fe_space(make_geometry(nxc, nyc), disc.deg_v, disc.deg_p)
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
            Ppx=put(_interp_1d(nxc, nx, disc.deg_p, tables.nodes_p)),
            Ppy=put(_interp_1d(nyc, ny, disc.deg_p, tables.nodes_p)),
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


def _gmres_smooth(A, dinv, b, x, k: int, *, batched: bool = False, dot=None):
    """``k`` fixed steps of Jacobi-preconditioned GMRES as a smoother.

    Chebyshev assumes a real positive spectrum; the Jacobi-normalized
    convection-dominated velocity block has eigenvalues far off the real
    axis, where Chebyshev smoothing diverges.  A fixed-k minimal-residual
    polynomial adapts to the actual spectrum and cannot increase the
    residual.  The smoother is (mildly) nonlinear; every consumer is a
    flexible method, so that is safe.  No host synchronization: the
    (k+1) x k least-squares problem is solved on the device.

    ``batched``: ``b`` and ``x`` [B, ...] hold B members, each with its
    own inner products, Hessenberg matrix [B, k+1, k] and least-squares
    solve.  A member with a zero residual gets a zero correction (the
    clamps and the isfinite guard keep its 0/0 out).  ``dot``: a tile's
    inner product (``ops.matfree.make_dot``).
    """
    if dot is not None and not batched:
        return _gmres_smooth_tile(A, dinv, b, x, k, dot)
    dot = bvdot if batched else tvdot
    # a per-member scalar [B] against a [B, ...] vector; a 0-dim one as is
    col = (lambda v: v.reshape(v.shape + (1,) * (b.dim() - 1))) if batched else (lambda v: v)
    r0 = b - A(x)
    tiny = torch.finfo(r0.dtype).tiny
    beta = torch.sqrt(dot(r0, r0))
    V = [r0 * col(1.0 / torch.clamp_min(beta, tiny))]
    Z = []
    H = r0.new_zeros(b.shape[:1] * batched + (k + 1, k))
    for j in range(k):
        z = dinv * V[j]
        Z.append(z)
        w = A(z)
        for i in range(j + 1):
            hij = dot(V[i], w)
            w = w - col(hij) * V[i]
            H[..., i, j] = hij
        hj1 = torch.sqrt(dot(w, w))
        H[..., j + 1, j] = hj1
        V.append(w / col(torch.clamp_min(hj1, tiny)))
    # least squares min || beta e1 - H y ||  via normal equations on the
    # tiny (k+1) x k Hessenberg (well-conditioned for a smoother; k <= 4);
    # solve_ex skips the error-check synchronization, the isfinite guard
    # below covers a singular system
    HtH = H.mT @ H + tiny * torch.eye(k, dtype=H.dtype, device=H.device)
    y, _ = torch.linalg.solve_ex(HtH, H[..., 0, :] * beta[..., None])
    y = torch.where(torch.isfinite(y), y, 0.0)
    dx = col(y[..., 0]) * Z[0]
    for j in range(1, k):
        dx = dx + col(y[..., j]) * Z[j]
    return x + dx


def _gmres_smooth_tile(A, dinv, b, x, k: int, dot):
    """``_gmres_smooth`` on a tile of a domain decomposition: the same
    minimal-residual polynomial, with the Arnoldi basis built by classical
    Gram-Schmidt on unnormalized vectors, so each step's products share one
    reduction (k + 1 in all, not the modified Gram-Schmidt's
    (k + 1)(k + 2) / 2): each reduction is a round trip between the
    ranks.  Equal to ``_gmres_smooth`` up to rounding.  On one NVIDIA H100
    (700 W) shared by four ranks, the 300x100 Q3/Q2 unsteady step on 2 x 2
    tiles took 367.0 s with it and 426.8 s with the modified Gram-Schmidt
    smoother on the tile's products (480.6 against 824.0 all-reduces per
    outer iteration)."""
    r0 = b - A(x)
    tiny = torch.finfo(r0.dtype).tiny
    H = r0.new_zeros((k + 1, k))
    w_hat = A(dinv * r0)
    rr, rw = dot.pairs((r0, r0), (r0, w_hat))
    beta = torch.sqrt(rr)
    inv = 1.0 / torch.clamp_min(beta, tiny)
    V = [r0 * inv]
    Z = [dinv * V[0]]
    H[0, 0] = rw * inv * inv
    w = w_hat * inv - H[0, 0] * V[0]
    for j in range(1, k):
        w_hat = A(dinv * w)
        prods = dot.pairs((w, w), *((V[i], w_hat) for i in range(j)), (w, w_hat))
        hj = torch.sqrt(prods[0])
        H[j, j - 1] = hj
        inv = 1.0 / torch.clamp_min(hj, tiny)
        V.append(w * inv)
        Z.append(dinv * V[j])
        H[:j, j] = prods[1:j + 1] * inv
        H[j, j] = prods[j + 1] * inv * inv
        w = w_hat * inv
        for i in range(j + 1):
            w = w - H[i, j] * V[i]
    H[k, k - 1] = torch.sqrt(dot(w, w))
    HtH = H.mT @ H + tiny * torch.eye(k, dtype=H.dtype, device=H.device)
    y, _ = torch.linalg.solve_ex(HtH, H[0, :] * beta)
    y = torch.where(torch.isfinite(y), y, 0.0)
    dx = y[0] * Z[0]
    for j in range(1, k):
        dx = dx + y[j] * Z[j]
    return x + dx


def _lmax_start(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """The power iteration's start vector: standard normal draws from a CPU
    generator seeded with 7, moved to ``device`` -- the same vector on every
    device.  (The JAX package draws from ``PRNGKey(7)``; tests substitute
    that vector here.)"""
    g = torch.Generator(device="cpu").manual_seed(7)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(device=device, dtype=dtype)


def _tile_start(shape, dtype: torch.dtype, device, disc: Disc | None) -> torch.Tensor:
    """``_lmax_start`` of ``shape``, or on a tile of a decomposition its
    slice of the start vector of the whole lattice (the last two axes of
    ``shape`` are the tile's lattice)."""
    if disc is None or not disc.decomposed:
        return _lmax_start(shape, dtype, device)
    *lead, NY, NX = shape
    gy, gx = (NY - 1) * disc.halo_iy, (NX - 1) * disc.halo_ix
    full = _lmax_start(tuple(lead) + ((NY - 1) * disc.halo_ny + 1, (NX - 1) * disc.halo_n + 1),
                       dtype, device)
    return full[..., gy: gy + NY, gx: gx + NX].contiguous()


def _as_prec(prec):
    """A preconditioner callable from an inverse diagonal (Jacobi) or a
    callable ``r -> d`` (the Schwarz sweep)."""
    return prec if callable(prec) else (lambda r: prec * r)


def _estimate_lmax(A, prec, shape, dtype: torch.dtype, device, iters: int = 8,
                   batch: int | None = None, dot=None, disc: Disc | None = None):
    """``iters`` power iterations for the spectral radius of ``P A``
    (``prec`` an inverse diagonal or a callable; matrix-free, no host
    synchronization); a 0-dim tensor.

    ``batch``: the operator and ``prec`` act on B members ([B, *shape]);
    every member starts from the same vector (the JAX package's ``vmap``
    closes over one start vector) and gets its own estimate, a [B] tensor
    broadcast against ``shape`` (``_member_scalar``).

    On a tile (``disc`` decomposed; ``dot`` its inner product) the start
    vector is the tile's slice of the whole lattice's, so a decomposed
    estimate is the undecomposed one (the JAX package draws a tile-shaped
    vector on every tile, whose seams disagree and whose estimate differs
    from the single-device one)."""
    P = _as_prec(prec)
    v = _tile_start(shape, dtype, device, disc)
    if batch is None:
        dot, scalar = (dot or tvdot), (lambda t: t)
    else:
        v = v.expand((batch,) + tuple(shape)).contiguous()
        dot, scalar = bvdot, (lambda t: _member_scalar(t, len(shape)))
    lam = scalar(torch.ones(() if batch is None else (batch,), dtype=dtype, device=device))
    for _ in range(iters):
        w = P(A(v))
        lam = scalar(torch.sqrt(dot(w, w)))
        v = w / torch.clamp_min(lam, 1e-30)
    return lam


def _member_scalar(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-member scalars [B] -> [B, 1, ...] against a member's ``ndim``
    dimensions: the Chebyshev coefficients built from it then broadcast over
    the member axis, each member's arithmetic the unbatched one's."""
    return v.reshape(v.shape[:1] + (1,) * ndim)


def _chebyshev_coeffs(lmax, degree: int, lmin_ratio: float = 4.0):
    """The scalars of ``degree`` >= 1 Chebyshev steps on
    [lmax/lmin_ratio, 1.1 lmax] (``lmax`` a 0-dim tensor, or an ensemble's
    per-member estimates from ``_estimate_lmax(batch=B)``).  ``lmin_ratio``
    4 is the classic smoothing window -- only the high end of the spectrum
    must be damped; larger ratios approach a solver over the whole
    spectrum of a well-conditioned operator (the pressure mass).  Built
    once per V-cycle or solver: eager PyTorch would launch each of these
    0-dim operations in every step."""
    lmin = lmax / lmin_ratio
    lmax = 1.1 * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, steps


def _chebyshev(A, prec, coeffs, b, x=None):
    """Chebyshev-accelerated preconditioned smoothing (``prec`` an inverse
    diagonal -- Jacobi -- or a callable, e.g. the Schwarz sweep; ``coeffs``
    from ``_chebyshev_coeffs``); ``x=None`` starts from zero without
    applying ``A`` to it.  The JAX package's loop also forms one more
    residual and direction, which its result never reads."""
    P = _as_prec(prec)
    r = b if x is None else b - A(x)
    theta, steps = coeffs
    d = P(r) / theta
    x = d if x is None else x + d
    for a, c in steps:
        r = b - A(x)
        d = a * d + c * P(r)
        x = x + d
    return x


def _restrict(d_fine: Disc, d_coarse: Disc, Py, Px, k: int, r):
    """Transpose-interpolation restriction ``Py^T r Px``; on a tile the
    fine seams weigh 1/2 (corners 1/4) so that the tiles' partial sums add
    up to the global value, which the coarse seam exchange completes."""
    w = d_fine.seam_weights(k)
    if w is not None:
        r = r * w
    return _seam_sum(d_coarse, torch.einsum("yY,...yx,xX->...YX", Py, r, Px))


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

    ``smoother``: "gmres" (fixed-step Jacobi-preconditioned minimal-residual
    smoothing, robust on the nonsymmetric Newton-regime block), "jacobi"
    (Chebyshev-Jacobi; for the SPD Stokes block -- it diverges on
    convection-dominated operators) or "schwarz" (Chebyshev over the
    cell-block additive Schwarz sweep, which also preconditions the coarse
    solve).  The Chebyshev smoothers take one spectral estimate, on the
    finest level, and reuse it below.

    A [B] ``nu`` (an ensemble) builds one cycle for the B members: state
    [B, 2, NY, NX], per-member diagonals, the batched GMRES smoother, a
    [B] spectral estimate for the Chebyshev smoothers, per-member Schwarz
    cell matrices, and batched coarse solves.
    """
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown mg_smoother {smoother!r}; one of {SMOOTHERS}")
    batched = is_batched(nu)
    out_dtype = disc.dtype
    if dtype is not None and dtype != disc.dtype:
        disc = disc.to(dtype)
        if state_u is not None:
            state_u = state_u.to(dtype)
        nu = as_dtype_scalar(nu, dtype)
        inv_dt = as_dtype_scalar(inv_dt, dtype)

    # ---- walk the chain, building per-level operators ----
    levels = []  # (disc, A, prec, edge)
    cheb = None  # Chebyshev scalars of the finest level's estimate
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

        if smoother == "schwarz":
            prec = make_schwarz_smoother(d, nu, inv_dt, linq, diag, stokes=stokes)
        else:
            prec = 1.0 / diag
        dotd = make_dot(d)
        if cheb is None and smoother != "gmres":
            lmax = _estimate_lmax(A, prec, (2,) + d.NV, d.dtype, d.device,
                                  batch=nu.shape[0] if batched else None, dot=dotd, disc=d)
            cheb = _chebyshev_coeffs(lmax, smooth_degree)
        levels.append((d, A, prec, d.mg, dotd))
        if d.mg is None:
            break
        edge = d.mg
        if u is not None and not stokes:
            # state restriction: nodal evaluation of the (continuous) fine
            # function at coarse nodes
            u = torch.einsum("Yy,...yx,Xx->...YX", edge.Evy, u, edge.Evx)
        d = edge.coarse

    def restrict(edge: MGEdge, d_fine: Disc, r):
        return _restrict(d_fine, edge.coarse, edge.Pvy, edge.Pvx, d_fine.deg_v, r)

    def prolong(edge: MGEdge, x):
        return torch.einsum("Yy,...yx,Xx->...YX", edge.Pvy, x, edge.Pvx)

    if smoother == "gmres":

        def smooth(A, prec, b, x, dot):
            x = torch.zeros_like(b) if x is None else x
            return _gmres_smooth(A, prec, b, x, smooth_degree, batched=batched, dot=dot)

    else:

        def smooth(A, prec, b, x, dot):
            return _chebyshev(A, prec, cheb, b, x)

    def vcycle(li: int, b):
        d, A, prec, edge, dot = levels[li]
        if li == len(levels) - 1:
            # CG is only valid on the SPD Stokes block; the NS-regime F is
            # nonsymmetric (convection), so the coarse solve is GMRES there
            spd = stokes or state_u is None
            if batched:
                solver, tol = (cg_batched if spd else gmres_batched), coarse_rtol * bnorm(b)
                kw = {}
            else:
                solver, tol = (cg if spd else gmres), coarse_rtol * torch.sqrt((dot or tvdot)(b, b))
                kw = {"dot": dot}
            x, _ = solver(A, b, torch.zeros_like(b), tol=tol, maxiter=coarse_iters,
                          M=_as_prec(prec), **kw)
            return x
        x = smooth(A, prec, b, None, dot)
        r = _zero_constrained(d, b - A(x))
        bc = _zero_constrained(edge.coarse, restrict(edge, d, r))
        xc = vcycle(li + 1, bc)
        x = x + _zero_constrained(d, prolong(edge, xc))
        return smooth(A, prec, b, x, dot)

    def M(b):
        return vcycle(0, b.to(disc.dtype)).to(out_dtype)

    return M


def make_lp_vcycle(disc: Disc, *, batched: bool = False):
    """Build ``M(b) -> x``: one V(2, 2) cycle on the pressure Laplacian (the
    (1/dt) Lp^-1 leg of the Cahouet-Chabard Schur approximation,
    ``ops.matfree.apply_Lp``), in the dtype of ``disc``; ``batched``: ``b``
    [B, NPy, NPx] holds B members (Lp is the same for all: only the coarse
    CG runs per member).

    The hierarchy reuses the velocity chain's coarse discretizations with
    the pressure-lattice transfers (``MGEdge.Ppx/Ppy``).  Lp is SPD:
    Chebyshev-Jacobi smoothing with one spectral estimate on the finest
    level, reused below, and a Jacobi-CG coarse solve (at most 48
    iterations, to rel 5e-2, as the velocity cycle's).  Coarse levels drop
    the voxelized cylinder (full rectangle, every pressure node active):
    each level voxelizes the hole on its own lattice, and corrections
    interpolated across a differently shaped hole diverge (the JAX
    package's ``make_lp_vcycle`` records why).  The restricted residual is
    still masked with the coarse level's own active nodes, as there.
    """
    levels = []  # (disc, A, dinv, edge)
    d = disc
    cheb = None  # one spectral estimate, on the finest level
    while True:
        dloc = d
        if levels:  # coarse level: full rectangle, no hole
            dloc = dloc.replace(
                cell_mask=torch.ones_like(dloc.cell_mask),
                p_active=torch.ones_like(dloc.p_active),
            )
        A = lambda x, _d=dloc: apply_Lp(_d, x)
        dinv = 1.0 / diag_Lp(dloc)
        dotd = make_dot(dloc)
        if cheb is None:
            lmax = _estimate_lmax(A, dinv, dloc.NP, dloc.dtype, dloc.device, dot=dotd, disc=dloc)
            cheb = _chebyshev_coeffs(lmax, 2)
        levels.append((dloc, A, dinv, dloc.mg, dotd))
        if d.mg is None:
            break
        d = d.mg.coarse

    def interior(d, x):
        return torch.where(d.p_free, x, 0.0)

    def prolong(edge: MGEdge, x):
        return torch.einsum("Yy,...yx,Xx->...YX", edge.Ppy, x, edge.Ppx)

    def vcycle(li: int, b):
        d, A, dinv, edge, dot = levels[li]
        if li == len(levels) - 1:
            if batched:
                solver, tol, kw = cg_batched, 5e-2 * bnorm(b), {}
            else:
                solver, tol, kw = cg, 5e-2 * torch.sqrt((dot or tvdot)(b, b)), {"dot": dot}
            x, _ = solver(A, b, torch.zeros_like(b), tol=tol, maxiter=48, M=lambda r: dinv * r, **kw)
            return x
        x = _chebyshev(A, dinv, cheb, b)
        r = interior(d, b - A(x))
        bc = interior(edge.coarse, _restrict(d, edge.coarse, edge.Ppy, edge.Ppx, d.deg_p, r))
        xc = vcycle(li + 1, bc)
        x = x + interior(d, prolong(edge, xc))
        return _chebyshev(A, dinv, cheb, b, x)

    return lambda b: vcycle(0, b)

"""Block preconditioners for the saddle system.

The port of the JAX package's ``precond/blocks.py``: the reference's three
block preconditioners -- blockDiagonal (NSSolver.hpp:154-176,
NSSolverStationary.hpp:131-153), blockTriangular (NSSolver.hpp:211-237,
NSSolverStationary.hpp:188-218) and aSIMPLE (NSSolver.hpp:293-350,
NSSolverStationary.hpp:282-311) -- each in its unsteady and stationary
variant.  The velocity leg is an inner FGMRES on F preconditioned by the
geometric-multigrid V-cycle (point Jacobi without a chain), or with
``inner_mode="fixed"`` a fixed number of residual-corrected V-cycles; the
pressure leg is chosen by ``PrecondConfig.schur_mode`` -- the reference's
Jacobi-CG on the 1/nu-scaled pressure mass, Cahouet-Chabard's added
pressure-Laplacian leg, or pressure convection-diffusion (PCD) -- and
aSIMPLE solves with S-hat = B diag(F)^-1 B^T.  The sweep optionally runs
in a lower precision inside the f64 outer Krylov (``vmult_dtype``);
``make_krylov_lo`` configures the GMRES-IR restart cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from navier_stokes_solver_tpu_torch.krylov import LowCycle, cg, fgmres, tnorm
from navier_stokes_solver_tpu_torch.ops import Blocks, LinearizationQ, matfree
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.precond.mg import (
    SMOOTHERS,
    _chebyshev,
    _chebyshev_coeffs,
    _estimate_lmax,
    as_dtype_scalar,
    make_lp_vcycle,
    make_mg_vcycle,
)

__all__ = ["LinearContext", "PrecondConfig", "make_preconditioner", "make_krylov_lo"]

VARIANTS = ("stationary", "unsteady")
SCHUR_MODES = ("mass", "cahouet", "pcd")
INNER_MODES = ("auto", "krylov", "fixed")
ASIMPLE_STOKES_SCHUR = ("shat", "mass")
# relative tolerance of the nested Lp FGMRES (V-cycle preconditioned) and
# of the PCD mass solve
CC_LP_REL = 1e-2
# aSIMPLE damping (hardcoded at the reference's call site, NSSolver.cpp:645)
ASIMPLE_ALPHA = 0.5
# aSIMPLE's S-hat solve (in the unsteady variant the substitute for one ILU
# application on S-hat, NSSolver.hpp:338): that variant's relative
# tolerance, and the iteration cap of both variants
ASIMPLE_S_REL = 1e-1
ASIMPLE_S_MAXITER = 200
# inner_mode="fixed": residual-corrected V-cycles on the velocity and
# Chebyshev-Jacobi sweeps on the pressure mass
FIXED_F_CYCLES = 2
FIXED_MP_DEGREE = 6


def torch_dtype(v) -> torch.dtype | None:
    """``None``, a ``torch.dtype``, or its name ("float32") -> torch dtype."""
    if v is None or isinstance(v, torch.dtype):
        return v
    dt = getattr(torch, str(v), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {v!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Equivalence-layer tunables (documented deviations from Trilinos):
    the fields and defaults of the JAX package's ``PrecondConfig`` that
    the structured path reads."""

    # iteration cap of the inner velocity FGMRES and pressure-mass CG
    inner_maxiter: int = 100
    # compute precision of the multigrid V-cycle (None = operator dtype)
    mg_dtype: Any = "float32"
    # compute precision of the whole preconditioner application (inner
    # solves included); the outer Krylov stays in the operator dtype
    vmult_dtype: Any = "float32"
    # "krylov" (= "auto"): nested FGMRES/CG inner solves to the reference's
    # tolerances; "fixed": ``FIXED_F_CYCLES`` residual-corrected V-cycles on
    # the velocity and ``FIXED_MP_DEGREE`` Chebyshev-Jacobi sweeps on the
    # pressure mass -- no nested iteration, a linear preconditioner
    inner_mode: str = "auto"
    mg_smooth_degree: int = 3
    # V-cycle smoother: "gmres" (robust on the nonsymmetric Newton-regime
    # block; the default), "jacobi" (Chebyshev-Jacobi, Stokes/SPD only) or
    # "schwarz" (cell-block additive Schwarz; stronger per sweep, costlier)
    mg_smoother: str = "gmres"
    # working precision of the outer GMRES/FGMRES restart cycles (GMRES-IR,
    # krylov.LowCycle); None = full-precision outer (reference parity).
    # The tangent-solve loop (api/base.py) falls back to full precision
    # when the cycles stall.
    krylov_cycle_dtype: Any = None
    # Schur-complement treatment of the blockDiagonal / blockTriangular
    # pressure leg:
    #   "mass":    the reference's 1/nu-scaled pressure-mass solve
    #              (NSSolver.hpp:228-236);
    #   "cahouet": Cahouet-Chabard, S^-1 ~ nu Mp^-1 + (1/dt) Lp^-1 -- with
    #              the implicit-Euler time term the Schur complement is
    #              dt-Laplacian dominated, and the mass leg alone loses
    #              h/dt robustness;
    #   "pcd":     pressure convection-diffusion, S^-1 ~ Mp_raw^-1 Fp Lp^-1.
    # Both upgrades apply in the Newton regime only; Stokes-regime systems
    # (no time term, no convection) take the mass solve.
    schur_mode: str = "mass"
    # when set, replace the nested Lp solve with this many residual-corrected
    # Lp V-cycles (None = nested FGMRES to ``CC_LP_REL``)
    cc_lp_cycles: int | None = None
    # Stokes-regime overrides of the blockTriangular inner tolerances and
    # of the stationary aSIMPLE's FGMRES(F) / S solves (None = the
    # variant's, see ``make_block_triangular`` and ``make_asimple``)
    tri_rel_u_stokes: float | None = None
    tri_rel_p_stokes: float | None = None
    # Stokes-regime Schur surrogate of the stationary aSIMPLE: "shat" (the
    # reference's S-hat solve; Stokes outer counts grow ~1/h) or "mass"
    # (the Stokes-correct pressure-mass solve; h-flat counts)
    asimple_stokes_schur: str = "shat"
    # dense direct-LU preconditioner: not ported
    direct_lu: bool = False

    def check(self) -> None:
        """Raise on unknown settings and on those not ported yet."""
        if self.inner_mode not in INNER_MODES:
            raise ValueError(f"unknown inner_mode {self.inner_mode!r}")
        if self.mg_smoother not in SMOOTHERS:
            raise ValueError(f"unknown mg_smoother {self.mg_smoother!r}")
        if self.schur_mode not in SCHUR_MODES:
            raise ValueError(f"unknown schur_mode {self.schur_mode!r}")
        if self.asimple_stokes_schur not in ASIMPLE_STOKES_SCHUR:
            raise ValueError(f"unknown asimple_stokes_schur {self.asimple_stokes_schur!r}")
        if self.direct_lu:
            raise NotImplementedError(
                "direct_lu is not ported yet (ROADMAP.md A.D7, with the "
                "simplex -M backend)"
            )
        if self.krylov_cycle_dtype == "mixed":
            raise NotImplementedError(
                "krylov_cycle_dtype='mixed' is not ported (ROADMAP.md A.14)"
            )
        for name in ("tri_rel_u_stokes", "tri_rel_p_stokes"):
            v = getattr(self, name)
            if v is not None and not v > 0.0:
                raise ValueError(f"PrecondConfig.{name} must be > 0, got {v!r}")


@dataclasses.dataclass(frozen=True)
class LinearContext:
    """Everything the preconditioners need about the current linearization
    (the matrix-free analog of the assembled Trilinos blocks handed to
    ``preconditioner.initialize(...)``, NSSolver.cpp:607-651)."""

    disc: Disc
    nu: float
    inv_dt: float
    stokes: bool
    linq: LinearizationQ | None  # Newton linearization state at q-points
    diag_f: torch.Tensor  # diag of the (post-BC) velocity block
    state_u: torch.Tensor | None = None  # nodal velocity (MG rediscretization)

    # ---- block applies (post boundary elimination, NSSolver.cpp:596) ----
    def F(self, x_u):
        return matfree.apply_F(
            self.disc, self.nu, self.inv_dt, self.linq, x_u,
            stokes=self.stokes, bc_diag=self.diag_f,
        )

    def B(self, x_u):
        return matfree.apply_B(self.disc, x_u, stokes=self.stokes)

    def Bt(self, x_p):
        return matfree.apply_Bt(self.disc, x_p, zero_dirichlet_rows=True)

    def Mp(self, x_p):
        return matfree.apply_Mp(self.disc, self.nu, x_p)

    def Lp(self, x_p):
        """Pressure Laplacian (the Cahouet-Chabard and PCD legs)."""
        return matfree.apply_Lp(self.disc, x_p)

    def S(self, x_p):
        """Approximate Schur complement S = B diag(F)^-1 B^T, composed
        matrix-free (replaces the Trilinos ``mmult`` triple product,
        NSSolver.hpp:286); identity on non-existent pressure lanes."""
        y = self.B(self.Bt(x_p) / self.diag_f)
        return torch.where(self.disc.p_active, y, x_p)

    def jacobi_F(self):
        dinv = 1.0 / self.diag_f
        return lambda x: dinv * x

    def smoother_F(self, cfg: PrecondConfig):
        """Velocity-block preconditioner: the geometric-multigrid V-cycle
        when the disc carries a chain, point Jacobi otherwise
        (``multigrid=False``)."""
        if self.disc.mg is None:
            return self.jacobi_F()
        return make_mg_vcycle(
            self.disc, self.nu, self.inv_dt, self.state_u,
            stokes=self.stokes,
            smooth_degree=cfg.mg_smooth_degree,
            smoother=cfg.mg_smoother,
            dtype=torch_dtype(cfg.mg_dtype),
        )

    def jacobi_Mp(self):
        dinv = 1.0 / matfree.diag_Mp(self.disc, self.nu)
        return lambda x: dinv * x


def _schur_mode(ctx: LinearContext, cfg: PrecondConfig) -> str:
    """Resolved Schur treatment: the upgraded modes apply in the Newton
    regime; in the Stokes regime (no time term in the operator whatever
    ``inv_dt``, and no convection) the mass solve is the right one."""
    if cfg.schur_mode == "mass" or ctx.stokes:
        return "mass"
    return cfg.schur_mode


def _lp_has_vcycle(ctx: LinearContext) -> bool:
    """True when the disc carries a multigrid chain, i.e. the Lp leg is
    backed by a V-cycle rather than point Jacobi."""
    return ctx.disc.mg is not None


def _lp_preconditioner(ctx: LinearContext):
    """The Lp V-cycle on a disc with a multigrid chain, Jacobi otherwise;
    in the dtype of ``ctx``."""
    if _lp_has_vcycle(ctx):
        return make_lp_vcycle(ctx.disc)
    dinv = 1.0 / matfree.diag_Lp(ctx.disc)
    return lambda r: dinv * r


def _make_p_solver(ctx: LinearContext, cfg: PrecondConfig):
    """Pressure-block inner solver ``solve(rhs, tol) -> dp``.

    "mass": Jacobi-CG on the 1/nu-scaled pressure mass to the caller's
    (reference) tolerance, dp = nu Mp^-1 rhs.  "cahouet": adds the dt leg,
    dp += inv_dt Lp^-1 rhs (V-cycle-preconditioned FGMRES to ``CC_LP_REL``,
    or ``cc_lp_cycles`` residual-corrected V-cycles).  "pcd":
    dp = Mp_raw^-1 Fp Lp^-1 rhs.
    """
    mp = ctx.jacobi_Mp()

    def solve_mass(rhs, tol):
        dp, _ = cg(ctx.Mp, rhs, torch.zeros_like(rhs), tol=tol,
                   maxiter=cfg.inner_maxiter, M=mp)
        return dp

    mode = _schur_mode(ctx, cfg)
    if mode == "mass":
        return solve_mass

    mlp = _lp_preconditioner(ctx)
    rel = CC_LP_REL
    # N Jacobi sweeps scaled by inv_dt are worse than no leg at all: the
    # cycles replace the nested solve only behind a V-cycle
    cycles = cfg.cc_lp_cycles if _lp_has_vcycle(ctx) else None

    if cycles is not None:

        def solve_lp(rhs):
            dl = mlp(rhs)
            for _ in range(cycles - 1):
                dl = dl + mlp(rhs - ctx.Lp(dl))
            return dl

    else:

        def solve_lp(rhs):
            # FGMRES, not CG: the V-cycle's inexact coarse solve makes the
            # preconditioner (mildly) nonlinear, which stalls CG
            dl, _ = fgmres(
                ctx.Lp, rhs, torch.zeros_like(rhs), tol=rel * tnorm(rhs),
                maxiter=cfg.inner_maxiter, M=mlp,
            )
            return dl

    if mode == "cahouet":

        def solve_cc(rhs, tol):
            return solve_mass(rhs, tol) + ctx.inv_dt * solve_lp(rhs)

        return solve_cc

    dinv_raw = 1.0 / matfree.diag_Mp(ctx.disc, 1.0)

    def solve_pcd(rhs, tol):
        z = solve_lp(rhs)
        wv = matfree.apply_Fp(ctx.disc, ctx.nu, ctx.inv_dt, ctx.linq, z)
        dp, _ = cg(
            lambda x: matfree.apply_Mp_raw(ctx.disc, x),
            wv, torch.zeros_like(wv), tol=rel * tnorm(wv),
            maxiter=cfg.inner_maxiter, M=lambda r: dinv_raw * r,
        )
        return dp

    return solve_pcd


def _fixed_mode(cfg: PrecondConfig) -> bool:
    """``inner_mode`` "fixed"; "auto" resolves to "krylov"."""
    return cfg.inner_mode == "fixed"


def _fixed_F_solver(ctx: LinearContext, mf):
    """Fixed-cycle velocity solve: one application of ``mf`` plus
    ``FIXED_F_CYCLES - 1`` residual-corrected repeats."""

    def solve(rhs):
        du = mf(rhs)
        for _ in range(FIXED_F_CYCLES - 1):
            du = du + mf(rhs - ctx.F(du))
        return du

    return solve


def _fixed_chebyshev(A, dinv, shape, ctx: LinearContext, degree: int):
    """``degree`` Chebyshev-Jacobi sweeps from zero on [lmax/30, 1.1 lmax]
    -- a solver over the whole spectrum of a well-conditioned operator --
    with ``lmax`` from five power iterations (the seeded start vector)."""
    lmax = _estimate_lmax(A, dinv, shape, ctx.disc.dtype, ctx.disc.device, iters=5)
    coeffs = _chebyshev_coeffs(lmax, degree, lmin_ratio=30.0)
    return lambda rhs: _chebyshev(A, dinv, coeffs, rhs)


def _fixed_Mp_solver(ctx: LinearContext):
    """``FIXED_MP_DEGREE`` Chebyshev-Jacobi sweeps on the (well-conditioned)
    pressure mass."""
    dinv = 1.0 / matfree.diag_Mp(ctx.disc, ctx.nu)
    return _fixed_chebyshev(ctx.Mp, dinv, ctx.disc.NP, ctx, FIXED_MP_DEGREE)


def _fixed_p_solver(ctx: LinearContext, cfg: PrecondConfig):
    """Fixed-sweep pressure solve ``solve(rhs) -> dp`` (no nested
    iteration): the Chebyshev mass sweeps, plus one Lp V-cycle per
    application under Cahouet-Chabard, or the V-cycle / Fp / Jacobi-mass
    sandwich under PCD.  Without a multigrid chain the Lp leg is
    ``FIXED_MP_DEGREE`` Chebyshev-Jacobi sweeps: one Jacobi application is
    far too weak for the inv_dt-scaled leg."""
    base = _fixed_Mp_solver(ctx)
    mode = _schur_mode(ctx, cfg)
    if mode == "mass":
        return base
    if _lp_has_vcycle(ctx):
        mlp = make_lp_vcycle(ctx.disc)
    else:
        dinv_lp = 1.0 / matfree.diag_Lp(ctx.disc)
        mlp = _fixed_chebyshev(ctx.Lp, dinv_lp, ctx.disc.NP, ctx, FIXED_MP_DEGREE)
    if mode == "cahouet":
        return lambda rhs: base(rhs) + ctx.inv_dt * mlp(rhs)
    dinv_raw = 1.0 / matfree.diag_Mp(ctx.disc, 1.0)
    return lambda rhs: dinv_raw * matfree.apply_Fp(ctx.disc, ctx.nu, ctx.inv_dt, ctx.linq, mlp(rhs))


def make_block_diagonal(ctx: LinearContext, cfg: PrecondConfig, variant: str):
    """[F 0; 0 S]^-1 approximation via inner solves.

    Unsteady (NSSolver.hpp:154-176): FGMRES(F) and the pressure leg to an
    *absolute* tolerance 1e-1.  Stationary (NSSolverStationary.hpp:131-153):
    the same solves to a *relative* 1e-1 of each block's source.
    """
    mf = ctx.smoother_F(cfg)

    if _fixed_mode(cfg):
        solve_f = _fixed_F_solver(ctx, mf)
        solve_fp = _fixed_p_solver(ctx, cfg)
        return lambda src: Blocks(u=solve_f(src.u), p=solve_fp(src.p))

    solve_p = _make_p_solver(ctx, cfg)
    unsteady = variant == "unsteady"
    tol_abs = as_dtype_scalar(1e-1, ctx.disc.dtype)

    def vmult(src: Blocks) -> Blocks:
        if unsteady:
            tol_u = tol_p = tol_abs
        else:
            tol_u = 1e-1 * tnorm(src.u)
            tol_p = 1e-1 * tnorm(src.p)
        du, _ = fgmres(
            ctx.F, src.u, ctx.disc.zeros_u(), tol=tol_u, maxiter=cfg.inner_maxiter, M=mf,
        )
        return Blocks(u=du, p=solve_p(src.p, tol_p))

    return vmult


def make_block_triangular(ctx: LinearContext, cfg: PrecondConfig, variant: str):
    """Triangular sweep: velocity solve FGMRES(F) (V-cycle preconditioned),
    pressure correction tmp = src_p - B du, then the pressure leg on tmp.

    Tolerances are the reference's: unsteady (NSSolver.hpp:211-237) rel
    1e-4 on the velocity and 1e-5 * ||src_p|| on the pressure, stationary
    (NSSolverStationary.hpp:188-218) rel 1e-2 / 1e-2; ``cfg`` may override
    both on Stokes systems.
    """
    mf = ctx.smoother_F(cfg)
    unsteady = variant == "unsteady"
    rel_u = 1e-4 if unsteady else 1e-2
    rel_p = 1e-5 if unsteady else 1e-2
    if ctx.stokes:
        if cfg.tri_rel_u_stokes is not None:
            rel_u = cfg.tri_rel_u_stokes
        if cfg.tri_rel_p_stokes is not None:
            rel_p = cfg.tri_rel_p_stokes
    if _fixed_mode(cfg):
        solve_f = _fixed_F_solver(ctx, mf)
        solve_fp = _fixed_p_solver(ctx, cfg)

        def vmult_fixed(src: Blocks) -> Blocks:
            du = solve_f(src.u)
            return Blocks(u=du, p=solve_fp(src.p - ctx.B(du)))

        return vmult_fixed

    solve_p = _make_p_solver(ctx, cfg)
    eps = torch.finfo(ctx.disc.dtype).eps

    def vmult(src: Blocks) -> Blocks:
        du, _ = fgmres(
            ctx.F, src.u, ctx.disc.zeros_u(), tol=rel_u * tnorm(src.u),
            maxiter=cfg.inner_maxiter, M=mf,
        )
        tmp = src.p - ctx.B(du)
        # The reference keys this tolerance off ||src.p|| (NSSolver.hpp:228)
        # while solving with rhs ``tmp``; when src.p == 0 that is tol = 0 on
        # a nonzero system -- floor it at machine precision of the rhs.
        dp = solve_p(tmp, torch.maximum(rel_p * tnorm(src.p), 100.0 * eps * tnorm(tmp)))
        return Blocks(u=du, p=dp)

    return vmult


def _solve_S(ctx: LinearContext, rhs, tol, M):
    """Inner solve with the approximate Schur complement S-hat, FGMRES
    preconditioned by ``M`` (the pressure-Laplacian leg: its V-cycle's
    inexact coarse solve makes it mildly nonlinear, which stalls CG).

    In the Newton regime S = B diag(F)^-1 B^T is (nearly) SPD; in the
    Stokes regime the continuity sign flip makes it negative definite, so
    the solve runs on -S (the JAX package's documented deviation).  The
    JAX package's CG branch serves backends without a pressure Laplacian,
    which the port does not have.
    """
    op = ctx.S
    if ctx.stokes:
        op = lambda p: -ctx.S(p)
        rhs = -rhs
    dp, _ = fgmres(op, rhs, torch.zeros_like(rhs), tol=tol, maxiter=ASIMPLE_S_MAXITER, M=M)
    return dp


def make_asimple(ctx: LinearContext, cfg: PrecondConfig, variant: str):
    """SIMPLE-type factorized preconditioner.

    The S-hat solves take the pressure-Laplacian preconditioner (the Lp
    V-cycle, or Jacobi without a chain) as the analog of the reference's
    ILU on the assembled S-hat (NSSolver.hpp:289-292): S-hat is spectrally
    a pressure Laplacian.

    Unsteady (NSSolver.hpp:293-350): smoother applications -- du = M_F(src_u);
    tmp_p = src_p + B du; dp = S-hat solve to ``ASIMPLE_S_REL``;
    du *= D; dp /= alpha; du -= B^T dp; du *= D^-1, with alpha
    ``ASIMPLE_ALPHA``.

    Stationary (NSSolverStationary.hpp:282-311): inner FGMRES(F) (or the
    fixed cycles) and the S-hat solve to rel 1e-1 (the Stokes overrides
    apply in the Stokes regime, and ``asimple_stokes_schur="mass"`` swaps
    the Stokes-regime S-hat solve for the pressure-mass solve), then
    dp *= alpha and u -= D^-1 B^T dp.
    """
    mf = ctx.smoother_F(cfg)
    D = ctx.diag_f
    Dinv = 1.0 / D
    ms = _lp_preconditioner(ctx)  # built once per linearization

    if variant == "unsteady":

        def vmult(src: Blocks) -> Blocks:
            du = mf(src.u)
            tmp_p = src.p + ctx.B(du)
            dp = _solve_S(ctx, tmp_p, ASIMPLE_S_REL * tnorm(tmp_p), M=ms)
            # the reference's four separate sweeps, in its order
            du = du * D
            dp = dp / ASIMPLE_ALPHA
            du = du - ctx.Bt(dp)
            du = du * Dinv
            return Blocks(u=du, p=dp)

        return vmult

    fixed = _fixed_mode(cfg)
    solve_f = _fixed_F_solver(ctx, mf) if fixed else None
    rel_f = rel_s = 1e-1
    if ctx.stokes:
        if cfg.tri_rel_u_stokes is not None:
            rel_f = cfg.tri_rel_u_stokes
        if cfg.tri_rel_p_stokes is not None:
            rel_s = cfg.tri_rel_p_stokes
    stokes_mass = ctx.stokes and cfg.asimple_stokes_schur == "mass"
    mp = ctx.jacobi_Mp() if stokes_mass else None

    def vmult(src: Blocks) -> Blocks:
        if fixed:
            du = solve_f(src.u)
        else:
            du, _ = fgmres(
                ctx.F, src.u, ctx.disc.zeros_u(), tol=rel_f * tnorm(src.u),
                maxiter=cfg.inner_maxiter, M=mf,
            )
        tmp_p = src.p - ctx.B(du)
        tol = rel_s * tnorm(tmp_p)
        if stokes_mass:
            # the Stokes-correct pressure-mass solve, blockTriangular's leg
            dp, _ = cg(ctx.Mp, tmp_p, torch.zeros_like(tmp_p), tol=tol,
                       maxiter=cfg.inner_maxiter, M=mp)
        else:
            dp = _solve_S(ctx, tmp_p, tol, M=ms)
        dp = dp * ASIMPLE_ALPHA
        du = du - Dinv * ctx.Bt(dp)
        return Blocks(u=du, p=dp)

    return vmult


def _cast_ctx(ctx: LinearContext, dtype: torch.dtype) -> LinearContext:
    """Re-land the whole linearization in ``dtype`` -- tensors and the
    scalars ``nu`` and ``inv_dt`` -- for mixed-precision preconditioning."""
    cast = lambda t: None if t is None else t.to(dtype)
    return dataclasses.replace(
        ctx,
        disc=ctx.disc.to(dtype),
        linq=None if ctx.linq is None else LinearizationQ(*map(cast, ctx.linq)),
        diag_f=ctx.diag_f.to(dtype),
        state_u=cast(ctx.state_u),
        nu=as_dtype_scalar(ctx.nu, dtype),
        inv_dt=as_dtype_scalar(ctx.inv_dt, dtype),
    )


def make_krylov_lo(
    kind: int,
    ctx: LinearContext,
    *,
    variant: str = "stationary",
    cfg: PrecondConfig | None,
) -> LowCycle | None:
    """Low-precision restart-cycle configuration for the outer Krylov solve
    (GMRES-IR; ``PrecondConfig.krylov_cycle_dtype``), or None when disabled.

    The cycle operator and preconditioner are the same Jacobian apply and
    block preconditioner as the full-precision outer solve, re-landed in
    the cycle dtype.  The Jacobian apply evaluates and projects on its own,
    so the cycle matvec does not run the fused cell kernel; the kernel
    serves the ``apply_F`` calls inside the preconditioner.
    """
    wd = torch_dtype(cfg.krylov_cycle_dtype) if cfg is not None else None
    if wd is None or wd == ctx.disc.dtype:
        # cycles at the operator precision: a no-op LowCycle would still arm
        # the IR stall/fallback machinery
        return None
    ctx_lo = _cast_ctx(ctx, wd)
    M_lo = make_preconditioner(kind, ctx_lo, variant=variant, cfg=cfg)

    def A_lo(x):
        return matfree.apply_jacobian(
            ctx_lo.disc, ctx_lo.nu, ctx_lo.inv_dt, ctx_lo.linq, ctx_lo.diag_f, x,
            stokes=ctx_lo.stokes,
        )

    return LowCycle(matvec=A_lo, M=M_lo, dtype=wd)


PRECONDITIONER_NAMES = {0: "blockDiagonal", 1: "blockTriangular", 2: "aSIMPLE"}


def make_preconditioner(
    kind: int,
    ctx: LinearContext,
    *,
    variant: str = "stationary",
    cfg: PrecondConfig | None = None,
) -> Callable[[Blocks], Blocks]:
    """The block preconditioner ``vmult: Blocks -> Blocks`` (the dispatch
    of NSSolver.cpp:607-668): 0 blockDiagonal, 1 blockTriangular, 2 aSIMPLE
    (damping ``ASIMPLE_ALPHA``), in the ``variant``'s tolerances."""
    cfg = cfg or PrecondConfig()
    cfg.check()
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if kind not in PRECONDITIONER_NAMES:
        raise ValueError(
            "Invalid preconditioner type. Use 0: blockDiagonal, "
            "1: blockTriangular, 2: aSIMPLE."
        )  # NSSolver.cpp:667

    out_dtype = ctx.disc.dtype
    vd = torch_dtype(cfg.vmult_dtype)
    mixed = vd is not None and vd != out_dtype
    if mixed:
        ctx = _cast_ctx(ctx, vd)
    if kind == 0:
        vmult = make_block_diagonal(ctx, cfg, variant)
    elif kind == 1:
        vmult = make_block_triangular(ctx, cfg, variant)
    else:
        vmult = make_asimple(ctx, cfg, variant)
    if not mixed:
        return vmult

    def vmult_mixed(src: Blocks) -> Blocks:
        out = vmult(Blocks(*(a.to(vd) for a in src)))
        return Blocks(*(a.to(out_dtype) for a in out))

    return vmult_mixed

"""Block preconditioners for the saddle system (main-path part).

The port of the JAX package's ``precond/blocks.py`` on the ported paths:
the blockTriangular sweep in its stationary (NSSolverStationary.hpp:188-218)
and unsteady (NSSolver.hpp:211-237) variants, with a
multigrid-preconditioned inner FGMRES on the velocity block and a pressure
leg chosen by ``PrecondConfig.schur_mode`` -- the reference's Jacobi-CG on
the 1/nu-scaled pressure mass, Cahouet-Chabard's added pressure-Laplacian
leg, or pressure convection-diffusion (PCD).  The sweep optionally runs in
a lower precision inside the f64 outer Krylov (``vmult_dtype``);
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
    as_dtype_scalar,
    make_lp_vcycle,
    make_mg_vcycle,
)

__all__ = ["LinearContext", "PrecondConfig", "make_preconditioner", "make_krylov_lo"]

VARIANTS = ("stationary", "unsteady")
SCHUR_MODES = ("mass", "cahouet", "pcd")
# relative tolerance of the nested Lp FGMRES (V-cycle preconditioned) and
# of the PCD mass solve
CC_LP_REL = 1e-2


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
    """Equivalence-layer tunables (documented deviations from Trilinos);
    the fields and defaults of the JAX package's ``PrecondConfig`` that the
    blockTriangular path reads."""

    # iteration cap of the inner velocity FGMRES and pressure-mass CG
    inner_maxiter: int = 100
    # compute precision of the multigrid V-cycle (None = operator dtype)
    mg_dtype: Any = "float32"
    # compute precision of the whole preconditioner application (inner
    # solves included); the outer Krylov stays in the operator dtype
    vmult_dtype: Any = "float32"
    # "krylov" (= "auto"): nested FGMRES/CG inner solves to the reference's
    # tolerances.  "fixed" is not ported.
    inner_mode: str = "auto"
    mg_smooth_degree: int = 3
    mg_smoother: str = "gmres"
    # working precision of the outer GMRES/FGMRES restart cycles (GMRES-IR,
    # krylov.LowCycle); None = full-precision outer (reference parity).
    # The tangent-solve loop (api/base.py) falls back to full precision
    # when the cycles stall.
    krylov_cycle_dtype: Any = None
    # Schur-complement treatment of the pressure leg:
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
    # Stokes-regime overrides of the blockTriangular inner tolerances
    # (None = the variant's, see ``make_block_triangular``)
    tri_rel_u_stokes: float | None = None
    tri_rel_p_stokes: float | None = None
    # dense direct-LU preconditioner: not ported
    direct_lu: bool = False

    def check(self) -> None:
        """Raise on settings this port does not implement yet."""
        if self.inner_mode not in ("auto", "krylov"):
            raise NotImplementedError(
                f"inner_mode={self.inner_mode!r} is not ported yet "
                "(ROADMAP.md A.D3: fixed V-cycle and Chebyshev sweeps)"
            )
        if self.mg_smoother != "gmres":
            raise NotImplementedError(
                f"mg_smoother={self.mg_smoother!r} is not ported yet "
                "(ROADMAP.md A.D3: the Chebyshev-Jacobi and Schwarz velocity "
                "smoothers)"
            )
        if self.schur_mode not in SCHUR_MODES:
            raise ValueError(f"unknown schur_mode {self.schur_mode!r}")
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

    def smoother_F(self, cfg: PrecondConfig):
        """Velocity-block preconditioner: the geometric-multigrid V-cycle."""
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
    kind: int, ctx: LinearContext, *, variant: str = "stationary", cfg: PrecondConfig | None
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
    of NSSolver.cpp:607-668).  blockTriangular (kind 1) is ported, in both
    variants."""
    cfg = cfg or PrecondConfig()
    cfg.check()
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if kind in (0, 2):
        raise NotImplementedError(
            f"{PRECONDITIONER_NAMES[kind]} is not ported yet (ROADMAP.md A.D1)"
        )
    if kind != 1:
        raise ValueError(
            "Invalid preconditioner type. Use 0: blockDiagonal, "
            "1: blockTriangular, 2: aSIMPLE."
        )  # NSSolver.cpp:667

    out_dtype = ctx.disc.dtype
    vd = torch_dtype(cfg.vmult_dtype)
    if vd is None or vd == out_dtype:
        return make_block_triangular(ctx, cfg, variant)
    vmult = make_block_triangular(_cast_ctx(ctx, vd), cfg, variant)

    def vmult_mixed(src: Blocks) -> Blocks:
        out = vmult(Blocks(*(a.to(vd) for a in src)))
        return Blocks(*(a.to(out_dtype) for a in out))

    return vmult_mixed

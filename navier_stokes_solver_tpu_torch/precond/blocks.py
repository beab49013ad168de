"""Block preconditioners for the saddle system (main-path part).

The port of the JAX package's ``precond/blocks.py`` on the slice's path:
the stationary blockTriangular sweep (NSSolverStationary.hpp:188-218) with
a multigrid-preconditioned inner FGMRES on the velocity block and a
Jacobi-CG solve on the 1/nu-scaled pressure mass, optionally run in a
lower precision inside the f64 outer Krylov (``vmult_dtype``), and the
GMRES-IR restart-cycle configuration (``make_krylov_lo``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from navier_stokes_solver_tpu_torch.krylov import LowCycle, cg, fgmres, tnorm
from navier_stokes_solver_tpu_torch.ops import Blocks, LinearizationQ, matfree
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.precond.mg import as_dtype_scalar, make_mg_vcycle

__all__ = ["LinearContext", "PrecondConfig", "make_preconditioner", "make_krylov_lo"]


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
    stationary blockTriangular path reads."""

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
    # Schur-complement treatment: "mass" (the reference's 1/nu-scaled
    # pressure-mass solve, NSSolver.hpp:228-236) is the ported one.
    schur_mode: str = "mass"
    # Stokes-regime overrides of the blockTriangular inner tolerances
    # (None = the reference's stationary rel 1e-2 / 1e-2,
    # NSSolverStationary.hpp:196/211)
    tri_rel_u_stokes: float | None = None
    tri_rel_p_stokes: float | None = None
    # dense direct-LU preconditioner: not ported
    direct_lu: bool = False

    def check(self) -> None:
        """Raise on settings this port does not implement yet."""
        if self.inner_mode not in ("auto", "krylov"):
            raise NotImplementedError(
                f"inner_mode={self.inner_mode!r} is not ported yet "
                "(ROADMAP.md A.D3: fixed inner sweeps need _chebyshev)"
            )
        if self.mg_smoother != "gmres":
            raise NotImplementedError(
                f"mg_smoother={self.mg_smoother!r} is not ported yet "
                "(ROADMAP.md A.D3: _chebyshev and _estimate_lmax)"
            )
        if self.schur_mode != "mass":
            raise NotImplementedError(
                f"schur_mode={self.schur_mode!r} is not ported yet "
                "(ROADMAP.md A.D5: Cahouet-Chabard and PCD Schur legs)"
            )
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

    def Mp(self, x_p):
        return matfree.apply_Mp(self.disc, self.nu, x_p)

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


def _make_p_solver(ctx: LinearContext, cfg: PrecondConfig):
    """Pressure-block inner solver ``solve(rhs, tol) -> dp`` ("mass" mode):
    Jacobi-CG on the 1/nu-scaled pressure mass, dp = nu Mp^-1 rhs."""
    mp = ctx.jacobi_Mp()

    def solve_mass(rhs, tol):
        dp, _ = cg(ctx.Mp, rhs, torch.zeros_like(rhs), tol=tol,
                   maxiter=cfg.inner_maxiter, M=mp)
        return dp

    return solve_mass


def make_block_triangular(ctx: LinearContext, cfg: PrecondConfig):
    """Stationary triangular sweep (NSSolverStationary.hpp:188-218):
    velocity solve FGMRES(F) to rel 1e-2 (AMG -> V-cycle preconditioned),
    pressure correction tmp = src_p - B du, then CG(Mp) to rel 1e-2 of
    ||src_p||; ``cfg`` may override both tolerances on Stokes systems."""
    mf = ctx.smoother_F(cfg)
    rel_u = rel_p = 1e-2
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
    of NSSolver.cpp:607-668).  Only the stationary blockTriangular (kind 1)
    is ported."""
    cfg = cfg or PrecondConfig()
    cfg.check()
    if variant != "stationary":
        raise NotImplementedError(
            f"the {variant!r} preconditioner variant is not ported yet "
            "(ROADMAP.md A.D5: the unsteady path)"
        )
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
        return make_block_triangular(ctx, cfg)
    vmult = make_block_triangular(_cast_ctx(ctx, vd), cfg)

    def vmult_mixed(src: Blocks) -> Blocks:
        out = vmult(Blocks(*(a.to(vd) for a in src)))
        return Blocks(*(a.to(out_dtype) for a in out))

    return vmult_mixed

"""Shared solver machinery: options, setup, tangent solves, lift/drag."""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.obs import PhaseTimer
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg
from navier_stokes_solver_tpu_torch.precond.blocks import PRECONDITIONER_NAMES, torch_dtype

__all__ = [
    "SolverOptions",
    "NSSolverBase",
    "state_from_numpy",
    "SOLVER_NAMES",
    "PRECONDITIONER_NAMES",
]

SOLVER_NAMES = {0: "GMRES", 1: "FGMRES", 2: "Bicgstab"}


@dataclasses.dataclass
class SolverOptions:
    """CLI-equivalent configuration (defaults from test.cpp:25-34): the JAX
    package's fields and defaults that the ported paths serve, plus
    ``device``."""

    mesh_size: tuple[int, int] = (100, 100)  # -m X,Y
    degree_velocity: int = 3  # generated-mesh path default (test.cpp:26)
    degree_pressure: int = 2
    Re: float = 100.0  # -r
    solver_type: int = 1  # -s (0 GMRES, 1 FGMRES, 2 BiCGStab)
    tolerance: float = 1e-6  # -t (absolute)
    preconditioner_type: int = 0  # -p (0 blockDiagonal, 1 blockTriangular, 2 aSIMPLE)
    time_span: float = 1.0  # -T span,step (unsteady only)
    time_step: float = 0.01
    # Outer GMRES/FGMRES restart basis (deal.II default 30; a deeper basis
    # is a perf knob -- same fields, fewer outer iterations).
    krylov_basis: int = 30
    read_mesh_from_file: bool = False  # -M: not ported
    mesh_file_name: str = ""  # -M FILE: not ported
    geometry: str = "channel"  # "cavity": not ported
    multigrid: bool = True  # geometric-MG velocity smoother (AMG analog)
    # working precision of the solve: None = float64; torch.float32 (or
    # "float32") is the CLI's --f32
    dtype: Any = None
    # where every tensor of the solve lives: the card unless the caller
    # asks for "cpu" (without a card, "cuda" fails in setup: no silent
    # fallback)
    device: Any = "cuda"
    verbose: bool = True
    write_output: bool = False  # VTU snapshots: not ported
    # directory of the lift/drag coefficient files (write_lift_drag_to_file)
    output_dir: str = "."
    profile_dir: str = ""  # the CLI captures a torch.profiler trace here
    fused: bool = False  # the fused time loop: not ported
    # Stationary continuation: skip the reference's repeat Stokes-regime
    # tangent solves, whose state-independent rhs makes the strict-< line
    # search reject every update (see the JAX package's SolverOptions).
    skip_futile_stokes: bool = False
    precond_config: Any = None  # precond.PrecondConfig
    dd: Any = None  # domain decomposition: not ported
    # Newton continuity-rhs sign: False = the reference's +(q, div u_k)
    # (NSSolver.cpp:517-519), which disagrees with its Jacobian's
    # +(q, div du) row; True = the Jacobian-consistent -(q, div u_k)
    consistent_continuity: bool = False

    def check(self) -> None:
        """Raise on options outside the ported slice: a field whose feature
        is not ported raises only when set away from its default."""
        if self.read_mesh_from_file or self.mesh_file_name:
            raise NotImplementedError(
                "-M (simplex mesh backend) is not ported yet (ROADMAP.md A.D7)"
            )
        if self.geometry == "cavity":
            raise NotImplementedError(
                "the cavity geometry is not ported yet (ROADMAP.md A.D6b)"
            )
        if self.geometry != "channel":
            raise ValueError(f"unknown geometry {self.geometry!r}")
        if self.dd is not None:
            raise NotImplementedError(
                "domain decomposition is not ported yet (ROADMAP.md A.D9, dist/)"
            )
        if self.write_output:
            raise NotImplementedError("VTU output is not ported yet (ROADMAP.md A.D6b)")
        if self.fused:
            raise NotImplementedError(
                "the fused time loop is not ported yet (ROADMAP.md A.D5b)"
            )
        if self.solver_type not in (0, 1, 2):
            raise ValueError(f"invalid solver_type {self.solver_type!r}")
        if self.preconditioner_type not in (0, 1, 2):
            raise ValueError(f"invalid preconditioner_type {self.preconditioner_type!r}")
        if torch_dtype(self.dtype) not in (None, torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        (self.precond_config or PrecondConfig()).check()


def state_from_numpy(u, p, *, dtype: torch.dtype, device) -> Blocks:
    """A ``Blocks`` state from lattice arrays -- e.g. the JAX package's
    ``np.asarray(solver.solution.u)`` [2, NVy, NVx] and ``.p`` [NPy, NPx]."""
    put = lambda a: torch.as_tensor(np.array(a), device=device).to(dtype)
    return Blocks(u=put(u), p=put(p))


class NSSolverBase:
    """Common lifecycle of the stationary and unsteady solvers."""

    VARIANT: str = ""
    KRYLOV_MAXITER: int = 0  # SolverControl maxit
    # Krylov iterations per solver call: a whole number of restart cycles,
    # so chunking is mathematically one long restarted solve -- except for
    # the GMRES-IR cross-chunk stall test, which looks at chunk ends, and
    # for BiCGStab, whose every chunk restarts (the shadow residual resets
    # at each chunk boundary, as in the JAX package).  The length is fixed
    # (basis * (KRYLOV_CHUNK_MAX // basis)); the JAX package's parity runs
    # set NSTPU_KRYLOV_CHUNK to the same value.
    KRYLOV_CHUNK_MAX: int = 960

    def __init__(self, options: SolverOptions | None = None, **kwargs):
        if options is None:
            options = SolverOptions(**kwargs)
        elif kwargs:
            options = dataclasses.replace(options, **kwargs)
        options.check()
        self.options = options
        self.device = torch.device(options.device)
        self.dtype = torch_dtype(options.dtype) or torch.float64
        self.Re = options.Re
        self.nu: float = 0.01 if self.VARIANT == "unsteady" else 0.001
        self.history: list[dict] = []
        self.lift_force = 0.0
        self.drag_force = 0.0
        self.lift_coeff = 0.0
        self.drag_coeff = 0.0
        self.timer = PhaseTimer(self.device)

    # ------------------------------------------------------------------
    def log(self, *msg):
        if self.options.verbose:
            print(*msg, flush=True)

    def setup(self):
        """Build mesh, FE space and device data (NSSolver::setup,
        NSSolver.cpp:3-311)."""
        o = self.options
        t0 = _time.perf_counter()
        self.geo = make_channel_geometry(*o.mesh_size)
        self.space = make_fe_space(self.geo, o.degree_velocity, o.degree_pressure)
        self.disc = make_disc(self.space, self.dtype, self.device)
        if o.multigrid:
            self.disc = attach_mg(self.disc)
        self.log(f"  Number of elements = {self.geo.n_active_cells}")
        self.log("-----------------------------------------------")
        self.log("Initializing the finite element space")
        self.log(f"  Velocity degree:           = {o.degree_velocity}")
        self.log(f"  Pressure degree:           = {o.degree_pressure}")
        self.log("-----------------------------------------------")
        self.log("  Number of DoFs: ")
        self.log(f"    velocity = {self.space.n_dofs_velocity}")
        self.log(f"    pressure = {self.space.n_dofs_pressure}")
        self.log(f"    total    = {self.space.n_dofs}")
        self.n_dofs = self.space.n_dofs

        zero = Blocks(u=self.disc.zeros_u(), p=self.disc.zeros_p())
        self.solution = zero
        self.solution_old = zero
        self.delta = zero  # persistent delta_owned (warm start semantics)
        # assembly and lift/drag do not use the MG chain
        self.disc_nomg = self.disc.replace(mg=None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds = _time.perf_counter() - t0
        return self

    # ------------------------------------------------------------------
    @property
    def inv_dt(self) -> float:
        return 0.0

    def _inlet_amp(self, lifting: bool) -> float:
        raise NotImplementedError

    def assemble_system(self, stokes: bool, lifting: bool) -> float:
        """Assemble rhs = -R with BC; returns its l2 norm."""
        with self.timer.phase("assemble"):
            self.rhs, rn = kernels.assemble_kernel(
                self.disc_nomg,
                self.nu,
                self.inv_dt,
                self.solution,
                self.solution_old.u,
                self._inlet_amp(lifting),
                stokes=stokes,
                consistent=self.options.consistent_continuity,
            )
            rn = float(rn)
        return rn

    def solve_system(self, stokes: bool, lifting: bool) -> int:
        """Tangent solve; prints and returns the Krylov iteration count
        (NSSolver.cpp:601-672)."""
        o = self.options
        self.log(f"Solver tolerance: {o.tolerance}")
        total = 0
        first = True
        basis = max(1, int(o.krylov_basis))
        chunk_len = basis * max(1, self.KRYLOV_CHUNK_MAX // basis)
        cfg = o.precond_config
        prev_res = None
        with self.timer.phase("krylov_solve"):
            while True:
                chunk = min(chunk_len, self.KRYLOV_MAXITER - total)
                self.delta, info = kernels.solve_kernel(
                    self.disc,
                    self.nu,
                    self.inv_dt,
                    self.solution,
                    self.rhs,
                    self.delta,
                    self._inlet_amp(lifting),
                    o.tolerance,
                    stokes=stokes,
                    solver_type=o.solver_type,
                    prec_type=o.preconditioner_type,
                    variant=self.VARIANT,
                    maxiter=chunk,
                    project_x0=first,
                    precond_cfg=cfg,
                    basis=basis,
                )
                first = False
                it = info.iters
                total += it
                self.log(
                    f"   [chunk] {total} iterations, residual {info.resnorm:.3e}"
                )
                if info.failed:
                    # deal.II SolverControl::check_failure would throw
                    # NoConvergence here (non-finite residual / breakdown)
                    raise RuntimeError(
                        f"Krylov breakdown after {total} iterations "
                        f"(residual {info.resnorm!r}); the reference "
                        "aborts with deal.II NoConvergence on the same run"
                    )
                if info.converged or total >= self.KRYLOV_MAXITER:
                    break
                if getattr(cfg, "krylov_cycle_dtype", None) is not None:
                    # GMRES-IR stall detection: in-call (a chunk exits below
                    # its iteration budget) or across chunks (the true
                    # restart residual stopped improving).  Either way,
                    # retire the remaining iterations with full-precision
                    # cycles; the restart structure makes the switch exact.
                    res = info.resnorm
                    if it < chunk or (prev_res is not None and res >= 0.99 * prev_res):
                        cfg = dataclasses.replace(cfg, krylov_cycle_dtype=None)
                        self.log(
                            f"   [gmres-ir] f32 cycles stalled at residual "
                            f"{res:.3e} after {total} iterations; falling back"
                            " to f64 cycles"
                        )
                        prev_res = None
                        continue
                    prev_res = res
                elif it < chunk:
                    break
        self.log(f"   {total} iterations")
        return total

    # ------------------------------------------------------------------
    # Lift / drag (NSSolver.cpp:839-974)
    # ------------------------------------------------------------------
    def compute_lift_drag(self):
        self.log("===============================================")
        self.log("Computing lift and drag forces")
        with self.timer.phase("lift_drag"):
            drag, lift = kernels.lift_drag_kernel(self.disc_nomg, self.nu, self.solution)
            self.drag_force = float(drag)
            self.lift_force = float(lift)
        self.log(f"Lift force: {self.lift_force}")
        self.log(f"Drag force: {self.drag_force}")

    def _inlet_u_max(self) -> float:
        raise NotImplementedError

    def get_avg_inlet_velocity(self) -> float:
        """U_avg = 2 * U(0, H/2) / 3 (NSSolver.cpp:940-944)."""
        return 2.0 * self._inlet_u_max() / 3.0

    def get_reynolds(self) -> float:
        return self.get_avg_inlet_velocity() * 0.1 / self.nu

    def compute_lift_coeff(self):
        ua = self.get_avg_inlet_velocity()
        self.lift_coeff = 2.0 * self.lift_force / (ua * ua * 0.1)

    def compute_drag_coeff(self):
        ua = self.get_avg_inlet_velocity()
        self.drag_coeff = 2.0 * self.drag_force / (ua * ua * 0.1)

    def print_lift_coeff(self):
        self.log("===============================================")
        self.compute_lift_coeff()
        self.log(f"Lift coefficient: {self.lift_coeff}")

    def print_drag_coeff(self):
        self.log("===============================================")
        self.compute_drag_coeff()
        self.log(f"Drag coefficient: {self.drag_coeff}")

    def write_lift_drag_to_file(self, directory: str | None = None):
        """Append the coefficients to per-Re files in ``directory``
        (default ``options.output_dir``; NSSolver.cpp:976-1018)."""
        directory = directory or self.options.output_dir
        re = self.get_reynolds()
        for name, value in (
            ("drag_coefficient", self.drag_coeff),
            ("lift_coefficient", self.lift_coeff),
        ):
            with open(os.path.join(directory, f"{name}_{re:.2f}.txt"), "a") as f:
                f.write(f"{value}\n")

    def output(self, time_step: int | None = None):
        """VTU output (NSSolver.cpp:761-797): a no-op, since
        ``SolverOptions.check`` rejects ``write_output`` (ROADMAP.md A.D6b)."""

    def fields(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of (velocity [2, NVy, NVx], pressure [NPy, NPx])."""
        return self.solution.u.cpu().numpy(), self.solution.p.cpu().numpy()

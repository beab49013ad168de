"""Shared solver machinery: options, setup, tangent solves, lift/drag."""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.dist import (
    all_gather_blocks,
    all_gather_simplex_blocks,
    decompose_disc,
    decompose_simplex_disc,
    make_dd_mesh,
    simplex_strip,
)
from navier_stokes_solver_tpu_torch.geometry import (
    make_cavity_geometry,
    make_channel_geometry,
    make_fe_space,
)
from navier_stokes_solver_tpu_torch.io import (
    read_msh,
    write_msh,
    write_vtu_record,
    write_vtu_tri,
    write_vtu_tri_record,
)
from navier_stokes_solver_tpu_torch.obs import PhaseTimer
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg
from navier_stokes_solver_tpu_torch.precond.blocks import (
    PRECONDITIONER_NAMES,
    direct_lu_eligible,
    torch_dtype,
)
from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel
from navier_stokes_solver_tpu_torch.unstructured.dense import attach_dense_schur

__all__ = [
    "SolverOptions",
    "NSSolverBase",
    "state_from_numpy",
    "SOLVER_NAMES",
    "PRECONDITIONER_NAMES",
]

SOLVER_NAMES = {0: "GMRES", 1: "FGMRES", 2: "Bicgstab"}
# SolverOptions.geometry -> the maker of its structured geometry (every
# multigrid level is made by the same one)
GEOMETRIES = {"channel": make_channel_geometry, "cavity": make_cavity_geometry}


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
    # -M: the unstructured P2/P1 simplex backend (switches the degrees to
    # 2,1); from the gmsh file ``mesh_file_name``, or without one from the
    # triangulated internal channel at ``mesh_size``
    read_mesh_from_file: bool = False
    mesh_file_name: str = ""
    # "channel": the reference's channel with its cylinder; "cavity": the
    # lid-driven unit cavity (geometry/cavity.py; structured path only)
    geometry: str = "channel"
    multigrid: bool = True  # geometric-MG velocity smoother (AMG analog)
    # working precision of the solve: None = float64; torch.float32 (or
    # "float32") is the CLI's --f32
    dtype: Any = None
    # where every tensor of the solve lives: the card unless the caller
    # asks for "cpu" (without a card, "cuda" fails in setup: no silent
    # fallback).  Under ``dd``, "cuda" is ``cuda:{LOCAL_RANK}``, and a list
    # gives each rank its device (ranks may then share a card, under gloo)
    device: Any = "cuda"
    verbose: bool = True
    write_output: bool = False  # VTU snapshots (output(); the reference writes always)
    # directory of the VTU snapshots and of the lift/drag coefficient files
    output_dir: str = "."
    write_mesh: bool = False  # write mesh.msh at setup (NSSolver.cpp:108)
    # optional body force f(x, y) -> (fx, fy), vectorized over arrays (the
    # reference's ForcingTerm placeholder, NSSolver.hpp:93-122; zero when
    # None); structured path only
    forcing: Any = None
    profile_dir: str = ""  # the CLI captures a torch.profiler trace here
    # the CLI's --fused: the unsteady solver runs ``solve_fused`` (the
    # stationary solver ignores it, as the JAX package's does)
    fused: bool = False
    # Stationary continuation: skip the reference's repeat Stokes-regime
    # tangent solves, whose state-independent rhs makes the strict-< line
    # search reject every update (see the JAX package's SolverOptions).
    skip_futile_stokes: bool = False
    precond_config: Any = None  # precond.PrecondConfig
    # domain decomposition (x_tiles, y_tiles) (or an int: x-tiles): run on
    # this rank's tile of an SPMD group of x_tiles * y_tiles ranks (the
    # reference's ``mpiexec -n``, run_sim_steady.sh:24; ``dist/``); the
    # process group must exist (``dist.launch``, or the CLI's ``--dd``).
    # The -M simplex mesh decomposes into 1-D x-strips only: (n, 1)
    # (dist/simplex.py).  None = one device
    dd: Any = None
    # -M: attach the dense inverses of the pressure mass and pressure
    # Laplacian (unstructured/dense.py; up to DENSE_SCHUR_MAX_NP pressure
    # nodes), so the Schur legs are one matrix-vector product each instead
    # of nested iterations (not on x-strips, whose legs iterate)
    dense_schur: bool = True
    # Newton continuity-rhs sign: False = the reference's +(q, div u_k)
    # (NSSolver.cpp:517-519), which disagrees with its Jacobian's
    # +(q, div du) row; True = the Jacobian-consistent -(q, div u_k)
    consistent_continuity: bool = False

    def check(self) -> None:
        """Raise on options outside the ported slice: a field whose feature
        is not ported raises only when set away from its default."""
        if self.geometry not in GEOMETRIES:
            raise ValueError(f"unknown geometry {self.geometry!r}")
        if self.read_mesh_from_file and self.geometry == "cavity":
            raise ValueError("geometry='cavity' is structured-path only (no -M)")
        if self.read_mesh_from_file and self.forcing is not None:
            raise ValueError("a body force is structured-path only (no -M)")
        if self.dd is not None:
            n_x, n_y = dd_tiles(self.dd)
            if n_x < 1 or n_y < 1:
                raise ValueError(f"invalid dd {self.dd!r}")
            if self.read_mesh_from_file and n_y != 1:
                raise NotImplementedError(
                    "simplex decomposition is 1-D (x-strips); use dd=(n, 1)"
                )
        elif isinstance(self.device, (list, tuple)):
            raise ValueError("a device per rank needs dd")
        if self.solver_type not in (0, 1, 2):
            raise ValueError(f"invalid solver_type {self.solver_type!r}")
        if self.preconditioner_type not in (0, 1, 2):
            raise ValueError(f"invalid preconditioner_type {self.preconditioner_type!r}")
        if torch_dtype(self.dtype) not in (None, torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        (self.precond_config or PrecondConfig()).check()


def dd_tiles(dd) -> tuple[int, int]:
    """``SolverOptions.dd`` as ``(x_tiles, y_tiles)``."""
    return (int(dd), 1) if isinstance(dd, int) else tuple(int(n) for n in dd)


def state_from_numpy(u, p, *, dtype: torch.dtype, device) -> Blocks:
    """A ``Blocks`` state from lattice arrays -- e.g. the JAX package's
    ``np.asarray(solver.solution.u)`` [2, NVy, NVx] and ``.p`` [NPy, NPx]."""
    put = lambda a: torch.as_tensor(np.array(a), device=device).to(dtype)
    return Blocks(u=put(u), p=put(p))


def time_state_from_numpy(ts, *, dtype: torch.dtype, device):
    """The port's ``timeloop.TimeState`` from one with the same fields whose
    leaves are arrays -- e.g. the JAX package's (batched, an ensemble's, or
    not) after ``jax.tree_util.tree_map(np.asarray, ts)``: the floating
    leaves in ``dtype``, ``step`` and the counts int32, on ``device``."""
    from navier_stokes_solver_tpu_torch.timeloop import StepStats, TimeState

    put = lambda a, dt: torch.as_tensor(np.array(a), device=device).to(dt)
    fl = lambda a: put(a, dtype)
    i32 = lambda a: put(a, torch.int32)
    st = ts.stats
    return TimeState(
        solution=state_from_numpy(ts.solution.u, ts.solution.p, dtype=dtype, device=device),
        time=fl(ts.time), step=i32(ts.step), drag=fl(ts.drag), lift=fl(ts.lift),
        stats=StepStats(newton_iters=i32(st.newton_iters), krylov_iters=i32(st.krylov_iters),
                        final_residual=fl(st.final_residual)),
    )


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
        if options.read_mesh_from_file:
            # -M flips the FE degrees (test.cpp:66-70) and selects the
            # unstructured P2/P1 simplex backend (NSSolver.cpp:144-209)
            options = dataclasses.replace(options, degree_velocity=2, degree_pressure=1)
        self.options = options
        # this rank's place on the tile mesh under dd (dist.Mesh), else None
        self.mesh = None
        # the strip tables of a decomposed -M mesh (dist.DecomposedSimplex)
        self.dd_simplex = None
        if options.dd is not None:
            devs = options.device if isinstance(options.device, (list, tuple)) else None
            self.mesh = make_dd_mesh(*dd_tiles(options.dd), devices=devs,
                                     default="cuda" if devs else options.device)
            self.device = self.mesh.device
        else:
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
    @property
    def is_root(self) -> bool:
        """True on the rank that logs and writes files (the only one
        without dd)."""
        return self.mesh is None or self.mesh.rank == 0

    def log(self, *msg):
        if self.options.verbose and self.is_root:
            print(*msg, flush=True)

    def setup(self):
        """Build mesh, FE space and device data (NSSolver::setup,
        NSSolver.cpp:3-311).  The ``-M`` path builds the unstructured P2/P1
        simplex backend (NSSolver.cpp:144-209) from a gmsh file, or from
        the triangulated internal channel when no file is given."""
        o = self.options
        t0 = _time.perf_counter()
        make_geometry = GEOMETRIES[o.geometry]
        self.geo = make_geometry(*o.mesh_size)
        if o.read_mesh_from_file:
            self.space = None
            self.disc, glob = self._simplex_disc()
            n_el = glob.n_tri
            n_dofs_v, n_dofs_p = 2 * glob.n_nodes_v, glob.n_nodes_p
        else:
            self.space = make_fe_space(self.geo, o.degree_velocity, o.degree_pressure)
            if self.mesh is None:
                self.disc = make_disc(self.space, self.dtype, self.device, forcing=o.forcing)
                if o.multigrid:
                    self.disc = attach_mg(self.disc, make_geometry)
            else:
                self.disc = self._tile_disc(make_geometry)
            n_el = self.geo.n_active_cells
            n_dofs_v, n_dofs_p = self.space.n_dofs_velocity, self.space.n_dofs_pressure
            if o.write_mesh:
                # the reference always writes the generated mesh
                # (GridOut::write_msh, NSSolver.cpp:108-110); opt-in here
                write_msh(self.geo, "mesh.msh")
        self.log(f"  Number of elements = {n_el}")
        self.log("-----------------------------------------------")
        self.log("Initializing the finite element space")
        self.log(f"  Velocity degree:           = {o.degree_velocity}")
        self.log(f"  Pressure degree:           = {o.degree_pressure}")
        self.log("-----------------------------------------------")
        self.log("  Number of DoFs: ")
        self.log(f"    velocity = {n_dofs_v}")
        self.log(f"    pressure = {n_dofs_p}")
        self.log(f"    total    = {n_dofs_v + n_dofs_p}")
        self.n_dofs = n_dofs_v + n_dofs_p
        cfg = o.precond_config
        if cfg is not None and cfg.direct_lu:
            name = PRECONDITIONER_NAMES[o.preconditioner_type]
            direct_lu_eligible(self.disc, log=lambda msg: self.log(f"{msg} ({name})"))

        zero = Blocks(u=self.disc.zeros_u(), p=self.disc.zeros_p())
        self.solution = zero
        self.solution_old = zero
        self.delta = zero  # persistent delta_owned (warm start semantics)
        # assembly and lift/drag do not use the MG chain
        self.disc_nomg = self.disc if self.space is None else self.disc.replace(mg=None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_seconds = _time.perf_counter() - t0
        return self

    def _tile_disc(self, make_geometry):
        """This rank's tile of the channel (``dist.decompose_disc``, with
        its decomposed multigrid chain when ``multigrid``), on its device."""
        o, m = self.options, self.mesh
        glob = make_disc(self.space, self.dtype, "cpu", forcing=o.forcing)
        disc = decompose_disc(
            glob, m.n_x, m.n_y, m.iy, m.ix, mesh=m, device=self.device,
            multigrid=o.multigrid, make_geometry=make_geometry,
        )
        self.log(f"  Domain decomposition: {m.n_x} x {m.n_y} tiles ({m.backend})")
        return disc

    def _simplex_disc(self):
        """The -M disc and the whole mesh's: the gmsh file's triangles (read
        by every rank), or the triangulated internal channel; the
        p-multigrid flag with ``multigrid``, and the dense Schur inverses
        with ``dense_schur``.  Under dd the whole mesh's disc is built on
        the host and decomposed into x-strips (``dist.decompose_simplex_disc``,
        kept in ``dd_simplex``); this rank's strip is the disc, with no
        dense inverse (a strip's legs iterate, as in the JAX package)."""
        o, m = self.options, self.mesh
        if o.mesh_file_name:
            data = read_msh(o.mesh_file_name)
            if data["tri"].shape[0] == 0:
                raise ValueError(f"{o.mesh_file_name!r} contains no triangles")
            mesh = data["nodes_xy"], data["tri"], data["edges"], data["edge_tag"]
        else:
            mesh = triangulate_channel(self.geo)
        disc = make_simplex_disc(*mesh, dtype=self.dtype, device="cpu" if m else self.device)
        if o.multigrid:
            disc = disc.replace(p_mg=True)
        if m is not None:
            self.dd_simplex = decompose_simplex_disc(*mesh, m.n_x, global_disc=disc)
            self.log(f"  Domain decomposition: {m.n_x} x-strips ({m.backend})")
            return simplex_strip(self.dd_simplex, m.ix, device=self.device, dtype=self.dtype, mesh=m), disc
        if o.dense_schur:
            disc = attach_dense_schur(disc)
        return disc, disc

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
        if not self.is_root:
            return
        for name, value in (
            ("drag_coefficient", self.drag_coeff),
            ("lift_coefficient", self.lift_coeff),
        ):
            with open(os.path.join(directory, f"{name}_{re:.2f}.txt"), "a") as f:
                f.write(f"{value}\n")

    def output(self, time_step: int | None = None):
        """VTU output (NSSolver.cpp:761-797) into ``options.output_dir`` when
        ``write_output`` is set: ``output_NNN.0.vtu`` and its ``.pvtu``
        record on the structured lattice, ``output_NNN.0.vtu`` of triangles
        under ``-M`` (``NNN`` = ``time_step``, 0 by default).  Under dd one
        piece per tile (x-strip under ``-M``, then with its ``.pvtu``
        record) with partitioning = its id (the reference's per-rank
        pieces, NSSolver.cpp:781-793), written by rank 0."""
        o = self.options
        if not o.write_output:
            return
        u, p = self.fields()
        if not self.is_root:
            return
        counter = time_step or 0
        if self.dd_simplex is not None:
            write_vtu_tri_record(self.dd_simplex, u, p, directory=o.output_dir, counter=counter)
        elif self.space is None:
            os.makedirs(o.output_dir, exist_ok=True)
            write_vtu_tri(self.disc, u, p, os.path.join(o.output_dir, f"output_{counter:03d}.0.vtu"))
        else:
            tiles = None if self.mesh is None else (self.mesh.n_x, self.mesh.n_y)
            write_vtu_record(self.space, u, p, directory=o.output_dir, counter=counter, tiles=tiles)

    def fields(self) -> tuple[np.ndarray, np.ndarray]:
        """Host copies of (velocity, pressure): [2, NVy, NVx] and [NPy, NPx]
        on the structured lattice, [2, n_nodes_v] and [n_nodes_p] under
        ``-M``.  Under dd the global fields on every rank, stitched from
        the tiles or x-strips (a collective)."""
        if self.dd_simplex is not None:
            return tuple(all_gather_simplex_blocks(self.solution, self.disc, self.dd_simplex))
        if self.mesh is not None:
            return tuple(all_gather_blocks(self.solution, self.disc))
        return self.solution.u.cpu().numpy(), self.solution.p.cpu().numpy()

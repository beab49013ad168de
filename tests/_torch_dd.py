"""Rank functions of the port's domain-decomposition tests
(``tests/test_torch_dist.py``, ``tests/test_torch_dist_runs.py``).

``dist.launch`` runs them in spawned processes, one per tile, on the CPU
under gloo; they take and return plain data (numpy arrays, numbers).  No
JAX here: a rank imports only torch and the port.
"""

from __future__ import annotations

import numpy as np
import torch

MESH = (16, 8)  # the tests' channel, Q2/Q1
NU, INV_DT = 0.1, 100.0


def _rank_mesh(dd):
    from navier_stokes_solver_tpu_torch.dist import make_dd_mesh

    torch.set_num_threads(1)
    return make_dd_mesh(*dd, devices=["cpu"] * (dd[0] * dd[1]))


def global_disc(mesh=MESH, multigrid=True):
    """The port's f64 Q2/Q1 channel disc on the CPU."""
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond import attach_mg

    disc = make_disc(make_fe_space(make_channel_geometry(*mesh), 2, 1), torch.float64, "cpu")
    return attach_mg(disc) if multigrid else disc


def _blocks(u, p):
    from navier_stokes_solver_tpu_torch.ops import Blocks

    return Blocks(u=torch.as_tensor(u), p=torch.as_tensor(p))


def operators(disc, x, st, u_old):
    """Every operator the tests hold, on ``disc`` (a tile or the whole
    channel): ``{name: tensor}`` -- lattice results, the dot, lift and
    drag."""
    from navier_stokes_solver_tpu_torch.ops import Blocks, matfree as mf

    linq = mf.eval_state(disc, st)
    dF = mf.diag_F(disc, NU, INV_DT, linq, stokes=False)
    dS = mf.diag_F(disc, NU, INV_DT, None, stokes=True)
    out = {
        "F_stokes": mf.apply_F(disc, NU, INV_DT, None, x.u, stokes=True),
        "F_newton": mf.apply_F(disc, NU, INV_DT, linq, x.u, stokes=False),
        "F_stokes_bc": mf.apply_F(disc, NU, INV_DT, None, x.u, stokes=True, bc_diag=dS),
        "F_newton_bc": mf.apply_F(disc, NU, INV_DT, linq, x.u, stokes=False, bc_diag=dF),
        "diag_F": dF,
        "B": mf.apply_B(disc, x.u, stokes=False),
        "Bt": mf.apply_Bt(disc, x.p),
        "Mp": mf.apply_Mp(disc, NU, x.p),
        "Lp": mf.apply_Lp(disc, x.p),
    }
    r = mf.residual(disc, NU, INV_DT, st, u_old, dF, stokes=False, inlet_amp=0.3)
    out["residual_u"], out["residual_p"] = r.u, r.p
    dot = mf.make_dot(disc)
    out["dot"] = (dot or (lambda a, b: torch.dot(a.u.reshape(-1), b.u.reshape(-1))
                          + torch.dot(a.p.reshape(-1), b.p.reshape(-1))))(x, Blocks(st.u, x.p))
    out["drag"], out["lift"] = mf.lift_drag_forces(disc, NU, st)
    return out


def _gather(tile, t):
    """A tile's lattice tensor (velocity or pressure) or scalar, as the
    global host array / number on every rank."""
    from navier_stokes_solver_tpu_torch.dist import all_gather_blocks
    from navier_stokes_solver_tpu_torch.ops import Blocks

    if t.dim() == 0:
        return float(t)
    if t.shape[-1] == tile.NV[-1]:
        return all_gather_blocks(Blocks(t, tile.zeros_p()), tile).u
    return all_gather_blocks(Blocks(tile.zeros_u(), t), tile).p


def operators_rank(rank, dd, x, st, u_old):
    """``operators`` on this rank's tile of the global arrays ``x``, ``st``
    (each a (u, p) pair) and ``u_old``, gathered."""
    from navier_stokes_solver_tpu_torch.dist import decompose_disc, tile_blocks

    m = _rank_mesh(dd)
    tile = decompose_disc(global_disc(), *dd, m.iy, m.ix, mesh=m)
    xt, stt = tile_blocks(_blocks(*x), tile), tile_blocks(_blocks(*st), tile)
    uo = tile_blocks(_blocks(u_old, st[1]), tile).u
    ops = operators(tile, xt, stt, uo)
    out = {k: _gather(tile, v) for k, v in ops.items()}
    out["seams_agree"] = _seams_agree(tile, ops["F_newton_bc"])
    return out


def _seams_agree(tile, t):
    """Whether every copy of every seam node of the lattice tensor ``t``
    holds the same bits on all the tiles that share it."""
    from navier_stokes_solver_tpu_torch.dist import all_gather_blocks
    from navier_stokes_solver_tpu_torch.ops import Blocks

    a = all_gather_blocks(Blocks(t, tile.zeros_p()), tile, stacked=True).u
    n_x, n_y = tile.halo_n, tile.halo_ny
    ok = True
    for iy in range(n_y):
        for ix in range(n_x):
            i = iy * n_x + ix
            if ix + 1 < n_x:
                ok &= np.array_equal(a[i][..., :, -1], a[i + 1][..., :, 0])
            if iy + 1 < n_y:
                ok &= np.array_equal(a[i][..., -1, :], a[i + n_x][..., 0, :])
    return bool(ok)


def tangent_solve(disc, st, *, stokes, maxiter):
    """One tangent solve, FGMRES + blockTriangular + MG (the unsteady
    variant), capped at ``maxiter``: (delta, iterations, residual)."""
    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.ops import Blocks
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    cfg = PrecondConfig(vmult_dtype=None, mg_dtype=None)
    rhs, _ = kernels.assemble_kernel(disc, NU, INV_DT, st, st.u, 0.3, stokes=stokes)
    zero = Blocks(u=torch.zeros_like(st.u), p=torch.zeros_like(st.p))
    delta, info = kernels.solve_kernel(
        disc, NU, INV_DT, st, rhs, zero, 0.3, 1e-14, stokes=stokes, solver_type=1, prec_type=1,
        variant="unsteady", maxiter=maxiter, precond_cfg=cfg,
    )
    return delta, info.iters, info.resnorm


def tangent_rank(rank, dd, st, maxiter):
    """``tangent_solve`` in both regimes on this rank's tile, gathered."""
    from navier_stokes_solver_tpu_torch.dist import all_gather_blocks, decompose_disc, tile_blocks

    m = _rank_mesh(dd)
    tile = decompose_disc(global_disc(), *dd, m.iy, m.ix, mesh=m)
    stt = tile_blocks(_blocks(*st), tile)
    out = {}
    for stokes in (True, False):
        delta, it, res = tangent_solve(tile, stt, stokes=stokes, maxiter=maxiter)
        out[stokes] = (tuple(all_gather_blocks(delta, tile)), it, res)
    return out


def fused_step(disc, nu, kw):
    """One step of ``make_time_step`` from rest on ``disc`` (one process;
    dt 0.01): fields, drag, lift and counts."""
    from navier_stokes_solver_tpu_torch.timeloop import initial_state, make_time_step

    ts = make_time_step(disc, **kw)(initial_state(disc), nu, 0.01)
    return dict(u=ts.solution.u.numpy(), p=ts.solution.p.numpy(), drag=float(ts.drag),
                lift=float(ts.lift), newton=int(ts.stats.newton_iters), krylov=int(ts.stats.krylov_iters))


def fused_step_rank(rank, dd, nu, kw):
    """One step of ``timeloop.make_time_step`` from
    ``timeloop.initial_state`` on this rank's tile, gathered."""
    from navier_stokes_solver_tpu_torch.dist import all_gather_blocks, decompose_disc
    from navier_stokes_solver_tpu_torch.timeloop import initial_state, make_time_step

    m = _rank_mesh(dd)
    tile = decompose_disc(global_disc(), *dd, m.iy, m.ix, mesh=m)
    ts = make_time_step(tile, **kw)(initial_state(tile), nu, 0.01)
    u, p = all_gather_blocks(ts.solution, tile)
    return dict(u=u, p=p, drag=float(ts.drag), lift=float(ts.lift), newton=int(ts.stats.newton_iters),
                krylov=int(ts.stats.krylov_iters), step=int(ts.step), counts=dict(m.counts))


def run_solver(dd, kind, opts, method, method_kw=None):
    """Build ``kind`` ("NSSolver" or "NSSolverStationary") with ``opts`` on
    the CPU (this rank's tile under ``dd``), set it up and call ``method``;
    returns the global fields, forces, Krylov counts and step index."""
    import navier_stokes_solver_tpu_torch.api as api

    s = getattr(api, kind)(device="cpu", dd=dd, verbose=False, **opts).setup()
    getattr(s, method)(**(method_kw or {}))
    if kind == "NSSolverStationary":
        s.compute_lift_drag()
    u, p = s.fields()
    return dict(u=u, p=p, drag=s.drag_force, lift=s.lift_force,
                krylov=[h["krylov_iters"] for h in s.history if "krylov_iters" in h],
                step=getattr(s, "time_step_index", None),
                counts=None if s.mesh is None else dict(s.mesh.counts))


def solver_rank(rank, dd, kind, opts, method, method_kw=None):
    torch.set_num_threads(1)
    return run_solver(dd, kind, opts, method, method_kw)


def checkpoint_rank(rank, dd, opts, straight, split, single):
    """The fused loop under ``dd``: the whole span straight (checkpointing
    into ``straight``), then one call stopped after a step and a resumed
    call (``split``), and a resume from the single-device checkpoint
    ``single``, which must raise.  Returns both runs' fields and histories and the
    error message."""
    import navier_stokes_solver_tpu_torch.api as api

    torch.set_num_threads(1)
    mk = lambda: api.NSSolver(device="cpu", dd=dd, verbose=False, **opts).setup()
    kw = dict(newton_max=2, krylov_maxiter=20)
    out = {}
    s = mk()
    s.solve_fused(checkpoint_dir=straight, **kw)
    out["straight"] = (*s.fields(), [h["drag_force"] for h in s.history], s.time_step_index)
    s = mk()
    s.solve_fused(checkpoint_dir=split, max_steps_this_call=1, **kw)
    out["partial_step"] = s.time_step_index
    s = mk()
    s.solve_fused(checkpoint_dir=split, **kw)
    out["split"] = (*s.fields(), [h["drag_force"] for h in s.history], s.time_step_index)
    try:
        mk().solve_fused(checkpoint_dir=single, **kw)
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def sweep_rank(rank, n_ens, nus, steps, kw):
    """``ensemble.run_sweep`` over an ``('ens',)`` mesh of ``n_ens`` ranks:
    every rank's (gathered) final fields and [T, B] history."""
    from navier_stokes_solver_tpu_torch.dist import make_mesh
    from navier_stokes_solver_tpu_torch.ensemble import run_sweep

    torch.set_num_threads(1)
    mesh = make_mesh(1, n_ens, devices=["cpu"] * n_ens)
    final, hist = run_sweep(global_disc(), nus, 0.01, steps, mesh=mesh, **kw)
    return dict(u=final.solution.u.numpy(), p=final.solution.p.numpy(),
                hist={k: v.numpy() for k, v in hist.items()})


def sweep(nus, steps, kw):
    """The same sweep on one process, unsharded."""
    from navier_stokes_solver_tpu_torch.ensemble import run_sweep

    final, hist = run_sweep(global_disc(), nus, 0.01, steps, **kw)
    return dict(u=final.solution.u.numpy(), p=final.solution.p.numpy(),
                hist={k: v.numpy() for k, v in hist.items()})


def mesh_errors_rank(rank):
    """The mesh's refusals inside a 2-rank group: a 2 x 2 mesh needs four
    ranks."""
    from navier_stokes_solver_tpu_torch.dist import make_dd_mesh

    try:
        make_dd_mesh(2, 2, devices=["cpu"] * 4)
    except ValueError as e:
        return str(e)
    return None

"""Rank functions of the port's x-strip tests (``tests/test_torch_dist_simplex.py``).

``dist.launch`` runs them in spawned processes, one per strip of the
triangulated 16x8 channel (``-M``), on the CPU under gloo; they take and
return plain data (numpy arrays, numbers).  No JAX here: a rank imports only
torch and the port.
"""

from __future__ import annotations

import numpy as np
import torch

MESH = (16, 8)  # the tests' channel, triangulated: P2/P1
NU, INV_DT = 0.1, 100.0


def mesh_data(mesh=MESH):
    """(nodes_xy, tri, edges, edge_tag) of the triangulated channel."""
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
    from navier_stokes_solver_tpu_torch.unstructured import triangulate_channel

    return triangulate_channel(make_channel_geometry(*mesh))


def global_disc(p_mg=True):
    """The port's f64 simplex disc of the whole channel on the CPU."""
    from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc

    return make_simplex_disc(*mesh_data(), dtype=torch.float64, device="cpu").replace(p_mg=p_mg)


def rank_strip(n):
    """This rank's strip of an ``n``-strip decomposition, with its process
    mesh, and the strip tables."""
    from navier_stokes_solver_tpu_torch.dist import decompose_simplex_disc, make_dd_mesh, simplex_strip

    torch.set_num_threads(1)
    m = make_dd_mesh(n, 1, devices=["cpu"] * n)
    dd = decompose_simplex_disc(*mesh_data(), n, global_disc=global_disc())
    return simplex_strip(dd, m.ix, device="cpu", mesh=m), dd


def operators(disc, x, st, u_old, xc, rf):
    """Every strip-aware operator on ``disc`` (a strip or the whole mesh):
    ``{name: tensor}`` -- the velocity block in both regimes with and
    without its boundary rows, the diagonals, B, Bt, the pressure
    operators, the residual, the Jacobian, the p-multigrid transfers and
    coarse operator, the seam-weighted dot, lift and drag."""
    from navier_stokes_solver_tpu_torch.ops import Blocks
    from navier_stokes_solver_tpu_torch.unstructured import ops as so
    from navier_stokes_solver_tpu_torch.unstructured import pmg

    linq = so.eval_state(disc, st)
    dF = so.diag_F(disc, NU, INV_DT, linq, stokes=False)
    dS = so.diag_F(disc, NU, INV_DT, None, stokes=True)
    d1 = pmg.diag_F1(disc, NU, INV_DT, None, stokes=True)
    out = {
        "F_stokes": so.apply_F(disc, NU, INV_DT, None, x.u, stokes=True),
        "F_newton": so.apply_F(disc, NU, INV_DT, linq, x.u, stokes=False),
        "F_stokes_bc": so.apply_F(disc, NU, INV_DT, None, x.u, stokes=True, bc_diag=dS),
        "F_newton_bc": so.apply_F(disc, NU, INV_DT, linq, x.u, stokes=False, bc_diag=dF),
        "diag_F": dF,
        "diag_F_stokes": dS,
        "B": so.apply_B(disc, x.u, stokes=False),
        "Bt": so.apply_Bt(disc, x.p),
        "Mp": so.apply_Mp(disc, NU, x.p),
        "Mp_raw": so.apply_Mp_raw(disc, x.p),
        "Lp": so.apply_Lp(disc, x.p),
        "Fp": so.apply_Fp(disc, NU, INV_DT, linq, x.p),
        "diag_Lp": so.diag_Lp(disc),
        "diag_Mp": so.diag_Mp(disc, NU),
        "prolong": pmg.prolong(disc, xc),
        "restrict": pmg.restrict(disc, rf),
        "diag_F1": d1,
        "F1": pmg.apply_F1(disc, NU, INV_DT, None, xc, stokes=True, bc_diag=d1),
    }
    r = so.residual(disc, NU, INV_DT, st, u_old, dF, stokes=False, inlet_amp=0.3)
    out["residual_u"], out["residual_p"] = r.u, r.p
    j = so.apply_jacobian(disc, NU, INV_DT, linq, dF, x, stokes=False)
    out["J_u"], out["J_p"] = j.u, j.p
    out["dot"] = so.make_dot(disc)(x, Blocks(st.u, x.p))
    out["drag"], out["lift"] = so.lift_drag_forces(disc, NU, st)
    return out


def operators_rank(rank, n, x, st, u_old, xc, rf):
    """``operators`` on this rank's strip of the global arrays ``x``, ``st``
    (each a (u, p) pair), ``u_old``, ``xc`` [2, n_p] and ``rf`` [2, n_v]:
    each vector result strip-stacked (every strip's copy of every node),
    each scalar as a number; and the round trip of ``x`` through
    ``strip_blocks`` and ``all_gather_simplex_blocks`` (bit for bit)."""
    from navier_stokes_solver_tpu_torch.dist import all_gather_simplex_blocks, strip_blocks
    from navier_stokes_solver_tpu_torch.ops import Blocks

    s, dd = rank_strip(n)
    blk = lambda u, p: strip_blocks(Blocks(torch.as_tensor(u), torch.as_tensor(p)), s, dd)
    xs, sts = blk(*x), blk(*st)
    uo = blk(u_old, st[1]).u
    xcs = torch.stack([blk(np.zeros_like(rf), c).p for c in xc])
    ops = operators(s, xs, sts, uo, xcs, blk(rf, xc[0]).u)
    out = {k: float(v) if v.dim() == 0 else torch.stack(s.mesh.all_gather(v)).numpy() for k, v in ops.items()}
    back = all_gather_simplex_blocks(xs, s, dd)
    out["round_trip"] = all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, x))
    return out


def fused_rank(rank, n, opts, fused_kw):
    """``NSSolver.solve_fused`` on this rank's strip (``dd=(n, 1)``):
    the global fields, forces and per-step counts."""
    torch.set_num_threads(1)
    return fused_run(opts, fused_kw, dd=(n, 1))


def fused_run(opts, fused_kw, dd=None):
    """``fused_rank``'s run (on one process without ``dd``)."""
    import navier_stokes_solver_tpu_torch.api as api

    s = api.NSSolver(device="cpu", dd=dd, verbose=False, **opts).setup()
    s.solve_fused(**fused_kw)
    u, p = s.fields()
    return dict(u=u, p=p, drag=s.drag_force, lift=s.lift_force, step=s.time_step_index,
                newton=[h["newton_iters"] for h in s.history],
                krylov=[h["krylov_iters"] for h in s.history])

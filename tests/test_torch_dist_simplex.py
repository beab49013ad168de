"""The port's ``-M`` x-strips (``navier_stokes_solver_tpu_torch.dist.simplex``)
against the JAX package's ``dist/simplex.py`` and against the port on one
process.

The port runs one process per strip (``dist.launch``: spawned ranks, gloo,
the CPU); the rank functions are in ``tests/_torch_dd_simplex.py``.  The
JAX side runs here on the whole mesh (its operators) or on its own strips
(its tables, its VTU record).  Everything is f64 on the triangulated 16x8
channel: the strip tables exactly (integers) or to 1e-15, the round trip
bit for bit, every strip operator at every strip's copy of every node to
1e-12 of the JAX package's global operator, and whole solves against one
rank at the gates of each case.
"""

from __future__ import annotations

import concurrent.futures
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dd as W
import _torch_dd_simplex as S
from navier_stokes_solver_tpu.dist import decompose_simplex_disc as j_decompose
from navier_stokes_solver_tpu.geometry import make_channel_geometry as jgeo
from navier_stokes_solver_tpu.io.vtu import write_vtu_tri_record as j_write_record
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops.matfree import LinearizationQ as JLinQ
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_disc
from navier_stokes_solver_tpu.unstructured import ops as jops
from navier_stokes_solver_tpu.unstructured import pmg as jpmg
from navier_stokes_solver_tpu.unstructured import triangulate_channel as j_triangulate
from navier_stokes_solver_tpu_torch import dist
from navier_stokes_solver_tpu_torch.io import write_vtu_tri_record
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

torch.set_num_threads(1)

F64 = PrecondConfig(vmult_dtype=None, mg_dtype=None)


def _jax_mesh():
    return j_triangulate(jgeo(*S.MESH))


def _run_both(rank_fn, n, rank_args, single_fn, single_args):
    """``rank_fn`` on ``n`` strips beside ``single_fn`` on this process:
    (the ranks' results, the single result)."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(dist.launch, rank_fn, n, *rank_args)
        one = single_fn(*single_args)
        return fut.result(), one


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_strip_tables_equal_jax(n_dev):
    """``decompose_simplex_disc``: every stacked table equals the JAX
    package's (integers and masks exactly, weights and geometry to 1e-15),
    and so do the maps, the padded sizes and the extra dead pressure slot's
    effect (n_p != n_v); ``simplex_strip`` lowers strip t's rows of them."""
    ours = dist.decompose_simplex_disc(*S.mesh_data(), n_dev, global_disc=S.global_disc())
    theirs = j_decompose(*_jax_mesh(), n_dev=n_dev)
    td = theirs.disc
    assert (ours.n_nodes_v, ours.n_nodes_p, ours.n_tri) == (td.n_nodes_v, td.n_nodes_p, td.n_tri)
    assert ours.n_nodes_v != ours.n_nodes_p
    for name, arr in ours.tables.items():
        ref = np.asarray(getattr(td, name))
        assert arr.shape == ref.shape, name
        if arr.dtype.kind in "biu":
            np.testing.assert_array_equal(arr, ref, err_msg=name)
        else:
            np.testing.assert_allclose(arr, ref, rtol=0, atol=1e-15, err_msg=name)
    for space in ("seam_v", "seam_p"):
        for name, arr in getattr(ours, space).items():
            ref = np.asarray(getattr(getattr(td, space), name))
            assert arr.shape == ref.shape, (space, name)
            np.testing.assert_allclose(arr, ref, rtol=0, atol=1e-15 if name == "weight" else 0,
                                       err_msg=f"{space}.{name}")
    np.testing.assert_array_equal(ours.v_global, theirs.v_global)
    np.testing.assert_array_equal(ours.p_global, theirs.p_global)
    for t in range(n_dev):
        strip = dist.simplex_strip(ours, t, device="cpu")
        assert strip.decomposed and (strip.halo_n, strip.halo_ix) == (n_dev, t)
        np.testing.assert_array_equal(strip.dofs_v.numpy(), ours.tables["dofs_v"][t])
        np.testing.assert_array_equal(strip.seam_p.add_r.numpy(), ours.seam_p["add_r"][t])
        assert strip.dense_lp_inv is None
    with pytest.raises(ValueError, match="too few elements"):
        dist.decompose_simplex_disc(*S.mesh_data((2, 2)), 16)


def test_round_trip_and_weights():
    """``scatter_simplex_blocks`` equals the JAX package's stacked vectors
    bit for bit and ``gather_simplex_blocks`` takes them back bit for bit
    (2 and 4 strips); ``strip_blocks`` is strip t's row; the seam weights
    sum to exactly 1 over every node's copies and are 0 on padding."""
    from navier_stokes_solver_tpu.dist import scatter_simplex_blocks as j_scatter

    g = np.random.default_rng(0)
    gd = S.global_disc()
    x = (g.standard_normal((2, gd.n_nodes_v)), g.standard_normal(gd.n_nodes_p))
    for n_dev in (2, 4):
        dd = dist.decompose_simplex_disc(*S.mesh_data(), n_dev, global_disc=gd)
        ours = dist.scatter_simplex_blocks(Blocks(*map(torch.as_tensor, x)), dd)
        theirs = j_scatter(JBlocks(*map(jnp.asarray, x)), j_decompose(*_jax_mesh(), n_dev=n_dev))
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(dist.gather_simplex_blocks(ours, dd), x):
            np.testing.assert_array_equal(a, b)
        for t in range(n_dev):
            got = dist.strip_blocks(Blocks(*map(torch.as_tensor, x)), dist.simplex_strip(dd, t, device="cpu"), dd)
            np.testing.assert_array_equal(got.u.numpy(), ours.u[t])
            np.testing.assert_array_equal(got.p.numpy(), ours.p[t])
        for space, ids, n_glob in (("seam_v", dd.v_global, dd.n_nodes_v_global),
                                   ("seam_p", dd.p_global, dd.n_nodes_p_global)):
            w = getattr(dd, space)["weight"]
            acc = np.zeros(n_glob)
            for t in range(n_dev):
                sel = ids[t] >= 0
                np.add.at(acc, ids[t][sel], w[t][sel])
                assert (w[t][~sel] == 0.0).all()
            np.testing.assert_array_equal(acc, 1.0)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def _jax_operators(x, st, u_old, xc, rf):
    """The JAX package's global operators on the whole mesh (the names of
    ``_torch_dd_simplex.operators``)."""
    nu, inv_dt = S.NU, S.INV_DT
    d = j_disc(*_jax_mesh())
    J = lambda a: jnp.asarray(a)
    xb, sb = JBlocks(J(x[0]), J(x[1])), JBlocks(J(st[0]), J(st[1]))
    linq = jops.eval_state(d, sb)
    dF = jops.diag_F(d, nu, inv_dt, linq, stokes=False)
    dS = jops.diag_F(d, nu, inv_dt, None, stokes=True)
    d1 = jpmg.diag_F1(d, nu, inv_dt, None, stokes=True)
    out = {
        "F_stokes": jops.apply_F(d, nu, inv_dt, None, xb.u, stokes=True),
        "F_newton": jops.apply_F(d, nu, inv_dt, linq, xb.u, stokes=False),
        "F_stokes_bc": jops.apply_F(d, nu, inv_dt, None, xb.u, stokes=True, bc_diag=dS),
        "F_newton_bc": jops.apply_F(d, nu, inv_dt, linq, xb.u, stokes=False, bc_diag=dF),
        "diag_F": dF,
        "diag_F_stokes": dS,
        "B": jops.apply_B(d, xb.u, stokes=False),
        "Bt": jops.apply_Bt(d, xb.p),
        "Mp": jops.apply_Mp(d, nu, xb.p),
        "Mp_raw": jops.apply_Mp_raw(d, xb.p),
        "Lp": jops.apply_Lp(d, xb.p),
        "Fp": jops.apply_Fp(d, nu, inv_dt, JLinQ(u=linq.u, gradu=linq.gradu, p=None), xb.p),
        "diag_Lp": jops.diag_Lp(d),
        "diag_Mp": jops.diag_Mp(d, nu),
        "prolong": jpmg.prolong(d, J(xc)),
        "restrict": jpmg.restrict(d, J(rf)),
        "diag_F1": d1,
        "F1": jpmg.apply_F1(d, nu, inv_dt, None, J(xc), stokes=True, bc_diag=d1),
    }
    r = jops.residual(d, nu, inv_dt, sb, J(u_old), dF, stokes=False, inlet_amp=0.3)
    out["residual_u"], out["residual_p"] = r.u, r.p
    j = jops.apply_jacobian(d, nu, inv_dt, linq, dF, xb, stokes=False)
    out["J_u"], out["J_p"] = j.u, j.p
    out["dot"] = jops.make_dot(d)(xb, JBlocks(sb.u, xb.p))
    out["drag"], out["lift"] = jops.lift_drag_forces(d, nu, sb)
    return {k: np.asarray(v) for k, v in out.items()}


def test_strip_operators_match_jax_global():
    """On 2 gloo ranks, each rank's strip gives, at every copy of every
    node it holds, the JAX package's global result to 1e-12: apply_F
    (Stokes and Newton, with and without the boundary rows), the
    diagonals, B, Bt, the pressure mass (scaled and raw), Lp, Fp, the
    residual, the Jacobian, the p-multigrid prolong / restrict and coarse
    operator and diagonal, the seam-weighted dot, lift and drag; the strip
    round trip is bit for bit."""
    gd = S.global_disc()
    g = np.random.default_rng(1)
    x = (g.standard_normal((2, gd.n_nodes_v)), g.standard_normal(gd.n_nodes_p))
    st = (0.3 * g.standard_normal((2, gd.n_nodes_v)), g.standard_normal(gd.n_nodes_p))
    u_old = 0.3 * g.standard_normal((2, gd.n_nodes_v))
    xc, rf = g.standard_normal((2, gd.n_nodes_p)), g.standard_normal((2, gd.n_nodes_v))
    n = 2
    ranks, theirs = _run_both(S.operators_rank, n, (n, x, st, u_old, xc, rf),
                              _jax_operators, (x, st, u_old, xc, rf))
    dd = dist.decompose_simplex_disc(*S.mesh_data(), n, global_disc=gd)
    ours = ranks[0]
    assert ours.pop("round_trip")
    assert set(ours) == set(theirs)
    for k, v in ours.items():
        if isinstance(v, float):
            np.testing.assert_allclose(v, float(theirs[k]), rtol=0, atol=1e-12, err_msg=k)
            continue
        ids = dd.v_global if v.shape[-1] == dd.n_nodes_v else dd.p_global
        for t in range(n):
            sel = ids[t] >= 0
            np.testing.assert_allclose(v[t][..., sel], theirs[k][..., ids[t][sel]], rtol=0, atol=1e-12,
                                       err_msg=f"{k} strip {t}")
    assert abs(ours["drag"]) > 0.0


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def _solver_pair(n, kind, opts, method, method_kw=None, single_opts=None):
    """``kind``'s ``method`` on ``n`` strips and on one rank (with
    ``single_opts`` over ``opts``)."""
    single = {**opts, **(single_opts or {})}
    ranks, one = _run_both(W.solver_rank, n, ((n, 1), kind, opts, method, method_kw),
                           W.run_solver, (None, kind, single, method, method_kw))
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["u"], ranks[0]["u"])
        assert r["drag"] == ranks[0]["drag"]
    return ranks[0], one


def test_host_solve_newton_two_strips_matches_one_rank_and_jax():
    """Stationary ``solve_newton`` at Re 10 (FGMRES + blockTriangular with
    the p-multigrid velocity leg, tol 1e-10) on 2 strips against the
    port's one rank and the JAX package's single device (both with their
    dense Schur legs, which a strip does not take): drag and lift within
    1e-8, ``u`` 1e-8, ``p`` 1e-7."""
    from navier_stokes_solver_tpu.api import NSSolverStationary as JStationary
    from navier_stokes_solver_tpu.api import SolverOptions as JOptions

    common = dict(mesh_size=S.MESH, Re=10.0, solver_type=1, tolerance=1e-10, preconditioner_type=1,
                  read_mesh_from_file=True)
    dd, one = _solver_pair(2, "NSSolverStationary", {**common, "precond_config": F64}, "solve_newton")
    j = JStationary(JOptions(**common, verbose=False)).setup()
    j.solve_newton()
    j.compute_lift_drag()
    ju, jp = j.fields()
    for ref, name in ((one, "one rank"), (dict(u=ju, p=jp, drag=j.drag_force, lift=j.lift_force), "JAX")):
        np.testing.assert_allclose(dd["drag"], ref["drag"], rtol=0, atol=1e-8, err_msg=name)
        np.testing.assert_allclose(dd["lift"], ref["lift"], rtol=0, atol=1e-8, err_msg=name)
        np.testing.assert_allclose(dd["u"], ref["u"], rtol=0, atol=1e-8, err_msg=name)
        np.testing.assert_allclose(dd["p"], ref["p"], rtol=0, atol=1e-7, err_msg=name)
    assert dd["counts"]["seam_exchanges"] > 0 and dd["counts"]["all_reduces"] > 0


def test_host_unsteady_four_strips_matches_one_rank():
    """Host unsteady ``solve`` at Re 5, two steps, FGMRES + blockTriangular
    with the p-multigrid velocity leg, tol 1e-10, on 4 strips against the
    port's one rank with the same (iterative) Schur legs: drag within 1e-8,
    ``u`` 1e-7 and ``p`` within 1e-6 x max|p|.  The pressure gate is
    relative: the JAX package's own 4-strip run of this case, held against
    its single device with the dense f32 Schur legs, misses an absolute
    1e-6 (4.84e-6 at worst against max|p| 66.26, 7.3e-8 of the field's
    scale, in 90 of 153 pressure nodes)."""
    common = dict(mesh_size=S.MESH, Re=5.0, time_span=0.02, time_step=0.01, solver_type=1,
                  tolerance=1e-10, preconditioner_type=1, read_mesh_from_file=True, precond_config=F64)
    dd, one = _solver_pair(4, "NSSolver", common, "solve", single_opts=dict(dense_schur=False))
    assert dd["step"] == one["step"] == 2
    np.testing.assert_allclose(dd["drag"], one["drag"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(dd["u"], one["u"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(dd["p"], one["p"], rtol=0, atol=1e-6 * np.abs(one["p"]).max())


def _fused_pair(n, opts, kw):
    """``solve_fused`` on ``n`` strips and on one rank, held equal: Newton
    and Krylov counts per step, drag within 1e-8, ``u`` 1e-7, ``p`` within
    1e-6 x max|p|.  Every tangent solve is capped: a capped solve is a
    fixed sequence of operations, so the strips differ from one rank only
    by the rounding of the seam sums and products."""
    ranks, one = _run_both(S.fused_rank, n, (n, opts, kw), S.fused_run, (opts, kw))
    dd = ranks[0]
    assert dd["step"] == one["step"] == 2
    assert (dd["newton"], dd["krylov"]) == (one["newton"], one["krylov"])
    np.testing.assert_allclose(dd["drag"], one["drag"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(dd["u"], one["u"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(dd["p"], one["p"], rtol=0, atol=1e-6 * np.abs(one["p"]).max())


def test_solve_fused_four_strips_matches_one_rank():
    """``solve_fused`` on 4 strips against one rank with the same
    (iterative) Schur legs -- the counterpart of the JAX package's
    ``test_simplex_dd_api_solve_fused_matches_single`` (there aSIMPLE, to
    convergence): FGMRES + blockTriangular with the Jacobi velocity leg,
    two steps, every tangent solve capped at 30 iterations.  (Capped
    aSIMPLE solves part: its inner S-hat solves stop on a relative
    tolerance, so a rounding difference moves their last iteration.)"""
    opts = dict(mesh_size=S.MESH, Re=5.0, time_span=0.02, time_step=0.01, solver_type=1, tolerance=1e-10,
                preconditioner_type=1, multigrid=False, read_mesh_from_file=True, dense_schur=False,
                precond_config=F64)
    _fused_pair(4, opts, dict(newton_max=3, krylov_maxiter=30))


def test_fused_pmg_cahouet_two_strips_matches_one_rank():
    """``solve_fused`` with the p-multigrid velocity leg and the
    Cahouet-Chabard Schur leg (FGMRES + blockTriangular, two steps,
    ``newton_max`` 2, every tangent solve capped at 30 iterations) on 2
    strips -- the seam-aware transfers, coarse GMRES and iterative Lp leg
    -- against one rank with the same iterative legs."""
    cfg = PrecondConfig(schur_mode="cahouet", vmult_dtype=None, mg_dtype=None)
    opts = dict(mesh_size=S.MESH, Re=5.0, time_span=0.02, time_step=0.01, solver_type=1, tolerance=1e-10,
                preconditioner_type=1, read_mesh_from_file=True, dense_schur=False, precond_config=cfg)
    _fused_pair(2, opts, dict(newton_max=2, krylov_maxiter=30))


# ---------------------------------------------------------------------------
# output and entry points
# ---------------------------------------------------------------------------


def test_vtu_record_bytes_equal_jax(tmp_path):
    """``write_vtu_tri_record`` writes the JAX writer's bytes: one triangle
    piece per strip (partitioning = strip id, no final newline in either
    package's triangle pieces) and the ``.pvtu`` record."""
    from navier_stokes_solver_tpu_torch.io.vtu import read_vtu

    gd = S.global_disc()
    g = np.random.default_rng(2)
    u, p = g.standard_normal((2, gd.n_nodes_v)), g.standard_normal(gd.n_nodes_p)
    dd = dist.decompose_simplex_disc(*S.mesh_data(), 4, global_disc=gd)
    write_vtu_tri_record(dd, u, p, directory=str(tmp_path / "torch"), counter=3)
    j_write_record(j_decompose(*_jax_mesh(), n_dev=4), u, p, directory=str(tmp_path / "jax"), counter=3)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [f"output_003.{t}.vtu" for t in range(4)] + [
        "output_003.pvtu"]
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    for t in range(4):
        assert (read_vtu(str(tmp_path / "torch" / f"output_003.{t}.vtu"))["partitioning"] == t).all()


def test_cli_unsteady_strips_spawn_their_ranks(capfd):
    """``cli.unsteady -M --dd 2 --device cpu`` outside a process group
    spawns two ranks; rank 0 alone prints the run, whose drag is the
    one-process run's; ``--dd 2,2`` with ``-M`` stops with the 1-D
    refusal before a rank starts."""
    from navier_stokes_solver_tpu_torch.cli import unsteady

    base = ["-M", "-m", "16,8", "-r", "5", "-T", "0.01,0.01", "-s", "1", "-p", "1", "-t", "1e-6",
            "--device", "cpu"]
    assert unsteady.run(base + ["--dd", "2"]) is None
    text = capfd.readouterr().out
    drags = re.findall(r"^Drag force: (\S+)$", text, re.M)
    assert len(drags) >= 1 and "Domain decomposition: 2 x-strips (gloo)" in text, text[-2000:]
    assert text.count("Domain decomposition") == 1  # rank 0 only
    one = unsteady.run(base + ["--quiet"])
    # to the solver's tolerance: the one process takes the dense f32 Schur
    # legs, the strips the iterative ones
    np.testing.assert_allclose(float(drags[-1]), one.drag_force, rtol=1e-5)
    with pytest.raises(NotImplementedError, match=re.escape("1-D (x-strips)")):
        unsteady.run(base + ["--dd", "2,2"])

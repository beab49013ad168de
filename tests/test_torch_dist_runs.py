"""Whole runs of the port under domain decomposition against the port on
one process, within the JAX package's ``tests/test_dist.py`` bounds.

The decomposed runs are spawned ranks (``dist.launch``, gloo, the CPU;
rank functions in ``tests/_torch_dd.py``); the one-process run goes here,
beside them.  Q2/Q1, f64: the fused step on ``_torch_dd.MESH`` (16x8,
whose multigrid chain has a coarse level), the solver runs on the 16x4
channel (no coarse level; a quarter of the collectives per solve, each a
gloo message between processes).  (The JAX package's two dd tests that fail
on the CPU -- the Cahouet Lp V-cycle step and the simplex host solve --
are no parity targets: the port's runs are held against the port.)
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import os

import numpy as np
import pytest
import torch

import _torch_dd as W
from navier_stokes_solver_tpu_torch import dist
from navier_stokes_solver_tpu_torch.api import NSSolver

Q2 = dict(mesh_size=(16, 4), degree_velocity=2, degree_pressure=1, Re=10.0, solver_type=1,
          preconditioner_type=1)
# the stationary solve on the 16x8 channel: at 16x4 the (2, 2) fields part
# by 1.8e-8, over the JAX test's 1e-8
NEWTON = dict(Q2, mesh_size=W.MESH, tolerance=1e-10)


def _launch(fn, dd, *args):
    return dist.launch(fn, dd[0] * dd[1], dd, *args)


@contextlib.contextmanager
def _one_thread():
    """This process on one thread, as each rank runs, while ranks run
    beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _single_and_dd(kind, opts, method, method_kw, dds):
    """The run on one process (here) and under each of ``dds`` (spawned
    ranks), concurrently."""
    with concurrent.futures.ThreadPoolExecutor(len(dds)) as ex:
        futs = [ex.submit(_launch, W.solver_rank, dd, kind, opts, method, method_kw) for dd in dds]
        with _one_thread():
            single = W.run_solver(None, kind, opts, method, method_kw)
        return single, [f.result() for f in futs]


def _assert_ranks_agree(ranks, keys=("drag", "krylov")):
    """Every rank returns the same global fields and scalars."""
    for r in ranks[1:]:
        for k in ("u", "p"):
            np.testing.assert_array_equal(r[k], ranks[0][k])
        assert [r[k] for k in keys] == [ranks[0][k] for k in keys]


def test_fused_step_matches_single():
    """One ``timeloop.make_time_step`` step on each rank's tile from
    ``timeloop.initial_state`` (nu 1 -- ``solve_fused``'s viscosity at Re 10 --, FGMRES +
    blockTriangular + the decomposed MG chain in f64, tol 1e-10,
    newton_max 3) under (2, 1) against ``make_time_step`` on one process:
    u 1e-7, p 1e-6, drag and lift 1e-7, the same Newton count; seams
    exchanged and products reduced."""
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    kw = dict(solver_type=1, prec_type=1, tol=1e-10, newton_max=3, krylov_maxiter=300,
              precond_cfg=PrecondConfig(vmult_dtype=None, mg_dtype=None))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_launch, W.fused_step_rank, (2, 1), 1.0, kw)
        with _one_thread():
            single = W.fused_step(W.global_disc(), 1.0, kw)
        ranks = fut.result()
    _assert_ranks_agree(ranks, ("drag", "lift", "newton", "krylov"))
    dd = ranks[0]
    assert dd["step"] == 1 and dd["newton"] == single["newton"]
    np.testing.assert_allclose(dd["u"], single["u"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(dd["p"], single["p"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd["drag"], single["drag"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(dd["lift"], single["lift"], rtol=0, atol=1e-7)
    assert dd["counts"]["seam_exchanges"] > 0 and dd["counts"]["all_reduces"] > 0


def test_solve_newton_matches_single():
    """The stationary Newton solve (16x8, to Re 10, FGMRES +
    blockTriangular + the decomposed MG chain, tol 1e-10) under (4, 1) and
    (2, 2) against one
    process: u 1e-8, p 1e-7, drag 1e-8, the same number of tangent solves,
    Krylov totals within 1.1x + 5."""
    single, runs = _single_and_dd("NSSolverStationary", NEWTON, "solve_newton", None, [(4, 1), (2, 2)])
    for ranks in runs:
        _assert_ranks_agree(ranks)
        dd = ranks[0]
        np.testing.assert_allclose(dd["u"], single["u"], rtol=0, atol=1e-8)
        np.testing.assert_allclose(dd["p"], single["p"], rtol=0, atol=1e-7)
        np.testing.assert_allclose(dd["drag"], single["drag"], rtol=0, atol=1e-8)
        assert len(dd["krylov"]) == len(single["krylov"])
        assert sum(dd["krylov"]) <= 1.1 * sum(single["krylov"]) + 5


def test_solve_fused_matches_single():
    """``NSSolver.solve_fused`` (tol 1e-9; one step -- the checkpoint test
    runs two) under (4, 1) against one process:
    u 1e-6, p 1e-4, drag 1e-6, the same step count."""
    opts = dict(Q2, tolerance=1e-9, time_span=0.01, time_step=0.01)
    single, (ranks,) = _single_and_dd("NSSolver", opts, "solve_fused",
                                      dict(newton_max=3, krylov_maxiter=200), [(4, 1)])
    _assert_ranks_agree(ranks)
    dd = ranks[0]
    assert dd["step"] == single["step"] == 1
    np.testing.assert_allclose(dd["u"], single["u"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dd["p"], single["p"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dd["drag"], single["drag"], rtol=0, atol=1e-6)


def test_checkpoint_resume_and_layout_mismatch(tmp_path):
    """Under (2, 1) a fused run stopped after one step and resumed equals
    the straight run bit for bit; the checkpoint is the JAX package's
    tile-stacked layout; a single-device checkpoint does not resume into
    the decomposed run, nor a decomposed one into a single-device run."""
    from navier_stokes_solver_tpu_torch.io import load_time_state
    from navier_stokes_solver_tpu_torch.timeloop import initial_state

    opts = dict(Q2, tolerance=1e-9, time_span=0.02, time_step=0.01, multigrid=False)
    single = str(tmp_path / "single")
    NSSolver(device="cpu", verbose=False, **opts).setup().solve_fused(
        newton_max=2, krylov_maxiter=20, checkpoint_dir=single, max_steps_this_call=1)
    straight, split = str(tmp_path / "straight"), str(tmp_path / "split")
    out = _launch(W.checkpoint_rank, (2, 1), opts, straight, split, single)[0]
    assert out["partial_step"] == 1
    (u1, p1, d1, n1), (u2, p2, d2, n2) = out["straight"], out["split"]
    assert n1 == n2 == 2 and d1 == d2
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(p1, p2)
    assert out["mismatch"] is not None and "dd layout" in out["mismatch"]
    with np.load(os.path.join(straight, "time_state.npz")) as z:
        tile = (2 * Q2["mesh_size"][1] + 1, 2 * (Q2["mesh_size"][0] // 2) + 1)
        assert z["u"].shape == (2, 2) + tile and z["step"].shape == (2,)
        assert list(z["step"]) == [2, 2]
    s = NSSolver(device="cpu", verbose=False, **opts).setup()
    with pytest.raises(ValueError, match="dd layout"):
        load_time_state(s.disc, straight, template=initial_state(s.disc))

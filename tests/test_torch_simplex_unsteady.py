"""The port's unsteady ``-M`` simplex runs against the JAX package, on the
CPU.

* Two implicit-Euler steps on the triangulated 16x8 channel, Re 20 (the
  per-step Re ramp: levels 1 and 11), the reference's continuity sign,
  FGMRES + blockTriangular with the p-multigrid velocity leg and the nested
  (f64) Schur legs, all-f64, tol 1e-5: the JAX package's Newton history
  and Krylov count in every tangent solve, drag and lift per step rtol
  1e-7, fields within 1e-6 of their magnitude.
* Capped tangent solves of the unsteady Newton regime (FGMRES +
  blockTriangular, 30 iterations): with the nested legs, iterate and
  residual within 1e-10; with the dense Schur legs, whose f32 inverses and
  f32 products differ between the packages in the last bit (numpy/XLA
  against torch), equal counts and iterate and residual within 1e-5 (the
  difference is f32 rounding from the first iteration on: 3.3e-6 after 5,
  1.3e-6 after 30).  A whole run with them drifts further (a parity-sign
  Newton loop stops where its Krylov solve first returns 0 iterations), so
  the dense legs are held here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.api import NSSolver as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.api import kernels as jk
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_disc
from navier_stokes_solver_tpu.unstructured.dense import attach_dense_schur as j_attach
from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions
from navier_stokes_solver_tpu_torch.api import kernels as tk
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.precond import PrecondConfig
from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel
from navier_stokes_solver_tpu_torch.unstructured.dense import attach_dense_schur

torch.set_num_threads(1)

F64 = dict(vmult_dtype=None, mg_dtype=None)
RUN = dict(mesh_size=(16, 8), read_mesh_from_file=True, Re=20.0, solver_type=1, preconditioner_type=1,
           tolerance=1e-5, time_span=0.02, time_step=0.01, dense_schur=False, verbose=False)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolver.KRYLOV_CHUNK_MAX))
        j = JSolver(JOptions(**RUN, precond_config=JCfg(**F64))).setup()
        j.solve()
        t = NSSolver(SolverOptions(**RUN, precond_config=PrecondConfig(**F64), device="cpu")).setup()
        t.solve()
    return j, t


def _solves(s):
    return [(h["phase"], h["nu"], h["n_iter"], h["krylov_iters"]) for h in s.history if h["phase"] != "step"]


def _steps(s):
    return [h for h in s.history if h["phase"] == "step"]


def test_unsteady_newton_history_and_krylov_counts(pair):
    j, t = pair
    assert [h["phase"] for h in t.history] == [h["phase"] for h in j.history]
    assert _solves(t) == _solves(j)
    assert {h["nu"] for h in t.history if "nu" in h} == {1.0, 1.0 / 11.0}
    assert len(_steps(t)) == 2 and max(h[3] for h in _solves(t)) > 100


def test_unsteady_drag_and_lift_per_step(pair):
    j, t = pair
    for hj, ht in zip(_steps(j), _steps(t)):
        assert ht["step"] == hj["step"] and ht["time"] == hj["time"]
        np.testing.assert_allclose(ht["drag_coeff"], hj["drag_coeff"], rtol=1e-7)
        np.testing.assert_allclose(ht["lift_coeff"], hj["lift_coeff"], rtol=1e-7, atol=1e-7 * abs(hj["drag_coeff"]))
    assert (t.drag_coeff, t.lift_coeff) == (_steps(t)[-1]["drag_coeff"], _steps(t)[-1]["lift_coeff"])


def test_unsteady_fields(pair):
    j, t = pair
    for got, want in zip(t.fields(), j.fields()):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("dense", [False, True], ids=["nested", "dense"])
def test_capped_unsteady_tangent_solve(dense):
    mesh = triangulate_channel(make_channel_geometry(16, 8))
    jd = j_disc(*mesh).replace(p_mg=True)
    td = make_simplex_disc(*mesh, dtype=torch.float64, device="cpu").replace(p_mg=True)
    if dense:
        jd, td = j_attach(jd), attach_dense_schur(td)
    rng = np.random.default_rng(1)
    u, p = 0.3 * rng.standard_normal((2, td.n_nodes_v)), rng.standard_normal(td.n_nodes_p)
    jst, tst = JBlocks(jnp.asarray(u), jnp.asarray(p)), Blocks(torch.as_tensor(u), torch.as_tensor(p))
    nu, inv_dt, n = 1.0 / 20.0, 100.0, 30
    kw = dict(stokes=False, solver_type=1, prec_type=1, variant="unsteady", maxiter=n)
    jr, _ = jk.assemble_kernel(jd, nu, inv_dt, jst, jst.u, 0.0, stokes=False)
    tr, _ = tk.assemble_kernel(td, nu, inv_dt, tst, tst.u, 0.0, stokes=False)
    jx, ji = jk.solve_kernel(jd, nu, inv_dt, jst, jr, jst, 0.0, 1e-14, precond_cfg=JCfg(**F64), **kw)
    tx, ti = tk.solve_kernel(td, nu, inv_dt, tst, tr, tst, 0.0, 1e-14, precond_cfg=PrecondConfig(**F64), **kw)
    assert (ti.iters, ti.converged, ti.failed) == (n, False, False) == (int(ji.iters), bool(ji.converged), bool(ji.failed))
    rel = 1e-5 if dense else 1e-10
    np.testing.assert_allclose(ti.resnorm, float(ji.resnorm), rtol=rel)
    for got, want in zip(tx, jx):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= rel * np.abs(want).max()

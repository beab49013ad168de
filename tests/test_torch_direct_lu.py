"""The port's direct dense-LU preconditioner (``PrecondConfig.direct_lu``,
the CLI's ``--direct-lu``) against the JAX package, on the CPU.

* The dense Jacobian (``precond.blocks.dense_jacobian``, one-hot columns
  through the simplex backend's batched Jacobian apply) equals the JAX
  package's -- its ``apply_jacobian`` under ``vmap`` over the identity --
  within 1e-12 in f64, both regimes, and the port's own unbatched apply
  column for column within 1e-14.
* One f32 application of the LU solve inverts the Jacobian to f32
  backward error (equilibrated rows and columns), as the JAX package's.
* Whole solves (stationary ``-M`` 16x8, a two-step unsteady ``-M`` run,
  the structured 12x6 Q2/Q1 backend): Krylov counts within 1 per solve,
  drag rtol 1e-7, fields within 1e-7 of their magnitude.
* Above ``DIRECT_LU_MAX_N`` unknowns the ``-p`` preconditioner applies, as
  in the JAX package, and ``setup()`` says so -- from the predicate that
  decides, counting unknowns: at structured 156x20 Q3/Q2 (69,564 DoFs,
  70,051 unknowns with the inactive nodes inside the cylinder) the message
  appears, at 155x20 (69,603 unknowns) it does not (setup only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import navier_stokes_solver_tpu.unstructured.ops as jops
import navier_stokes_solver_tpu_torch.precond.blocks as tblocks
import navier_stokes_solver_tpu_torch.unstructured.ops as tops
from navier_stokes_solver_tpu.api import NSSolver as JNSSolver
from navier_stokes_solver_tpu.api import NSSolverStationary as JStationary
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond.blocks import LinearContext as JCtx
from navier_stokes_solver_tpu.precond.blocks import _cast_ctx as j_cast_ctx
from navier_stokes_solver_tpu.precond.blocks import make_direct_lu as j_make_direct_lu
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_disc
from navier_stokes_solver_tpu_torch.api import NSSolver, NSSolverStationary, SolverOptions
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig, make_krylov_lo, make_preconditioner
from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel

torch.set_num_threads(1)

NU = 1.0 / 20.0
MESH = (16, 8)
REGIMES = pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])


@pytest.fixture(scope="module")
def case():
    mesh = triangulate_channel(make_channel_geometry(*MESH))
    jd = j_disc(*mesh)
    td = make_simplex_disc(*mesh, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5)
    a = dict(u=0.3 * rng.standard_normal((2, td.n_nodes_v)), p=rng.standard_normal(td.n_nodes_p),
             bu=rng.standard_normal((2, td.n_nodes_v)), bp=rng.standard_normal(td.n_nodes_p))
    return jd, td, a


def _contexts(case, stokes, inv_dt=0.0):
    jd, td, a = case
    jst = JBlocks(jnp.asarray(a["u"]), jnp.asarray(a["p"]))
    tst = Blocks(torch.as_tensor(a["u"]), torch.as_tensor(a["p"]))
    jl = None if stokes else jops.eval_state(jd, jst)
    tl = None if stokes else tops.eval_state(td, tst)
    jctx = JCtx(disc=jd, nu=NU, inv_dt=inv_dt, stokes=stokes, linq=jl,
                diag_f=jops.diag_F(jd, NU, inv_dt, jl, stokes=stokes),
                state_u=None if stokes else jst.u, ops=jops)
    tctx = LinearContext(disc=td, nu=NU, inv_dt=inv_dt, stokes=stokes, linq=tl,
                         diag_f=tops.diag_F(td, NU, inv_dt, tl, stokes=stokes),
                         state_u=None if stokes else tst.u, ops=tops)
    return jctx, tctx


def _jax_dense(jctx):
    d = jctx.disc
    flat0, unravel = ravel_pytree(JBlocks(u=d.zeros_u(), p=d.zeros_p()))

    def mv(xf):
        y = jctx.ops.apply_jacobian(d, jctx.nu, jctx.inv_dt, jctx.linq, jctx.diag_f, unravel(xf),
                                    stokes=jctx.stokes)
        return ravel_pytree(y)[0]

    return np.asarray(jax.vmap(mv)(jnp.eye(flat0.shape[0], dtype=flat0.dtype)).T)


@REGIMES
def test_dense_jacobian_matches_jax_and_the_apply(case, stokes):
    jctx, tctx = _contexts(case, stokes, inv_dt=0.0 if stokes else 100.0)
    At = tblocks.dense_jacobian(tctx)
    A = At.T.numpy()
    want = _jax_dense(jctx)
    assert A.shape == want.shape == (tblocks._n_unknowns(tctx.disc),) * 2
    scale = np.abs(want).max()
    assert np.abs(A - want).max() <= 1e-12 * scale
    # column for column against the port's own (unbatched) Jacobian apply
    J = tctx.jacobian()
    nu_ = tctx.disc.zeros_u().numel()
    for j in range(0, A.shape[0], 97):
        e = torch.zeros(A.shape[0], dtype=torch.float64)
        e[j] = 1.0
        y = J(Blocks(u=e[:nu_].reshape(2, -1), p=e[nu_:]))
        col = torch.cat([y.u.reshape(-1), y.p]).numpy()
        assert np.abs(A[:, j] - col).max() <= 1e-14 * scale, j


@REGIMES
def test_lu_solve_inverts_the_jacobian_in_f32(case, stokes):
    """Both packages' f32 LU preconditioners on the same right-hand side:
    each within f32 backward error of the f64 Jacobian, and within 1e-4 of
    each other."""
    jctx, tctx = _contexts(case, stokes)
    _, td, a = case
    A64 = tblocks.dense_jacobian(tctx).T
    n_before = len(tblocks.DIRECT_LU_TIMES)
    tM = tblocks.make_direct_lu(tblocks._cast_ctx(tctx, torch.float32))
    assert len(tblocks.DIRECT_LU_TIMES) == n_before + 1
    assert tblocks.DIRECT_LU_TIMES[-1]["n"] == A64.shape[0]
    jM = j_make_direct_lu(j_cast_ctx(jctx, jnp.float32))
    got = tM(Blocks(torch.as_tensor(a["bu"]).float(), torch.as_tensor(a["bp"]).float()))
    want = jM(JBlocks(jnp.asarray(a["bu"], jnp.float32), jnp.asarray(a["bp"], jnp.float32)))
    assert got.u.dtype == torch.float32
    b = np.concatenate([a["bu"].reshape(-1), a["bp"]])
    for x in (np.concatenate([got.u.numpy().reshape(-1), got.p.numpy()]),
              np.concatenate([np.asarray(want.u).reshape(-1), np.asarray(want.p)])):
        res = np.abs(A64.numpy() @ x.astype(np.float64) - b).max()
        assert res <= 1e-4 * np.abs(b).max(), res
    gx = np.concatenate([got.u.numpy().reshape(-1), got.p.numpy()])
    wx = np.concatenate([np.asarray(want.u).reshape(-1), np.asarray(want.p)])
    assert np.abs(gx - wx).max() <= 1e-4 * np.abs(wx).max()


def _fields_close(got, want, rel):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), (np.abs(g - w).max(), np.abs(w).max())


def _counts(s):
    return [h["krylov_iters"] for h in s.history if "krylov_iters" in h]


def _pair(opts, unsteady=False, **kw):
    J, T = (JNSSolver, NSSolver) if unsteady else (JStationary, NSSolverStationary)
    out = []
    for S, O, C, extra in ((J, JOptions, JCfg, {}), (T, SolverOptions, PrecondConfig, dict(device="cpu"))):
        s = S(O(**opts, precond_config=C(direct_lu=True, **kw), verbose=False, **extra)).setup()
        if unsteady:
            s.solve()
        else:
            s.solve_newton()
            s.compute_lift_drag()
            s.compute_drag_coeff()
        out.append(s)
    return out


def _same_solve(j, t):
    jc, tc = _counts(j), _counts(t)
    assert len(jc) == len(tc) and all(abs(x - y) <= 1 for x, y in zip(jc, tc)), (jc, tc)
    np.testing.assert_allclose(t.drag_coeff, j.drag_coeff, rtol=1e-7)
    _fields_close(t.fields(), j.fields(), 1e-7)


def test_stationary_simplex_direct_lu_matches_jax(monkeypatch):
    """``-M`` 16x8 Re 20 -p 1 --direct-lu (f32 LU, f64 outer FGMRES)."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolverStationary.KRYLOV_CHUNK_MAX))
    j, t = _pair(dict(mesh_size=MESH, read_mesh_from_file=True, Re=20.0, solver_type=1,
                      preconditioner_type=1, tolerance=1e-10))
    _same_solve(j, t)
    assert max(_counts(t)) <= 5  # the exact preconditioner collapses the outer counts


def test_unsteady_simplex_direct_lu_matches_jax(monkeypatch):
    """Two unsteady ``-M`` steps at Re 1, tol 1e-9 (config 3's settings at
    16x8), consistent continuity sign: counts, drag and lift per step."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolver.KRYLOV_CHUNK_MAX))
    j, t = _pair(dict(mesh_size=MESH, read_mesh_from_file=True, Re=1.0, solver_type=1,
                      preconditioner_type=1, tolerance=1e-9, time_span=0.02, time_step=0.01,
                      consistent_continuity=True), unsteady=True)
    jc, tc = _counts(j), _counts(t)
    assert len(jc) == len(tc) and all(abs(x - y) <= 1 for x, y in zip(jc, tc)), (jc, tc)
    steps = lambda s: [h for h in s.history if h["phase"] == "step"]
    for hj, ht in zip(steps(j), steps(t)):
        np.testing.assert_allclose(ht["drag_coeff"], hj["drag_coeff"], rtol=1e-7)
        np.testing.assert_allclose(ht["lift_coeff"], hj["lift_coeff"], rtol=1e-7, atol=1e-7 * abs(hj["drag_coeff"]))
    _fields_close(t.fields(), j.fields(), 1e-7)


def test_structured_direct_lu_matches_jax(monkeypatch):
    """The structured backend's Jacobian batches under ``torch.func.vmap``:
    12x6 Q2/Q1 Re 20 -p 1 --direct-lu against the JAX package."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolverStationary.KRYLOV_CHUNK_MAX))
    j, t = _pair(dict(mesh_size=(12, 6), degree_velocity=2, degree_pressure=1, Re=20.0, solver_type=1,
                      preconditioner_type=1, tolerance=1e-10))
    _same_solve(j, t)


def test_ineligible_system_takes_the_p_preconditioner(case, monkeypatch, capsys):
    """Above ``DIRECT_LU_MAX_N`` unknowns: the ``-p`` preconditioner (the
    same vmult as without ``direct_lu``), GMRES-IR cycles armed again, and
    ``setup()`` logs the fallback."""
    _, tctx = _contexts(case, False)
    _, td, a = case
    src = Blocks(torch.as_tensor(a["bu"]), torch.as_tensor(a["bp"]))
    cfg_lu = PrecondConfig(direct_lu=True, krylov_cycle_dtype="float32")
    assert make_krylov_lo(1, tctx, cfg=cfg_lu) is None
    monkeypatch.setattr(tblocks, "DIRECT_LU_MAX_N", tblocks._n_unknowns(td) - 1)
    n_before = len(tblocks.DIRECT_LU_TIMES)
    got = make_preconditioner(1, tctx, cfg=cfg_lu)(src)
    want = make_preconditioner(1, tctx, cfg=PrecondConfig(krylov_cycle_dtype="float32"))(src)
    assert len(tblocks.DIRECT_LU_TIMES) == n_before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert make_krylov_lo(1, tctx, cfg=cfg_lu) is not None
    n = tblocks._n_unknowns(td)
    NSSolverStationary(SolverOptions(mesh_size=MESH, read_mesh_from_file=True, precond_config=cfg_lu,
                                     device="cpu")).setup()
    out = capsys.readouterr().out
    assert f"{n} unknowns exceed DIRECT_LU_MAX_N = {n - 1}" in out and "blockDiagonal" in out


@pytest.mark.parametrize("mesh", [(156, 20), (155, 20)], ids=["156x20", "155x20"])
def test_fallback_message_comes_from_the_predicate(mesh, capsys):
    s = NSSolver(SolverOptions(mesh_size=mesh, precond_config=PrecondConfig(direct_lu=True), device="cpu")).setup()
    out = capsys.readouterr().out
    n = tblocks._n_unknowns(s.disc)
    eligible = tblocks.direct_lu_eligible(s.disc)
    assert eligible == (mesh == (155, 20)) and s.n_dofs <= tblocks.DIRECT_LU_MAX_N
    said = f"direct LU: {n} unknowns exceed DIRECT_LU_MAX_N = {tblocks.DIRECT_LU_MAX_N}"
    assert (said in out) == (not eligible) and out.count("direct LU:") == (not eligible)

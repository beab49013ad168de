"""The port's fused time loop (``timeloop``) against the JAX package's, on
the CPU.  All-f64 preconditioners, FGMRES + blockTriangular.

* ``make_time_step`` at 16x8 Q3/Q2, nu 0.1, tol 1e-6, ``newton_max`` 3,
  each tangent solve capped at 20 Krylov iterations (whole solves are
  chaotic): one step from ``initial_state`` (the step that lifts the
  inlet) and one from a seeded state (step 1, so no lift): the
  JAX package's Newton and Krylov counts, ``final_residual``, drag and lift
  within rtol 1e-7 (the lift of this symmetric mesh is rounding: it is
  held to 1e-7 of the drag), fields within 1e-6 of their magnitude; the
  state's dtypes (``step`` int32, the scalars in the disc's dtype).
* ``make_stokes_init``: fields within 1e-6 of their magnitude.
* ``run_time_loop``: chunked runs equal the unchunked one bit for bit.
* ``solve_fused`` on ``-M`` 24x10 (Re 1, the Jacobian-consistent sign, the
  iterative Schur legs: the dense ones multiply in f32 and drift), two
  steps with every tangent solve capped at 40 Krylov iterations -- whole
  unsteady ``-M`` solves are chaotic, a rounding difference moves their
  stopping iteration, so the count gate stands on capped solves: the same
  gates as above.
* ``--fused`` through ``cli.unsteady`` (16x8, Re 1, tol 1e-8, one step,
  the CLI's defaults: f32 preconditioner, ``newton_max`` 10,
  ``krylov_maxiter`` 2000): the JAX CLI's coefficient lines, drag rtol 1e-7.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu import timeloop as jtl
from navier_stokes_solver_tpu.api import NSSolver as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.cli import unsteady as j_unsteady
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch import timeloop as ttl
from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions, state_from_numpy
from navier_stokes_solver_tpu_torch.cli import unsteady as t_unsteady
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

torch.set_num_threads(1)

F64 = dict(vmult_dtype=None, mg_dtype=None)
STRUCTURED = dict(mesh_size=(16, 8), Re=10.0, solver_type=1, preconditioner_type=1, tolerance=1e-6,
                  time_span=0.03, time_step=0.01, verbose=False)
STEP = dict(solver_type=1, prec_type=1, tol=1e-6, newton_max=3, krylov_maxiter=20)
NU, DT = 0.1, 0.01
SIMPLEX = dict(mesh_size=(24, 10), read_mesh_from_file=True, Re=1.0, solver_type=1, preconditioner_type=1,
               tolerance=1e-9, time_span=0.02, time_step=0.01, dense_schur=False,
               consistent_continuity=True, verbose=False)
SIMPLEX_CAPS = dict(newton_max=3, krylov_maxiter=40)
GATE, FIELD_GATE = 1e-7, 1e-6


def _solvers(run):
    j = JSolver(JOptions(**run, precond_config=JCfg(**F64))).setup()
    t = NSSolver(SolverOptions(**run, precond_config=PrecondConfig(**F64), device="cpu")).setup()
    return j, t


def _assert_fields(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= FIELD_GATE * np.abs(w).max()


def _assert_forces(got, want):
    (gd, gl), (wd, wl) = got, want
    np.testing.assert_allclose(gd, wd, rtol=GATE)
    np.testing.assert_allclose(gl, wl, rtol=GATE, atol=GATE * abs(wd))


@pytest.fixture(scope="module")
def steps():
    """{start: (JAX TimeState, port TimeState)} after one step."""
    j, t = _solvers(STRUCTURED)
    jstep = jax.jit(jtl.make_time_step(j.disc, precond_cfg=JCfg(**F64), **STEP))
    tstep = ttl.make_time_step(t.disc, precond_cfg=PrecondConfig(**F64), **STEP)
    rng = np.random.default_rng(0)
    d = t.disc
    u = 0.05 * rng.standard_normal((2,) + d.NV) * d.u_active.numpy()
    p = 0.05 * rng.standard_normal(d.NP) * d.p_active.numpy()
    j0, t0 = jtl.initial_state(j.disc), ttl.initial_state(t.disc)
    starts = {
        "initial": (j0, t0),
        "seeded": (
            j0._replace(solution=JBlocks(jnp.asarray(u), jnp.asarray(p)), step=jnp.int32(1),
                        time=jnp.asarray(DT, jnp.float64)),
            t0._replace(solution=state_from_numpy(u, p, dtype=torch.float64, device="cpu"),
                        step=torch.tensor(1, dtype=torch.int32), time=torch.tensor(DT)),
        ),
    }
    return {k: (jstep(js, NU, DT), tstep(ts, NU, DT)) for k, (js, ts) in starts.items()}


@pytest.mark.parametrize("start", ["initial", "seeded"])
def test_time_step_matches_jax(steps, start):
    js, ts = steps[start]
    assert (int(ts.stats.newton_iters), int(ts.stats.krylov_iters)) == (
        int(js.stats.newton_iters), int(js.stats.krylov_iters))
    assert int(js.stats.krylov_iters) > 20
    np.testing.assert_allclose(float(ts.stats.final_residual), float(js.stats.final_residual), rtol=GATE)
    _assert_forces((float(ts.drag), float(ts.lift)), (float(js.drag), float(js.lift)))
    _assert_fields(ts.solution, js.solution)
    assert int(ts.step) == int(js.step) and float(ts.time) == float(js.time)
    assert ts.step.dtype == ts.stats.krylov_iters.dtype == torch.int32
    assert ts.time.dtype == ts.drag.dtype == ts.stats.final_residual.dtype == torch.float64


def test_stokes_init_matches_jax():
    j, t = _solvers(STRUCTURED)
    kw = dict(solver_type=1, prec_type=1, tol=1e-8, krylov_maxiter=200)
    want = jax.jit(jtl.make_stokes_init(j.disc, precond_cfg=JCfg(**F64), **kw))(NU)
    got = ttl.make_stokes_init(t.disc, precond_cfg=PrecondConfig(**F64), **kw)(NU)
    assert float(np.abs(np.asarray(want.u)).max()) > 0.1
    _assert_fields(got, want)


@pytest.fixture(scope="module")
def unchunked():
    t = NSSolver(SolverOptions(**STRUCTURED, precond_config=PrecondConfig(**F64), device="cpu")).setup()
    step = ttl.make_time_step(t.disc, precond_cfg=PrecondConfig(**F64), **{**STEP, "newton_max": 1, "krylov_maxiter": 20})
    return step, t.disc, ttl.run_time_loop(step, ttl.initial_state(t.disc), NU, DT, 3)


@pytest.mark.parametrize("chunk", [1, 2])
def test_run_time_loop_chunked_bitwise_equal(unchunked, chunk):
    step, disc, (f1, h1) = unchunked
    seen = []
    f2, h2 = ttl.run_time_loop(step, ttl.initial_state(disc), NU, DT, 3, chunk=chunk,
                               on_chunk=lambda ts, out: seen.append((int(ts.step), len(out[0]))))
    assert seen == ([(1, 1), (2, 1), (3, 1)] if chunk == 1 else [(2, 2), (3, 1)])
    for k in ("drag", "lift", "newton_iters", "krylov_iters", "final_residual"):
        assert h1[k].shape == (3,)
        np.testing.assert_array_equal(h2[k], h1[k])
    for a, b in zip(f2.solution, f1.solution):
        assert torch.equal(a, b)
    assert int(f2.step) == 3 and h1["newton_iters"].dtype == np.int32


@pytest.fixture(scope="module")
def simplex_pair():
    j, t = _solvers(SIMPLEX)
    j.solve_fused(**SIMPLEX_CAPS)
    t.solve_fused(**SIMPLEX_CAPS)
    return j, t


def test_solve_fused_simplex_counts(simplex_pair):
    j, t = simplex_pair
    key = lambda h: (h["phase"], h["time"], h["step"], h["newton_iters"], h["krylov_iters"])
    assert [key(h) for h in t.history] == [key(h) for h in j.history]
    assert len(t.history) == 2 and t.time_step_index == 2 and t.nu == 1.0
    # the caps bind (some solves stop at 40) and some solves converge before them
    assert any(h["krylov_iters"] % 40 for h in t.history) and max(h["krylov_iters"] for h in t.history) >= 40


def test_solve_fused_simplex_forces_and_fields(simplex_pair):
    j, t = simplex_pair
    for hj, ht in zip(j.history, t.history):
        _assert_forces((ht["drag_force"], ht["lift_force"]), (hj["drag_force"], hj["lift_force"]))
    _assert_forces((t.drag_coeff, t.lift_coeff), (j.drag_coeff, j.lift_coeff))
    _assert_fields(t.fields(), j.fields())


def _coefficient_lines(text):
    return [(m[1], float(m[2])) for m in re.finditer(r"^(Lift coefficient|Drag coefficient): (\S+)$", text, re.M)]


def test_cli_fused_matches_the_jax_cli(capsys):
    argv = ["-m", "16,8", "-r", "1", "-s", "1", "-p", "1", "-t", "1e-8", "-T", "0.01,0.01", "--fused"]
    assert j_unsteady.main(argv) == 0
    want = _coefficient_lines(capsys.readouterr().out)
    s = t_unsteady.run(argv + ["--device", "cpu"])
    got = _coefficient_lines(capsys.readouterr().out)
    assert [k for k, _ in got] == [k for k, _ in want] == ["Lift coefficient", "Drag coefficient"]
    _assert_forces((got[1][1], got[0][1]), (want[1][1], want[0][1]))
    assert (s.drag_coeff, s.lift_coeff) == (got[1][1], got[0][1])
    assert s.time_step_index == 1 and s.solve_seconds > 0
    assert [h["phase"] for h in s.history] == ["step"] and s.history[0]["newton_iters"] >= 2

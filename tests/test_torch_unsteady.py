"""The unsteady solver (``NSSolver``) in both packages: 16x8 Q3/Q2, Re 20,
dt 0.01, T 0.02 (two implicit-Euler steps), tol 1e-9, FGMRES with
blockTriangular and the Cahouet-Chabard Schur leg.

  * all-f64 (no f32 preconditioner), ``solve()`` with the per-step Re ramp
    (levels 1 and 11): the per-solve Krylov counts and the history are
    equal, drag and lift per step agree to rtol 1e-7, the fields to 1e-6
    of their largest magnitude (BASELINE.md's 1e-6 gate).  The lift of this
    mesh is ~1e-9 of the drag, i.e. rounding: it is held to 1e-7 of the
    drag.  The pressure differs by up to ~1.5e-6 absolute at the inlet
    corner, where the outer tolerance (absolute 1e-9) leaves it least
    determined; at tol 1e-11 the difference drops ~10x.
  * the default f32 preconditioner, ``solve(direct=True)``: the total
    outer count is within 5% of the JAX package's.  f32 rounding steers
    the outer iteration here, and at tol 1e-9 the answer is only as sharp
    as the tolerance: the JAX package's own f32 and f64 preconditioners
    give drags 7.4e-7 apart after two steps and pressures 2.9e-5 apart.
    The port is held inside that spread: drag rtol 1e-6, velocity 1e-6,
    pressure 1e-4 (absolute, |p| <= 10.4).
  * the JAX package's state after step 1, carried into the port with
    ``state_from_numpy`` as ``solution`` and ``solution_old``, gives the
    same Newton residual norm in one ``assemble_system`` (both continuity
    signs) to rtol 1e-12.

The power iteration of the pressure-Laplacian V-cycle starts from a random
vector; both configurations give the port the JAX package's
(``PRNGKey(7)``) so that the two packages run the same preconditioner.
The JAX runs take the port's fixed Krylov chunk (``NSTPU_KRYLOV_CHUNK``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu_torch.precond.mg as tmg
from navier_stokes_solver_tpu.api import NSSolver as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions, state_from_numpy
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

BASE = dict(
    mesh_size=(16, 8), degree_velocity=3, degree_pressure=2, Re=20.0,
    solver_type=1, tolerance=1e-9, preconditioner_type=1, verbose=False,
    time_span=0.02, time_step=0.01,
)
CONFIGS = {  # name: (PrecondConfig fields, solve(direct=...))
    "f64": (dict(schur_mode="cahouet", vmult_dtype=None, mg_dtype=None), False),
    "f32": (dict(schur_mode="cahouet"), True),
}
FIELD_GATE = 1e-6
# the f32 configuration's gates: inside the JAX package's own f32-vs-f64 spread
F32_GATES = dict(drag=1e-6, u=1e-6, p=1e-4)


def _jax_start(shape, dtype, device):
    """The JAX package's power-iteration start vector, in ``dtype``."""
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.tensor(np.asarray(jax.random.normal(jax.random.PRNGKey(7), tuple(shape), jd)), device=device)


def _run(solver_cls, options_cls, cfg_cls, name, **extra):
    cfg, direct = CONFIGS[name]
    s = solver_cls(options_cls(precond_config=cfg_cls(**cfg), **BASE, **extra))
    s.setup()
    s.solve(direct=direct)
    return s


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolver.KRYLOV_CHUNK_MAX))
        j = _run(JSolver, JOptions, JCfg, name)
        mp.setattr(tmg, "_lmax_start", _jax_start)
        t = _run(NSSolver, SolverOptions, PrecondConfig, name, device="cpu")
    return name, j, t


def _solves(s):
    return [(h["phase"], h["nu"], h["n_iter"], h["krylov_iters"]) for h in s.history if h["phase"] != "step"]


def _steps(s):
    return [h for h in s.history if h["phase"] == "step"]


def test_krylov_counts_and_history(pair):
    name, j, t = pair
    assert [h["phase"] for h in t.history] == [h["phase"] for h in j.history]
    assert len(_steps(t)) == 2
    if name == "f64":
        assert _solves(t) == _solves(j)
        assert {h["nu"] for h in t.history if "nu" in h} == {1.0, 1.0 / 11.0}
    else:
        assert [h[:3] for h in _solves(t)] == [h[:3] for h in _solves(j)]
        tj = sum(h[3] for h in _solves(j))
        tt = sum(h[3] for h in _solves(t))
        assert abs(tt - tj) <= 0.05 * tj, (tt, tj)


def test_drag_and_lift_per_step(pair):
    name, j, t = pair
    rtol = 1e-7 if name == "f64" else F32_GATES["drag"]
    for hj, ht in zip(_steps(j), _steps(t)):
        assert ht["step"] == hj["step"] and ht["time"] == hj["time"]
        np.testing.assert_allclose(ht["drag_coeff"], hj["drag_coeff"], rtol=rtol)
        np.testing.assert_allclose(
            ht["lift_coeff"], hj["lift_coeff"], rtol=rtol, atol=rtol * abs(hj["drag_coeff"])
        )
    assert (t.drag_coeff, t.lift_coeff) == (_steps(t)[-1]["drag_coeff"], _steps(t)[-1]["lift_coeff"])


def test_fields_within_gate(pair):
    name, j, t = pair
    (ju, jp), (tu, tp) = j.fields(), t.fields()
    if name == "f64":
        atol_u = FIELD_GATE * np.abs(ju).max()
        atol_p = FIELD_GATE * np.abs(jp).max()
    else:
        atol_u, atol_p = F32_GATES["u"], F32_GATES["p"]
    np.testing.assert_allclose(tu, ju, rtol=0, atol=atol_u)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=atol_p)


def test_state_carried_across(pair):
    """Step 2 begins with solution_old = solution = the state after step 1
    (the JAX solver's ``solution_old`` at the end): one assemble_system in
    each package, both continuity signs."""
    _, j, t = pair
    u1, p1 = np.asarray(j.solution_old.u), np.asarray(j.solution_old.p)
    for consistent in (False, True):
        jj, tt = copy.copy(j), copy.copy(t)
        jj.options = dataclasses.replace(j.options, consistent_continuity=consistent)
        tt.options = dataclasses.replace(t.options, consistent_continuity=consistent)
        jj.solution = jj.solution_old = j.solution_old
        tt.solution = tt.solution_old = state_from_numpy(u1, p1, dtype=torch.float64, device="cpu")
        want = jj.assemble_system(False, lifting=False)
        got = tt.assemble_system(False, lifting=False)
        assert want > 1e-6
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_device_defaults_to_the_card():
    """Construct only: ``setup()`` would put the tensors on the card."""
    assert SolverOptions().device == "cuda"
    s = NSSolver(**BASE)
    assert s.device == torch.device("cuda")
    assert s.nu == 0.01 and s.inv_dt == 100.0


def test_lift_drag_files_match_the_jax_package(tmp_path):
    """``write_lift_drag_to_file`` appends to the JAX package's per-Re file
    names the same text, given the same coefficients (construct only)."""
    for s, sub in ((JSolver(JOptions(**BASE)), "jax"), (NSSolver(**BASE, device="cpu"), "torch")):
        (tmp_path / sub).mkdir()
        for drag, lift in ((5.579535233840, 0.010618948146), (3.0, -1e-3)):
            s.drag_coeff, s.lift_coeff = drag, lift
            s.write_lift_drag_to_file(str(tmp_path / sub))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    for n in names:
        assert (tmp_path / "torch" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


OUTSIDE_THE_PATH = [  # (option, ROADMAP item the message must name)
    (dict(dd=(2, 1)), "A.D9"),
]


def test_unported_options_raise(tmp_path):
    """Unported options raise naming their ROADMAP item; ``fused`` is
    accepted, and ``solve_fused`` refuses Re < 1 as the JAX package does
    (construct only); ``write_output`` is ported: ``output(step)`` writes
    the step's record."""
    for kw, match in OUTSIDE_THE_PATH:
        with pytest.raises(NotImplementedError, match=match):
            NSSolver(SolverOptions(**{**BASE, **kw}, device="cpu"))
    s = NSSolver(SolverOptions(**BASE, write_output=True, output_dir=str(tmp_path), device="cpu")).setup()
    s.output(3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["output_003.0.vtu", "output_003.pvtu"]
    assert NSSolver(SolverOptions(**BASE, fused=True, device="cpu")).options.fused
    for cls, opts in ((NSSolver, SolverOptions(**{**BASE, "Re": 0.5}, device="cpu")), (JSolver, JOptions(**{**BASE, "Re": 0.5}))):
        with pytest.raises(ValueError, match="Re >= 1"):
            cls(opts).solve_fused()

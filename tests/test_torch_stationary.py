"""The full stationary continuation in both packages: 16x8 Q3/Q2, target
Re 30, tol 1e-10, FGMRES with blockTriangular.

  * all-f64 configuration (no GMRES-IR, f64 preconditioner): the per-solve
    Krylov counts are equal.  ``skip_futile_stokes`` is on: the reference's
    repeat Stokes solves start at the noise floor of the f64 operator
    (their residual is the previous solve's ~1e-10), where the count is
    decided by rounding, not by the algorithm.
  * the ``bench.py`` tuned configuration (basis 60, f32 GMRES-IR cycles,
    Stokes inner rel 1e-4): f32 rounding steers the iteration, so the drag
    agrees to rtol 1e-7 and the total outer count to within 5%.  The JAX
    run takes the port's fixed Krylov chunk (``NSTPU_KRYLOV_CHUNK``), so
    both packages run the same GMRES-IR cross-chunk stall test.
  * in both, the fields agree to the 1e-6 gate of BASELINE.md.
  * a JAX solution loaded with ``state_from_numpy`` gives the same residual
    norm and lift/drag in the port to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.api import NSSolverStationary as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.api import kernels as jk
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
from navier_stokes_solver_tpu_torch.api import kernels as tk
from navier_stokes_solver_tpu_torch.api import state_from_numpy
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

BASE = dict(
    mesh_size=(16, 8), degree_velocity=3, degree_pressure=2, Re=30.0,
    solver_type=1, tolerance=1e-10, preconditioner_type=1, verbose=False,
    skip_futile_stokes=True,
)
CONFIGS = {
    "f64": (dict(krylov_basis=30), dict(vmult_dtype=None, mg_dtype=None)),
    "tuned": (
        dict(krylov_basis=60),
        dict(krylov_cycle_dtype="float32", tri_rel_u_stokes=1e-4, tri_rel_p_stokes=1e-4),
    ),
}
FIELD_GATE = 1e-6  # BASELINE.md: fields match to 1e-6


def _run(solver_cls, options_cls, cfg_cls, name, **extra):
    opts, cfg = CONFIGS[name]
    s = solver_cls(options_cls(precond_config=cfg_cls(**cfg), **opts, **BASE, **extra))
    s.setup()
    s.solve_newton()
    s.compute_lift_drag()
    s.compute_drag_coeff()
    return s


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    name = request.param
    chunk = NSSolverStationary.KRYLOV_CHUNK_MAX
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSTPU_KRYLOV_CHUNK", str(chunk))
        j = _run(JSolver, JOptions, JCfg, name)
    t = _run(NSSolverStationary, SolverOptions, PrecondConfig, name, device="cpu")
    return name, j, t


def _counts(s):
    return [(h["phase"], h.get("krylov_iters")) for h in s.history]


def test_krylov_counts(pair):
    name, j, t = pair
    if name == "f64":
        assert _counts(t) == _counts(j)
    else:
        assert [h["phase"] for h in t.history] == [h["phase"] for h in j.history]
        tj = sum(h.get("krylov_iters", 0) for h in j.history)
        tt = sum(h.get("krylov_iters", 0) for h in t.history)
        assert abs(tt - tj) <= 0.05 * tj, (tt, tj)


def test_drag(pair):
    _, j, t = pair
    np.testing.assert_allclose(t.drag_coeff, j.drag_coeff, rtol=1e-7)
    assert np.isfinite(t.lift_coeff)


def test_fields_within_gate(pair):
    _, j, t = pair
    ju, jp = j.fields()
    tu, tp = t.fields()
    np.testing.assert_allclose(tu, ju, rtol=0, atol=FIELD_GATE)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=FIELD_GATE)


def test_state_from_numpy_residual_and_forces(pair):
    """The JAX package's converged state, carried into the port, gives the
    same Newton residual (both continuity signs) and lift/drag.

    At the converged state the residual norm (~1e-10) is all cancellation,
    so it is held to 1e-12 absolute; at the same state perturbed by 1e-3 it
    is held to rtol 1e-12.
    """
    _, j, t = pair
    ju, jp = j.fields()
    rng = np.random.default_rng(9)
    du = 1e-3 * rng.standard_normal(ju.shape) * np.asarray(j.disc.u_active)
    for scale, tol in ((0.0, dict(rtol=0, atol=1e-12)), (1.0, dict(rtol=1e-12))):
        u = ju + scale * du
        jst = type(j.solution)(u=jnp.asarray(u), p=jnp.asarray(jp))
        tst = state_from_numpy(u, jp, dtype=torch.float64, device="cpu")
        for consistent in (False, True):
            _, jn = jk.assemble_kernel(
                j.disc_nomg, j.nu, 0.0, jst, jst.u, 0.0, stokes=False, consistent=consistent
            )
            _, tn = tk.assemble_kernel(
                t.disc_nomg, t.nu, 0.0, tst, tst.u, 0.0, stokes=False, consistent=consistent
            )
            np.testing.assert_allclose(float(tn), float(jn), **tol)
    st = state_from_numpy(ju, jp, dtype=torch.float64, device="cpu")
    jd, jl = jk.lift_drag_kernel(j.disc_nomg, j.nu, j.solution)
    td, tl = tk.lift_drag_kernel(t.disc_nomg, t.nu, st)
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-12)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-12, atol=1e-12 * abs(float(jd)))


OUTSIDE_THE_SLICE = [  # (option, ROADMAP item the message must name)
    (dict(dd=(2, 2), read_mesh_from_file=True), r"1-D \(x-strips\)"),  # -M decomposes into x-strips only
]


def test_options_outside_the_slice_raise():
    """... and ``fused=True``, which the stationary solver ignores, as the
    JAX package's does; the cavity, VTU output, ``write_mesh`` and a body
    force are ported (``tests/test_torch_cavity.py``, ``test_torch_io.py``)
    and construct in both packages."""
    for kw, match in OUTSIDE_THE_SLICE:
        with pytest.raises(NotImplementedError, match=match):
            NSSolverStationary(SolverOptions(**{**BASE, **kw}, device="cpu"))
    ported = dict(geometry="cavity", write_output=True, write_mesh=True, forcing=lambda x, y: (x, y))
    assert NSSolverStationary(SolverOptions(**BASE, **ported, device="cpu")).options.geometry == "cavity"
    assert JSolver(JOptions(**BASE, **ported)).options.geometry == "cavity"
    assert NSSolverStationary(SolverOptions(**BASE, fused=True, device="cpu")).options.fused
    assert JSolver(JOptions(**BASE, fused=True)).options.fused


def test_options_need_an_explicit_device():
    """The device is the card unless the caller asks for the CPU: without a
    card, leaving it out fails in ``setup()`` -- never a silent fallback."""
    assert SolverOptions(**BASE).device == "cuda"
    s = NSSolverStationary(**BASE)
    assert s.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            s.setup()

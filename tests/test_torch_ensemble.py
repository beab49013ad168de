"""The port's Reynolds-sweep ensemble (``ensemble/``) against the JAX
package's ``vmap`` ensemble and against its own unbatched step, on the CPU.

* Against JAX: 16x8 Q2/Q1 with the multigrid chain, FGMRES +
  blockTriangular, Cahouet-Chabard with one Lp V-cycle, all-f64, B = 3
  (Re 20, 60, 100), two steps from rest, ``newton_max`` 3, every tangent
  solve capped at 20 Krylov iterations: per step and member the Newton and
  Krylov counts equal, drag and lift within rtol 1e-7 (the lift of the
  symmetric mesh is rounding: held to 1e-7 of the drag), the final fields
  within 1e-6 of their magnitude.  The Lp V-cycle's power iteration starts
  from the JAX package's ``PRNGKey(7)`` vector, substituted at
  ``precond.mg._lmax_start`` (as in ``test_torch_schur.py``).
* Against the unbatched step: member b of the batched step against
  ``make_time_step`` at nu_b, at Krylov tolerance 1e-12 (so that the solves
  stop well inside the gate; at 1e-9 the two stop on different sides of the
  tolerance, 1.4e-10 apart in drag at Re 100): equal counts, drag and lift
  within rtol 1e-12.  Not bit for bit: the batched inner products and
  Gram-Schmidt products round differently from the unbatched ``torch.dot``
  and GEMV; every operator is bitwise per member.
* Freezing: a member that stops earlier (FGMRES: its own iteration count;
  Newton: its own count) is not changed by the later iterations, by value.
* The batched plain kernels equal B per-member plain calls, bit for bit.
* The JAX-to-port batched ``TimeState`` carrier round-trips.
* What the ensemble does not batch yet raises ``NotImplementedError``:
  ``krylov_cycle_dtype="mixed"`` names ROADMAP A.14 (``mesh=`` is tested
  in ``tests/test_torch_dist.py``).
  (GMRES-IR cycles, ``direct_lu`` and the ``-M`` simplex disc batch:
  ``test_torch_ensemble_rest.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu_torch.precond.mg as tmg

from navier_stokes_solver_tpu import ensemble as jens
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geometry
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond.mg import attach_mg as j_attach_mg
from navier_stokes_solver_tpu_torch import timeloop as ttl
from navier_stokes_solver_tpu_torch.api import time_state_from_numpy
from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step, run_sweep
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.krylov import fgmres_batched
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc, matfree
from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F_plain
from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v
from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc_plain
from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg
from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel

torch.set_num_threads(1)

MESH, DEG = (16, 8), (2, 1)
RES = (20.0, 60.0, 100.0)
NUS = [1.0 / re for re in RES]
DT, STEPS = 0.01, 2
CFG = dict(schur_mode="cahouet", cc_lp_cycles=1, vmult_dtype=None, mg_dtype=None)
STEP = dict(solver_type=1, prec_type=1, tol=1e-9, newton_max=3, krylov_maxiter=20)
GATE, FIELD_GATE = 1e-7, 1e-6


def _jax_start(shape, dtype, device):
    """The JAX package's power-iteration start vector, as a tensor."""
    v = jax.random.normal(jax.random.PRNGKey(7), tuple(shape), jnp.float64)
    return torch.tensor(np.asarray(v), device=device).to(dtype)


def _disc():
    return attach_mg(make_disc(make_fe_space(make_channel_geometry(*MESH), *DEG), torch.float64, "cpu"))


@pytest.fixture(scope="module")
def sweeps():
    """Per step: (JAX batched TimeState, port's history) of the two runs."""
    jdisc = j_attach_mg(j_make_disc(j_space(j_geometry(*MESH), *DEG)))
    jstep = jax.jit(jens.make_ensemble_step(jdisc, precond_cfg=JCfg(**CFG), **STEP))
    jts = jens.sweep.initial_ensemble_state(jdisc, len(NUS))
    jnus = jax.numpy.asarray(NUS, jdisc.dtype)
    jsteps = []
    for _ in range(STEPS):  # run_sweep's scan body, one step at a time
        jts = jstep(jts, jnus, DT)
        jsteps.append(jax.tree_util.tree_map(np.asarray, jts))
    own_start, tmg._lmax_start = tmg._lmax_start, _jax_start
    try:
        final, hist = run_sweep(_disc(), NUS, DT, STEPS, precond_cfg=PrecondConfig(**CFG), **STEP)
    finally:
        tmg._lmax_start = own_start
    return jsteps, final, {k: v.numpy() for k, v in hist.items()}


def test_sweep_counts_match_jax(sweeps):
    jsteps, _, hist = sweeps
    for k, js in enumerate(jsteps):
        assert hist["newton_iters"][k].tolist() == js.stats.newton_iters.tolist()
        assert hist["krylov_iters"][k].tolist() == js.stats.krylov_iters.tolist()
    # the cap binds in some solves, and the members stop at different iterations
    assert hist["krylov_iters"].max() >= 20 and len(set(hist["krylov_iters"][-1].tolist())) > 1


def test_sweep_forces_and_fields_match_jax(sweeps):
    jsteps, final, hist = sweeps
    assert hist["drag"].shape == (STEPS, len(NUS))
    for k, js in enumerate(jsteps):
        np.testing.assert_allclose(hist["drag"][k], js.drag, rtol=GATE)
        np.testing.assert_allclose(hist["lift"][k], js.lift, rtol=GATE, atol=GATE * np.abs(js.drag).max())
    for got, want in zip(final.solution, jsteps[-1].solution):
        got = got.numpy()
        assert got.shape == want.shape == (len(NUS),) + want.shape[1:]
        for b in range(len(NUS)):
            assert np.abs(got[b] - want[b]).max() <= FIELD_GATE * np.abs(want[b]).max()
    assert final.step.tolist() == [STEPS] * len(NUS) and final.step.dtype == torch.int32


def test_members_match_the_unbatched_step():
    disc = _disc()
    kw = dict(STEP, tol=1e-12, krylov_maxiter=200, precond_cfg=PrecondConfig(**CFG))
    final, hist = run_sweep(disc, NUS, DT, STEPS, **kw)
    step = ttl.make_time_step(disc, **kw)
    for b, nu in enumerate(NUS):
        ts = ttl.initial_state(disc)
        for k in range(STEPS):
            ts = step(ts, nu, DT)
            assert int(ts.stats.newton_iters) == hist["newton_iters"][k, b]
            assert int(ts.stats.krylov_iters) == hist["krylov_iters"][k, b]
            np.testing.assert_allclose(float(hist["drag"][k, b]), float(ts.drag), rtol=1e-12)
            np.testing.assert_allclose(float(hist["lift"][k, b]), float(ts.lift), rtol=1e-12,
                                       atol=1e-12 * abs(float(ts.drag)))
        assert np.abs((final.solution.u[b] - ts.solution.u).numpy()).max() <= 1e-9 * float(ts.solution.u.abs().max())


@pytest.mark.parametrize("level", ["fgmres", "newton"])
def test_a_stopped_member_is_frozen(level):
    """The member that stops first ends with the value it had when it
    stopped: the same run cut off at its own count gives the same bits."""
    disc = _disc()
    nus = torch.tensor(NUS)
    cfg = PrecondConfig(**CFG)
    if level == "fgmres":
        rng = np.random.default_rng(0)
        st = Blocks(torch.tensor(0.3 * rng.standard_normal((3, 2) + disc.NV)) * disc.u_active,
                    torch.tensor(rng.standard_normal((3,) + disc.NP)) * disc.p_active)
        linq = matfree.eval_state(disc, st)
        dF = matfree.diag_F(disc, nus, 1.0 / DT, linq, stokes=False)
        A = lambda x: matfree.apply_F(disc, nus, 1.0 / DT, linq, x, stokes=False, bc_diag=dF)
        b = torch.tensor(rng.standard_normal((3, 2) + disc.NV)) * disc.u_active
        run = lambda n: fgmres_batched(A, b, torch.zeros_like(b), tol=1e-6, maxiter=n, M=lambda r: r / dF)
        x, info = run(400)
        counts = info.iters
        first = int(np.argmin(counts))
        x_cut, _ = run(int(counts[first]))
        assert info.converged.all() and len(set(counts.tolist())) > 1
        assert torch.equal(x[first], x_cut[first])
        return
    # from step 1, members 1 and 2 perturbed (seeded, interior nodes): with
    # the Jacobian-consistent sign the Newton counts then differ per member
    kw = dict(STEP, consistent=True, precond_cfg=cfg)
    ts1 = make_ensemble_step(disc, **kw)(initial_ensemble_state(disc, 3), nus, DT)
    rng = np.random.default_rng(0)
    u = ts1.solution.u.clone()
    for b, a in ((1, 1e-7), (2, 1e-5)):
        u[b] += a * torch.tensor(rng.standard_normal(u[b].shape)) * (disc.u_active & ~disc.u_dirichlet)
    ts0 = ts1._replace(solution=Blocks(u, ts1.solution.p))
    kw = dict(kw, newton_max=6, newton_tol=1e-10, tol=1e-12, krylov_maxiter=200)
    ts = make_ensemble_step(disc, **kw)(ts0, nus, DT)
    counts = ts.stats.newton_iters.numpy()
    first = int(np.argmin(counts))
    assert len(set(counts.tolist())) > 1
    cut = make_ensemble_step(disc, **{**kw, "newton_max": int(counts[first])})(ts0, nus, DT)
    for a, c in zip(ts.solution, cut.solution):
        assert torch.equal(a[first], c[first])
    assert float(ts.drag[first]) == float(cut.drag[first])


def test_batched_plain_kernels_equal_per_member_calls():
    disc = _disc()
    rng = np.random.default_rng(1)
    nus = torch.tensor(NUS)
    u = torch.tensor(0.3 * rng.standard_normal((3, 2) + disc.NV))
    x = torch.tensor(rng.standard_normal((3, 2) + disc.NV))
    linq = matfree.eval_state(disc, Blocks(u, torch.tensor(rng.standard_normal((3,) + disc.NP))))
    bc = matfree.diag_F(disc, nus, 1.0 / DT, linq, stokes=False)
    for stokes in (True, False):
        loc = cell_apply_F_plain(disc, nus, 1.0 / DT, linq, _gather_v(disc, x), stokes=stokes)
        assert loc.shape == (9, 3, 2, disc.ny, disc.nx)
        out = scatter_v_bc_plain(disc, loc, bc_diag=bc, x_u=x)
        raw = scatter_v_bc_plain(disc, loc)
        for b in range(3):
            lq = matfree.LinearizationQ(linq.u[:, b], linq.gradu[:, b], None)
            one = cell_apply_F_plain(disc, NUS[b], 1.0 / DT, lq, _gather_v(disc, x[b]), stokes=stokes)
            assert torch.equal(loc[:, b], one)
            assert torch.equal(out[b], scatter_v_bc_plain(disc, one, bc_diag=bc[b], x_u=x[b]))
            assert torch.equal(raw[b], scatter_v_bc_plain(disc, one))


def test_jax_time_state_carrier_round_trips(sweeps):
    jsteps, _, _ = sweeps
    js = jsteps[-1]
    ts = time_state_from_numpy(js, dtype=torch.float64, device="cpu")
    assert ts.step.dtype == ts.stats.krylov_iters.dtype == torch.int32
    leaves = lambda t: (*t.solution, t.time, t.step, t.drag, t.lift, *t.stats)
    for got, want in zip(leaves(ts), leaves(js), strict=True):
        got = got.numpy()
        assert got.shape == np.shape(want) and np.array_equal(got, want)
    # the carried state steps on in the port as the JAX state does in JAX
    step = make_ensemble_step(_disc(), precond_cfg=PrecondConfig(**CFG), **STEP)
    assert step(ts, torch.tensor(NUS), DT).step.tolist() == [STEPS + 1] * len(NUS)


def test_unported_combinations_name_the_roadmap():
    disc = _disc()
    simplex = make_simplex_disc(*triangulate_channel(make_channel_geometry(8, 4)), dtype=torch.float64, device="cpu")
    for d in (disc, simplex):
        with pytest.raises(NotImplementedError, match="mixed.*A.14"):
            make_ensemble_step(d, precond_cfg=PrecondConfig(**CFG, krylov_cycle_dtype="mixed"))

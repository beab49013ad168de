"""The rest of the port's ensemble -- GMRES-IR restart cycles with a member
axis, one direct LU per member, the ``-M`` simplex ensemble -- against the
JAX package's ``vmap`` ensemble and the port's unbatched step, on the CPU.

* The batched GMRES-IR core (``krylov.fgmres_batched``/``gmres_batched``
  with ``lo``) on seeded dense per-member systems against JAX
  ``vmap(fgmres(..., lo=LowCycle(...)))``: equal iterations and flags,
  solutions within 1e-10.  One member's f64 matrix is scaled below f32's
  smallest subnormal (1e-50): its f32 image is zero, its cycles cannot
  reduce the residual, and it takes the stall exit (``beta > lo.stall *
  stall_ref``) beside members that converge -- with the same count, flags
  and iterate as under the JAX ``vmap``.
* The 16x8 Q2/Q1 ensemble (B = 3, Re 20/60/100, two steps, ``newton_max``
  3, FGMRES + blockTriangular + Cahouet-Chabard, all-f64 disc and
  preconditioner) with f32 cycles, its tangent solves whole (cap 200) with
  the consistent continuity sign.  Per step and member: Newton counts
  equal, Krylov totals within the step's Newton count, drag and lift
  rtol 1e-7, fields 1e-6 of their magnitude; each member against the
  port's unbatched step: the same counts gate, drag rtol 1e-9.  Two f32
  computations of one cycle round differently (XLA and torch, or a batched
  and an unbatched product), and a cycle ends where its f32 Givens estimate
  crosses ``eta * beta``, so a tangent solve may end one iteration apart
  (measured: 0-2 per step of 2-3 solves; capped at 20, the two packages'
  drags part by 2e-6: capped f32 iterates are rounding-sensitive, so the
  solves run whole).
* The structured direct-LU ensemble (16x8, B = 3, capped at 20): counts
  equal, drag rtol 1e-7, fields 1e-6; each member's factors are the
  unbatched ``make_direct_lu``'s on that member's linearization, bit for
  bit, and a member the Krylov ``active`` mask drops is not factored.
* The simplex operators with a [B] ``nu`` against JAX ``vmap`` of the same
  functions, f64, within 1e-12 (the p-MG V-cycle 1e-10, as unbatched in
  ``test_torch_simplex.py``): ``eval_state``, ``diag_F``,
  ``apply_jacobian``, ``residual`` (both signs), ``apply_Fp``,
  ``apply_Mp``, ``lift_drag_forces`` and ``make_p_vcycle``.
* The ``-M`` 24x10 ensemble (B = 3, Re 1/50/100, consistent sign; at 12x6
  every member's drag is zero), with the iterative Schur legs (capped at
  40, one step) and with the direct LU (two steps): counts equal, a drag
  that is not zero, drag and lift rtol 1e-7, fields 1e-6; and the JAX
  simplex ensemble's state after one step, carried into the port
  (``api.time_state_from_numpy``), steps on as the JAX state does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.unstructured.ops as jops
import navier_stokes_solver_tpu.unstructured.pmg as jpmg
import navier_stokes_solver_tpu_torch.unstructured.ops as tops
import navier_stokes_solver_tpu_torch.unstructured.pmg as tpmg
from navier_stokes_solver_tpu import krylov as jk
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_simplex_disc
from navier_stokes_solver_tpu_torch import timeloop as ttl
from navier_stokes_solver_tpu_torch.api import kernels, time_state_from_numpy
from navier_stokes_solver_tpu_torch.ensemble import make_ensemble_step, run_sweep
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
from navier_stokes_solver_tpu_torch.krylov import LowCycle, fgmres_batched, gmres_batched
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig, blocks
from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel

from tests import _ensemble_matrix as em

torch.set_num_threads(1)

CAHOUET = dict(schur_mode="cahouet", cc_lp_cycles=1, **em.F64)
IR = dict(CAHOUET, krylov_cycle_dtype="float32")
LU = dict(CAHOUET, direct_lu=True)
STEP = dict(solver_type=1, prec_type=1, tol=1e-9, newton_max=3)
IR_STEP = dict(STEP, krylov_maxiter=200, consistent=True)
SIMPLEX_MESH = (24, 10)
SIMPLEX_NUS = [1.0, 1.0 / 50.0, 1.0 / 100.0]
SIMPLEX_STEP = dict(STEP, consistent=True)
SIMPLEX_CAP = {"iterative": 40, "direct_lu": 40}
# steps from rest: the iterative legs' capped solves cost 120 iterations a
# step, so one; the direct LU two (its second carries the JAX state on)
SIMPLEX_STEPS = {"iterative": 1, "direct_lu": 2}
OP_GATE, VCYCLE_GATE = 1e-12, 1e-10


# ---------------------------------------------------------------------------
# the batched GMRES-IR core
# ---------------------------------------------------------------------------


def _ir_systems(stall: bool):
    """B = 3 seeded dense systems (n = 40): well-conditioned matrices, and
    with ``stall`` member 2 scaled by 1e-50 -- below f32's smallest
    subnormal, so its f32 cycle operator is zero."""
    rng = np.random.default_rng(5)
    A = 4.0 * np.eye(40)[None] + 0.3 * rng.standard_normal((3, 40, 40))
    if stall:
        A[2] *= 1e-50
    return A, rng.standard_normal((3, 40))


@pytest.mark.parametrize("name", ["fgmres", "gmres"])
def test_gmres_ir_core_matches_jax_vmap(name):
    """FGMRES with a member that stalls beside two that converge; GMRES
    (left-preconditioned, Jacobi) with three that converge.  (Under the JAX
    package's GMRES a zero f32 operator leaves a 0 * NaN in the correction
    of its padded basis, so the stall member is FGMRES's.)"""
    stall = name == "fgmres"
    A, b = _ir_systems(stall)
    dinv = 1.0 / np.einsum("bii->bi", A) if not stall else None
    kw = dict(tol=1e-10, maxiter=300, basis=15)

    def one(Am, bm, dm):
        Mj = None if dm is None else (lambda r: dm * r)
        lo = jk.LowCycle(matvec=lambda x: Am.astype(jnp.float32) @ x,
                         M=None if dm is None else (lambda r: dm.astype(jnp.float32) * r), dtype=jnp.float32)
        return getattr(jk, name)(lambda x: Am @ x, bm, jnp.zeros_like(bm), M=Mj, lo=lo, **kw)

    if stall:
        jx, ji = jax.jit(jax.vmap(lambda Am, bm: one(Am, bm, None)))(jnp.asarray(A), jnp.asarray(b))
    else:
        jx, ji = jax.jit(jax.vmap(one))(jnp.asarray(A), jnp.asarray(b), jnp.asarray(dinv))
    tA, tA32 = torch.tensor(A), torch.tensor(A).float()
    mv = lambda M_: (lambda x: torch.bmm(M_, x[..., None])[..., 0])
    td = None if stall else torch.tensor(dinv)
    lo = LowCycle(matvec=mv(tA32), M=None if stall else (lambda r: td.float() * r), dtype=torch.float32)
    solver = fgmres_batched if stall else gmres_batched
    tx, ti = solver(mv(tA), torch.tensor(b), torch.zeros(3, 40, dtype=torch.float64),
                    M=None if stall else (lambda r: td * r), lo=lo, **kw)
    assert ti.iters.tolist() == np.asarray(ji.iters).tolist()
    assert ti.converged.tolist() == np.asarray(ji.converged).tolist()
    assert ti.failed.tolist() == np.asarray(ji.failed).tolist() == [False] * 3
    jx = np.asarray(jx)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-10)
    if stall:
        # the stall exit: one cycle (its one iteration finds the zero
        # operator), then the unchanged restart residual stops the member
        assert ti.converged.tolist() == [True, True, False] and ti.iters[2] == 1
        assert not tx[2].any() and not jx[2].any()
        np.testing.assert_allclose(ti.resnorm[2], np.linalg.norm(b[2]), rtol=1e-15)
        assert ti.iters[:2].min() > 10  # the others cycle on past the stalled member
    else:
        assert ti.converged.all() and np.all(ti.resnorm <= 1e-10)


# ---------------------------------------------------------------------------
# the structured ensembles: f32 GMRES-IR cycles, the direct LU
# ---------------------------------------------------------------------------


def _counts_within_newton(got, want):
    """Newton counts equal; Krylov totals within the step's Newton count."""
    assert got["newton_iters"].tolist() == want["newton_iters"].tolist()
    gap = np.abs(got["krylov_iters"].astype(int) - want["krylov_iters"].astype(int))
    assert np.all(gap <= np.asarray(want["newton_iters"])), (got["krylov_iters"], want["krylov_iters"])


_RUNS = {}


def _structured(kind):
    """(JAX per-step states, the port's final state and numpy history) of
    the 16x8 B = 3 ensemble with f32 cycles ("ir") or the direct LU ("lu"),
    each computed once per module."""
    if kind not in _RUNS:
        fields, kw = (IR, IR_STEP) if kind == "ir" else (LU, dict(STEP, krylov_maxiter=20))
        jsteps = em.jax_steps(em.jax_disc(), em.NUS, em.STEPS, JCfg(**fields), **kw)
        with em.jax_start_vector():
            final, hist = run_sweep(em.disc(), em.NUS, em.DT, em.STEPS, precond_cfg=PrecondConfig(**fields), **kw)
        _RUNS[kind] = (jsteps, final, {k: v.numpy() for k, v in hist.items()})
    return _RUNS[kind]


def _check_forces_and_fields(jsteps, final, hist, nus):
    for k, js in enumerate(jsteps):
        np.testing.assert_allclose(hist["drag"][k], js.drag, rtol=em.GATE)
        np.testing.assert_allclose(hist["lift"][k], js.lift, rtol=em.GATE, atol=em.GATE * np.abs(js.drag).max())
    for got, want in zip(final.solution, jsteps[-1].solution):
        got = got.numpy()
        assert got.shape == want.shape == (len(nus),) + want.shape[1:]
        for b in range(len(nus)):
            assert np.abs(got[b] - want[b]).max() <= em.FIELD_GATE * np.abs(want[b]).max()


def test_ir_ensemble_matches_jax():
    jsteps, final, hist = _structured("ir")
    for k, js in enumerate(jsteps):
        _counts_within_newton({key: hist[key][k] for key in ("newton_iters", "krylov_iters")},
                              {"newton_iters": js.stats.newton_iters, "krylov_iters": js.stats.krylov_iters})
    # whole solves: more than one restart cycle each (basis 30)
    assert hist["krylov_iters"].min() > 30 * hist["newton_iters"].max() // 3
    _check_forces_and_fields(jsteps, final, hist, em.NUS)


def test_ir_ensemble_members_match_the_unbatched_step():
    _, _, hist = _structured("ir")
    disc = em.disc()
    kw = dict(IR_STEP, precond_cfg=PrecondConfig(**IR))
    step = ttl.make_time_step(disc, **kw)
    for b, nu in enumerate(em.NUS):
        ts = ttl.initial_state(disc)
        for k in range(em.STEPS):
            with em.jax_start_vector():
                ts = step(ts, nu, em.DT)
            _counts_within_newton(
                {"newton_iters": hist["newton_iters"][k, b], "krylov_iters": hist["krylov_iters"][k, b]},
                {"newton_iters": ts.stats.newton_iters.numpy(), "krylov_iters": ts.stats.krylov_iters.numpy()})
            np.testing.assert_allclose(float(hist["drag"][k, b]), float(ts.drag), rtol=em.MEMBER_GATE)


def test_direct_lu_ensemble_matches_jax():
    jsteps, final, hist = _structured("lu")
    for k, js in enumerate(jsteps):
        assert hist["newton_iters"][k].tolist() == js.stats.newton_iters.tolist()
        assert hist["krylov_iters"][k].tolist() == js.stats.krylov_iters.tolist()
    assert hist["krylov_iters"].max() <= 3  # the exact preconditioner
    _check_forces_and_fields(jsteps, final, hist, em.NUS)


def test_direct_lu_member_factors_are_the_unbatched_ones():
    """Each member's factors (and solves) are ``make_direct_lu``'s on that
    member's slice of the linearization, bit for bit; a member outside
    ``active`` is not factored and solves to zero; one
    ``DIRECT_LU_TIMES`` entry per factorization."""
    disc = em.disc()
    rng = np.random.default_rng(2)
    nus = torch.tensor(em.NUS)
    st = Blocks(torch.tensor(0.3 * rng.standard_normal((3, 2) + disc.NV)) * disc.u_active,
                torch.tensor(rng.standard_normal((3,) + disc.NP)) * disc.p_active)
    ops = kernels._ops_for(disc)
    linq = ops.eval_state(disc, st)
    dF = ops.diag_F(disc, nus, 1.0 / em.DT, linq, stokes=False)
    src = Blocks(torch.tensor(rng.standard_normal((3, 2) + disc.NV)) * disc.u_active,
                 torch.tensor(rng.standard_normal((3,) + disc.NP)) * disc.p_active)
    ctx = LinearContext(disc=disc, nu=nus, inv_dt=1.0 / em.DT, stokes=False, linq=linq, diag_f=dF,
                        state_u=st.u, ops=ops, active=np.array([True, False, True]))
    blocks.DIRECT_LU_TIMES.clear()
    M = blocks.make_direct_lu(ctx)
    assert len(blocks.DIRECT_LU_TIMES) == 2 and M.factors[1] is None
    out = M(src)
    assert not out.u[1].any() and not out.p[1].any()
    for b in (0, 2):
        one = LinearContext(
            disc=disc, nu=float(nus[b]), inv_dt=1.0 / em.DT, stokes=False,
            linq=type(linq)(*(t[:, b].clone() for t in linq)), diag_f=dF[b].clone(),
            state_u=st.u[b].clone(), ops=ops,
        )
        M1 = blocks.make_direct_lu(one)
        for got, want in zip(M.factors[b], M1.factors[0], strict=True):
            assert torch.equal(got, want)
        want = M1(Blocks(src.u[b], src.p[b]))
        assert torch.equal(out.u[b], want.u) and torch.equal(out.p[b], want.p)


# ---------------------------------------------------------------------------
# the -M simplex ensemble
# ---------------------------------------------------------------------------


def _simplex_discs():
    mesh = triangulate_channel(make_channel_geometry(*SIMPLEX_MESH))
    td = make_simplex_disc(*mesh, dtype=torch.float64, device="cpu").replace(p_mg=True)
    return j_simplex_disc(*mesh).replace(p_mg=True), td


def test_simplex_operators_match_jax_vmap():
    jd, td = _simplex_discs()
    rng = np.random.default_rng(4)
    B, inv_dt = 3, 1.0 / em.DT
    nus = np.array(SIMPLEX_NUS)
    a = {k: rng.standard_normal((B,) + s) for k, s in (
        ("u", (2, td.n_nodes_v)), ("p", (td.n_nodes_p,)), ("x", (2, td.n_nodes_v)),
        ("xp", (td.n_nodes_p,)), ("uold", (2, td.n_nodes_v)))}
    a["u"] *= 0.3
    t = {k: torch.tensor(v) for k, v in a.items()}
    tn = torch.tensor(nus)

    def jax_ops(nu, u, p, x, xp, uold):
        st = JBlocks(u, p)
        lin = jops.eval_state(jd, st)
        dF = jops.diag_F(jd, nu, inv_dt, lin, stokes=False)
        J = jops.apply_jacobian(jd, nu, inv_dt, lin, dF, JBlocks(x, xp), stokes=False)
        out = dict(diag_F=dF, J_u=J.u, J_p=J.p, Fp=jops.apply_Fp(jd, nu, inv_dt, lin, xp),
                   Mp=jops.apply_Mp(jd, nu, xp), forces=jnp.stack(jops.lift_drag_forces(jd, nu, st)),
                   vcycle=jpmg.make_p_vcycle(jd, nu, inv_dt, u, stokes=False, diag_f=dF)(x))
        for c in (False, True):
            r = jops.residual(jd, nu, inv_dt, st, uold, dF, stokes=False, inlet_amp=0.3, consistent=c)
            out[f"res_u_{c}"], out[f"res_p_{c}"] = r.u, r.p
        return out

    want = jax.jit(jax.vmap(jax_ops))(*(jnp.asarray(v) for v in (nus, a["u"], a["p"], a["x"], a["xp"], a["uold"])))
    st = Blocks(t["u"], t["p"])
    lin = tops.eval_state(td, st)
    dF = tops.diag_F(td, tn, inv_dt, lin, stokes=False)
    J = tops.apply_jacobian(td, tn, inv_dt, lin, dF, Blocks(t["x"], t["xp"]), stokes=False)
    got = dict(diag_F=dF, J_u=J.u, J_p=J.p, Fp=tops.apply_Fp(td, tn, inv_dt, lin, t["xp"]),
               Mp=tops.apply_Mp(td, tn, t["xp"]), forces=torch.stack(tops.lift_drag_forces(td, tn, st), dim=-1),
               vcycle=tpmg.make_p_vcycle(td, tn, inv_dt, t["u"], stokes=False, diag_f=dF)(t["x"]))
    for c in (False, True):
        r = tops.residual(td, tn, inv_dt, st, t["uold"], dF, stokes=False, inlet_amp=0.3, consistent=c)
        got[f"res_u_{c}"], got[f"res_p_{c}"] = r.u, r.p
    assert got.keys() == want.keys()
    for k, g in got.items():
        w = np.asarray(want[k])
        assert tuple(g.shape) == w.shape, k
        for b in range(B):  # each member within the gate of its own magnitude
            err, scale = float(np.abs(g[b].numpy() - w[b]).max()), float(np.abs(w[b]).max())
            assert scale > 0 and err <= (VCYCLE_GATE if k == "vcycle" else OP_GATE) * scale, (k, b, err, scale)


def _simplex_runs(kind):
    """(JAX per-step states, the port's final state and numpy history) of
    the -M 24x10 B = 3 ensemble, iterative legs or the direct LU."""
    key = "simplex-" + kind
    if key not in _RUNS:
        jd, td = _simplex_discs()
        fields = dict(em.F64, direct_lu=kind == "direct_lu")
        kw = dict(SIMPLEX_STEP, krylov_maxiter=SIMPLEX_CAP[kind])
        jsteps = em.jax_steps(jd, SIMPLEX_NUS, SIMPLEX_STEPS[kind], JCfg(**fields), **kw)
        final, hist = run_sweep(td, SIMPLEX_NUS, em.DT, SIMPLEX_STEPS[kind], precond_cfg=PrecondConfig(**fields),
                                **kw)
        _RUNS[key] = (jsteps, final, {k: v.numpy() for k, v in hist.items()})
    return _RUNS[key]


@pytest.mark.parametrize("kind", ["iterative", "direct_lu"])
def test_simplex_ensemble_matches_jax(kind):
    jsteps, final, hist = _simplex_runs(kind)
    for k, js in enumerate(jsteps):
        assert hist["newton_iters"][k].tolist() == js.stats.newton_iters.tolist()
        assert hist["krylov_iters"][k].tolist() == js.stats.krylov_iters.tolist()
        assert np.all(np.abs(hist["drag"][k]) > 0.1)  # at 12x6 every drag is 0.0
    _check_forces_and_fields(jsteps, final, hist, SIMPLEX_NUS)


def test_simplex_jax_state_carrier_steps_on():
    """The JAX simplex ensemble's batched state, carried into the port,
    round-trips and steps on as the JAX state does in JAX."""
    jsteps, _, _ = _simplex_runs("direct_lu")
    ts = time_state_from_numpy(jsteps[0], dtype=torch.float64, device="cpu")
    leaves = lambda s: (*s.solution, s.time, s.step, s.drag, s.lift, *s.stats)
    for got, want in zip(leaves(ts), leaves(jsteps[0]), strict=True):
        assert got.shape == np.shape(want) and np.array_equal(got.numpy(), want)
    _, td = _simplex_discs()
    kw = dict(SIMPLEX_STEP, krylov_maxiter=SIMPLEX_CAP["direct_lu"], precond_cfg=PrecondConfig(**em.F64, direct_lu=True))
    ts = make_ensemble_step(td, **kw)(ts, torch.tensor(SIMPLEX_NUS), em.DT)
    js = jsteps[1]
    assert ts.step.tolist() == [2] * 3
    assert ts.stats.newton_iters.tolist() == js.stats.newton_iters.tolist()
    np.testing.assert_allclose(ts.drag.numpy(), js.drag, rtol=em.GATE)

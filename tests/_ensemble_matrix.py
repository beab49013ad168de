"""Shared setup of the ensemble solver-matrix parity tests
(``test_torch_ensemble_solvers.py``, ``test_torch_ensemble_legs.py``):
combinations (a)-(f) of solver, block preconditioner, Schur leg, inner mode
and V-cycle smoother, each run as a B = 3 ensemble on 16x8 Q2/Q1 with the
multigrid chain, all-f64, in both packages.

The JAX side steps ``jax.jit`` of its ``vmap`` ensemble step (the body of
its ``run_sweep``'s scan) and keeps every step's state; the port's side is
``run_sweep``.  The power iteration of the Chebyshev smoothers and of the
Lp V-cycle starts from the JAX package's ``PRNGKey(7)`` vector,
substituted at ``precond.mg._lmax_start``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import navier_stokes_solver_tpu_torch.precond.mg as tmg
from navier_stokes_solver_tpu import ensemble as jens
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geometry
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond.mg import attach_mg as j_attach_mg
from navier_stokes_solver_tpu_torch import timeloop as ttl
from navier_stokes_solver_tpu_torch.ensemble import run_sweep
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import make_disc
from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg

MESH, DEG = (16, 8), (2, 1)
RES = (20.0, 60.0, 100.0)
NUS = [1.0 / re for re in RES]
DT, STEPS = 0.01, 2
F64 = dict(vmult_dtype=None, mg_dtype=None)
STEP = dict(tol=1e-9, newton_max=3)
GATE, FIELD_GATE = 1e-7, 1e-6
# member b against the unbatched step: drag and lift rtol, field gate
MEMBER_GATE, MEMBER_FIELD_GATE = 1e-9, 1e-8

# (step options, PrecondConfig fields, Krylov cap) of combinations (a)-(f).
# Every tangent solve is capped inside the stretch where two roundings of
# the same solve agree (test_torch_ensemble.py caps at 20): whole solves
# under inexact nested inner solves are chaotic -- a rounding difference
# moves a nested solve's stopping iteration, and the outer iterates part.
# Measured on this setup, the JAX package against the port: BiCGStab at
# cap 20 ends one iteration apart (cap 10: counts equal, drag 1.7e-8); the
# PCD leg's nested CG and Lp FGMRES part the drag by 4.7e-6 at cap 20 and
# 9.5e-5 at cap 10 (the port's unbatched step against the JAX package's
# unbatched step: 4.7e-6 at cap 20 too), 3.9e-10 at cap 5.
COMBOS = {
    "a-fgmres-asimple": (dict(solver_type=1, prec_type=2), {}, 20),
    "b-gmres-blockdiag-mass": (dict(solver_type=0, prec_type=0), dict(schur_mode="mass"), 20),
    "c-bicgstab-blocktri-cahouet": (
        dict(solver_type=2, prec_type=1), dict(schur_mode="cahouet", cc_lp_cycles=1), 10
    ),
    "d-fgmres-blocktri-pcd": (dict(solver_type=1, prec_type=1), dict(schur_mode="pcd"), 5),
    "e-fgmres-blocktri-mass-fixed-jacobi": (
        dict(solver_type=1, prec_type=1), dict(schur_mode="mass", inner_mode="fixed", mg_smoother="jacobi"), 20
    ),
    "f-fgmres-blocktri-cahouet-schwarz": (
        dict(solver_type=1, prec_type=1), dict(schur_mode="cahouet", cc_lp_cycles=1, mg_smoother="schwarz"), 20
    ),
}


def jax_start(shape, dtype, device):
    """The JAX package's power-iteration start vector, as a tensor."""
    v = jax.random.normal(jax.random.PRNGKey(7), tuple(shape), jnp.float64)
    return torch.tensor(np.asarray(v), device=device).to(dtype)


class jax_start_vector:
    """Context: the port's power iterations start from ``jax_start``."""

    def __enter__(self):
        self.own, tmg._lmax_start = tmg._lmax_start, jax_start

    def __exit__(self, *exc):
        tmg._lmax_start = self.own


def disc(chain=True):
    d = make_disc(make_fe_space(make_channel_geometry(*MESH), *DEG), torch.float64, "cpu")
    return attach_mg(d) if chain else d


def jax_disc(chain=True):
    d = j_make_disc(j_space(j_geometry(*MESH), *DEG))
    return j_attach_mg(d) if chain else d


def jax_steps(jdisc, nus, n_steps, cfg, **step):
    """Per step, the JAX ensemble's batched TimeState as numpy arrays."""
    jstep = jax.jit(jens.make_ensemble_step(jdisc, precond_cfg=cfg, **step))
    jts = jens.sweep.initial_ensemble_state(jdisc, len(nus))
    jnus = jnp.asarray(nus, jdisc.dtype)
    out = []
    for _ in range(n_steps):  # run_sweep's scan body, one step at a time
        jts = jstep(jts, jnus, DT)
        out.append(jax.tree_util.tree_map(np.asarray, jts))
    return out


def run_combo(name):
    """(JAX per-step states, the port's final state and numpy history) of
    combination ``name``, all-f64."""
    opts, fields, cap = COMBOS[name]
    kw = dict(opts, **STEP, krylov_maxiter=cap)
    jsteps = jax_steps(jax_disc(), NUS, STEPS, JCfg(**F64, **fields), **kw)
    with jax_start_vector():
        final, hist = run_sweep(disc(), NUS, DT, STEPS, precond_cfg=PrecondConfig(**F64, **fields), **kw)
    return jsteps, final, {k: v.numpy() for k, v in hist.items()}


def check_against_jax(jsteps, final, hist):
    """Counts equal per step and member, drag and lift rtol 1e-7 (the lift
    of the symmetric mesh is rounding: held to 1e-7 of the drag), each
    member's final fields within 1e-6 of its magnitude."""
    for k, js in enumerate(jsteps):
        assert hist["newton_iters"][k].tolist() == js.stats.newton_iters.tolist(), k
        assert hist["krylov_iters"][k].tolist() == js.stats.krylov_iters.tolist(), k
        np.testing.assert_allclose(hist["drag"][k], js.drag, rtol=GATE)
        np.testing.assert_allclose(hist["lift"][k], js.lift, rtol=GATE, atol=GATE * np.abs(js.drag).max())
    for got, want in zip(final.solution, jsteps[-1].solution):
        got = got.numpy()
        assert got.shape == want.shape == (len(NUS),) + want.shape[1:]
        for b in range(len(NUS)):
            assert np.abs(got[b] - want[b]).max() <= FIELD_GATE * np.abs(want[b]).max()


def check_members_match_unbatched(name, b=2):
    """Member ``b`` of the batched combination (by default Re 100, the
    member whose solves stop last) against the unbatched
    ``make_time_step`` at nu_b, Krylov tolerance 1e-12 and the
    combination's cap: equal counts, drag and lift rtol ``MEMBER_GATE``,
    fields ``MEMBER_FIELD_GATE``.  Not bit for bit: the batched inner
    products and Gram-Schmidt products round differently from the unbatched
    ones (every operator and every preconditioner application is the
    unbatched one to 1e-13, test_torch_ensemble_legs.py), and the nested
    solves pass that on (measured drag spreads: 7.6e-13 (a), 8.0e-12 (c),
    1.1e-10 (d), 9.1e-14 (e), 2.0e-11 (f))."""
    opts, fields, cap = COMBOS[name]
    d = disc()
    kw = dict(opts, tol=1e-12, newton_max=3, krylov_maxiter=cap, precond_cfg=PrecondConfig(**F64, **fields))
    final, hist = run_sweep(d, NUS, DT, STEPS, **kw)
    step = ttl.make_time_step(d, **kw)
    ts = ttl.initial_state(d)
    for k in range(STEPS):
        ts = step(ts, NUS[b], DT)
        assert int(ts.stats.newton_iters) == hist["newton_iters"][k, b], k
        assert int(ts.stats.krylov_iters) == hist["krylov_iters"][k, b], k
        np.testing.assert_allclose(float(hist["drag"][k, b]), float(ts.drag), rtol=MEMBER_GATE)
        np.testing.assert_allclose(float(hist["lift"][k, b]), float(ts.lift), rtol=MEMBER_GATE,
                                   atol=MEMBER_GATE * abs(float(ts.drag)))
    for got, want in zip(final.solution, ts.solution):
        assert float((got[b] - want).abs().max()) <= MEMBER_FIELD_GATE * float(want.abs().max())

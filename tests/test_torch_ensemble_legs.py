"""The ensemble's pressure legs, fixed inner solves and V-cycle smoothers,
batched, against the JAX package's ``vmap`` ensemble, the port's unbatched
step and the port's unbatched preconditioner, on the CPU.

* Combinations (d) FGMRES + blockTriangular + PCD, (e) FGMRES +
  blockTriangular + the mass leg with ``inner_mode="fixed"`` and the
  Chebyshev-Jacobi smoother, (f) FGMRES + blockTriangular +
  Cahouet-Chabard with the Schwarz smoother, all-f64, on 16x8 Q2/Q1 with
  the chain, B = 3, capped tangent solves: per step and member the Newton
  and Krylov counts equal, drag and lift rtol 1e-7, fields 1e-6
  (``tests/_ensemble_matrix.py``, which gives the caps and why).
* Member b of each against the unbatched ``make_time_step`` at nu_b
  (``check_members_match_unbatched``).
* One application of the batched unsteady preconditioner against the
  unbatched one on member b's linearization, for each leg, inner mode and
  smoother (mass, PCD, fixed, Chebyshev-Jacobi, Schwarz, and aSIMPLE's
  S-hat solve), from a seeded state: within 1e-12 of each block's
  magnitude (measured: 7e-14).  The operators are bitwise per member; the
  nested solves' batched inner products round differently.
* The batched Schwarz cell matrices are each member's own, bit for bit.
"""

import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu_torch.ops import Blocks, matfree
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig, make_preconditioner
from navier_stokes_solver_tpu_torch.precond.schwarz import _cell_matrices
from tests._ensemble_matrix import NUS, check_against_jax, check_members_match_unbatched, disc, run_combo

torch.set_num_threads(1)

LEG_COMBOS = ["d-fgmres-blocktri-pcd", "e-fgmres-blocktri-mass-fixed-jacobi", "f-fgmres-blocktri-cahouet-schwarz"]
INV_DT = 100.0
F64 = dict(vmult_dtype=None, mg_dtype=None)
# (block preconditioner, PrecondConfig fields) of one preconditioner application
LEGS = {
    "mass": (1, dict(schur_mode="mass")),
    "pcd": (1, dict(schur_mode="pcd")),
    "fixed-cahouet": (1, dict(schur_mode="cahouet", inner_mode="fixed")),
    "jacobi-blockdiag-mass": (0, dict(schur_mode="mass", mg_smoother="jacobi")),
    "schwarz-asimple": (2, dict(mg_smoother="schwarz")),
}


@pytest.fixture(scope="module")
def state():
    """16x8 Q2/Q1 with the chain, B = 3: a seeded state's linearization
    and a seeded source, batched."""
    d = disc()
    rng = np.random.default_rng(0)
    u = torch.tensor(0.3 * rng.standard_normal((3, 2) + d.NV)) * d.u_active
    p = torch.tensor(rng.standard_normal((3,) + d.NP)) * d.p_active
    linq = matfree.eval_state(d, Blocks(u, p))
    src = Blocks(torch.tensor(rng.standard_normal((3, 2) + d.NV)) * d.u_active,
                 torch.tensor(rng.standard_normal((3,) + d.NP)) * d.p_active)
    return d, u, linq, src


def _ctx(d, nu, linq, u):
    return LinearContext(disc=d, nu=nu, inv_dt=INV_DT, stokes=False, linq=linq,
                         diag_f=matfree.diag_F(d, nu, INV_DT, linq, stokes=False), state_u=u)


def _member(linq, b):
    return matfree.LinearizationQ(*(t[:, b].contiguous() for t in linq))


@pytest.mark.parametrize("name", LEG_COMBOS)
def test_combination_matches_jax(name):
    check_against_jax(*run_combo(name))


@pytest.mark.parametrize("name", LEG_COMBOS)
def test_members_match_the_unbatched_step(name):
    check_members_match_unbatched(name)


@pytest.mark.parametrize("leg", list(LEGS))
def test_batched_preconditioner_is_each_members_own(state, leg):
    d, u, linq, src = state
    kind, fields = LEGS[leg]
    cfg = PrecondConfig(**F64, **fields)
    out = make_preconditioner(kind, _ctx(d, torch.tensor(NUS), linq, u), variant="unsteady", cfg=cfg)(src)
    for b, nu in enumerate(NUS):
        one = make_preconditioner(kind, _ctx(d, nu, _member(linq, b), u[b]), variant="unsteady", cfg=cfg)(
            Blocks(src.u[b], src.p[b]))
        for got, want in zip(out, one):
            assert float((got[b] - want).abs().max()) <= 1e-12 * float(want.abs().max()), (leg, b)


def test_batched_schwarz_cell_matrices_are_each_members_own(state):
    d, _, linq, _ = state
    A = _cell_matrices(d, torch.tensor(NUS), INV_DT, linq, stokes=False)
    assert A.shape == (3, d.ny, d.nx, 18, 18)
    for b, nu in enumerate(NUS):
        assert torch.equal(A[b], _cell_matrices(d, nu, INV_DT, _member(linq, b), stokes=False))

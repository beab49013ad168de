"""The ensemble's solvers and block preconditioners -- BiCGStab,
blockDiagonal, aSIMPLE -- batched, against the JAX package's ``vmap``
ensemble and against the port's unbatched step, on the CPU.

* The JAX package's own ensemble call (tests/test_ensemble.py: FGMRES +
  aSIMPLE, the default ``PrecondConfig``, 16x8 Q2/Q1 without a chain,
  nus [0.05, 0.1], two steps, tol 1e-9) in both packages, and the port's
  default call ``run_sweep(disc, nus, dt, n)`` (one step) against the JAX
  package's with the same arguments: drag within the JAX test's rtol 1e-6
  / atol 2e-9, Newton counts within 1, Krylov totals within 20%.  These
  are whole solves of 50-1,000 iterations with the f32 preconditioner,
  which the two packages round differently, and such solves are chaotic:
  on the JAX test's call the port's unbatched step ends 1-15 iterations
  (up to 13%) from the JAX package's unbatched step, the batched ones 1-4;
  on the default call the totals are 4% and 8% apart (measured).
* Combinations (a) FGMRES + aSIMPLE, (b) GMRES + blockDiagonal + the mass
  leg, (c) BiCGStab + blockTriangular + Cahouet-Chabard, all-f64, on 16x8
  Q2/Q1 with the chain, B = 3, capped tangent solves: per step and member
  the Newton and Krylov counts equal, drag and lift rtol 1e-7, fields 1e-6
  (``tests/_ensemble_matrix.py``, which gives the caps and why).
* Member b of each against the unbatched ``make_time_step`` at nu_b
  (``check_members_match_unbatched``).  (b) in the unsteady variant stops
  on the fused step's stagnation break in both packages: the inner solves
  to an absolute 1e-1 (the reference's, NSSolver.hpp:154-176) return zero
  once the residual's blocks are below it, so the left-preconditioned
  residual is zero and GMRES takes no iteration.
* ``bicgstab_batched`` on a synthetic [B] system against ``bicgstab`` per
  member: member 0's operator is skew-symmetric and its right-hand side
  lies in a subspace the operator maps onto its complement, so
  <rbar, A rbar> is exactly 0 and it breaks down at iteration 1 -- failed,
  frozen at its start -- while the others converge to the unbatched
  iterates.
"""

import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.ensemble import run_sweep
from navier_stokes_solver_tpu_torch.krylov import bicgstab, bicgstab_batched
from tests._ensemble_matrix import (
    DT,
    check_against_jax,
    check_members_match_unbatched,
    disc,
    jax_disc,
    jax_steps,
    run_combo,
)

torch.set_num_threads(1)

SOLVER_COMBOS = ["a-fgmres-asimple", "b-gmres-blockdiag-mass", "c-bicgstab-blocktri-cahouet"]


def _whole_runs_agree(jsteps, hist):
    """The JAX test's drag gate (rtol 1e-6 / atol 2e-9), Newton counts
    within 1, Krylov totals within 20%."""
    assert np.all(np.isfinite(hist["drag"])) and len(hist["drag"]) == len(jsteps)
    for k, js in enumerate(jsteps):
        np.testing.assert_allclose(hist["drag"][k], js.drag, rtol=1e-6, atol=2e-9)
        got, want = hist["newton_iters"][k].astype(int), js.stats.newton_iters.astype(int)
        assert np.abs(got - want).max() <= 1, (k, got, want)
        got, want = hist["krylov_iters"][k], js.stats.krylov_iters
        assert np.all(np.abs(got - want) <= 0.2 * want), (k, got, want)


def test_the_jax_ensemble_test_call_runs_in_both_packages():
    nus = [0.05, 0.1]
    kw = dict(solver_type=1, prec_type=2, tol=1e-9, newton_max=3, krylov_maxiter=200)
    jsteps = jax_steps(jax_disc(chain=False), nus, 2, JCfg(), **kw)
    _, hist = run_sweep(disc(chain=False), nus, DT, 2, **kw)
    hist = {k: v.numpy() for k, v in hist.items()}
    assert hist["drag"].shape == (2, 2)
    _whole_runs_agree(jsteps, hist)


def test_the_default_call_matches_jax():
    nus = [0.05, 0.1]
    jsteps = jax_steps(jax_disc(chain=False), nus, 1, JCfg())
    _, hist = run_sweep(disc(chain=False), nus, DT, 1)
    _whole_runs_agree(jsteps, {k: v.numpy() for k, v in hist.items()})


@pytest.mark.parametrize("name", SOLVER_COMBOS)
def test_combination_matches_jax(name):
    check_against_jax(*run_combo(name))


@pytest.mark.parametrize("name", SOLVER_COMBOS)
def test_members_match_the_unbatched_step(name):
    check_members_match_unbatched(name)


def test_bicgstab_batched_freezes_a_broken_down_member():
    rng = np.random.default_rng(3)
    B, n, h = 3, 40, 20
    A = np.stack([np.eye(n) * (4.0 + b) + 0.5 * rng.standard_normal((n, n)) for b in range(B)])
    K = rng.standard_normal((h, h))
    A[0] = 0.0
    A[0, h:, :h], A[0, :h, h:] = K, -K.T  # skew-symmetric, maps [:h] onto [h:]
    b = rng.standard_normal((B, n))
    b[0, h:] = 0.0
    A_t, b_t = torch.tensor(A), torch.tensor(b)
    diag = np.einsum("bii->bi", A).copy()
    diag[0] = 1.0  # member 0: no preconditioner (its diagonal is zero)
    dinv = torch.tensor(1.0 / diag)
    mv = lambda x: torch.bmm(A_t, x[:, :, None])[:, :, 0]
    x, info = bicgstab_batched(mv, b_t, torch.zeros_like(b_t), tol=1e-10, maxiter=100, M=lambda r: dinv * r)
    assert info.failed.tolist() == [True, False, False]
    assert info.iters[0] == 1 and not info.converged[0]
    assert torch.equal(x[0], torch.zeros(n, dtype=x.dtype))  # frozen at its start
    assert info.resnorm[0] == pytest.approx(float(np.linalg.norm(b[0])), rel=1e-14)
    for m in (1, 2):
        xm, im = bicgstab(lambda v: A_t[m] @ v, b_t[m], torch.zeros(n, dtype=torch.float64), tol=1e-10,
                          maxiter=100, M=lambda r: dinv[m] * r)
        assert im.converged and not im.failed and info.converged[m]
        assert info.iters[m] == im.iters
        np.testing.assert_allclose(x[m].numpy(), xm.numpy(), rtol=1e-12, atol=1e-12 * float(xm.abs().max()))
        assert info.resnorm[m] <= 1e-10 and im.resnorm <= 1e-10

"""The port's Krylov solvers against the JAX package on the systems of
``tests/test_krylov.py``: equal iteration counts, solutions to 1e-10.

Same matrices and right-hand sides (numpy, seeded) on both sides; the two
packages orthogonalize and reduce in a different summation order, so the
solutions agree to rounding, not bitwise (atol 1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu import krylov as jk
from navier_stokes_solver_tpu_torch import krylov as tk
from navier_stokes_solver_tpu_torch.ops import Blocks

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

ATOL = 1e-10


def _system(n=40, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n) if spd else A + n * np.eye(n)
    return A, rng.standard_normal(n)


def _both(name, A, b, x0=None, **kw):
    """Run solver ``name`` in both packages on A x = b; returns the infos
    and solutions."""
    x0 = np.zeros_like(b) if x0 is None else x0
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    jM = tM = None
    if kw.pop("jacobi", False):
        jM = lambda x, d=1.0 / jnp.diag(jA): d * x
        tM = lambda x, d=1.0 / torch.diag(tA): d * x
    jx, ji = getattr(jk, name)(lambda x: jA @ x, jnp.asarray(b), jnp.asarray(x0), M=jM, **kw)
    tx, ti = getattr(tk, name)(lambda x: tA @ x, torch.as_tensor(b), torch.as_tensor(x0), M=tM, **kw)
    return ji, ti, np.asarray(jx), tx.numpy()


def _check(ji, ti, jx, tx):
    assert ti.iters == int(ji.iters)
    assert ti.converged == bool(ji.converged)
    assert ti.failed == bool(ji.failed)
    np.testing.assert_allclose(tx, jx, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gmres", "fgmres"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_gmres_family(name, jacobi):
    A, b = _system(n=80 if jacobi else 40, seed=1 if jacobi else 0)
    out = _both(name, A, b, tol=1e-10 if not jacobi else 1e-9, maxiter=500, jacobi=jacobi)
    _check(*out)
    assert out[1].converged and out[1].iters > 0


@pytest.mark.parametrize("name", ["gmres", "fgmres"])
def test_gmres_restarts(name):
    A, b = _system(n=60, seed=3)
    out = _both(name, A, b, tol=1e-9, maxiter=2000, basis=8)
    _check(*out)
    assert out[1].iters > 8  # crossed restarts


@pytest.mark.parametrize("name", ["gmres", "fgmres"])
def test_gmres_maxiter_stop(name):
    A, b = _system(n=60, seed=3)
    out = _both(name, A, b, tol=1e-30, maxiter=37, basis=8)
    _check(*out)
    assert out[1].iters == 37 and not out[1].converged


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_cg(jacobi):
    A, b = _system(spd=True)
    out = _both("cg", A, b, tol=1e-10, maxiter=500, jacobi=jacobi)
    _check(*out)
    assert out[1].converged


@pytest.mark.parametrize("name", ["gmres", "fgmres", "cg"])
def test_zero_initial_residual_reports_zero_iters(name):
    A, x_ref = _system(spd=True)
    out = _both(name, A, A @ x_ref, x0=x_ref, tol=1e-6, maxiter=50)
    _check(*out)
    assert out[1].iters == 0 and out[1].converged


@pytest.mark.parametrize("name", ["gmres", "fgmres"])
def test_gmres_ir_low_cycles(name):
    """GMRES-IR: f32 restart cycles with f64 restart residuals reach f64
    tolerances in the same number of iterations in both packages."""
    A, b = _system(n=60, seed=3)
    jlo = jk.LowCycle(matvec=lambda x, A32=jnp.asarray(A, jnp.float32): A32 @ x,
                      dtype=jnp.float32)
    tlo = tk.LowCycle(matvec=lambda x, A32=torch.as_tensor(A).float(): A32 @ x,
                      dtype=torch.float32)
    jx, ji = getattr(jk, name)(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                               jnp.zeros(60), tol=1e-12, maxiter=500, basis=20, lo=jlo)
    tx, ti = getattr(tk, name)(lambda x: torch.as_tensor(A) @ x, torch.as_tensor(b),
                               torch.zeros(60, dtype=torch.float64), tol=1e-12,
                               maxiter=500, basis=20, lo=tlo)
    _check(ji, ti, np.asarray(jx), tx.numpy())
    assert ti.converged
    assert np.linalg.norm(b - A @ tx.numpy()) <= 1.2e-12


def test_block_vectors():
    """Solvers run over (u, p) block vectors, as the Newton solves do."""
    A, b = _system(n=30, seed=2)
    split = 12
    tA = torch.as_tensor(A)

    def mv(t):
        y = tA @ torch.cat([t.u, t.p])
        return Blocks(y[:split], y[split:])

    tb = torch.as_tensor(b)
    x, info = tk.fgmres(mv, Blocks(tb[:split], tb[split:]),
                        Blocks(torch.zeros(split, dtype=torch.float64),
                               torch.zeros(30 - split, dtype=torch.float64)),
                        tol=1e-10, maxiter=500)
    jx, ji = jk.fgmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), jnp.zeros(30),
                       tol=1e-10, maxiter=500)
    assert info.iters == int(ji.iters) and info.converged
    np.testing.assert_allclose(torch.cat([x.u, x.p]).numpy(), np.asarray(jx), atol=ATOL, rtol=0)

"""blockDiagonal, aSIMPLE, the fixed inner mode, BiCGStab and the
Jacobi/Schwarz velocity smoothers of the port against the JAX package,
with the same inputs (numpy, seeded).

Operators and sweeps at 16x8 Q3/Q2 in f64 (``vmult_dtype=None``,
``mg_dtype=None``): the vmults to 1e-10 of the largest entry (nested
Krylov solves with data-dependent iteration counts pass the summation-order
rounding on), the V-cycles to 1e-12 (a fixed sequence of operations),
BiCGStab's iterates to 1e-12 with equal iteration counts and breakdown
flags.  The power iterations of the Chebyshev windows start from the JAX
package's ``PRNGKey(7)`` vector, substituted at ``_lmax_start``.

Tangent solves (``solve_kernel``: the Krylov method, the preconditioner
and the initial-guess projection) for every solver and preconditioner
family, capped inside the stretch of iterations where the two packages'
trajectories agree; whole solves are compared in ``test_torch_cli.py``
(BASELINE config 1 at 16x8, and the ``--direct`` path count for count).
Long solves under inexact inner solves are chaotic -- rounding differences
grow until the stopping iteration moves -- so they do not give equal counts
(``test_tangent_solves``); ``scripts/torch_whole_solve_parity.py`` compares
their whole solves by distribution over perturbed starts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.krylov as jkry
import navier_stokes_solver_tpu.precond.blocks as jblocks
import navier_stokes_solver_tpu.precond.mg as jmg
import navier_stokes_solver_tpu_torch.krylov as tkry
import navier_stokes_solver_tpu_torch.precond.blocks as tblocks
import navier_stokes_solver_tpu_torch.precond.mg as tmg
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geo
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.ops import matfree as jmf
from navier_stokes_solver_tpu.precond import LinearContext as JCtx
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
from navier_stokes_solver_tpu_torch.ops import matfree as tmf
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

NU, INV_DT = 1.0 / 20.0, 100.0
F64 = dict(vmult_dtype=None, mg_dtype=None)
REGIMES = pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])


def _rel_close(got, want, rel):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (err, scale)


def _jax_start(shape, dtype, device):
    """The JAX package's power-iteration start vector, as a tensor."""
    v = jax.random.normal(jax.random.PRNGKey(7), tuple(shape), jnp.float64)
    return torch.tensor(np.asarray(v), device=device).to(dtype)


@pytest.fixture(autouse=True)
def _jax_lmax_start(monkeypatch):
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)


_CASE = {}


def _case():
    """(JAX disc, port disc, inputs) at 16x8 with the MG chain, built once."""
    if not _CASE:
        jd = jmg.attach_mg(j_make_disc(j_space(j_geo(16, 8), 3, 2)))
        td = tmg.attach_mg(
            make_disc(make_fe_space(make_channel_geometry(16, 8), 3, 2), torch.float64, "cpu")
        )
        rng = np.random.default_rng(13)
        a = dict(
            su=0.3 * rng.standard_normal((2,) + jd.NV),
            sp=rng.standard_normal(jd.NP),
            bu=rng.standard_normal((2,) + jd.NV),
            bp=rng.standard_normal(jd.NP),
        )
        _CASE.update(jd=jd, td=td, a=a)
    return _CASE["jd"], _CASE["td"], _CASE["a"]


def _contexts(stokes, inv_dt=INV_DT, mg=True):
    jd, td, a = _case()
    if not mg:
        jd, td = jd.replace(mg=None), td.replace(mg=None)
    ju, tu = jnp.asarray(a["su"]), torch.as_tensor(a["su"])
    jlin = None if stokes else jmf.eval_state(jd, JBlocks(ju, jnp.asarray(a["sp"])))
    tlin = None if stokes else tmf.eval_state(td, Blocks(tu, torch.as_tensor(a["sp"])))
    jctx = JCtx(
        disc=jd, nu=NU, inv_dt=inv_dt, stokes=stokes, linq=jlin,
        diag_f=jmf.diag_F(jd, NU, inv_dt, jlin, stokes=stokes), state_u=None if stokes else ju,
    )
    tctx = LinearContext(
        disc=td, nu=NU, inv_dt=inv_dt, stokes=stokes, linq=tlin,
        diag_f=tmf.diag_F(td, NU, inv_dt, tlin, stokes=stokes), state_u=None if stokes else tu,
    )
    return jctx, tctx


def _vmult_close(kind, stokes, variant, cfg, rel=1e-10, mg=True):
    _, _, a = _case()
    inv_dt = INV_DT if variant == "unsteady" else 0.0
    jctx, tctx = _contexts(stokes, inv_dt, mg)
    cfg = {**F64, **cfg}
    jv = jblocks.make_preconditioner(kind, jctx, variant=variant, cfg=JCfg(**cfg))
    tv = tblocks.make_preconditioner(kind, tctx, variant=variant, cfg=PrecondConfig(**cfg))
    want = jv(JBlocks(jnp.asarray(a["bu"]), jnp.asarray(a["bp"])))
    got = tv(Blocks(torch.as_tensor(a["bu"]), torch.as_tensor(a["bp"])))
    assert got.u.dtype == got.p.dtype == torch.float64
    _rel_close(got.u, want.u, rel)
    _rel_close(got.p, want.p, rel)


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def test_bicgstab_iterates_counts_and_breakdown():
    """A nonsymmetric, diagonally dominant system (with and without a
    Jacobi preconditioner, to 1e-12, and capped by ``maxiter``), and a
    skew-symmetric one in small integers, where <rbar, A p> = 0 exactly
    breaks the first step down."""
    rng = np.random.default_rng(3)
    n = 40
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.3
    S = rng.integers(-2, 3, (n, n)).astype(np.float64)
    S = S - S.T
    b = rng.standard_normal(n)
    dinv = 1.0 / np.diag(A)
    cases = [
        (A, None, 1e-10, 100),
        (A, dinv, 1e-10, 100),
        (A, None, 1e-14, 3),
        (S, None, 1e-10, 100),
    ]
    for mat, d, tol, maxiter in cases:
        jM = None if d is None else (lambda r, _d=jnp.asarray(d): _d * r)
        tM = None if d is None else (lambda r, _d=torch.as_tensor(d): _d * r)
        rhs = np.round(4 * b) if mat is S else b
        jx, ji = jkry.bicgstab(
            lambda x: jnp.asarray(mat) @ x, jnp.asarray(rhs), jnp.zeros(n),
            tol=tol, maxiter=maxiter, M=jM,
        )
        tx, ti = tkry.bicgstab(
            lambda x: torch.as_tensor(mat) @ x, torch.as_tensor(rhs), torch.zeros(n),
            tol=tol, maxiter=maxiter, M=tM,
        )
        assert (ti.iters, ti.converged, ti.failed) == (int(ji.iters), bool(ji.converged), bool(ji.failed))
        jx = np.asarray(jx)
        np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-12 * max(1.0, np.abs(jx).max()))
        np.testing.assert_allclose(ti.resnorm, float(ji.resnorm), rtol=1e-10)
    assert ti.failed and ti.iters == 1  # the skew-symmetric case


# ---------------------------------------------------------------------------
# vmults
# ---------------------------------------------------------------------------


@REGIMES
def test_block_diagonal_vmult(stokes):
    """Both variants; in the Stokes regime also the point-Jacobi velocity
    leg of a disc without a multigrid chain (``multigrid=False``)."""
    for variant in ("stationary", "unsteady"):
        _vmult_close(0, stokes, variant, {})
    if stokes:
        _vmult_close(0, stokes, "stationary", {}, mg=False)


@REGIMES
def test_asimple_vmult(stokes):
    """Both variants; in the Stokes regime also the "mass" surrogate, the
    velocity tolerance override and the point-Jacobi velocity leg.  (The
    S-hat solve itself is ill-determined: tightened to rel 1e-3 the two
    packages' results part at 1e-7, so its tolerance stays the
    reference's 1e-1 here.)"""
    for variant in ("stationary", "unsteady"):
        _vmult_close(2, stokes, variant, {})
    if stokes:
        _vmult_close(2, stokes, "stationary", {"asimple_stokes_schur": "mass"})
        _vmult_close(2, stokes, "stationary", {"tri_rel_u_stokes": 1e-3})
        _vmult_close(2, stokes, "stationary", {}, mg=False)


def test_fixed_mode_vmults():
    """inner_mode="fixed": the three preconditioners (stationary, both regimes
    between them), and the unsteady fixed Cahouet-Chabard leg behind the
    Lp V-cycle and the PCD leg behind Chebyshev-Jacobi (no chain)."""
    for kind, stokes in ((0, True), (1, False), (2, True)):
        _vmult_close(kind, stokes, "stationary", {"inner_mode": "fixed"})
    _vmult_close(1, False, "unsteady", {"inner_mode": "fixed", "schur_mode": "cahouet"})
    _vmult_close(1, False, "unsteady", {"inner_mode": "fixed", "schur_mode": "pcd"}, mg=False)


# ---------------------------------------------------------------------------
# tangent solves
# ---------------------------------------------------------------------------


TANGENT = {  # id: (solver_type, prec_type, variant, stokes, maxiter)
    "gmres-blockdiag-stationary-newton": (0, 0, "stationary", False, 30),
    "fgmres-blockdiag-unsteady-newton": (1, 0, "unsteady", False, 30),
    "fgmres-asimple-unsteady-newton": (1, 2, "unsteady", False, 30),
    "bicgstab-blocktri-stationary-stokes": (2, 1, "stationary", True, 5),
    "bicgstab-asimple-unsteady-newton": (2, 2, "unsteady", False, 5),
}


@pytest.mark.parametrize("kind", ["krylov", "bicgstab"])
def test_tangent_solves(kind):
    """``solve_kernel`` -- the Krylov method, its preconditioner and the
    initial-guess projection together -- from a seeded state, capped at
    ``maxiter`` (tol 1e-14 stops none of them): equal iteration counts and
    flags, residual and iterate to 1e-10.  The cap keeps the comparison
    inside the stretch where the two packages' trajectories agree: with
    inexact inner solves (a nonlinear preconditioner) a 1e-15 rounding
    difference grows -- to 2e-8 of the iterate after 120 GMRES iterations
    of the 16x8 blockDiagonal Stokes solve, faster under BiCGStab
    (``scripts/torch_parity_drift.py``) -- and long solves end a few
    iterations apart."""
    from navier_stokes_solver_tpu.api import kernels as jk
    from navier_stokes_solver_tpu_torch.api import kernels as tk

    jd, td, a = _case()
    rng = np.random.default_rng(1)
    u = 0.3 * rng.standard_normal((2,) + jd.NV) * np.asarray(jd.u_active)
    p = rng.standard_normal(jd.NP) * np.asarray(jd.p_active)
    jst, tst = JBlocks(jnp.asarray(u), jnp.asarray(p)), Blocks(torch.as_tensor(u), torch.as_tensor(p))
    for name, (solver, prec, variant, stokes, n) in TANGENT.items():
        if (solver == 2) != (kind == "bicgstab"):
            continue
        inv_dt = INV_DT if variant == "unsteady" else 0.0
        kw = dict(stokes=stokes, solver_type=solver, prec_type=prec, variant=variant, maxiter=n)
        jr, _ = jk.assemble_kernel(jd, NU, inv_dt, jst, jst.u, 0.0, stokes=stokes)
        tr, _ = tk.assemble_kernel(td, NU, inv_dt, tst, tst.u, 0.0, stokes=stokes)
        jx, ji = jk.solve_kernel(jd, NU, inv_dt, jst, jr, jst, 0.0, 1e-14, precond_cfg=JCfg(**F64), **kw)
        tx, ti = tk.solve_kernel(td, NU, inv_dt, tst, tr, tst, 0.0, 1e-14, precond_cfg=PrecondConfig(**F64), **kw)
        assert (ti.iters, ti.converged, ti.failed) == (n, False, False) == (int(ji.iters), bool(ji.converged), bool(ji.failed)), name
        np.testing.assert_allclose(ti.resnorm, float(ji.resnorm), rtol=1e-10, err_msg=name)
        _rel_close(tx.u, jx.u, 1e-10)
        _rel_close(tx.p, jx.p, 1e-10)


# ---------------------------------------------------------------------------
# V-cycle smoothers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "smoother,stokes", [("jacobi", True), ("schwarz", False)], ids=["jacobi-stokes", "schwarz-newton"]
)
def test_vcycle_smoothers(smoother, stokes):
    """The Chebyshev-Jacobi V-cycle on the Stokes block (it diverges on the
    convection-dominated Newton block) and the Schwarz V-cycle on the
    Newton block, f64, to 1e-12."""
    jd, td, a = _case()
    jctx, tctx = _contexts(stokes, 0.0)
    kw = dict(stokes=stokes, smooth_degree=3, smoother=smoother)
    jM = jmg.make_mg_vcycle(jd, NU, 0.0, jctx.state_u, **kw)
    tM = tmg.make_mg_vcycle(td, NU, 0.0, tctx.state_u, **kw)
    _rel_close(tM(torch.as_tensor(a["bu"])), jM(jnp.asarray(a["bu"])), 1e-12)

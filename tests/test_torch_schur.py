"""The port's pressure-side operators and Schur-complement legs against the
JAX package, at 16x8 and 24x12 Q3/Q2 in f64, with the same inputs (numpy,
seeded): ``p_outlet_mask``, ``apply_Lp``, ``diag_Lp``, ``apply_Fp`` and
``apply_Mp_raw``; the pressure transfers of ``attach_mg``; the Chebyshev
smoother, the power-iteration spectral estimate and the pressure-Laplacian
V-cycle; the Cahouet-Chabard and PCD pressure solvers; the unsteady
blockTriangular sweep.

The power iteration starts from a random vector.  The port draws it from a
seeded ``torch.Generator`` (``precond.mg._lmax_start``), the JAX package
from ``PRNGKey(7)``: the tests give the port JAX's vector.

Tolerances, relative to the largest entry of the JAX result: 1e-12 where
the computation is a fixed sequence of operations (operators, smoother,
estimate, one V-cycle), 1e-10 where nested Krylov solves with
data-dependent iteration counts pass the rounding on (the pressure solvers,
the sweep).  The pressure transfers are host tables: exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.precond.blocks as jblocks
import navier_stokes_solver_tpu.precond.mg as jmg
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
MESHES = [(16, 8), (24, 12)]
BY_MESH = pytest.mark.parametrize("mesh", MESHES, ids=["16x8", "24x12"])
F64 = dict(vmult_dtype=None, mg_dtype=None)


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


_CASES = {}
_LMAX_START = tmg._lmax_start


def _case(mesh):
    """(JAX disc, port disc, inputs) at one mesh, both with the MG chain,
    built once per module."""
    if mesh not in _CASES:
        jd = jmg.attach_mg(j_make_disc(j_space(j_geo(*mesh), 3, 2)))
        td = tmg.attach_mg(
            make_disc(make_fe_space(make_channel_geometry(*mesh), 3, 2), torch.float64, "cpu")
        )
        rng = np.random.default_rng(11)
        a = dict(
            su=0.3 * rng.standard_normal((2,) + jd.NV),
            sp=rng.standard_normal(jd.NP),
            bu=rng.standard_normal((2,) + jd.NV),
            bp=rng.standard_normal(jd.NP),
        )
        _CASES[mesh] = (jd, td, a)
    return _CASES[mesh]


def _contexts(mesh, stokes):
    jd, td, a = _case(mesh)
    ju, tu = jnp.asarray(a["su"]), torch.as_tensor(a["su"])
    jlin = None if stokes else jmf.eval_state(jd, JBlocks(ju, jnp.asarray(a["sp"])))
    tlin = None if stokes else tmf.eval_state(td, Blocks(tu, torch.as_tensor(a["sp"])))
    jctx = JCtx(
        disc=jd, nu=NU, inv_dt=INV_DT, stokes=stokes, linq=jlin,
        diag_f=jmf.diag_F(jd, NU, INV_DT, jlin, stokes=stokes), state_u=None if stokes else ju,
    )
    tctx = LinearContext(
        disc=td, nu=NU, inv_dt=INV_DT, stokes=stokes, linq=tlin,
        diag_f=tmf.diag_F(td, NU, INV_DT, tlin, stokes=stokes), state_u=None if stokes else tu,
    )
    return jctx, tctx


@BY_MESH
def test_pressure_operators(mesh):
    jd, td, a = _case(mesh)
    jlin = jmf.eval_state(jd, JBlocks(jnp.asarray(a["su"]), jnp.asarray(a["sp"])))
    tlin = tmf.eval_state(td, Blocks(torch.as_tensor(a["su"]), torch.as_tensor(a["sp"])))
    jx, tx = jnp.asarray(a["bp"]), torch.as_tensor(a["bp"])
    np.testing.assert_array_equal(tmf.p_outlet_mask(td).numpy(), np.asarray(jmf.p_outlet_mask(jd)))
    pairs = [
        (tmf.apply_Lp(td, tx), jmf.apply_Lp(jd, jx)),
        (tmf.diag_Lp(td), jmf.diag_Lp(jd)),
        (tmf.apply_Mp_raw(td, tx), jmf.apply_Mp_raw(jd, jx)),
        (tmf.apply_Fp(td, NU, INV_DT, tlin, tx), jmf.apply_Fp(jd, NU, INV_DT, jlin, jx)),
        (tmf.apply_Fp(td, NU, 0.0, None, tx), jmf.apply_Fp(jd, NU, 0.0, None, jx)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float64
        _rel_close(got, want, 1e-12)


def test_pressure_transfers_equal():
    for mesh in MESHES:
        jd, td, _ = _case(mesh)
        assert jd.mg is not None
        while jd.mg is not None:
            for name in ("Ppx", "Ppy"):
                np.testing.assert_array_equal(
                    getattr(td.mg, name).numpy(), np.asarray(getattr(jd.mg, name))
                )
            td, jd = td.mg.coarse, jd.mg.coarse
        assert td.mg is None


@BY_MESH
def test_estimate_lmax_and_chebyshev(mesh, monkeypatch):
    # the port's own start vector: seeded, and the same in both dtypes
    a = _LMAX_START((5, 7), torch.float64, "cpu")
    assert a.shape == (5, 7) and a.dtype == torch.float64
    assert torch.equal(a, _LMAX_START((5, 7), torch.float64, "cpu"))
    assert torch.equal(_LMAX_START((5, 7), torch.float32, "cpu"), a.to(torch.float32))
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)
    jd, td, a = _case(mesh)
    jA = lambda x: jmf.apply_Lp(jd, x)
    tA = lambda x: tmf.apply_Lp(td, x)
    jdinv, tdinv = 1.0 / jmf.diag_Lp(jd), 1.0 / tmf.diag_Lp(td)
    jl = jmg._estimate_lmax(jA, jdinv, jd.NP, jnp.float64)
    tl = tmg._estimate_lmax(tA, tdinv, td.NP, torch.float64, "cpu")
    _rel_close(tl, jl, 1e-12)
    jb, tb = jnp.asarray(a["bp"]), torch.as_tensor(a["bp"])
    coeffs = tmg._chebyshev_coeffs(tl, 3)
    for x0 in (None, np.zeros_like(a["bp"]), a["sp"]):  # None: the zero start
        want = jmg._chebyshev(jA, jdinv, jl, jb, jnp.asarray(0.0 * a["sp"] if x0 is None else x0), 3)
        got = tmg._chebyshev(tA, tdinv, coeffs, tb, None if x0 is None else torch.as_tensor(x0))
        _rel_close(got, want, 1e-12)


@BY_MESH
def test_lp_vcycle(mesh, monkeypatch):
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)
    jd, td, a = _case(mesh)
    want = jmg.make_lp_vcycle(jd)(jnp.asarray(a["bp"]))
    got = tmg.make_lp_vcycle(td)(torch.as_tensor(a["bp"]))
    _rel_close(got, want, 1e-12)


P_SOLVERS = {
    "cahouet-nested": dict(schur_mode="cahouet"),
    "cahouet-1-cycle": dict(schur_mode="cahouet", cc_lp_cycles=1),
    "pcd": dict(schur_mode="pcd"),
}


@pytest.mark.parametrize("name", list(P_SOLVERS))
def test_p_solver(name, monkeypatch):
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)
    _, _, a = _case(MESHES[0])
    jctx, tctx = _contexts(MESHES[0], stokes=False)
    cfg = {**F64, **P_SOLVERS[name]}
    jsolve = jblocks._make_p_solver(jctx, JCfg(**cfg))
    tsolve = tblocks._make_p_solver(tctx, PrecondConfig(**cfg))
    tol = 1e-5 * float(np.linalg.norm(a["bp"]))
    want = jsolve(jnp.asarray(a["bp"]), tol)
    got = tsolve(torch.as_tensor(a["bp"]), tol)
    _rel_close(got, want, 1e-10)


@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
def test_unsteady_block_triangular_vmult(stokes, monkeypatch):
    """The unsteady sweep (rel 1e-4 / 1e-5) with the Cahouet-Chabard leg;
    in the Stokes regime the leg is the mass solve."""
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)
    _, _, a = _case(MESHES[0])
    jctx, tctx = _contexts(MESHES[0], stokes)
    cfg = {**F64, "schur_mode": "cahouet", "cc_lp_cycles": 1}
    jv = jblocks.make_preconditioner(1, jctx, variant="unsteady", cfg=JCfg(**cfg))
    tv = tblocks.make_preconditioner(1, tctx, variant="unsteady", cfg=PrecondConfig(**cfg))
    want = jv(JBlocks(jnp.asarray(a["bu"]), jnp.asarray(a["bp"])))
    got = tv(Blocks(torch.as_tensor(a["bu"]), torch.as_tensor(a["bp"])))
    _rel_close(got.u, want.u, 1e-10)
    _rel_close(got.p, want.p, 1e-10)

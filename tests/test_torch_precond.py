"""The port's multigrid V-cycle and blockTriangular preconditioner against
the JAX package at 16x8 Q3/Q2, in both regimes, with the same inputs (numpy,
seeded).

Tolerances: in f64 (``mg_dtype=None, vmult_dtype=None``) the two packages
run the same algorithm -- including the data-dependent inner iteration
counts -- and differ only in summation order: 1e-10 relative to the
largest entry.  In f32 (the production setting) rounding differences of
~1e-7 pass through the inner Krylov solves: 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geo
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.ops import matfree as jmf
from navier_stokes_solver_tpu.precond import LinearContext as JCtx
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond import attach_mg as j_attach_mg
from navier_stokes_solver_tpu.precond import make_krylov_lo as j_make_krylov_lo
from navier_stokes_solver_tpu.precond import make_mg_vcycle as j_vcycle
from navier_stokes_solver_tpu.precond import make_preconditioner as j_make_prec
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
from navier_stokes_solver_tpu_torch.ops import matfree as tmf
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig
from navier_stokes_solver_tpu_torch.precond import attach_mg, make_krylov_lo
from navier_stokes_solver_tpu_torch.precond import make_mg_vcycle, make_preconditioner

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

NU = 1.0 / 30.0
REL = {"f64": 1e-10, "f32": 1e-4}
REGIMES = pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
PRECISIONS = pytest.mark.parametrize("prec", ["f64", "f32"])


def _rel_close(got, want, rel):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    assert float(np.max(np.abs(got - want))) <= rel * scale


@pytest.fixture(scope="module")
def discs():
    jd = j_attach_mg(j_make_disc(j_space(j_geo(16, 8), 3, 2)))
    td = attach_mg(make_disc(make_fe_space(make_channel_geometry(16, 8), 3, 2), torch.float64, "cpu"))
    rng = np.random.default_rng(5)
    a = dict(
        su=0.3 * rng.standard_normal((2,) + jd.NV),
        sp=rng.standard_normal(jd.NP),
        bu=rng.standard_normal((2,) + jd.NV),
        bp=rng.standard_normal(jd.NP),
    )
    return jd, td, a


def _contexts(discs, stokes):
    jd, td, a = discs
    ju, tu = jnp.asarray(a["su"]), torch.as_tensor(a["su"])
    jlin = None if stokes else jmf.eval_state(jd, JBlocks(ju, jnp.asarray(a["sp"])))
    tlin = None if stokes else tmf.eval_state(td, Blocks(tu, torch.as_tensor(a["sp"])))
    jctx = JCtx(
        disc=jd, nu=NU, inv_dt=0.0, stokes=stokes, linq=jlin,
        diag_f=jmf.diag_F(jd, NU, 0.0, jlin, stokes=stokes), state_u=None if stokes else ju,
    )
    tctx = LinearContext(
        disc=td, nu=NU, inv_dt=0.0, stokes=stokes, linq=tlin,
        diag_f=tmf.diag_F(td, NU, 0.0, tlin, stokes=stokes), state_u=None if stokes else tu,
    )
    return jctx, tctx


@REGIMES
@PRECISIONS
def test_mg_vcycle(discs, stokes, prec):
    jd, td, a = discs
    jctx, tctx = _contexts(discs, stokes)
    jM = j_vcycle(
        jd, NU, 0.0, jctx.state_u, stokes=stokes, smooth_degree=3,
        dtype=None if prec == "f64" else jnp.float32,
    )
    tM = make_mg_vcycle(
        td, NU, 0.0, tctx.state_u, stokes=stokes, smooth_degree=3,
        dtype=None if prec == "f64" else torch.float32,
    )
    got = tM(torch.as_tensor(a["bu"]))
    assert got.dtype == torch.float64
    _rel_close(got, jM(jnp.asarray(a["bu"])), REL[prec])


@REGIMES
@PRECISIONS
def test_block_triangular_vmult(discs, stokes, prec):
    _, _, a = discs
    jctx, tctx = _contexts(discs, stokes)
    dt = None if prec == "f64" else "float32"
    kw = dict(mg_dtype=dt, vmult_dtype=dt, tri_rel_u_stokes=1e-4, tri_rel_p_stokes=1e-4)
    jv = j_make_prec(1, jctx, variant="stationary", cfg=JCfg(**kw))
    tv = make_preconditioner(1, tctx, cfg=PrecondConfig(**kw))
    want = jv(JBlocks(jnp.asarray(a["bu"]), jnp.asarray(a["bp"])))
    got = tv(Blocks(torch.as_tensor(a["bu"]), torch.as_tensor(a["bp"])))
    assert got.u.dtype == got.p.dtype == torch.float64
    _rel_close(got.u, want.u, REL[prec])
    _rel_close(got.p, want.p, REL[prec])


@REGIMES
def test_krylov_lo_cycle_operators(discs, stokes):
    """GMRES-IR cycle operators: the f32 Jacobian apply and the f32
    preconditioner of ``make_krylov_lo`` match the JAX package's."""
    _, _, a = discs
    jctx, tctx = _contexts(discs, stokes)
    cfg = dict(krylov_cycle_dtype="float32")
    jlo = j_make_krylov_lo(1, jctx, variant="stationary", cfg=JCfg(**cfg))
    tlo = make_krylov_lo(1, tctx, cfg=PrecondConfig(**cfg))
    assert tlo.dtype == torch.float32 and tlo.eta == jlo.eta and tlo.stall == jlo.stall
    jb = JBlocks(jnp.asarray(a["bu"], jnp.float32), jnp.asarray(a["bp"], jnp.float32))
    tb = Blocks(torch.as_tensor(a["bu"]).float(), torch.as_tensor(a["bp"]).float())
    for jf, tf in ((jlo.matvec, tlo.matvec), (jlo.M, tlo.M)):
        want, got = jf(jb), tf(tb)
        assert got.u.dtype == torch.float32
        _rel_close(got.u, want.u, REL["f32"])
        _rel_close(got.p, want.p, REL["f32"])
    assert make_krylov_lo(1, tctx, cfg=PrecondConfig()) is None


UNPORTED = [  # (kind, cfg, variant, ROADMAP item the message must name)
    (0, {"direct_lu": True}, "stationary", "A.D7"),
    (1, {"direct_lu": True}, "stationary", "A.D7"),
    (2, {"direct_lu": True}, "unsteady", "A.D7"),
    (1, {"krylov_cycle_dtype": "mixed"}, "stationary", "A.14"),
    (2, {"krylov_cycle_dtype": "mixed"}, "unsteady", "A.14"),
]


def test_unported_options_raise(discs):
    _, tctx = _contexts(discs, True)
    for kind, cfg, variant, match in UNPORTED:
        with pytest.raises(NotImplementedError, match=match):
            make_preconditioner(kind, tctx, variant=variant, cfg=PrecondConfig(**cfg))


def test_nonpositive_inner_tolerance_rejected(discs):
    _, tctx = _contexts(discs, True)
    for name in ("tri_rel_u_stokes", "tri_rel_p_stokes"):
        with pytest.raises(ValueError, match=name):
            make_preconditioner(1, tctx, cfg=PrecondConfig(**{name: 0.0}))

"""PyTorch port's matrix-free operators against the JAX package, in f64.

The same inputs, made with numpy from a seed, go through both packages.
Tolerance: rtol 1e-12 with an absolute floor of 1e-12 times the largest
entry of the reference output -- the two packages contract the same terms
in a different summation order, and entries that cancel to ~0 can only be
held relative to the operator's scale.  The lattice gather and scatter are
the same ordered sums and must agree bit for bit.
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
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
from navier_stokes_solver_tpu_torch.ops import matfree as tmf
from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

RTOL = 1e-12
NU, INV_DT = 0.05, 50.0


def _close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture(scope="module", params=[(3, 2), (2, 1)], ids=["Q3Q2", "Q2Q1"])
def case(request):
    deg = request.param
    jd = j_make_disc(j_space(j_geo(20, 9), *deg))
    td = make_disc(make_fe_space(make_channel_geometry(20, 9), *deg), torch.float64, "cpu")
    rng = np.random.default_rng(11)
    NV, NP = jd.NV, jd.NP
    a = dict(
        x_u=rng.standard_normal((2,) + NV),
        x_p=rng.standard_normal(NP),
        st_u=0.3 * rng.standard_normal((2,) + NV),
        st_p=rng.standard_normal(NP),
        old_u=0.3 * rng.standard_normal((2,) + NV),
    )
    j = {k: jnp.asarray(v) for k, v in a.items()}
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    jst = JBlocks(j["st_u"], j["st_p"])
    tst = Blocks(t["st_u"], t["st_p"])
    return dict(
        jd=jd, td=td, j=j, t=t, jst=jst, tst=tst,
        jlin=jmf.eval_state(jd, jst), tlin=tmf.eval_state(td, tst),
    )


def test_gather_scatter_bit_identical(case):
    jd, td = case["jd"], case["td"]
    k = jd.deg_v
    x = case["j"]["x_u"]
    g_j = jmf._gather(x, k, jd.ny, jd.nx)
    g_t = tmf._gather(case["t"]["x_u"], k, td.ny, td.nx)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    loc = np.random.default_rng(3).standard_normal(g_j.shape)
    s_j = jmf._scatter(jnp.asarray(loc), k, jd.ny, jd.nx)
    s_t = tmf._scatter(torch.as_tensor(loc), k, td.ny, td.nx)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    kp = jd.deg_p
    locp = np.random.default_rng(4).standard_normal(((kp + 1) ** 2, jd.ny, jd.nx))
    np.testing.assert_array_equal(
        tmf._scatter(torch.as_tensor(locp), kp, td.ny, td.nx).numpy(),
        np.asarray(jmf._scatter(jnp.asarray(locp), kp, jd.ny, jd.nx)),
    )


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("with_bc", [False, True], ids=["raw", "bc"])
def test_scatter_v_bc_bit_identical(case, with_bc, dtype_name):
    """apply_F's second step -- the ordered scatter and the boundary rows
    (on the CPU the plain version of ``scatter_v_bc``) -- against the JAX
    package's ``_scatter_v`` and the two ``where`` of its ``apply_F``, bit
    for bit."""
    jd, td = case["jd"], case["td"]
    rng = np.random.default_rng(5)
    loc = rng.standard_normal(((jd.deg_v + 1) ** 2, 2, jd.ny, jd.nx)).astype(dtype_name)
    x = np.asarray(case["j"]["x_u"]).astype(dtype_name)
    want = jmf._scatter_v(jd, jnp.asarray(loc))
    bc = None
    if with_bc:
        jbc = jmf.diag_F(jd, NU, INV_DT, case["jlin"], stokes=False)
        bc = np.asarray(jbc).astype(dtype_name)
        want = jnp.where(jd.u_dirichlet, jnp.asarray(bc) * jnp.asarray(x), want)
        want = jnp.where(jd.u_active, want, jnp.asarray(x))
    td = td.to(getattr(torch, dtype_name))
    got = scatter_v_bc(
        td, torch.as_tensor(loc),
        bc_diag=None if bc is None else torch.as_tensor(bc), x_u=torch.as_tensor(x),
    )
    assert got.dtype == getattr(torch, dtype_name) and want.dtype == np.dtype(dtype_name)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert scatter_v_bc.launches == 0  # the CPU never launches


def test_eval_state(case):
    for got, want in zip(case["tlin"], case["jlin"]):
        _close(got, want)


@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
@pytest.mark.parametrize("with_bc", [False, True], ids=["raw", "bc"])
def test_apply_F(case, stokes, with_bc):
    jd, td = case["jd"], case["td"]
    jlin = None if stokes else case["jlin"]
    tlin = None if stokes else case["tlin"]
    jbc = jmf.diag_F(jd, NU, INV_DT, jlin, stokes=stokes) if with_bc else None
    tbc = tmf.diag_F(td, NU, INV_DT, tlin, stokes=stokes) if with_bc else None
    want = jmf.apply_F(jd, NU, INV_DT, jlin, case["j"]["x_u"], stokes=stokes, bc_diag=jbc)
    got = tmf.apply_F(td, NU, INV_DT, tlin, case["t"]["x_u"], stokes=stokes, bc_diag=tbc)
    _close(got, want)


@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
def test_apply_B(case, stokes):
    _close(
        tmf.apply_B(case["td"], case["t"]["x_u"], stokes=stokes),
        jmf.apply_B(case["jd"], case["j"]["x_u"], stokes=stokes),
    )


@pytest.mark.parametrize("zero_rows", [False, True])
def test_apply_Bt(case, zero_rows):
    _close(
        tmf.apply_Bt(case["td"], case["t"]["x_p"], zero_dirichlet_rows=zero_rows),
        jmf.apply_Bt(case["jd"], case["j"]["x_p"], zero_dirichlet_rows=zero_rows),
    )


def test_apply_Mp_and_diag_Mp(case):
    _close(
        tmf.apply_Mp(case["td"], NU, case["t"]["x_p"]),
        jmf.apply_Mp(case["jd"], NU, case["j"]["x_p"]),
    )
    _close(tmf.diag_Mp(case["td"], NU), jmf.diag_Mp(case["jd"], NU))


@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
def test_diag_F(case, stokes):
    _close(
        tmf.diag_F(case["td"], NU, INV_DT, None if stokes else case["tlin"], stokes=stokes),
        jmf.diag_F(case["jd"], NU, INV_DT, None if stokes else case["jlin"], stokes=stokes),
    )


@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
def test_apply_jacobian(case, stokes):
    jd, td = case["jd"], case["td"]
    jlin = None if stokes else case["jlin"]
    tlin = None if stokes else case["tlin"]
    jbc = jmf.diag_F(jd, NU, INV_DT, jlin, stokes=stokes)
    tbc = tmf.diag_F(td, NU, INV_DT, tlin, stokes=stokes)
    want = jmf.apply_jacobian(
        jd, NU, INV_DT, jlin, jbc, JBlocks(case["j"]["x_u"], case["j"]["x_p"]), stokes=stokes
    )
    got = tmf.apply_jacobian(
        td, NU, INV_DT, tlin, tbc, Blocks(case["t"]["x_u"], case["t"]["x_p"]), stokes=stokes
    )
    _close(got.u, want.u)
    _close(got.p, want.p)


@pytest.mark.parametrize(
    "stokes,consistent",
    [(True, False), (False, False), (False, True)],
    ids=["stokes", "newton-reference-sign", "newton-consistent"],
)
def test_residual(case, stokes, consistent):
    jd, td = case["jd"], case["td"]
    jbc = jmf.diag_F(jd, NU, INV_DT, None if stokes else case["jlin"], stokes=stokes)
    tbc = tmf.diag_F(td, NU, INV_DT, None if stokes else case["tlin"], stokes=stokes)
    want = jmf.residual(
        jd, NU, INV_DT, case["jst"], case["j"]["old_u"], jbc,
        stokes=stokes, inlet_amp=0.3, consistent=consistent,
    )
    got = tmf.residual(
        td, NU, INV_DT, case["tst"], case["t"]["old_u"], tbc,
        stokes=stokes, inlet_amp=0.3, consistent=consistent,
    )
    _close(got.u, want.u)
    _close(got.p, want.p)


def test_dirichlet_values(case):
    _close(tmf.dirichlet_values(case["td"], 0.7), jmf.dirichlet_values(case["jd"], 0.7))


def test_lift_drag_forces(case):
    got = tmf.lift_drag_forces(case["td"], NU, case["tst"])
    want = jmf.lift_drag_forces(case["jd"], NU, case["jst"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)


def test_apply_F_fused_matches_unfused(case):
    """The port's apply_F (gather, cell apply, scatter) against its own
    separate eval/physics/project pipeline, both regimes."""
    td = case["td"]
    for stokes, lin in ((True, None), (False, case["tlin"])):
        _close(
            tmf.apply_F(td, NU, INV_DT, lin, case["t"]["x_u"], stokes=stokes),
            tmf._apply_F_unfused(td, NU, INV_DT, lin, case["t"]["x_u"], stokes=stokes),
        )

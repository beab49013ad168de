"""The port's one-launch velocity-block apply (``ops/apply_f_kernel.py``)
against the JAX package's ``apply_F``.

On the CPU ``apply_F_fused`` takes its plain version (the cell apply, then
the ordered scatter with the boundary rows); on the card ``chip_smoke.py``
holds the CUDA kernel against that plain version and, bit for bit, against
the two launches it replaced.  Here the same inputs, made with numpy from a
seed, go through both packages in f64 at 16x8 and at the odd 7x3 (a shape
that no cell tile divides), for velocity degrees 2 and 3, both regimes,
with and without the boundary rows, on a contiguous and on a permuted
(dense, non-contiguous) lattice, and with a member axis of B = 3, each
member with its own viscosity.

Tolerance: rtol 1e-12 with an absolute floor of 1e-12 times the largest
entry of the reference, as in ``tests/test_torch_ops.py``: the two
packages sum the same terms in a different order, and entries that cancel
to ~0 can only be held relative to the operator's scale.
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
from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import (
    BLOCK_SHAPES,
    SHAPE_BY_CELLS,
    apply_F_fused,
    block_shape,
    block_tile,
)
from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F
from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

TOL = 1e-12  # f64 rtol, and atol relative to the reference's largest entry
NU, INV_DT = 0.05, 50.0
MESHES = [(16, 8), (7, 3)]
DEGREES = [(3, 2), (2, 1)]
NUS = (1 / 20.0, 1 / 60.0, 1 / 100.0)  # B = 3 members


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _permuted(x):
    """``x`` in a dense layout with the last axis slowest, as a multigrid
    transfer's einsum hands it over."""
    n = x.dim()
    p = x.permute(n - 1, *range(n - 1)).contiguous().permute(*range(1, n), 0)
    assert not p.is_contiguous() and torch.equal(p, x)
    return p


def _case(mesh, deg, batch=None, seed=3):
    """Both packages' discs and, from one numpy draw, the lattice ``x`` and
    the linearization state, with a leading member axis when ``batch``."""
    jd = j_make_disc(j_space(j_geo(*mesh), *deg))
    td = make_disc(make_fe_space(make_channel_geometry(*mesh), *deg), torch.float64, "cpu")
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    a = dict(
        x=rng.standard_normal(lead + (2,) + jd.NV),
        st_u=0.3 * rng.standard_normal(lead + (2,) + jd.NV),
        st_p=rng.standard_normal(lead + jd.NP),
    )
    return jd, td, a


def _jax_apply(jd, nu, a, stokes, with_bc):
    """JAX ``apply_F`` on one run's arrays (``a`` without a member axis)."""
    lin = jmf.eval_state(jd, JBlocks(jnp.asarray(a["st_u"]), jnp.asarray(a["st_p"])))
    lin = None if stokes else lin
    bc = jmf.diag_F(jd, nu, INV_DT, lin, stokes=stokes) if with_bc else None
    return jmf.apply_F(jd, nu, INV_DT, lin, jnp.asarray(a["x"]), stokes=stokes, bc_diag=bc)


def _torch_apply(td, nu, a, stokes, with_bc, permute):
    lin = tmf.eval_state(td, Blocks(torch.as_tensor(a["st_u"]), torch.as_tensor(a["st_p"])))
    lin = None if stokes else lin
    bc = tmf.diag_F(td, nu, INV_DT, lin, stokes=stokes) if with_bc else None
    x = torch.as_tensor(a["x"])
    return apply_F_fused(td, nu, INV_DT, lin, _permuted(x) if permute else x, stokes=stokes, bc_diag=bc)


@pytest.mark.parametrize("deg", DEGREES, ids=["Q3Q2", "Q2Q1"])
def test_apply_F_fused_matches_jax(deg):
    """Unbatched: every shape, regime, boundary-row setting and layout."""
    for mesh in MESHES:
        jd, td, a = _case(mesh, deg)
        for stokes in (True, False):
            for with_bc in (False, True):
                want = _jax_apply(jd, NU, a, stokes, with_bc)
                for permute in (False, True):
                    _close(_torch_apply(td, NU, a, stokes, with_bc, permute), want)
    assert apply_F_fused.launches == 0  # the CPU never launches


@pytest.mark.parametrize("deg", DEGREES, ids=["Q3Q2", "Q2Q1"])
def test_apply_F_fused_members_match_jax(deg):
    """B = 3 members with per-member viscosities ([B] tensor) in one call,
    each against the JAX ``apply_F`` of its own run."""
    B = len(NUS)
    for mesh in MESHES:
        jd, td, a = _case(mesh, deg, batch=B)
        nus = torch.tensor(NUS, dtype=torch.float64)
        for stokes in (True, False):
            for with_bc, permute in ((False, True), (True, False), (True, True)):
                got = _torch_apply(td, nus, a, stokes, with_bc, permute)
                assert got.shape == (B, 2) + td.NV
                for b in range(B):
                    member = {k: v[b] for k, v in a.items()}
                    _close(got[b], _jax_apply(jd, NUS[b], member, stokes, with_bc))
    assert apply_F_fused.launches == 0


def test_matfree_apply_F_is_the_one_launch_route():
    """``ops.matfree.apply_F`` goes through ``apply_F_fused`` (bit for bit
    on the CPU, where both take the plain version) and never through the
    two kernels it replaced."""
    _, td, a = _case((7, 3), (3, 2))
    x = torch.as_tensor(a["x"])
    lin = tmf.eval_state(td, Blocks(torch.as_tensor(a["st_u"]), torch.as_tensor(a["st_p"])))
    bc = tmf.diag_F(td, NU, INV_DT, lin, stokes=False)
    for stokes in (True, False):
        for b in (None, bc):
            got = tmf.apply_F(td, NU, INV_DT, None if stokes else lin, x, stokes=stokes, bc_diag=b)
            want = apply_F_fused(td, NU, INV_DT, None if stokes else lin, x, stokes=stokes, bc_diag=b)
            assert torch.equal(got, want)
    assert apply_F_fused.launches == cell_apply_F.launches == scatter_v_bc.launches == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Every operand is checked before any launch: a wrong dtype, shape or
    device, a lattice with gaps, a non-contiguous ``bc_diag``, a missing
    linearization, a [B] ``nu`` of the wrong length."""
    _, td, a = _case((7, 3), (3, 2))
    x = torch.as_tensor(a["x"])
    lin = tmf.eval_state(td, Blocks(torch.as_tensor(a["st_u"]), torch.as_tensor(a["st_p"])))
    bc = tmf.diag_F(td, NU, INV_DT, lin, stokes=False)
    wide = torch.zeros((2, x.shape[1], x.shape[2] + 1), dtype=x.dtype)[:, :, : x.shape[2]]
    cases = [  # (nu, linq, x_u, bc_diag), what the error must name
        ((NU, lin, x.to(torch.float32), bc), "float32"),
        ((NU, lin, x[:, :-1], bc), "shape"),
        ((NU, lin, x.to("meta"), bc), "meta"),
        ((NU, lin, wide, bc), "strides"),
        ((NU, lin, x, _permuted(bc)), "contiguous"),
        ((NU, lin, x, bc[:, :-1]), "shape"),
        ((NU, None, x, bc), "linq"),
        ((torch.tensor(NUS, dtype=torch.float64), lin, x, bc), "shape"),
    ]
    for (nu, linq, x_u, b), match in cases:
        with pytest.raises(ValueError, match=match):
            apply_F_fused(td, nu, INV_DT, linq, x_u, stokes=False, bc_diag=b)
    assert apply_F_fused.launches == 0


def test_every_launch_gets_a_block_shape():
    """The shape table covers every cell count (its bands descend to 0)
    and names built shapes; each tile is its block's cells less the halo
    row and column."""
    for k, bands in SHAPE_BY_CELLS.items():
        least = [b for b, _ in bands]
        assert least == sorted(least, reverse=True) and least[-1] == 0
        for cells in (1, 450, 2_999, 3_000, 7_000, 14_999, 15_000, 20_000, 153_600):
            shape = block_shape(k, cells)
            assert shape == next(s for b, s in bands if cells >= b)
            rows, cols = BLOCK_SHAPES[k][shape]
            assert block_tile(k, shape) == (rows - 1, cols - 1)

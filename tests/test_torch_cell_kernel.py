"""The port's fused cell apply (``ops/cell_kernel.py``) against the JAX
package's Pallas kernel ``cell_apply_F_pallas``.

Both entry points are held against it: ``cell_apply_F`` on gathered DoFs
and ``cell_apply_F_lattice`` on the velocity lattice (the main path's).
On the CPU the wrappers take their plain PyTorch versions (the CUDA kernel
is compared with them on the card by ``chip_smoke.py``); the
Pallas kernel runs in interpret mode, as ``tests/test_pallas.py`` runs it.
Same inputs from a numpy seed on both sides.  Tolerances are those of
``tests/test_pallas.py``: f64 rtol = atol = 1e-12, f32 rtol = atol = 1e-5
(summation order differs between the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geo
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops import eval_state as j_eval_state
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.ops.matfree import _gather_v as j_gather_v
from navier_stokes_solver_tpu.ops.pallas_cell import cell_apply_F_pallas
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import Blocks, eval_state, make_disc
from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
    cell_apply_F,
    cell_apply_F_lattice,
    cell_apply_F_lattice_plain,
    cell_apply_F_plain,
)
from navier_stokes_solver_tpu_torch.ops.matfree import LinearizationQ, _gather_v

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

NU, INV_DT = 0.05, 50.0
TOL = {"float64": 1e-12, "float32": 1e-5}


def _j_cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype)
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
        else a,
        tree,
    )


def _inputs(deg, dtype_name, seed=1):
    jd = j_make_disc(j_space(j_geo(20, 9), *deg))
    td = make_disc(make_fe_space(make_channel_geometry(20, 9), *deg), torch.float64, "cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2,) + jd.NV)
    su = 0.3 * rng.standard_normal((2,) + jd.NV)
    sp = rng.standard_normal(jd.NP)
    jlin = j_eval_state(jd, JBlocks(jnp.asarray(su), jnp.asarray(sp)))
    tlin = eval_state(td, Blocks(torch.as_tensor(su), torch.as_tensor(sp)))
    jx = j_gather_v(jd, jnp.asarray(x))
    tx = _gather_v(td, torch.as_tensor(x))
    if dtype_name == "float32":
        jd, jlin, jx = _j_cast(jd, jnp.float32), _j_cast(jlin, jnp.float32), jx.astype(jnp.float32)
        td = td.to(torch.float32)
        tlin = LinearizationQ(*(t.to(torch.float32) for t in tlin))
        tx = tx.to(torch.float32)
    return jd, jlin, jx, td, tlin, tx


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])
@pytest.mark.parametrize("deg", [(2, 1), (3, 2)], ids=["Q2Q1", "Q3Q2"])
def test_cell_apply_matches_pallas(deg, stokes, dtype_name):
    jd, jlin, jx, td, tlin, tx = _inputs(deg, dtype_name)
    nu = float(np.asarray(NU, dtype_name))
    want = cell_apply_F_pallas(jd, nu, INV_DT, None if stokes else jlin, jx, stokes=stokes)
    before = cell_apply_F.launches
    got = cell_apply_F(td, nu, INV_DT, None if stokes else tlin, tx, stokes=stokes)
    assert cell_apply_F.launches == before == 0  # the CPU never launches
    assert got.dtype == getattr(torch, dtype_name) and got.shape == tx.shape
    tol = TOL[dtype_name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_cpu_tensor_takes_the_plain_version():
    _, _, _, td, tlin, tx = _inputs((3, 2), "float64")
    np.testing.assert_array_equal(
        cell_apply_F(td, NU, INV_DT, tlin, tx, stokes=False).numpy(),
        cell_apply_F_plain(td, NU, INV_DT, tlin, tx, stokes=False).numpy(),
    )
    assert cell_apply_F.launches == 0


NOT_TAKEN = [  # (what the wrapper is given, what its error must name)
    (lambda tlin, tx: (tlin, tx.to(torch.float32)), "float32"),  # dtype
    (lambda tlin, tx: (tlin, tx[:, :, :, :-1]), "shape"),
    (lambda tlin, tx: (tlin, tx.transpose(2, 3).contiguous().transpose(2, 3)), "contiguous"),
    (lambda tlin, tx: (None, tx), "linq"),
    (lambda tlin, tx: (tlin._replace(gradu=tlin.gradu.transpose(1, 2)), tx), "contiguous"),
]


def test_wrapper_rejects_what_the_kernel_does_not_take():
    td, tlin, tx = _inputs((3, 2), "float64")[3:]
    for mutate, match in NOT_TAKEN:
        with pytest.raises(ValueError, match=match):
            cell_apply_F(td, NU, INV_DT, *mutate(tlin, tx), stokes=False)
    assert cell_apply_F.launches == 0


def _lattice(td, seed=1):
    """The velocity lattice ``_inputs`` gathered (its first draw), in the
    dtype of ``td``."""
    x = np.random.default_rng(seed).standard_normal((2,) + td.NV)
    return torch.as_tensor(x).to(td.dtype)


def test_cell_apply_lattice_matches_pallas():
    """The main path's entry point (the lattice read in place; on the CPU
    its plain version) against the Pallas kernel on the JAX package's
    gathered DoFs, every variant."""
    for deg in ((2, 1), (3, 2)):
        for dtype_name in ("float64", "float32"):
            jd, jlin, jx, td, tlin, _ = _inputs(deg, dtype_name)
            x_u = _lattice(td)
            nu = float(np.asarray(NU, dtype_name))
            for stokes in (True, False):
                want = cell_apply_F_pallas(jd, nu, INV_DT, None if stokes else jlin, jx, stokes=stokes)
                got = cell_apply_F_lattice(td, nu, INV_DT, None if stokes else tlin, x_u, stokes=stokes)
                assert got.dtype == x_u.dtype and got.shape == tuple(jx.shape)
                tol = TOL[dtype_name]
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    assert cell_apply_F.launches == 0


def test_lattice_wrapper_rejects_foreign_strides():
    """The lattice entry point takes a dense lattice in any axis order (the
    multigrid transfers hand it permuted ones) and rejects views with gaps
    or overlaps, which the kernel's 32-bit offsets do not cover."""
    td, tlin = _inputs((3, 2), "float64")[3:5]
    x_u = _lattice(td)
    want = cell_apply_F_lattice_plain(td, NU, INV_DT, tlin, x_u, stokes=False)
    permuted = x_u.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert not permuted.is_contiguous()
    got = cell_apply_F_lattice(td, NU, INV_DT, tlin, permuted, stokes=False)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    wide = torch.zeros((2, x_u.shape[1], x_u.shape[2] + 1), dtype=x_u.dtype)
    foreign = [
        wide[:, :, : x_u.shape[2]],  # a gap after every row
        x_u[:1].expand_as(x_u),  # both components on one memory
        torch.zeros((2, x_u.shape[1], 2 * x_u.shape[2]), dtype=x_u.dtype)[:, :, ::2],
    ]
    for view in foreign:
        assert view.shape == x_u.shape
        with pytest.raises(ValueError, match="strides"):
            cell_apply_F_lattice(td, NU, INV_DT, tlin, view, stokes=False)
    assert cell_apply_F.launches == 0

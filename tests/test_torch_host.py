"""PyTorch port's host layer against the JAX package: element tables, the
channel geometry and FE space, the lowered ``Disc`` tensors, the multigrid
hierarchy, and ``disc_from_numpy``.

All of it is computed on the host in float64 from the same NumPy code, so
the comparisons are exact (``assert_array_equal``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.elements import make_taylor_hood as j_tables
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geo
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.precond.mg import attach_mg as j_attach_mg
from navier_stokes_solver_tpu.precond.mg import mg_level_shapes as j_levels
from navier_stokes_solver_tpu_torch.elements import make_taylor_hood
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops import disc_from_numpy, make_disc
from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, mg_level_shapes

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

DEGREES = pytest.mark.parametrize("deg", [(3, 2), (2, 1)], ids=["Q3Q2", "Q2Q1"])
DISC_ARRAYS = (
    "cell_mask", "u_active", "p_active", "u_dirichlet", "u_inlet",
    "inlet_profile1", "neumann_rhs1", "cyl_face_mask",
)


def _eq(a, b):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def _jax_leaves(d):
    """A JAX Disc (with its MG chain) as a dict of Python scalars / numpy."""
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if f.name == "mg" and v is not None:
            v = {
                g.name: (_jax_leaves(getattr(v, g.name)) if g.name == "coarse"
                         else None if getattr(v, g.name) is None
                         else np.asarray(getattr(v, g.name)))
                for g in dataclasses.fields(v)
            }
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


@DEGREES
def test_element_tables_equal(deg):
    a, b = make_taylor_hood(*deg), j_tables(*deg)
    for f in dataclasses.fields(b):
        _eq(getattr(a, f.name), getattr(b, f.name))


@DEGREES
def test_geometry_and_space_equal(deg):
    ta, ja = make_fe_space(make_channel_geometry(20, 9), *deg), j_space(j_geo(20, 9), *deg)
    for name in ("cell_active", "cell_ring", "face_id"):
        _eq(getattr(ta.geo, name), getattr(ja.geo, name))
    for name in ("x_v", "y_v", "x_p", "y_p", "u_active", "p_active", "u_dirichlet", "u_inlet"):
        _eq(getattr(ta, name), getattr(ja, name))
    assert (ta.NVx, ta.NVy, ta.NPx, ta.NPy) == (ja.NVx, ja.NVy, ja.NPx, ja.NPy)
    assert ta.n_dofs == ja.n_dofs


@DEGREES
def test_disc_arrays_equal(deg):
    td = make_disc(make_fe_space(make_channel_geometry(20, 9), *deg), torch.float64, "cpu")
    jd = j_make_disc(j_space(j_geo(20, 9), *deg))
    assert (td.nx, td.ny, td.deg_v, td.deg_p, td.n_q1d) == (jd.nx, jd.ny, jd.deg_v, jd.deg_p, jd.n_q1d)
    assert (td.hx, td.hy, td.NV, td.NP) == (jd.hx, jd.hy, jd.NV, jd.NP)
    for name in DISC_ARRAYS:
        _eq(getattr(td, name), getattr(jd, name))
    assert td.dtype == torch.float64 and td.device.type == "cpu"


def test_bench_dof_count():
    space = make_fe_space(make_channel_geometry(100, 70), 3, 2)
    assert space.n_dofs == 154_244
    assert space.n_dofs == j_space(j_geo(100, 70), 3, 2).n_dofs


@pytest.mark.parametrize("mesh,deg", [((100, 70), (3, 2)), ((64, 24), (2, 1))])
def test_mg_hierarchy_equal(mesh, deg):
    td = attach_mg(make_disc(make_fe_space(make_channel_geometry(*mesh), *deg), torch.float64, "cpu"))
    jd = j_attach_mg(j_make_disc(j_space(j_geo(*mesh), *deg)))
    assert mg_level_shapes(td) == j_levels(jd)
    assert len(mg_level_shapes(td)) >= 3
    while jd.mg is not None:
        for name in ("Pvx", "Pvy", "Evx", "Evy"):
            _eq(getattr(td.mg, name), getattr(jd.mg, name))
        td, jd = td.mg.coarse, jd.mg.coarse
        for name in DISC_ARRAYS:
            _eq(getattr(td, name), getattr(jd, name))
    assert td.mg is None


def test_disc_from_numpy_round_trip():
    jd = j_attach_mg(j_make_disc(j_space(j_geo(32, 12), 3, 2)))
    td = disc_from_numpy(_jax_leaves(jd), device="cpu")
    assert mg_level_shapes(td) == j_levels(jd)
    while True:
        assert (td.nx, td.ny, td.hx, td.hy) == (jd.nx, jd.ny, jd.hx, jd.hy)
        for name in DISC_ARRAYS:
            _eq(getattr(td, name), getattr(jd, name))
        if jd.mg is None:
            break
        for name in ("Pvx", "Pvy", "Evx", "Evy"):
            _eq(getattr(td.mg, name), getattr(jd.mg, name))
        td, jd = td.mg.coarse, jd.mg.coarse


def test_disc_to_float32_casts_the_chain():
    td = attach_mg(make_disc(make_fe_space(make_channel_geometry(32, 12), 3, 2), torch.float64, "cpu"))
    t32 = td.to(torch.float32)
    d = t32
    while d is not None:
        assert d.dtype == torch.float32
        assert d.cell_tabs.dtype == torch.float32 and d.cell_w.dtype == torch.float32
        assert d.u_active.dtype == torch.bool
        if d.mg is not None:
            assert d.mg.Pvx.dtype == torch.float32
        d = None if d.mg is None else d.mg.coarse
    # the f32 tables are the f64 ones rounded once; JxW is formed in f32
    # from the rounded reference weights, as the JAX package forms it
    _eq(t32.phi_v, td.phi_v.to(torch.float32))
    _eq(t32.cell_tabs, td.cell_tabs.to(torch.float32))
    _eq(t32.w_q, td.w_ref.to(torch.float32) * (td.hx * td.hy))
    _eq(t32.cell_w, t32.w_q[:, None, None] * t32.cell_mask)
    assert td.to(torch.float64) is td
    # replacing a field keeps the tables: nothing is rebuilt
    assert td.replace(mg=None).cell_tabs is td.cell_tabs


def test_disc_from_numpy_rejects_decomposed():
    leaves = _jax_leaves(j_make_disc(j_space(j_geo(8, 4), 2, 1)))
    leaves["halo_axis"], leaves["halo_n"] = "x", 2
    with pytest.raises(ValueError, match="tile index"):
        disc_from_numpy(leaves, device="cpu")

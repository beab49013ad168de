"""The port's ``-M`` simplex P2/P1 backend against the JAX package, on the
CPU in f64, with the same inputs (numpy, seeded): the P2/P1 element tables,
both triangulations, ``make_simplex_disc`` (fields and gather tables), the
gmsh reader (MSH2 from the JAX package's ``scripts/generate_mesh.py``,
MSH4.1 and MSH1 written inline) and writer, every operator of
``unstructured/ops.py`` in both regimes and with both continuity signs,
the curved-edge lift/drag integral, the P2 -> P1 p-multigrid (transfers,
coarse operator, one V-cycle) and the dense Schur matrices and inverses.

Meshes: the triangulated 16x8 channel (its voxelized cylinder carries id-10
edges) and a curved-cylinder mesh at 40x10 background points.  The port's
operators apply per-element matrices where the JAX package evaluates at
quadrature points and projects: the same weak form summed in another
order.  Tolerances, relative to the largest entry of the JAX result: 1e-12
for operators, transfers and the lift/drag integral; 1e-10 for the
V-cycle, whose coarse GMRES has a data-dependent iteration count; integer
tables and masks exactly; the f32 dense inverses to f32 rounding (the
port inverts in f64 with torch, the JAX package with numpy).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.unstructured.dense as jdense
import navier_stokes_solver_tpu.unstructured.ops as jops
import navier_stokes_solver_tpu.unstructured.pmg as jpmg
import navier_stokes_solver_tpu_torch.unstructured.dense as tdense
import navier_stokes_solver_tpu_torch.unstructured.ops as tops
import navier_stokes_solver_tpu_torch.unstructured.pmg as tpmg
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_geo
from navier_stokes_solver_tpu.io import read_msh as j_read_msh
from navier_stokes_solver_tpu.io import write_msh as j_write_msh
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops.matfree import LinearizationQ as JLin
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_disc
from navier_stokes_solver_tpu.unstructured import triangulate_channel as j_tri
from navier_stokes_solver_tpu.unstructured import triangulate_channel_curved as j_curved
from navier_stokes_solver_tpu.unstructured.elements import make_simplex_tables as j_tables
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
from navier_stokes_solver_tpu_torch.io import read_msh, write_msh
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.ops.matfree import LinearizationQ
from navier_stokes_solver_tpu_torch.unstructured import (
    make_simplex_disc,
    triangulate_channel,
    triangulate_channel_curved,
)
from navier_stokes_solver_tpu_torch.unstructured.elements import make_simplex_tables

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NU, INV_DT = 1.0 / 20.0, 100.0
CURVED = (40, 10)
REGIMES = pytest.mark.parametrize("stokes", [True, False], ids=["stokes", "newton"])


def _rel_close(got, want, rel):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    assert scale > 0
    err = float(np.max(np.abs(got - want)))
    assert err <= rel * scale, (err, scale)


_CASES = {}


def _case(name):
    """(JAX disc, port disc, seeded inputs, mesh arrays) for "channel" (the
    triangulated 16x8 channel) or "curved", built once per module."""
    if name not in _CASES:
        if name == "channel":
            mesh = triangulate_channel(make_channel_geometry(16, 8))
        else:
            mesh = triangulate_channel_curved(*CURVED)
        jd = j_disc(*mesh)
        td = make_simplex_disc(*mesh, dtype=torch.float64, device="cpu")
        rng = np.random.default_rng(3)
        a = dict(
            u=0.3 * rng.standard_normal((2, td.n_nodes_v)),
            p=rng.standard_normal(td.n_nodes_p),
            x=rng.standard_normal((2, td.n_nodes_v)),
            xp=rng.standard_normal(td.n_nodes_p),
            uold=0.3 * rng.standard_normal((2, td.n_nodes_v)),
            xc=rng.standard_normal((2, td.n_nodes_p)),
        )
        _CASES[name] = (jd, td, a, mesh)
    return _CASES[name]


def _lin(jd, td, a):
    """Both packages' linearization at the seeded state (their own layouts)."""
    jl = jops.eval_state(jd, JBlocks(jnp.asarray(a["u"]), jnp.asarray(a["p"])))
    tl = tops.eval_state(td, Blocks(torch.as_tensor(a["u"]), torch.as_tensor(a["p"])))
    return jl, tl


def test_element_tables_and_triangulations_equal():
    j, t = j_tables(), make_simplex_tables()
    for f in ("q_xy", "w_q", "phi_v", "dphi_v", "phi_p", "dphi_p", "t_e", "w_e", "phi_v_edge",
              "dphi_v_edge", "phi_p_edge"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for jm, tm in (
        (j_tri(j_geo(16, 8)), triangulate_channel(make_channel_geometry(16, 8))),
        (j_curved(*CURVED), triangulate_channel_curved(*CURVED)),
    ):
        for x, y in zip(jm, tm):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)


def test_simplex_disc_fields_and_gather_tables():
    for name in ("channel", "curved"):
        jd, td, _, _ = _case(name)
        assert (td.n_nodes_v, td.n_nodes_p, td.n_tri) == (jd.n_nodes_v, jd.n_nodes_p, jd.n_tri)
        for f in ("dofs_v", "dofs_p", "u_dirichlet", "u_inlet", "cyl_tri", "cyl_edge", "edge_verts",
                  "gather_v", "gather_p", "gather_ev", "p_outlet", "pmg_vert", "pmg_edge", "pmg_vert_v",
                  "pmg_mid"):
            np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), err_msg=f)
        for f in ("coords_v", "coords_p", "invJ", "detJ", "inlet_profile1", "neumann_rhs1", "cyl_len",
                  "cyl_normal"):
            np.testing.assert_allclose(getattr(td, f).numpy(), np.asarray(getattr(jd, f)), rtol=0,
                                       atol=1e-15 * max(1.0, float(np.abs(np.asarray(getattr(jd, f))).max())),
                                       err_msg=f)
        assert td.cyl_tri.numel() > 0  # lift/drag edges present on both meshes


def _generate_mesh_main():
    spec = importlib.util.spec_from_file_location("generate_mesh", os.path.join(ROOT, "scripts", "generate_mesh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
4 1 1 0
1 0 0 0 0
2 1 0 0 0
3 1 1 0 0
4 0 1 0 0
1 0 0 0 0 1 0 1 7 2 1 -4
1 0 0 0 1 1 0 0 4 1 2 3 4
$EndEntities
$Nodes
1 4 1 4
2 1 0 4
1
2
3
4
0 0 0
1 0 0
1 1 0
0 1 0
$EndNodes
$Elements
2 3 1 3
1 1 1 1
1 1 4
2 1 2 2
2 1 2 3
3 1 3 4
$EndElements
"""

MSH1 = (
    "$NOD\n4\n1 0 0 0\n2 1 0 0\n3 1 1 0\n4 0 1 0\n$ENDNOD\n"
    "$ELM\n3\n1 2 5 1 3 1 2 3\n2 2 5 1 3 1 3 4\n3 1 7 2 2 1 2\n$ENDELM\n"
)


def test_read_msh_matches_the_jax_reader(tmp_path):
    """MSH2 (the JAX package's generator, curved mesh), MSH4.1 and MSH1:
    every array of the result equal, dtypes included."""
    msh2 = str(tmp_path / "curved.msh")
    assert _generate_mesh_main()(["--curved", "-m", "40,10", "-o", msh2]) == 0
    paths = [msh2]
    for name, text in (("m41.msh", MSH41), ("m1.msh", MSH1)):
        paths.append(str(tmp_path / name))
        with open(paths[-1], "w") as f:
            f.write(text)
    for path in paths:
        want, got = j_read_msh(path), read_msh(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, (path, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}:{k}")
    curved = read_msh(msh2)
    assert curved["tri"].shape[0] > 0 and 10 in set(curved["edge_tag"].tolist())
    assert read_msh(paths[1])["edge_tag"].tolist() == [7]


def test_write_msh_byte_for_byte(tmp_path):
    j_write_msh(j_geo(16, 8), str(tmp_path / "j.msh"))
    write_msh(make_channel_geometry(16, 8), str(tmp_path / "t.msh"))
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


def _jax_layout(tl):
    """The port's linearization [T, q, c] / [T, k, q, c] / [T, q] in the JAX
    package's [q, c, T] / [q, c, k, T] / [q, T]."""
    return (tl.u.permute(1, 2, 0), tl.gradu.permute(2, 3, 1, 0), tl.p.T)


@REGIMES
def test_velocity_operators_jacobian_and_residual(stokes):
    """``eval_state``, ``diag_F``, ``apply_F`` (with and without the boundary
    diagonal), ``apply_jacobian``, ``residual`` (both continuity signs),
    ``dirichlet_values`` and ``make_dot`` within 1e-12, on both meshes."""
    for name in ("channel", "curved"):
        jd, td, a, _ = _case(name)
        jl, tl = _lin(jd, td, a)
        for got, want in zip(_jax_layout(tl), jl):
            _rel_close(got, want, 1e-12)
        jlq, tlq = (None, None) if stokes else (jl, tl)
        jdF = jops.diag_F(jd, NU, INV_DT, jlq, stokes=stokes)
        tdF = tops.diag_F(td, NU, INV_DT, tlq, stokes=stokes)
        _rel_close(tdF, jdF, 1e-12)
        jx, tx = jnp.asarray(a["x"]), torch.as_tensor(a["x"])
        for bc in (False, True):
            want = jops.apply_F(jd, NU, INV_DT, jlq, jx, stokes=stokes, bc_diag=jdF if bc else None)
            got = tops.apply_F(td, NU, INV_DT, tlq, tx, stokes=stokes, bc_diag=tdF if bc else None)
            _rel_close(got, want, 1e-12)
        jxb = JBlocks(jx, jnp.asarray(a["xp"]))
        txb = Blocks(tx, torch.as_tensor(a["xp"]))
        want = jops.apply_jacobian(jd, NU, INV_DT, jlq, jdF, jxb, stokes=stokes)
        got = tops.apply_jacobian(td, NU, INV_DT, tlq, tdF, txb, stokes=stokes)
        _rel_close(got.u, want.u, 1e-12)
        _rel_close(got.p, want.p, 1e-12)
        jst = JBlocks(jnp.asarray(a["u"]), jnp.asarray(a["p"]))
        tst = Blocks(torch.as_tensor(a["u"]), torch.as_tensor(a["p"]))
        for consistent in (False, True):
            want = jops.residual(jd, NU, INV_DT, jst, jnp.asarray(a["uold"]), jdF, stokes=stokes,
                                 inlet_amp=0.3, consistent=consistent)
            got = tops.residual(td, NU, INV_DT, tst, torch.as_tensor(a["uold"]), tdF, stokes=stokes,
                                inlet_amp=0.3, consistent=consistent)
            _rel_close(got.u, want.u, 1e-12)
            if stokes:
                assert not got.p.any() and not np.asarray(want.p).any()
            else:
                _rel_close(got.p, want.p, 1e-12)
        _rel_close(tops.dirichlet_values(td, 0.3), jops.dirichlet_values(jd, 0.3), 0.0)
        np.testing.assert_allclose(float(tops.make_dot(td)(txb, txb)), float(jops.make_dot(jd)(jxb, jxb)),
                                   rtol=1e-14)


def test_pressure_and_coupling_operators():
    """``apply_B`` (both regimes), ``apply_Bt`` (with and without the
    Dirichlet rows), ``apply_Mp``, ``apply_Mp_raw``, ``apply_Lp``,
    ``apply_Fp`` (without and with convection), ``diag_Lp``, ``diag_Mp``
    within 1e-12, on both meshes."""
    for name in ("channel", "curved"):
        jd, td, a, _ = _case(name)
        jl, tl = _lin(jd, td, a)
        jx, tx = jnp.asarray(a["x"]), torch.as_tensor(a["x"])
        jp, tp = jnp.asarray(a["xp"]), torch.as_tensor(a["xp"])
        for stokes in (True, False):
            _rel_close(tops.apply_B(td, tx, stokes=stokes), jops.apply_B(jd, jx, stokes=stokes), 1e-12)
        for zero in (False, True):
            _rel_close(tops.apply_Bt(td, tp, zero_dirichlet_rows=zero),
                       jops.apply_Bt(jd, jp, zero_dirichlet_rows=zero), 1e-12)
        _rel_close(tops.apply_Mp(td, NU, tp), jops.apply_Mp(jd, NU, jp), 1e-12)
        _rel_close(tops.apply_Mp_raw(td, tp), jops.apply_Mp_raw(jd, jp), 1e-12)
        _rel_close(tops.apply_Lp(td, tp), jops.apply_Lp(jd, jp), 1e-12)
        for jlq, tlq in ((None, None), (jl, tl)):
            _rel_close(tops.apply_Fp(td, NU, INV_DT, tlq, tp), jops.apply_Fp(jd, NU, INV_DT, jlq, jp), 1e-12)
        _rel_close(tops.diag_Lp(td), jops.diag_Lp(jd), 1e-12)
        _rel_close(tops.diag_Mp(td, NU), jops.diag_Mp(jd, NU), 1e-12)


def test_lift_drag_on_the_curved_mesh():
    """The stress integral over the curved mesh's id-10 edges (and the
    voxelized channel's) at a seeded state, within 1e-12 of the drag."""
    for name in ("curved", "channel"):
        jd, td, a, _ = _case(name)
        jst = JBlocks(jnp.asarray(a["u"]), jnp.asarray(a["p"]))
        tst = Blocks(torch.as_tensor(a["u"]), torch.as_tensor(a["p"]))
        jdrag, jlift = (float(v) for v in jops.lift_drag_forces(jd, NU, jst))
        tdrag, tlift = (float(v) for v in tops.lift_drag_forces(td, NU, tst))
        assert jdrag != 0.0
        np.testing.assert_allclose(tdrag, jdrag, rtol=1e-12)
        np.testing.assert_allclose(tlift, jlift, rtol=1e-12, atol=1e-12 * abs(jdrag))


def _lin1(jd, td, a):
    """Both packages' vertex-injected P1 linearization."""
    ju1 = jnp.pad(jnp.asarray(a["u"]), ((0, 0), (0, 1)))[:, jd.pmg_vert_v]
    jv, jg = jpmg._eval_v1(jd, ju1)
    tv, tg = tpmg._eval_v1(td, torch.as_tensor(a["u"])[:, td.pmg_vert_v])
    return JLin(u=jv, gradu=jg, p=None), LinearizationQ(u=tv, gradu=tg, p=None)


def test_pmg_transfers_and_coarse_operator():
    """``prolong``, ``restrict``, ``diag_F1`` and ``apply_F1`` in both
    regimes within 1e-12, on both meshes."""
    for name in ("channel", "curved"):
        jd, td, a, _ = _case(name)
        _rel_close(tpmg.prolong(td, torch.as_tensor(a["xc"])), jpmg.prolong(jd, jnp.asarray(a["xc"])), 1e-12)
        _rel_close(tpmg.restrict(td, torch.as_tensor(a["x"])), jpmg.restrict(jd, jnp.asarray(a["x"])), 1e-12)
        jl1, tl1 = _lin1(jd, td, a)
        for stokes in (True, False):
            jlq, tlq = (None, None) if stokes else (jl1, tl1)
            jd1 = jpmg.diag_F1(jd, NU, INV_DT, jlq, stokes=stokes)
            td1 = tpmg.diag_F1(td, NU, INV_DT, tlq, stokes=stokes)
            _rel_close(td1, jd1, 1e-12)
            want = jpmg.apply_F1(jd, NU, INV_DT, jlq, jnp.asarray(a["xc"]), stokes=stokes, bc_diag=jd1)
            got = tpmg.apply_F1(td, NU, INV_DT, tlq, torch.as_tensor(a["xc"]), stokes=stokes, bc_diag=td1)
            _rel_close(got, want, 1e-12)


@REGIMES
def test_one_p_vcycle(stokes):
    """One application of the two-level V-cycle (GMRES smoothing, P1
    coarse GMRES), all-f64, within 1e-10, on both meshes."""
    for name in ("channel", "curved"):
        jd, td, a, _ = _case(name)
        jl, tl = _lin(jd, td, a)
        jlq, tlq = (None, None) if stokes else (jl, tl)
        jdF = jops.diag_F(jd, NU, INV_DT, jlq, stokes=stokes)
        tdF = tops.diag_F(td, NU, INV_DT, tlq, stokes=stokes)
        ju = None if stokes else jnp.asarray(a["u"])
        tu = None if stokes else torch.as_tensor(a["u"])
        jM = jpmg.make_p_vcycle(jd, NU, INV_DT, ju, stokes=stokes, diag_f=jdF)
        tM = tpmg.make_p_vcycle(td, NU, INV_DT, tu, stokes=stokes, diag_f=tdF)
        _rel_close(tM(torch.as_tensor(a["x"])), jM(jnp.asarray(a["x"])), 1e-10)


def test_dense_schur_matrices_and_inverses():
    """The assembled pressure mass and Laplacian (f64) within 1e-14 of the
    JAX package's; the attached f32 inverses to f32 rounding; the size cap
    leaves a disc above it without inverses."""
    for name in ("channel", "curved"):
        jd, td, _, _ = _case(name)
        for jf, tf in ((jdense.assemble_Mp_raw, tdense.assemble_Mp_raw), (jdense.assemble_Lp, tdense.assemble_Lp)):
            _rel_close(tf(td), jf(jd), 1e-14)
        ja, ta = jdense.attach_dense_schur(jd), tdense.attach_dense_schur(td)
        for f in ("dense_mp_raw_inv", "dense_lp_inv"):
            got, want = getattr(ta, f), np.asarray(getattr(ja, f))
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))
        assert tdense.attach_dense_schur(td, max_np=td.n_nodes_p - 1).dense_lp_inv is None
    assert tdense.DENSE_SCHUR_MAX_NP == jdense.DENSE_SCHUR_MAX_NP == 16_384

"""Whole ``-M`` simplex solves and the ``-M`` command line of the port against
the JAX package, on the CPU.

* ``SolverOptions(read_mesh_from_file=True)`` flips the degrees to P2/P1 as
  the JAX package does; ``-M`` refuses a 2-D tile grid (it decomposes into
  x-strips only) and writes its VTU piece.
* The stationary continuation on the triangulated 16x8 channel, Re 20,
  FGMRES + blockTriangular with the p-multigrid velocity leg and the dense
  Schur legs, all-f64 but for the dense legs' f32 products (as in the JAX
  package): the JAX package's Krylov count in every tangent solve, drag
  rtol 1e-7, fields within 1e-6 of their magnitude.
* The same without the dense legs (the nested Jacobi-CG mass solve).
* One application of each block preconditioner on the simplex backend,
  both variants, in the Newton regime: the dense and the nested Schur legs
  (mass, Cahouet-Chabard -- where ``cc_lp_cycles`` gives way to the nested
  FGMRES behind a Jacobi Lp, and to one exact solve behind the dense
  inverse -- and PCD), ``inner_mode="fixed"`` (the Chebyshev-Jacobi Lp leg
  without a dense inverse), the p-MG velocity leg, all-f64 but for the
  dense legs' f32 products: within 1e-10 of the JAX package with the nested
  legs (1e-8 under PCD, whose two nested Jacobi-preconditioned solves pass
  the operators' 1e-16 differences on: 8.5e-10 measured), 1e-5 with the
  dense ones (f32 rounding: 1.8e-6 measured; the power iteration starts
  from the JAX package's vector).
* The CLI: ``-M FILE`` (an MSH2 curved-cylinder mesh from the JAX
  package's ``scripts/generate_mesh.py``) and ``-M`` print the JAX CLI's
  lift/drag lines, drag rtol 1e-7 (the default f32 preconditioner: Krylov
  counts within 2%).
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.unstructured.ops as jops
import navier_stokes_solver_tpu_torch.precond.mg as tmg
import navier_stokes_solver_tpu_torch.unstructured.ops as tops

from navier_stokes_solver_tpu.api import NSSolverStationary as JStationary
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.cli import stationary as j_stationary
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond.blocks import LinearContext as JCtx
from navier_stokes_solver_tpu.precond.blocks import make_preconditioner as j_make_preconditioner
from navier_stokes_solver_tpu.unstructured import make_simplex_disc as j_disc
from navier_stokes_solver_tpu.unstructured.dense import attach_dense_schur as j_attach
from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
from navier_stokes_solver_tpu_torch.cli import stationary as t_stationary
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.precond import LinearContext, PrecondConfig, make_preconditioner
from navier_stokes_solver_tpu_torch.unstructured import SimplexDisc, make_simplex_disc, triangulate_channel
from navier_stokes_solver_tpu_torch.unstructured.dense import attach_dense_schur

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(mesh_size=(16, 8), read_mesh_from_file=True, Re=20.0, solver_type=1, preconditioner_type=1,
            tolerance=1e-8, verbose=False)
F64 = dict(vmult_dtype=None, mg_dtype=None)


def _run(dense):
    out = []
    for S, O, C, extra in ((JStationary, JOptions, JCfg, {}),
                           (NSSolverStationary, SolverOptions, PrecondConfig, dict(device="cpu"))):
        s = S(O(**BASE, dense_schur=dense, precond_config=C(**F64), **extra)).setup()
        s.solve_newton()
        s.compute_lift_drag()
        s.compute_drag_coeff()
        s.compute_lift_coeff()
        out.append(s)
    return out


@pytest.fixture(scope="module", params=[True, False], ids=["dense", "nested"])
def pair(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolverStationary.KRYLOV_CHUNK_MAX))
        return _run(request.param)


def test_options_select_the_simplex_backend(tmp_path):
    s = NSSolverStationary(SolverOptions(**BASE, device="cpu"))
    j = JStationary(JOptions(**BASE))
    assert (s.options.degree_velocity, s.options.degree_pressure) == (2, 1)
    assert (s.options.degree_velocity, s.options.degree_pressure) == (
        j.options.degree_velocity, j.options.degree_pressure)
    s.setup()
    assert isinstance(s.disc, SimplexDisc) and s.space is None and s.disc.p_mg
    assert s.disc.dense_lp_inv is not None and s.disc.dense_lp_inv.dtype == torch.float32
    assert s.n_dofs == 2 * s.disc.n_nodes_v + s.disc.n_nodes_p == 1269
    u, p = s.fields()
    assert u.shape == (2, s.disc.n_nodes_v) and p.shape == (s.disc.n_nodes_p,)
    with pytest.raises(NotImplementedError, match=r"1-D \(x-strips\)"):
        NSSolverStationary(SolverOptions(**BASE, dd=(2, 2), device="cpu"))
    out = NSSolverStationary(SolverOptions(**BASE, write_output=True, output_dir=str(tmp_path), device="cpu")).setup()
    out.output()
    assert [p.name for p in tmp_path.iterdir()] == ["output_000.0.vtu"]
    bare = NSSolverStationary(SolverOptions(**BASE, multigrid=False, dense_schur=False, device="cpu")).setup()
    assert not bare.disc.p_mg and bare.disc.dense_mp_raw_inv is None


def test_stationary_krylov_counts_equal(pair):
    j, t = pair
    want = [(h["phase"], h["nu"], h["n_iter"], h["krylov_iters"]) for h in j.history]
    got = [(h["phase"], h["nu"], h["n_iter"], h["krylov_iters"]) for h in t.history]
    assert got == want and want[0][3] > 30


def test_stationary_drag_and_fields(pair):
    j, t = pair
    np.testing.assert_allclose(t.drag_coeff, j.drag_coeff, rtol=1e-7)
    np.testing.assert_allclose(t.lift_coeff, j.lift_coeff, rtol=1e-7, atol=1e-7 * abs(j.drag_coeff))
    for got, want in zip(t.fields(), j.fields()):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


FORCE_LINES = ("Lift force", "Drag force", "Lift coefficient", "Drag coefficient")


def _force_lines(text):
    return [
        (m.group(1), float(m.group(2)))
        for m in re.finditer(rf"^({'|'.join(FORCE_LINES)}): (\S+)$", text, re.M)
    ]


def _curved_msh(path):
    spec = importlib.util.spec_from_file_location("generate_mesh", os.path.join(ROOT, "scripts", "generate_mesh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--curved", "-m", "40,10", "-o", path]) == 0
    return path


def test_cli_mesh_file_and_triangulated_channel(tmp_path, capsys, monkeypatch):
    """``-M FILE`` and ``-M`` through ``main`` of both CLIs (Re 20, -p 1,
    tol 1e-8, default f32 preconditioner): the same lift/drag lines, drag
    rtol 1e-7; Krylov counts per solve within 2%."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolverStationary.KRYLOV_CHUNK_MAX))
    path = _curved_msh(str(tmp_path / "curved.msh"))
    capsys.readouterr()
    for mesh in (["-M", path], ["-M", "-m", "16,8"]):
        argv = mesh + ["-r", "20", "-p", "1", "-t", "1e-8"]
        outs = []
        for main, extra in ((j_stationary.main, []), (t_stationary.main, ["--device", "cpu"])):
            assert main(argv + extra) == 0
            outs.append(capsys.readouterr().out)
        want, got = (_force_lines(o) for o in outs)
        assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 4
        drag = max(abs(v) for k, v in want if k.startswith("Drag"))
        assert drag > 0
        for (k, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * drag if k.startswith("Lift") else 0.0, err_msg=k)
        jits, tits = ([int(n) for n in re.findall(r"^   (\d+) iterations$", o, re.M)] for o in outs)
        assert len(tits) == len(jits) and jits[0] > 30
        for a, b in zip(tits, jits):
            assert abs(a - b) <= 0.02 * b + 1, (tits, jits)
        assert "velocity = " in outs[1] and "Pressure degree:           = 1" in outs[1]


SWEEPS = [  # (kind, variant, PrecondConfig fields); each with dense and nested Schur legs
    (1, "unsteady", {}),
    (1, "unsteady", dict(schur_mode="cahouet", cc_lp_cycles=2)),
    (1, "unsteady", dict(schur_mode="pcd")),
    (0, "unsteady", dict(schur_mode="cahouet", inner_mode="fixed")),
    (1, "stationary", dict(schur_mode="cahouet")),
    (2, "unsteady", {}),
]


def _jax_start(shape, dtype, device):
    v = jax.random.normal(jax.random.PRNGKey(7), tuple(shape), jnp.float64)
    return torch.tensor(np.asarray(v), device=device).to(dtype)


def test_preconditioner_sweeps_on_the_simplex_backend(monkeypatch):
    monkeypatch.setattr(tmg, "_lmax_start", _jax_start)
    mesh = triangulate_channel(make_channel_geometry(16, 8))
    rng = np.random.default_rng(4)
    nu, inv_dt = 1.0 / 20.0, 100.0
    for dense in (False, True):
        jd = j_disc(*mesh).replace(p_mg=True)
        td = make_simplex_disc(*mesh, dtype=torch.float64, device="cpu").replace(p_mg=True)
        if dense:
            jd, td = j_attach(jd), attach_dense_schur(td)
        u, p = 0.3 * rng.standard_normal((2, td.n_nodes_v)), rng.standard_normal(td.n_nodes_p)
        bu, bp = rng.standard_normal((2, td.n_nodes_v)), rng.standard_normal(td.n_nodes_p)
        jl = jops.eval_state(jd, JBlocks(jnp.asarray(u), jnp.asarray(p)))
        tl = tops.eval_state(td, Blocks(torch.as_tensor(u), torch.as_tensor(p)))
        jctx = JCtx(disc=jd, nu=nu, inv_dt=inv_dt, stokes=False, linq=jl,
                    diag_f=jops.diag_F(jd, nu, inv_dt, jl, stokes=False), state_u=jnp.asarray(u), ops=jops)
        tctx = LinearContext(disc=td, nu=nu, inv_dt=inv_dt, stokes=False, linq=tl,
                             diag_f=tops.diag_F(td, nu, inv_dt, tl, stokes=False), state_u=torch.as_tensor(u),
                             ops=tops)
        rel = 1e-5 if dense else 1e-10
        for kind, variant, cfg in SWEEPS:
            want = j_make_preconditioner(kind, jctx, variant=variant, cfg=JCfg(**F64, **cfg))(
                JBlocks(jnp.asarray(bu), jnp.asarray(bp)))
            got = make_preconditioner(kind, tctx, variant=variant, cfg=PrecondConfig(**F64, **cfg))(
                Blocks(torch.as_tensor(bu), torch.as_tensor(bp)))
            for g, w in zip(got, want):
                w = np.asarray(w)
                err = np.abs(g.numpy() - w).max()
                gate = rel if dense or cfg.get("schur_mode") != "pcd" else 1e-8
                assert err <= gate * np.abs(w).max(), (dense, kind, variant, cfg, err)

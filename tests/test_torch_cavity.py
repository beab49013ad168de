"""The lid-driven cavity and the body force in the port against the JAX
package, on the CPU, all-f64.

  * the cavity's geometry and space arrays are the JAX package's, exactly;
  * the multigrid chain: the JAX package builds every coarse level of a
    cavity as the channel (its ``precond/mg.py:114``), so its level-1
    operators belong to another problem; the port builds a cavity at every
    level, and the channel's chain is unchanged (bitwise the JAX package's,
    which is what the port built before the cavity);
  * the cavity's residual and Jacobian apply within 1e-12 of the JAX
    package's, and one V-cycle on the JAX package's own hierarchy (carried
    across by ``disc_from_numpy``);
  * a 16x16 Q2/Q1 ``solve_direct`` at Re 50 on each package's own chain:
    fields within 1e-6, the pressure's mean removed (the cavity pressure is
    defined up to a constant); the outer counts differ with the chains and
    are only printed;
  * the body force: its rhs within 1e-14, a forced residual within 1e-12, a
    forced 16x8 channel solve within 1e-6, and the forced residual of an
    ensemble's B = 3 members equal to three unbatched ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.api import NSSolverStationary as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.geometry import make_cavity_geometry as j_cavity
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_channel
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops import make_disc as j_make_disc
from navier_stokes_solver_tpu.ops import matfree as jmf
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu.precond import attach_mg as j_attach_mg
from navier_stokes_solver_tpu.precond import make_mg_vcycle as j_vcycle
from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
from navier_stokes_solver_tpu_torch.api import kernels as tk
from navier_stokes_solver_tpu_torch.geometry import (
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    make_cavity_geometry,
    make_channel_geometry,
    make_fe_space,
)
from navier_stokes_solver_tpu_torch.ops import Blocks, disc_from_numpy, make_disc
from navier_stokes_solver_tpu_torch.ops import matfree as tmf
from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg, make_mg_vcycle
from navier_stokes_solver_tpu_torch.precond.mg import mg_level_shapes

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

NU = 1.0 / 50.0
FIELD_GATE = 1e-6  # BASELINE.md, relative to each field's largest magnitude
SPACE_ARRAYS = ("u_active", "p_active", "u_dirichlet", "u_inlet")
DISC_ARRAYS = ("cell_mask", "u_active", "p_active", "u_dirichlet", "u_inlet",
               "inlet_profile1", "neumann_rhs1", "cyl_face_mask")


def force(x, y):
    """A body force that varies in both directions."""
    return np.sin(np.pi * x) * np.cos(np.pi * y), x * y


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, tol, rel=True):
    """Within ``tol`` of ``want``'s largest magnitude (``rel``), else
    absolutely; an all-zero ``want`` must be matched exactly."""
    got, want = _np(got), _np(want)
    if not want.any():
        assert not got.any()
        return
    scale = float(np.max(np.abs(want))) if rel else 1.0
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, (err, scale)


def _jax_leaves(d):
    """A JAX Disc (with its MG chain) as a dict of Python scalars / numpy."""
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if f.name == "mg" and v is not None:
            v = {g.name: (_jax_leaves(v.coarse) if g.name == "coarse" else np.asarray(getattr(v, g.name)))
                 for g in dataclasses.fields(v)}
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def _state(disc, seed):
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal((2,) + disc.NV), rng.standard_normal(disc.NP)


def test_geometry_and_space_arrays_equal_jax():
    for mesh in ((16, 16), (8, 6)):
        tg, jg = make_cavity_geometry(*mesh), j_cavity(*mesh)
        for name in ("face_id", "cell_active", "cell_ring"):
            np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
        assert (tg.inlet_kind, tg.hx, tg.hy) == (jg.inlet_kind, jg.hx, jg.hy) == ("constant", 1 / mesh[0], 1 / mesh[1])
        assert not (tg.face_id == BOUNDARY_OUTLET).any() and (tg.face_id[3, -1] == BOUNDARY_INLET).all()
        for deg in ((2, 1), (3, 2)):
            ts, js = make_fe_space(tg, *deg), j_space(jg, *deg)
            for name in SPACE_ARRAYS:
                np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
            np.testing.assert_array_equal(ts.inlet_profile(0.75), js.inlet_profile(0.75))
            assert ts.u_inlet[-1].all() and not ts.u_inlet[:-1].any()  # the lid, corners included


def test_jax_cavity_chain_is_channel_shaped_and_the_ports_is_a_cavity():
    """The JAX fault, shown: its level-1 disc of a 32x32 cavity has the
    2.2 x 0.41 channel's spacing, inactive cells (the cylinder's hole), the
    parabolic inlet on the left side and outlet faces.  The port's chain is
    a cavity at every level."""
    jd = j_attach_mg(j_make_disc(j_space(j_cavity(32, 32), 2, 1)))
    j1 = jd.mg.coarse
    assert (j1.nx, j1.ny) == (16, 16)
    assert abs(j1.hx - 2.2 / 16) < 1e-12 and abs(j1.hy - 0.41 / 16) < 1e-12
    assert float(jnp.min(j1.cell_mask)) == 0.0
    assert bool(jnp.all(j1.u_inlet[:, 0])) and float(jnp.ptp(j1.inlet_profile1)) > 0.0
    assert float(jnp.max(jnp.abs(j1.neumann_rhs1))) > 0.0
    td = attach_mg(make_disc(make_fe_space(make_cavity_geometry(32, 32), 2, 1), torch.float64, "cpu"),
                   make_cavity_geometry)
    shapes = mg_level_shapes(td)
    assert shapes == [(32, 32), (16, 16), (8, 8)]
    d = td
    while d.mg is not None:
        d = d.mg.coarse
        want = make_disc(make_fe_space(make_cavity_geometry(d.nx, d.ny), 2, 1), torch.float64, "cpu")
        assert (d.hx, d.hy) == (want.hx, want.hy) == (1 / d.nx, 1 / d.ny)
        for name in DISC_ARRAYS:
            assert torch.equal(getattr(d, name), getattr(want, name)), name
        assert bool((d.cell_mask == 1).all()) and not bool(d.neumann_rhs1.any())
        assert bool(d.u_inlet[-1].all()) and not bool(d.u_inlet[:-1].any())


@pytest.mark.parametrize("mesh,deg", [((16, 8), (3, 2)), ((64, 24), (2, 1))])
def test_channel_chain_is_unchanged(mesh, deg):
    """The default maker (the channel) and the explicit one build the chain
    the JAX package builds, bit for bit."""
    fine = make_disc(make_fe_space(make_channel_geometry(*mesh), *deg), torch.float64, "cpu")
    jd = j_attach_mg(j_make_disc(j_space(j_channel(*mesh), *deg)))
    for td in (attach_mg(fine), attach_mg(fine, make_channel_geometry)):
        j = jd
        while j.mg is not None:
            for name in ("Pvx", "Pvy", "Evx", "Evy", "Ppx", "Ppy"):
                np.testing.assert_array_equal(_np(getattr(td.mg, name)), np.asarray(getattr(j.mg, name)))
            td, j = td.mg.coarse, j.mg.coarse
            assert (td.nx, td.ny, td.hx, td.hy) == (j.nx, j.ny, j.hx, j.hy)
            for name in DISC_ARRAYS:
                np.testing.assert_array_equal(_np(getattr(td, name)), np.asarray(getattr(j, name)))
        assert td.mg is None


def test_cavity_operators_and_a_vcycle_on_the_jax_hierarchy():
    jd = j_attach_mg(j_make_disc(j_space(j_cavity(16, 16), 2, 1)))
    td = disc_from_numpy(_jax_leaves(jd), device="cpu")
    u, p = _state(td, 3)
    rng = np.random.default_rng(4)
    xu, xp = rng.standard_normal((2,) + td.NV), rng.standard_normal(td.NP)
    jst, tst = JBlocks(jnp.asarray(u), jnp.asarray(p)), Blocks(torch.as_tensor(u), torch.as_tensor(p))
    jlin, tlin = jmf.eval_state(jd, jst), tmf.eval_state(td, tst)
    for stokes in (True, False):
        jl, tl = (None, None) if stokes else (jlin, tlin)
        jdF = jmf.diag_F(jd, NU, 0.0, jl, stokes=stokes)
        tdF = tmf.diag_F(td, NU, 0.0, tl, stokes=stokes)
        _close(tdF, jdF, 1e-12)
        for amp in (1.0, 0.0):
            jr = jmf.residual(jd, NU, 0.0, jst, jst.u, jdF, stokes=stokes, inlet_amp=amp)
            tr = tmf.residual(td, NU, 0.0, tst, tst.u, tdF, stokes=stokes, inlet_amp=amp)
            _close(tr.u, jr.u, 1e-12)
            _close(tr.p, jr.p, 1e-12)
        x = (JBlocks(jnp.asarray(xu), jnp.asarray(xp)), Blocks(torch.as_tensor(xu), torch.as_tensor(xp)))
        jy = jmf.apply_jacobian(jd, NU, 0.0, jl, jdF, x[0], stokes=stokes)
        ty = tmf.apply_jacobian(td, NU, 0.0, tl, tdF, x[1], stokes=stokes)
        _close(ty.u, jy.u, 1e-12)
        _close(ty.p, jy.p, 1e-12)
        jM = j_vcycle(jd, NU, 0.0, None if stokes else jst.u, stokes=stokes, smooth_degree=3, dtype=None)
        tM = make_mg_vcycle(td, NU, 0.0, None if stokes else tst.u, stokes=stokes, smooth_degree=3, dtype=None)
        _close(tM(torch.as_tensor(xu)), jM(jnp.asarray(xu)), 1e-12)


def _direct(solver, opts):
    """``solve_direct`` with every tangent solve's Krylov count; returns
    (counts, u, p with its mean removed)."""
    s = solver(opts).setup()
    counts, solve = [], s.solve_system
    s.solve_system = lambda *a, **kw: counts.append(solve(*a, **kw)) or counts[-1]
    s.solve_direct()
    u, p = (np.asarray(a) for a in s.fields())
    return counts, u, p - p.mean()


def _both_direct(monkeypatch, **kw):
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", str(NSSolverStationary.KRYLOV_CHUNK_MAX))
    base = dict(degree_velocity=2, degree_pressure=1, solver_type=1, tolerance=1e-10,
                preconditioner_type=1, krylov_basis=60, verbose=False, **kw)
    cfg = dict(vmult_dtype=None, mg_dtype=None)
    j = _direct(JSolver, JOptions(**base, precond_config=JCfg(**cfg)))
    t = _direct(NSSolverStationary, SolverOptions(**base, precond_config=PrecondConfig(**cfg), device="cpu"))
    return j, t


def test_cavity_solve_direct_matches_jax(monkeypatch):
    (jc, ju, jp), (tc, tu, tp) = _both_direct(monkeypatch, mesh_size=(16, 16), Re=50.0, geometry="cavity")
    msg = f"outers per tangent solve: JAX {jc}, port {tc}"
    assert len(jc) >= 3 and len(tc) >= 3, msg
    _close(tu, ju, FIELD_GATE)
    _close(tp, jp, FIELD_GATE)
    assert float(np.abs(tu[0, -1]).min()) == 1.0  # the lid


def test_forcing_rhs_matches_jax():
    for geo, deg in (((make_cavity_geometry, j_cavity), (2, 1)), ((make_channel_geometry, j_channel), (3, 2))):
        tsp, jsp = make_fe_space(geo[0](8, 6), *deg), j_space(geo[1](8, 6), *deg)
        td = make_disc(tsp, torch.float64, "cpu", forcing=force)
        jd = j_make_disc(jsp, forcing=force)
        assert td.forcing_rhs.shape == (2,) + td.NV
        _close(td.forcing_rhs, jd.forcing_rhs, 1e-14)
        assert td.to(torch.float32).forcing_rhs.dtype == torch.float32
        assert make_disc(tsp, torch.float64, "cpu").forcing_rhs is None


def test_forced_residual_matches_jax():
    """On a disc of its own and on the JAX package's, carried across by
    ``disc_from_numpy``."""
    jd = j_make_disc(j_space(j_cavity(12, 10), 2, 1), forcing=force)
    own = make_disc(make_fe_space(make_cavity_geometry(12, 10), 2, 1), torch.float64, "cpu", forcing=force)
    carried = disc_from_numpy(_jax_leaves(jd), device="cpu")
    np.testing.assert_array_equal(_np(carried.forcing_rhs), np.asarray(jd.forcing_rhs))
    u, p = _state(own, 6)
    jst = JBlocks(jnp.asarray(u), jnp.asarray(p))
    for td in (own, carried):
        tst = Blocks(torch.as_tensor(u), torch.as_tensor(p))
        for stokes in (True, False):
            jdF = jmf.diag_F(jd, NU, 0.0, None if stokes else jmf.eval_state(jd, jst), stokes=stokes)
            tdF = tmf.diag_F(td, NU, 0.0, None if stokes else tmf.eval_state(td, tst), stokes=stokes)
            jr = jmf.residual(jd, NU, 0.0, jst, jst.u, jdF, stokes=stokes, inlet_amp=0.0)
            tr = tmf.residual(td, NU, 0.0, tst, tst.u, tdF, stokes=stokes, inlet_amp=0.0)
            _close(tr.u, jr.u, 1e-12)
            unforced = tmf.residual(td.replace(forcing_rhs=None), NU, 0.0, tst, tst.u, tdF, stokes=stokes,
                                    inlet_amp=0.0)
            assert not torch.equal(tr.u, unforced.u)


def test_forced_channel_solve_matches_jax(monkeypatch):
    (_, ju, jp), (_, tu, tp) = _both_direct(monkeypatch, mesh_size=(16, 8), Re=20.0, forcing=force)
    _close(tu, ju, FIELD_GATE)
    _close(tp, jp, FIELD_GATE)


def test_forced_residual_with_the_member_axis():
    """B = 3 members through ``assemble_kernel`` (the ensemble's Newton
    regime): each member's residual equals the unbatched one of its
    viscosity and state."""
    disc = make_disc(make_fe_space(make_channel_geometry(12, 6), 2, 1), torch.float64, "cpu", forcing=force)
    states = [_state(disc, 10 + b) for b in range(3)]
    nus = torch.tensor([1 / 20, 1 / 60, 1 / 100])
    st = Blocks(torch.as_tensor(np.stack([u for u, _ in states])), torch.as_tensor(np.stack([p for _, p in states])))
    rhs, norms = tk.assemble_kernel(disc, nus, 100.0, st, st.u, 0.0, stokes=False)
    assert rhs.u.shape == (3, 2) + disc.NV
    for b, (u, p) in enumerate(states):
        one = Blocks(torch.as_tensor(u), torch.as_tensor(p))
        want, n = tk.assemble_kernel(disc, float(nus[b]), 100.0, one, one.u, 0.0, stokes=False)
        assert torch.equal(rhs.u[b], want.u) and torch.equal(rhs.p[b], want.p)
        assert float(norms[b]) == pytest.approx(float(n), rel=1e-14)


def test_option_cases():
    """``-M`` refuses the cavity, as in the JAX package, and the body force
    (which the JAX package's ``-M`` path drops without a word); the cavity
    runs on the structured path in both packages."""
    for kw in (dict(geometry="cavity"), dict(forcing=force)):
        with pytest.raises(ValueError, match="structured-path only"):
            NSSolverStationary(SolverOptions(read_mesh_from_file=True, mesh_size=(8, 4), **kw, device="cpu"))
    with pytest.raises(ValueError, match="structured-path only"):
        JSolver(JOptions(read_mesh_from_file=True, mesh_size=(8, 4), geometry="cavity", verbose=False)).setup()
    for bad in ("box", "Cavity"):
        with pytest.raises(ValueError, match="unknown geometry"):
            NSSolverStationary(SolverOptions(geometry=bad, device="cpu"))
    kw = dict(mesh_size=(16, 16), degree_velocity=2, degree_pressure=1, geometry="cavity", verbose=False)
    s = NSSolverStationary(SolverOptions(**kw, device="cpu")).setup()
    assert s.n_dofs == JSolver(JOptions(**kw)).setup().n_dofs
    assert s.geo.inlet_kind == "constant" and s.disc.mg is not None
    assert s.disc.mg.coarse.hx == 1 / s.disc.mg.coarse.nx

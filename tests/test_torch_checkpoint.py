"""Checkpoints of the port (``io.checkpoint``) and ``NSSolver.solve_fused``
against the JAX package, on the CPU: 16x8 Q3/Q2, Re 20 (Newton at Re 11),
three steps, tol 1e-6, all-f64 FGMRES + blockTriangular, ``newton_max`` 2
and every tangent solve capped at 20 Krylov iterations (whole solves are
chaotic: the cap keeps the count gate on capped solves), one step per
chunk.

* ``solve_fused`` in both packages: the JAX package's Newton and Krylov
  counts per step, drag and lift rtol 1e-7 (the lift, rounding on this
  symmetric mesh, within 1e-7 of the drag), fields within 1e-6 of their
  magnitude.
* Resume across the packages, both ways: one package writes its checkpoint
  after one step, the other resumes it to step 3 and matches its own
  uninterrupted run at the same gates (step 1 comes from the checkpoint's
  history, exactly); the port's own split run equals its unsplit run bit
  for bit.  The port's ``time_state.npz`` has the JAX package's keys and
  dtypes, its ``history.json`` four columns.
* ``save_checkpoint`` / ``load_checkpoint`` read what the other package
  wrote.
* An interrupted save leaves the previous checkpoint readable; a
  checkpoint whose ``p``, ``step`` or ``lift`` does not fit the run raises.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.api import NSSolver as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.io import checkpoint as jck
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions
from navier_stokes_solver_tpu_torch.io import checkpoint as tck
from navier_stokes_solver_tpu_torch.precond import PrecondConfig
from navier_stokes_solver_tpu_torch.timeloop import initial_state

torch.set_num_threads(1)

F64 = dict(vmult_dtype=None, mg_dtype=None)
RUN = dict(mesh_size=(16, 8), Re=20.0, solver_type=1, preconditioner_type=1, tolerance=1e-6,
           time_span=0.03, time_step=0.01, verbose=False)
FUSED = dict(newton_max=2, krylov_maxiter=20, chunk_steps=1)
GATE, FIELD_GATE = 1e-7, 1e-6
KEYS = ("step", "time", "newton_iters", "krylov_iters")


def _jax():
    return JSolver(JOptions(**RUN, precond_config=JCfg(**F64))).setup()


def _port():
    return NSSolver(SolverOptions(**RUN, precond_config=PrecondConfig(**F64), device="cpu")).setup()


def _fused(s, **kw):
    s.solve_fused(**FUSED, **kw)
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    out = {"jax": _fused(_jax()), "port": _fused(_port())}
    _fused(_jax(), checkpoint_dir=str(d / "jax"), max_steps_this_call=1)
    _fused(_port(), checkpoint_dir=str(d / "port"), max_steps_this_call=1)
    for src in ("jax", "port"):
        for dst in ("by_jax", "by_port"):
            shutil.copytree(d / src, d / f"{src}_{dst}")
    out["jax->port"] = _fused(_port(), checkpoint_dir=str(d / "jax_by_port"))
    out["port->jax"] = _fused(_jax(), checkpoint_dir=str(d / "port_by_jax"))
    out["port->port"] = _fused(_port(), checkpoint_dir=str(d / "port_by_port"))
    out["dir"] = d
    return out


def _assert_close_runs(got, want):
    assert [tuple(h[k] for k in KEYS) for h in got.history] == [tuple(h[k] for k in KEYS) for h in want.history]
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["drag_force"], w["drag_force"], rtol=GATE)
        np.testing.assert_allclose(g["lift_force"], w["lift_force"], rtol=GATE, atol=GATE * abs(w["drag_force"]))
    for g, w in zip(got.fields(), want.fields()):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.abs(g - w).max() <= FIELD_GATE * np.abs(w).max()


def test_solve_fused_counts_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    assert [tuple(h[k] for k in KEYS) for h in t.history] == [tuple(h[k] for k in KEYS) for h in j.history]
    assert len(t.history) == 3 and t.time_step_index == 3 and t.nu == 1.0 / 11.0
    assert all(h["newton_iters"] >= 2 and h["krylov_iters"] == 40 for h in t.history)
    assert all(h["seconds"] > 0 and h["newton_residual"] > 0 for h in t.history)


def test_solve_fused_forces_and_fields_match_jax(runs):
    _assert_close_runs(runs["port"], runs["jax"])
    np.testing.assert_allclose(runs["port"].drag_coeff, runs["jax"].drag_coeff, rtol=GATE)


@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_resume_across_packages(runs, direction):
    """The resumed run matches the resuming package's own uninterrupted run;
    its step 1 is the writer's, read back from history.json exactly."""
    writer, reader = direction.split("->")
    got = runs[direction]
    assert got.time_step_index == 3 and len(got.history) == 3
    first = json.loads((runs["dir"] / writer / "history.json").read_text())
    assert len(first) == 1
    h = got.history[0]
    assert [h["drag_force"], h["lift_force"], h["newton_iters"], h["krylov_iters"]] == first[0]
    _assert_close_runs(got, runs[reader])


def test_split_run_equals_unsplit_bitwise(runs):
    got, want = runs["port->port"], runs["port"]
    for g, w in zip(got.history, want.history):
        for k in ("drag_force", "lift_force") + KEYS:
            assert g[k] == w[k], k
    for g, w in zip(got.solution, want.solution):
        assert torch.equal(g, w)
    assert got.time == want.time and got.nu == want.nu


def test_checkpoint_files_have_the_jax_format(runs):
    d = runs["dir"]
    with np.load(d / "jax" / "time_state.npz") as a, np.load(d / "port" / "time_state.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(["u", "p", "time", "step", "drag", "lift"])
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
        assert b["step"].dtype == np.int32 and int(b["step"]) == 1
    for writer in ("jax", "port"):
        hist = json.loads((d / writer / "history.json").read_text())
        assert len(hist) == 1 and len(hist[0]) == 4
    assert sorted(p.name for p in (d / "port").iterdir()) == ["history.json", "time_state.npz"]


def _seeded(s):
    """Fill a set-up solver's three states from a numpy seed."""
    put = torch.as_tensor if isinstance(s, NSSolver) else jnp.asarray
    rng = np.random.default_rng(3)
    u, p = (rng.standard_normal((3,) + tuple(a.shape)) for a in s.solution)
    s.solution, s.solution_old, s.delta = (type(s.solution)(put(u[i]), put(p[i])) for i in range(3))
    s.time, s.time_step_index, s.apply_first, s.nu = 0.07, 7, False, 1.0 / 11.0
    return u, p


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_solver_checkpoint_read_by_the_other_package(tmp_path, writer):
    src, dst = (_jax(), _port()) if writer == "jax" else (_port(), _jax())
    u, p = _seeded(src)
    (jck if writer == "jax" else tck).save_checkpoint(src, str(tmp_path))
    manifest = (tck if writer == "jax" else jck).load_checkpoint(dst, str(tmp_path))
    assert manifest["format_version"] == 1 and manifest["time_step_index"] == 7
    for i, blk in enumerate((dst.solution, dst.solution_old, dst.delta)):
        np.testing.assert_array_equal(np.asarray(blk.u), u[i])
        np.testing.assert_array_equal(np.asarray(blk.p), p[i])
    assert (dst.time, dst.time_step_index, dst.apply_first, dst.nu) == (0.07, 7, False, 1.0 / 11.0)


def test_interrupted_save_keeps_the_previous_checkpoint(runs, tmp_path, monkeypatch):
    shutil.copytree(runs["dir"] / "port", tmp_path / "ck")
    path = str(tmp_path / "ck")
    before = tck.load_time_state(runs["port"].disc, path)

    def dies_midway(f, **arrays):
        f.write(b"PK\x03\x04 partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(tck.np, "savez_compressed", dies_midway)
    with pytest.raises(KeyboardInterrupt):
        tck.save_time_state(initial_state(runs["port"].disc), path)
    monkeypatch.undo()
    after = tck.load_time_state(runs["port"].disc, path)
    assert int(after.step) == 1
    for a, b in zip((*after.solution, after.time, after.drag, after.lift),
                    (*before.solution, before.time, before.drag, before.lift)):
        assert torch.equal(a, b)


BAD = {  # field: a replacement that does not fit the run
    "p": lambda a: a[:-1],
    "step": lambda a: a.astype(np.int64),
    "lift": lambda a: a.reshape(1),
}


@pytest.mark.parametrize("field", list(BAD))
def test_load_rejects_a_field_that_does_not_fit(runs, tmp_path, field):
    with np.load(runs["dir"] / "port" / "time_state.npz") as data:
        arrays = {k: data[k] for k in data.files}
    arrays[field] = BAD[field](arrays[field])
    np.savez(tmp_path / "time_state.npz", **arrays)
    with pytest.raises(ValueError, match=f"'{field}'"):
        tck.load_time_state(runs["port"].disc, str(tmp_path))

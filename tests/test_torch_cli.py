"""The port's CLI and options against the JAX package's.

  * ``SolverOptions()`` has the JAX package's defaults in every field both
    have (``preconditioner_type`` 0, blockDiagonal, among them);
  * no module of the port imports ``jax`` or the JAX package (a fresh
    interpreter imports them all);
  * ``parse_options`` gives the JAX CLI's field values over argv lists
    that cover every flag;
  * ``main`` at 16x8 on the CPU (BASELINE config 1 cut to size) prints
    the JAX CLI's lift/drag lines: the same labels in the same order, drag
    rtol 1e-7 (lift, rounding on this symmetric mesh, within 1e-7 of the
    drag), Krylov counts per solve within 2%;
  * every flag whose feature is not ported stops the run with the
    ``NotImplementedError`` naming its ROADMAP item (non-zero exit from
    the shell);
  * the stationary ``--direct`` path (``solve_direct``) at 16x8, all-f64,
    gives the JAX package's Krylov count in every tangent solve, drag rtol
    1e-7 and fields within 1e-6 of their magnitude;
  * the unsteady program with ``--profile-dir`` writes a Chrome trace;
    ``--f32`` solves in float32 within f32 rounding of the JAX CLI's
    ``--f32``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from navier_stokes_solver_tpu.api import NSSolverStationary as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.cli import stationary as j_stationary
from navier_stokes_solver_tpu.cli.common import parse_options as j_parse
from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
from navier_stokes_solver_tpu_torch.cli import stationary as t_stationary
from navier_stokes_solver_tpu_torch.cli import unsteady as t_unsteady
from navier_stokes_solver_tpu_torch.cli.common import parse_options as t_parse
from navier_stokes_solver_tpu_torch.obs import TRACE_FILE
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


def _default(f):
    return f.default_factory() if f.default is dataclasses.MISSING else f.default


def test_solver_options_defaults_match_the_jax_package():
    """``device`` is the port's own field; ``dtype`` holds a framework's
    dtype object, so its default is compared by meaning (None = float64 in
    both) rather than by value in the loop."""
    jf, tf = _fields(JOptions), _fields(SolverOptions)
    shared = (set(jf) & set(tf)) - {"device", "dtype"}
    assert {"preconditioner_type", "profile_dir", "mesh_file_name", "fused", "output_dir"} <= shared
    for name in sorted(shared):
        assert _default(tf[name]) == _default(jf[name]), name
    assert _default(tf["dtype"]) is None and _default(jf["dtype"]) is None
    assert SolverOptions().preconditioner_type == 0


def test_the_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import navier_stokes_solver_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'navier_stokes_solver_tpu' or m.startswith('navier_stokes_solver_tpu.'))\n"
        "assert 'navier_stokes_solver_tpu_torch.cli.stationary' in names, names\n"
        "assert 'navier_stokes_solver_tpu_torch.ensemble.sweep' in names, names\n"
        "print(len(names), bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) > 20 and bad.strip() == "[]", out.stdout


ARGVS = [  # (argv, unsteady)
    ([], False),
    ([], True),
    (["-m", "60,40", "-T", "0.03,0.01", "-r", "1.0", "-s", "1", "-p", "1", "-t", "1e-9"], True),
    (["-m", "100,33", "-r", "20", "-s", "0", "-p", "0", "-t", "1e-8", "--quiet"], False),
    (["-s", "2", "-p", "2", "--basis", "60", "--ir", "--schur", "cahouet", "--stokes-schur", "mass"], False),
    (["--ir", "mixed", "--schur", "pcd", "--direct-lu", "--skip-futile-stokes",
      "--consistent-continuity", "--f32"], False),
    (["-M", "--cavity", "--output", "--output-dir", "out", "--profile-dir", "prof", "--dd", "2"], False),
    (["-M", "mesh.msh", "--dd", "2,2", "--fused", "-T", "8,0.01"], True),
]


def _comparable(v):
    if dataclasses.is_dataclass(v):
        return {k: _comparable(x) for k, x in dataclasses.asdict(v).items()}
    if v is not None and type(v).__module__.startswith(("jax", "numpy", "torch")):
        return str(np.dtype(getattr(v, "dtype", v))) if not isinstance(v, torch.dtype) else str(v)[6:]
    return v


def test_parse_options_matches_the_jax_cli():
    for argv, unsteady in ARGVS:
        j, t = j_parse(argv, unsteady), t_parse(argv + CPU, unsteady)
        assert t.device == "cpu"
        for name in set(_fields(JOptions)) & set(_fields(SolverOptions)):
            jv, tv = getattr(j, name), getattr(t, name)
            if name == "precond_config" and jv is not None:
                jv, tv = _comparable(jv), _comparable(tv)
                jv = {k: v for k, v in jv.items() if k in tv}
            assert _comparable(tv) == _comparable(jv), (argv, name)
    assert t_parse([], False).device == "cuda"
    for argv in (["-s", "5"], ["-p", "3"], ["-t", "0"], ["-m", "16"]):
        with pytest.raises(SystemExit):
            t_parse(argv, False)


FORCE_LINES = ("Lift force", "Drag force", "Lift coefficient", "Drag coefficient")


def _force_lines(text):
    return [
        (m.group(1), float(m.group(2)))
        for m in re.finditer(rf"^({'|'.join(FORCE_LINES)}): (\S+)$", text, re.M)
    ]


def test_main_prints_the_jax_cli_lift_and_drag(capsys, monkeypatch):
    """BASELINE config 1 (GMRES + blockDiagonal, tol 1e-8) at 16x8 with
    ``--skip-futile-stokes``.  The CLI runs the default f32 preconditioner,
    and left-preconditioned GMRES under inexact inner solves is chaotic
    (rounding differences grow until the stopping iteration moves), so the
    per-solve Krylov counts are held to 2%, not equality."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", "960")
    argv = ["-m", "16,8", "-r", "20", "-s", "0", "-p", "0", "-t", "1e-8", "--skip-futile-stokes"]
    outs = []
    for main, extra in ((j_stationary.main, []), (t_stationary.main, CPU)):
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    want, got = (_force_lines(o) for o in outs)
    jits, tits = ([int(n) for n in re.findall(r"^   (\d+) iterations$", o, re.M)] for o in outs)
    assert [k for k, _ in got] == [k for k, _ in want] and len(want) == 4
    drag = max(abs(v) for k, v in want if k.startswith("Drag"))
    for (k, g), (_, w) in zip(got, want):
        atol = 1e-7 * drag if k.startswith("Lift") else 0.0
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=atol, err_msg=k)
    assert len(tits) == len(jits) and jits[0] > 100
    for t, j in zip(tits, jits):
        assert abs(t - j) <= 0.02 * j, (tits, jits)


UNPORTED_FLAGS = [  # (CLI module, flags, ROADMAP item the error must name)
    (t_stationary, ["-M", "--dd", "2,2"], "1-D (x-strips)"),  # -M decomposes into x-strips only
    (t_stationary, ["--ir", "mixed"], "A.14"),
]


def test_unported_flags_stop_naming_their_item():
    """... and ``--cavity`` and ``--output``, ported, build their solver
    (``tests/test_torch_io.py`` runs ``--output``)."""
    for cli, flags, item in UNPORTED_FLAGS:
        with pytest.raises(NotImplementedError, match=re.escape(item)):
            cli.main(["-m", "16,8", "--quiet"] + flags + CPU)
    out = subprocess.run(
        [sys.executable, "-m", "navier_stokes_solver_tpu_torch.cli.unsteady", "--ir", "mixed", "--quiet"] + CPU,
        cwd=ROOT, capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode != 0 and "A.14" in out.stderr and out.stdout == ""
    for unsteady in (False, True):
        opts = t_parse(["-m", "16,16", "--cavity", "--output", "--quiet"] + CPU, unsteady=unsteady)
        assert (opts.geometry, opts.write_output) == ("cavity", True)
        assert NSSolverStationary(opts).setup().geo.inlet_kind == "constant"


def _direct(solver, opts):
    """``solve_direct`` with the Krylov count of every tangent solve (the
    Stokes initialization's included); returns (counts, drag, fields)."""
    s = solver(opts).setup()
    counts, solve = [], s.solve_system
    s.solve_system = lambda *a, **kw: counts.append(solve(*a, **kw)) or counts[-1]
    s.solve_direct()
    s.compute_lift_drag()
    s.compute_drag_coeff()
    u, p = s.fields()
    return counts, s.drag_coeff, (np.asarray(u), np.asarray(p))


def test_solve_direct_matches_the_jax_package(monkeypatch):
    """The stationary ``--direct`` path (Stokes initialization, then Newton
    at exactly Re 20) at 16x8, FGMRES + blockTriangular, all-f64
    preconditioner: the JAX package's Krylov count in every tangent solve,
    drag rtol 1e-7, fields within 1e-6 of their magnitude."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", "960")
    kw = dict(mesh_size=(16, 8), Re=20.0, solver_type=1, preconditioner_type=1, tolerance=1e-6, verbose=False)
    f64 = dict(vmult_dtype=None, mg_dtype=None)
    jc, jd, jf = _direct(JSolver, JOptions(precond_config=JCfg(**f64), **kw))
    tc, td, tf = _direct(NSSolverStationary, SolverOptions(precond_config=PrecondConfig(**f64), device="cpu", **kw))
    assert tc == jc and len(jc) >= 3 and jc[0] > 0, (tc, jc)
    np.testing.assert_allclose(td, jd, rtol=1e-7)
    for g, w in zip(tf, jf):
        _assert_field_close(g, w, 1e-6)


def _assert_field_close(got, want, rel):
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rel * scale, (err, scale)


def test_profile_dir_unsteady_and_f32(tmp_path, capsys):
    """A short unsteady --direct step with --profile-dir prints its
    lift/drag lines and leaves a Chrome trace of the solve; --f32 runs the
    stationary --direct solve in float32 as the JAX CLI's --f32 does.  At
    tol 1e-3 on this mesh the two packages' f32 runs part by 2.6e-6 in the
    drag and 3.9e-5 of the velocity's magnitude (summation order), and end
    each tangent solve at the same count; the gates are about ten times
    that (the f32 drag here is 0.7% from the converged one).  A change of
    the numerics fails them: a blockTriangular velocity tolerance of 2e-2
    instead of 1e-2 moves the first solve from 30 to 33 iterations."""
    prof = tmp_path / "prof"
    argv = ["-m", "16,8", "-r", "20", "-p", "1", "-t", "1e-1", "-T", "0.01,0.01", "--direct", "--profile-dir", str(prof)]
    assert t_unsteady.main(argv + CPU) == 0
    assert [k for k, _ in _force_lines(capsys.readouterr().out)] == list(FORCE_LINES)
    with open(prof / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    argv = ["-m", "16,8", "-r", "20", "-p", "1", "-t", "1e-3", "--f32", "--quiet"]
    jc, jd, jf = _direct(JSolver, j_parse(argv, False))
    tc, td, tf = _direct(NSSolverStationary, t_parse(argv + CPU, False))
    assert all(a.dtype == np.float32 for a in jf + tf)
    assert len(tc) == len(jc) and all(abs(t - j) <= 1 for t, j in zip(tc, jc)), (tc, jc)
    np.testing.assert_allclose(td, jd, rtol=3e-5)
    for g, w in zip(tf, jf):
        _assert_field_close(g, w, 4e-4)

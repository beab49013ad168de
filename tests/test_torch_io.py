"""The port's output and mesh IO against the JAX package's, on the CPU.

  * ``write_vtu``, ``write_vtu_record`` (one piece, and ``tiles=(2, 1)``
    with its ``.pvtu``) and ``write_vtu_tri`` write the JAX writers' bytes
    from the same numpy arrays; ``solver.output()`` writes the JAX solver's
    files from the same state, and they decode to the fields at the cell
    corners, bit for bit;
  * the port's native C++ library builds (asserted, never skipped) and its
    VTU writer writes its Python writer's bytes; the JAX package's own
    Python writer leaves out the last newline of its native writer's file
    (a fault of the reference, shown here);
  * the native gmsh reader returns the Python reader's and the JAX
    reader's arrays on MSH2 (``write_msh``), MSH4.1 and MSH1 files;
  * ``write_mesh`` writes the JAX package's ``mesh.msh``;
  * both stationary CLIs with ``--output`` write the same list of files.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import navier_stokes_solver_tpu.native as j_native
from navier_stokes_solver_tpu.api import NSSolverStationary as JSolver
from navier_stokes_solver_tpu.api import SolverOptions as JOptions
from navier_stokes_solver_tpu.cli import stationary as j_stationary
from navier_stokes_solver_tpu.geometry import make_cavity_geometry as j_cavity
from navier_stokes_solver_tpu.geometry import make_channel_geometry as j_channel
from navier_stokes_solver_tpu.geometry import make_fe_space as j_space
from navier_stokes_solver_tpu.io import read_msh as j_read_msh
from navier_stokes_solver_tpu.io import vtu as j_vtu
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu_torch import native
from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions, state_from_numpy
from navier_stokes_solver_tpu_torch.cli import stationary as t_stationary
from navier_stokes_solver_tpu_torch.geometry import make_cavity_geometry, make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.io import read_msh, write_msh, write_vtu, write_vtu_record, write_vtu_tri
from navier_stokes_solver_tpu_torch.io.msh import _read_msh_python
from navier_stokes_solver_tpu_torch.io import vtu as t_vtu
from navier_stokes_solver_tpu_torch.io.vtu import read_vtu
from navier_stokes_solver_tpu_torch.unstructured import triangulate_channel

# One intra-op thread: the shapes here are tiny, and the test workers already
# share the cores; torch's default pool only spins and slows its neighbours.
torch.set_num_threads(1)

CPU = ["--device", "cpu"]
SPACES = {  # name: (geometry makers, mesh, degrees); the channel has inactive cells
    "channel 20x8 Q2/Q1": ((make_channel_geometry, j_channel), (20, 8), (2, 1)),
    "cavity 8x6 Q3/Q2": ((make_cavity_geometry, j_cavity), (8, 6), (3, 2)),
}


def _spaces(name):
    (tg, jg), mesh, deg = SPACES[name]
    return make_fe_space(tg(*mesh), *deg), j_space(jg(*mesh), *deg)


def _fields(space, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, space.NVy, space.NVx)), rng.standard_normal((space.NPy, space.NPx))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(d):
    return {n: _bytes(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def _python_writer(monkeypatch, module):
    """``module``'s quad writer without its native path (the plain version)."""
    monkeypatch.setattr(module, "write_vtu_native", lambda *a, **k: False)


def _jax_tree(d, quad=True):
    """The JAX package's files in ``d``, written by its Python writer, with
    the final newline its C++ writer adds to quad pieces put back."""
    return {n: b + b"\n" if quad and n.endswith(".vtu") else b for n, b in _tree(d).items()}


def test_write_vtu_matches_jax(tmp_path, monkeypatch):
    """Whole pieces and a sub-rectangle with a partitioning array, against
    both JAX writers: its C++ writer's file (its default wherever g++
    builds it), and its Python writer's, which lacks the last newline."""
    for i, name in enumerate(SPACES):
        ts, js = _spaces(name)
        u, p = _fields(ts, i)
        part = np.arange(ts.geo.ny * ts.geo.nx, dtype=float).reshape(ts.geo.ny, ts.geo.nx)
        for kw in ({}, dict(partitioning=part, cell_range=(1, ts.geo.ny, 2, ts.geo.nx - 1))):
            got = _bytes(write_vtu(ts, u, p, str(tmp_path / "t.vtu"), **kw))
            with monkeypatch.context() as m:
                _python_writer(m, t_vtu)
                _python_writer(m, j_native)
                assert _bytes(write_vtu(ts, u, p, str(tmp_path / "tp.vtu"), **kw)) == got
                assert _bytes(j_vtu.write_vtu(js, u, p, str(tmp_path / "jp.vtu"), **kw)) + b"\n" == got
            if j_native.native_available():
                assert _bytes(j_vtu.write_vtu(js, u, p, str(tmp_path / "j.vtu"), **kw)) == got


def test_write_vtu_record_matches_jax(tmp_path, monkeypatch):
    ts, js = _spaces("channel 20x8 Q2/Q1")
    u, p = _fields(ts, 2)
    _python_writer(monkeypatch, j_native)
    for counter, tiles in ((7, None), (3, (2, 1))):
        jdir, tdir, pdir = (str(tmp_path / f"{k}{counter}") for k in "jtp")
        jv = j_vtu.write_vtu_record(js, u, p, directory=jdir, counter=counter, tiles=tiles)
        tv = write_vtu_record(ts, u, p, directory=tdir, counter=counter, tiles=tiles)
        with monkeypatch.context() as m:
            _python_writer(m, t_vtu)
            write_vtu_record(ts, u, p, directory=pdir, counter=counter, tiles=tiles)
        assert os.path.basename(tv) == os.path.basename(jv) == f"output_{counter:03d}.pvtu"
        want = _jax_tree(jdir)
        assert len(want) == 1 + (1 if tiles is None else 2)
        assert _tree(tdir) == want and _tree(pdir) == want
    pieces = [read_vtu(str(tmp_path / "t3" / f"output_003.{r}.vtu")) for r in (0, 1)]
    assert [set(pc["partitioning"]) for pc in pieces] == [{0.0}, {1.0}]


def test_write_vtu_tri_matches_jax(tmp_path):
    from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc

    nodes, tri, edges, tags = triangulate_channel(make_channel_geometry(12, 6))
    rng = np.random.default_rng(3)
    u, p = rng.standard_normal((2, 2 * len(nodes) + 40)), rng.standard_normal(len(nodes))
    arrays = types.SimpleNamespace(coords_p=nodes, dofs_p=tri.astype(np.int32))
    part = np.arange(len(tri), dtype=float)
    for kw in ({}, dict(partitioning=part)):
        want = _bytes(j_vtu.write_vtu_tri(arrays, u, p, str(tmp_path / "j.vtu"), **kw))
        assert _bytes(write_vtu_tri(arrays, u, p, str(tmp_path / "t.vtu"), **kw)) == want
    disc = make_simplex_disc(nodes, tri, edges, tags, dtype=torch.float64, device="cpu")
    assert _bytes(write_vtu_tri(disc, u, p, str(tmp_path / "d.vtu"))) == _bytes(
        j_vtu.write_vtu_tri(arrays, u, p, str(tmp_path / "j.vtu")))


def test_native_library_builds_and_writes_the_python_bytes(tmp_path, monkeypatch):
    assert native.native_available(), "g++ must build the native IO library"
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR and os.path.exists(path)
    for i, name in enumerate(SPACES):
        ts, _ = _spaces(name)
        u, p = _fields(ts, 10 + i)
        for kw in ({}, dict(partitioning=2.0), dict(cell_range=(0, 2, 1, 3))):
            a = _bytes(write_vtu(ts, u, p, str(tmp_path / "n.vtu"), **kw))
            with monkeypatch.context() as m:
                _python_writer(m, t_vtu)
                b = _bytes(write_vtu(ts, u, p, str(tmp_path / "p.vtu"), **kw))
            assert a == b and a.endswith(b"</VTKFile>\n")


def _write_msh41(path, data):
    """``data`` (quads and tagged boundary lines) as gmsh MSH4.1: one curve
    entity per physical tag, the quads on surface entity 1, every node in
    one block."""
    nodes, quad, edges, etag = data["nodes_xy"], data["quad"], data["edges"], data["edge_tag"]
    tags = sorted(set(etag.tolist()))
    box = "0 0 0 1 1 0"
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities", f"0 {len(tags)} 1 0"]
    lines += [f"{k + 1} {box} 1 {t} 0" for k, t in enumerate(tags)]
    lines += [f"1 {box} 1 1 0", "$EndEntities", "$Nodes", f"1 {len(nodes)} 1 {len(nodes)}",
              f"2 1 0 {len(nodes)}"]
    lines += [str(i + 1) for i in range(len(nodes))]
    lines += [f"{x:.17g} {y:.17g} 0" for x, y in nodes]
    lines += ["$EndNodes", "$Elements", f"{len(tags) + 1} {len(edges) + len(quad)} 1 {len(edges) + len(quad)}"]
    eid = 0
    for k, t in enumerate(tags):
        sel = edges[etag == t]
        lines.append(f"1 {k + 1} 1 {len(sel)}")
        for a, b in sel:
            eid += 1
            lines.append(f"{eid} {a + 1} {b + 1}")
    lines.append(f"2 1 3 {len(quad)}")
    for q in quad:
        eid += 1
        lines.append(f"{eid} " + " ".join(str(v + 1) for v in q))
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_native_msh_reader_matches_python_and_jax(tmp_path):
    assert native.native_available()
    files = []
    for name, geo in (("channel", make_channel_geometry(24, 10)), ("cavity", make_cavity_geometry(5, 4))):
        path = str(tmp_path / f"{name}2.msh")
        write_msh(geo, path)
        files.append(path)
        path41 = str(tmp_path / f"{name}41.msh")
        _write_msh41(path41, _read_msh_python(path))
        files.append(path41)
    msh1 = str(tmp_path / "m1.msh")
    with open(msh1, "w") as f:
        f.write("$NOD\n4\n1 0 0 0\n2 1 0 0\n3 1 1 0\n4 0 1 0\n$ENDNOD\n$ELM\n3\n"
                "1 2 5 1 3 1 2 3\n2 2 5 1 3 1 3 4\n3 1 7 2 2 1 2\n$ENDELM\n")
    files.append(msh1)
    for path in files:
        got, plain, want = native.read_msh_native(path), _read_msh_python(path), j_read_msh(path)
        assert set(got) == set(plain) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], plain[k], err_msg=f"{path}:{k}")
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}:{k}")
        for k, a in read_msh(path).items():
            np.testing.assert_array_equal(a, want[k])
    assert {6, 7, 8, 10} == set(read_msh(files[1])["edge_tag"].tolist())  # MSH4.1 tags through $Entities
    with pytest.raises(ValueError, match="failed to parse"):
        native.read_msh_native(str(tmp_path / "missing.msh"))


def test_write_mesh_matches_jax(tmp_path, monkeypatch):
    for geometry, mesh in (("channel", (16, 8)), ("cavity", (8, 8))):
        kw = dict(mesh_size=mesh, degree_velocity=2, degree_pressure=1, geometry=geometry,
                  write_mesh=True, verbose=False)
        for sub, make in (("j", lambda: JSolver(JOptions(**kw))),
                          ("t", lambda: NSSolverStationary(SolverOptions(**kw, device="cpu")))):
            (tmp_path / geometry / sub).mkdir(parents=True)
            monkeypatch.chdir(tmp_path / geometry / sub)
            make().setup()
        want = _bytes(tmp_path / geometry / "j" / "mesh.msh")
        assert _bytes(tmp_path / geometry / "t" / "mesh.msh") == want and want.startswith(b"$MeshFormat")


def test_output_writes_the_jax_files(tmp_path, monkeypatch):
    """``output()`` from the same state: the structured record and the
    ``-M`` triangle piece, byte for byte, decoding to the fields."""
    _python_writer(monkeypatch, j_native)
    for mesh_file in (False, True):
        kw = dict(mesh_size=(10, 6), degree_velocity=2, degree_pressure=1, read_mesh_from_file=mesh_file,
                  geometry="channel" if mesh_file else "cavity", write_output=True, verbose=False)
        dirs = {k: str(tmp_path / f"{k}{int(mesh_file)}") for k in "jt"}
        j = JSolver(JOptions(**kw, output_dir=dirs["j"])).setup()
        t = NSSolverStationary(SolverOptions(**kw, output_dir=dirs["t"], device="cpu")).setup()
        rng = np.random.default_rng(7)
        u, p = rng.standard_normal(j.solution.u.shape), rng.standard_normal(j.solution.p.shape)
        j.solution = JBlocks(jnp.asarray(u), jnp.asarray(p))
        t.solution = state_from_numpy(u, p, dtype=torch.float64, device="cpu")
        for s in (j, t):
            s.output()
            s.output(12)
        want = _jax_tree(dirs["j"], quad=not mesh_file)
        assert _tree(dirs["t"]) == want
        assert ("output_012.0.vtu" in want) and (("output_012.pvtu" in want) is not mesh_file)
        got = read_vtu(os.path.join(dirs["t"], "output_012.0.vtu"))
        cu, cp = (u, p) if mesh_file else (u[:, ::2, ::2].reshape(2, -1), p.ravel())
        n = got["pressure"].shape[0]
        assert np.array_equal(got["velocity"][:, :2].T, cu[:, :n]) and np.array_equal(got["pressure"], cp)


def test_cli_output_writes_the_jax_file_list(tmp_path, monkeypatch, capsys):
    """Both stationary programs with ``--output`` on a short continuation
    (16x8, Re 10): ``output()`` at the JAX package's call sites."""
    monkeypatch.setenv("NSTPU_KRYLOV_CHUNK", "960")
    argv = ["-m", "16,8", "-r", "10", "-s", "1", "-p", "1", "-t", "1e-6", "--skip-futile-stokes",
            "--output", "--quiet", "--output-dir"]
    calls = {}
    for name, main, extra in (("j", j_stationary.main, []), ("t", t_stationary.main, CPU)):
        out = str(tmp_path / name)
        seen = []
        cls = JSolver if name == "j" else NSSolverStationary
        orig = cls.output
        monkeypatch.setattr(cls, "output", lambda self, *a: seen.append(a) or orig(self, *a))
        assert main(argv + [out] + extra) == 0
        calls[name] = (sorted(os.listdir(out)), len(seen))
    capsys.readouterr()
    assert calls["t"] == calls["j"] and calls["j"][0] == ["output_000.0.vtu", "output_000.pvtu"]
    assert calls["j"][1] > 1, calls  # the solve's own calls, besides the program's last one

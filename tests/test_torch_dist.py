"""The port's domain decomposition (``navier_stokes_solver_tpu_torch.dist``)
against the JAX package's ``dist`` and against the port on one process.

The port runs one process per tile (``dist.launch``: spawned ranks, gloo,
the CPU); the rank functions are in ``tests/_torch_dd.py``.  The JAX side
runs here, on the virtual CPU devices of ``conftest.py``, inside
``shard_map``.  Everything is f64 at 16x8 Q2/Q1: tiles and round trips bit
for bit or to 1e-14, operators to 1e-12, capped tangent solves to 1e-10
with equal counts; the whole runs are in ``tests/test_torch_dist_runs.py``.  The -M simplex x-strips
are in ``tests/test_torch_dist_simplex.py``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dd as W
from navier_stokes_solver_tpu import dist as jdist
from navier_stokes_solver_tpu.geometry import make_channel_geometry as jgeo
from navier_stokes_solver_tpu.geometry import make_fe_space as jspace
from navier_stokes_solver_tpu.ops import Blocks as JBlocks
from navier_stokes_solver_tpu.ops import make_disc as jmake_disc
from navier_stokes_solver_tpu.ops import matfree as jmf
from navier_stokes_solver_tpu.precond.mg import attach_mg as jattach_mg
from navier_stokes_solver_tpu_torch import dist
from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions
from navier_stokes_solver_tpu_torch.ops import Blocks, disc_from_numpy
from navier_stokes_solver_tpu_torch.precond.mg import mg_level_shapes

try:  # JAX >= 0.6
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jax.sharding.PartitionSpec


def _jdisc(multigrid=True):
    d = jmake_disc(jspace(jgeo(*W.MESH), 2, 1))
    return jattach_mg(d) if multigrid else d


def _inputs(seed=0):
    """Global (u, p) arrays: a direction x, a state st (scaled to a flow's
    size), and u_old."""
    d = W.global_disc(multigrid=False)
    g = np.random.default_rng(seed)
    nv, np_ = (2,) + d.NV, d.NP
    x = (g.standard_normal(nv), g.standard_normal(np_))
    st = (0.3 * g.standard_normal(nv), g.standard_normal(np_))
    return x, st, 0.3 * g.standard_normal(nv)


def _jax_leaves(d):
    """A JAX Disc (with its MG chain) as a dict of Python scalars / numpy."""
    out = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if f.name == "mg" and v is not None:
            v = {g.name: (_jax_leaves(getattr(v, g.name)) if g.name == "coarse"
                          else np.asarray(getattr(v, g.name)))
                 for g in dataclasses.fields(v)}
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def _jax_mesh(dd):
    n_x, n_y = dd
    mesh = jdist.make_dd_mesh(n_x, n_y, devices=jax.devices()[: n_x * n_y])
    spec = P(("y", "x")) if n_y > 1 else P("x")
    return mesh, spec


def _tile0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _launch(fn, dd, *args):
    return dist.launch(fn, dd[0] * dd[1], dd, *args)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def test_round_trips_match_jax_bit_for_bit():
    """scatter_blocks / gather_blocks: the JAX package's stacked slabs bit
    for bit, and back; tile_blocks is the slab; divisibility raises."""
    x, _, _ = _inputs(3)
    gd = W.global_disc(multigrid=False)
    jd = _jdisc(False)
    for dd in ((4, 1), (2, 2), (1, 2)):
        tile = dist.decompose_disc(gd, *dd, multigrid=False)
        ours = dist.scatter_blocks(Blocks(*map(torch.as_tensor, x)), tile)
        theirs = jdist.scatter_blocks(JBlocks(*map(jnp.asarray, x)), jdist.decompose_disc(jd, *dd))
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))
        back = dist.gather_blocks(ours, tile)
        for a, b in zip(back, x):
            np.testing.assert_array_equal(a, b)
        for i in range(dd[0] * dd[1]):
            t = dist.decompose_disc(gd, *dd, i // dd[0], i % dd[0], multigrid=False)
            got = dist.tile_blocks(Blocks(*map(torch.as_tensor, x)), t)
            np.testing.assert_array_equal(got.u.numpy(), ours.u[i])
            np.testing.assert_array_equal(got.p.numpy(), ours.p[i])
    for dd in ((3, 1), (1, 3)):
        with pytest.raises(ValueError, match="not divisible"):
            dist.decompose_disc(gd, *dd)


def _assert_disc_equal(ours, theirs_leaves, i, path="disc"):
    for k in ("nx", "ny", "deg_v", "deg_p", "n_q1d", "hx", "hy", "halo_n", "halo_ny"):
        assert getattr(ours, k) == theirs_leaves[k], (path, k)
    for k in ("cell_mask", "u_active", "p_active", "u_dirichlet", "u_inlet", "inlet_profile1",
              "neumann_rhs1", "cyl_face_mask"):
        np.testing.assert_allclose(getattr(ours, k).numpy(), theirs_leaves[k][i], rtol=0, atol=1e-14,
                                   err_msg=f"{path}.{k}")
    mg = theirs_leaves["mg"]
    assert (ours.mg is None) == (mg is None), path
    if mg is not None:
        for k in ("Pvx", "Pvy", "Evx", "Evy", "Ppx", "Ppy"):
            np.testing.assert_allclose(getattr(ours.mg, k).numpy(), mg[k][i], rtol=0, atol=1e-14,
                                       err_msg=f"{path}.mg.{k}")
        _assert_disc_equal(ours.mg.coarse, mg["coarse"], i, path + ".coarse")


def test_tiles_match_jax_with_their_mg_chains():
    """Every port tile (no process group) equals the JAX package's tile i:
    masks, profiles, the decomposed MG chain's transfers and level
    shapes; ``disc_from_numpy`` carries a JAX tile across the same."""
    gd = W.global_disc()
    for dd in ((2, 1), (2, 2)):
        jl = _jax_leaves(jdist.decompose_disc(_jdisc(), *dd))
        for i in range(dd[0] * dd[1]):
            tile = dist.decompose_disc(gd, *dd, i // dd[0], i % dd[0])
            assert (tile.halo_iy, tile.halo_ix) == divmod(i, dd[0])
            assert len(mg_level_shapes(tile)) >= 2
            _assert_disc_equal(tile, jl, i)
            carried = disc_from_numpy(jl, device="cpu", tile=i)
            assert mg_level_shapes(carried) == mg_level_shapes(tile)
            assert (carried.halo_iy, carried.halo_ix) == (tile.halo_iy, tile.halo_ix)
            np.testing.assert_array_equal(carried.p_outlet.numpy(), tile.p_outlet.numpy())
            # only the rightmost tiles own the outlet
            assert bool(tile.p_outlet.any()) == (tile.halo_ix == dd[0] - 1)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


def _jax_operators(dd, x, st, u_old):
    """The JAX package's operators inside shard_map on the tiles, gathered
    (the names of ``_torch_dd.operators``)."""
    nu, inv_dt = W.NU, W.INV_DT
    jd = _jdisc(False)
    sd = jdist.decompose_disc(jd, *dd)
    mesh, spec = _jax_mesh(dd)
    xs = jdist.scatter_blocks(JBlocks(*map(jnp.asarray, x)), sd)
    sts = jdist.scatter_blocks(JBlocks(*map(jnp.asarray, st)), sd)
    uos = jdist.scatter_blocks(JBlocks(jnp.asarray(u_old), jnp.asarray(st[1])), sd).u

    def local(d_sh, x_sh, st_sh, uo_sh):
        d, xt, stt, uo = _tile0(d_sh), _tile0(x_sh), _tile0(st_sh), uo_sh[0]
        linq = jmf.eval_state(d, stt)
        dF = jmf.diag_F(d, nu, inv_dt, linq, stokes=False)
        dS = jmf.diag_F(d, nu, inv_dt, None, stokes=True)
        out = {
            "F_stokes": jmf.apply_F(d, nu, inv_dt, None, xt.u, stokes=True),
            "F_newton": jmf.apply_F(d, nu, inv_dt, linq, xt.u, stokes=False),
            "F_stokes_bc": jmf.apply_F(d, nu, inv_dt, None, xt.u, stokes=True, bc_diag=dS),
            "F_newton_bc": jmf.apply_F(d, nu, inv_dt, linq, xt.u, stokes=False, bc_diag=dF),
            "diag_F": dF,
            "B": jmf.apply_B(d, xt.u, stokes=False),
            "Bt": jmf.apply_Bt(d, xt.p),
            "Mp": jmf.apply_Mp(d, nu, xt.p),
            "Lp": jmf.apply_Lp(d, xt.p),
        }
        r = jmf.residual(d, nu, inv_dt, stt, uo, dF, stokes=False, inlet_amp=0.3)
        out["residual_u"], out["residual_p"] = r.u, r.p
        out["dot"] = jmf.make_dot(d)(xt, JBlocks(stt.u, xt.p))
        out["drag"], out["lift"] = jmf.lift_drag_forces(d, nu, stt)
        return jax.tree_util.tree_map(lambda a: a[None], out)

    out = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec, check_vma=False))(
        sd, xs, sts, uos)
    res = {}
    for k, v in out.items():
        v = np.asarray(v)
        if v.ndim == 1:
            res[k] = float(v[0])
        elif v.shape[-1] == sd.NV[-1]:
            res[k] = np.asarray(jdist.gather_blocks(JBlocks(v, jnp.zeros((v.shape[0],) + sd.NP)), sd).u)
        else:
            res[k] = np.asarray(jdist.gather_blocks(JBlocks(jnp.zeros((v.shape[0], 2) + sd.NV), v), sd).p)
    return res


def test_operators_match_single_and_jax():
    """Gathered from the ranks, every operator -- apply_F in both regimes
    with and without its boundary rows (the walls' Dirichlet nodes sit on
    the x-seams, the inlet's on the y-seam), B, Bt, Mp, Lp, the residual,
    the seam-weighted dot, lift and drag -- equals the port on the whole
    channel and the JAX package's shard_map to 1e-12, under (2, 1) and
    (2, 2); every copy of a seam node (corners of four tiles included)
    holds the same bits."""
    x, st, u_old = _inputs()
    dds = [(2, 1), (2, 2)]
    with concurrent.futures.ThreadPoolExecutor(len(dds)) as ex:
        futs = [ex.submit(_launch, W.operators_rank, dd, x, st, u_old) for dd in dds]
        gd = W.global_disc(multigrid=False)
        single = W.operators(gd, Blocks(*map(torch.as_tensor, x)), Blocks(*map(torch.as_tensor, st)),
                             torch.as_tensor(u_old))
        theirs = [_jax_operators(dd, x, st, u_old) for dd in dds]
        runs = [f.result() for f in futs]
    for dd, ranks, jax_ops in zip(dds, runs, theirs):
        for r in ranks[1:]:  # every rank holds the same global result
            for k in r:
                np.testing.assert_array_equal(r[k], ranks[0][k])
        ours = dict(ranks[0])
        assert ours.pop("seams_agree"), f"{dd}: the copies of a seam node differ between tiles"
        assert set(ours) == set(jax_ops) == set(single)
        for k in ours:
            ref = single[k].numpy() if single[k].dim() else float(single[k])
            np.testing.assert_allclose(ours[k], ref, rtol=0, atol=1e-12, err_msg=f"{dd} {k} vs single")
            np.testing.assert_allclose(ours[k], jax_ops[k], rtol=0, atol=1e-12, err_msg=f"{dd} {k} vs JAX")


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def test_capped_tangent_solves_match_jax():
    """FGMRES + blockTriangular + the decomposed MG chain, capped at 20
    iterations, in both regimes under (2, 1): the port's ranks and the JAX
    package's ``DistKernels`` agree to 1e-10 with equal counts."""
    from navier_stokes_solver_tpu.dist.kernels import DistKernels
    from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg

    dd, cap = (2, 1), 20
    _, st, _ = _inputs(1)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(_launch, W.tangent_rank, dd, st, cap)
        mesh, _ = _jax_mesh(dd)
        sd = jdist.device_put_dist(jdist.decompose_disc(_jdisc(), *dd), mesh)
        sts = jdist.device_put_dist(jdist.scatter_blocks(JBlocks(*map(jnp.asarray, st)), sd), mesh)
        K = DistKernels(sd, mesh)
        zero = jax.tree_util.tree_map(jnp.zeros_like, sts)
        cfg = JCfg(vmult_dtype=None, mg_dtype=None)
        theirs = {}
        for stokes in (True, False):
            rhs, _ = K.assemble_kernel(sd, W.NU, W.INV_DT, sts, sts.u, 0.3, stokes=stokes)
            delta, info = K.solve_kernel(
                sd, W.NU, W.INV_DT, sts, rhs, zero, 0.3, 1e-14, stokes=stokes, solver_type=1,
                prec_type=1, variant="unsteady", maxiter=cap, precond_cfg=cfg,
            )
            theirs[stokes] = (jdist.gather_blocks(delta, sd), int(info.iters), float(info.resnorm))
        ours = fut.result()[0]
    for stokes in (True, False):
        (u, p), it, res = ours[stokes]
        tu, tit, tres = theirs[stokes]
        assert it == tit == cap, (stokes, it, tit)
        np.testing.assert_allclose(u, np.asarray(tu.u), rtol=0, atol=1e-10)
        np.testing.assert_allclose(p, np.asarray(tu.p), rtol=0, atol=1e-10)
        np.testing.assert_allclose(res, tres, rtol=1e-6)


def test_run_sweep_mesh_matches_unsharded():
    """``run_sweep(mesh=...)`` with B = 4 over two 'ens' ranks equals the
    unsharded sweep member for member (history and final fields to
    1e-12)."""
    nus = [1 / 20, 1 / 40, 1 / 60, 1 / 80]
    kw = dict(solver_type=1, prec_type=1, tol=1e-9, newton_max=2, krylov_maxiter=20)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(dist.launch, W.sweep_rank, 2, 2, nus, 1, kw)
        ref = W.sweep(nus, 1, kw)
        ranks = fut.result()
    for out in ranks:
        for k in ref["hist"]:
            np.testing.assert_allclose(out["hist"][k], ref["hist"][k], rtol=0, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(out["u"], ref["u"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(out["p"], ref["p"], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_cli_dd_spawns_its_ranks_and_writes_tile_pieces(tmp_path, capfd):
    """``cli.stationary --dd 2,1`` outside a process group spawns two ranks;
    rank 0 alone prints the run and writes one VTU piece per tile
    (partitioning = tile id); the drag is the one-process run's."""
    from navier_stokes_solver_tpu_torch.cli import stationary
    from navier_stokes_solver_tpu_torch.io.vtu import read_vtu

    base = ["-m", "16,8", "-r", "1", "-s", "1", "-p", "1", "-t", "1e-10", "--device", "cpu"]
    out_dir = str(tmp_path / "vtu")
    assert stationary.run(base + ["--dd", "2,1", "--output", "--output-dir", out_dir]) is None
    text = capfd.readouterr().out
    drags = re.findall(r"^Drag force: (\S+)$", text, re.M)
    assert len(drags) == 1, text[-2000:]  # rank 0 only
    assert "Domain decomposition: 2 x 1 tiles (gloo)" in text
    assert sorted(os.listdir(out_dir)) == ["output_000.0.vtu", "output_000.1.vtu", "output_000.pvtu"]
    for rank in range(2):
        part = read_vtu(os.path.join(out_dir, f"output_000.{rank}.vtu"))["partitioning"]
        assert (part == rank).all()
    one = stationary.run(base + ["--quiet"])
    np.testing.assert_allclose(float(drags[0]), one.drag_force, rtol=0, atol=1e-8)


def test_dd_refusals():
    """Outside a process group the dd options raise; a mesh needs exactly
    its ranks; -M with a 2-D tile grid raises the 1-D (x-strips) refusal;
    dd rejects the direct LU."""
    from navier_stokes_solver_tpu_torch.precond.blocks import direct_lu_eligible

    with pytest.raises(RuntimeError, match="process group"):
        NSSolver(SolverOptions(device="cpu", dd=(2, 1)))
    with pytest.raises(NotImplementedError, match=re.escape("simplex decomposition is 1-D (x-strips)")):
        NSSolver(SolverOptions(device="cpu", dd=(2, 2), read_mesh_from_file=True))
    with pytest.raises(ValueError, match="needs dd"):
        NSSolver(SolverOptions(device=["cpu", "cpu"]))
    assert "needs 4 ranks" in dist.launch(W.mesh_errors_rank, 2)[0]
    tile = dist.decompose_disc(W.global_disc(), 2, 1, 0, 1)
    assert not direct_lu_eligible(tile)
    with pytest.raises(ValueError, match="process mesh"):
        from navier_stokes_solver_tpu_torch.ops import matfree

        matfree.apply_B(tile, tile.zeros_u(), stokes=True)


def test_backend_selection_and_card_checks():
    """The ranks' backend: gloo on the CPU and on a shared card, NCCL with a
    card per rank; a rank's device from an explicit list or
    ``cuda:{LOCAL_RANK}``; the NCCL shared-card check is not taken under
    gloo or on the CPU.  (NCCL itself needs cards: not run here.)"""
    from navier_stokes_solver_tpu_torch.dist.mesh import _check_devices, backend_for, rank_device

    cases = {
        "cpu": "gloo", ("cpu", "cpu"): "gloo", ("cuda:0", "cpu"): "gloo",
        ("cuda:0", "cuda:0"): "gloo", ("cuda:0", "cuda:1", "cuda:0"): "gloo",
        "cuda": "nccl", ("cuda:0", "cuda:1"): "nccl", ("cuda:1", "cuda:0", "cuda:2", "cuda:3"): "nccl",
    }
    for device, want in cases.items():
        assert backend_for(list(device) if isinstance(device, tuple) else device) == want, device
    assert rank_device(1, ["cuda:0", "cuda:0"]) == torch.device("cuda", 0)
    assert rank_device(3, None, "cpu") == torch.device("cpu")
    old = os.environ.pop("LOCAL_RANK", None)
    try:
        assert rank_device(2) == torch.device("cuda", 2)
        os.environ["LOCAL_RANK"] = "1"
        assert rank_device(2) == torch.device("cuda", 1)
    finally:
        os.environ.pop("LOCAL_RANK", None)
        if old is not None:
            os.environ["LOCAL_RANK"] = old
    # no collective is issued (there is no process group here)
    _check_devices("gloo", torch.device("cuda", 0), 4)
    _check_devices("nccl", torch.device("cpu"), 4)


def test_port_imports_no_jax():
    """Neither the port nor ``chip_smoke.py`` nor the rank functions import
    JAX or the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|navier_stokes_solver_tpu)(\b|\.)(?!_torch)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "_torch_dd.py"),
             os.path.join(ROOT, "tests", "_torch_dd_simplex.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "navier_stokes_solver_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            text = fh.read()
        bad += [f"{os.path.relpath(f, ROOT)}: {m.group(0).strip()}" for m in pat.finditer(text)]
    assert not bad, bad

"""Discretization data on one device, built from a host FESpace.

``Disc`` bundles everything the matrix-free operators need: the grid and
degree configuration, the mask/profile tensors, and the reference-element
tables already lowered to tensors in the working dtype on the disc's device
(PyTorch runs eagerly, so the tables are built once, by ``make_disc``,
instead of being folded into every call).  ``Disc.to(dtype)`` casts the
floating tensors -- including the multigrid chain -- to another precision.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.elements import make_taylor_hood
from navier_stokes_solver_tpu_torch.geometry.channel import (
    BOUNDARY_CYLINDER,
    BOUNDARY_OUTLET,
)
from navier_stokes_solver_tpu_torch.geometry.space import FESpace

__all__ = ["Disc", "MGEdge", "make_disc", "disc_from_numpy"]

# Floating tensor fields that come from the host space, and the element
# tables; ``Disc.to`` casts both (and re-forms the JxW weights from w_ref).
_FLOAT_FIELDS = ("cell_mask", "inlet_profile1", "neumann_rhs1", "cyl_face_mask")
_TABLE_FIELDS = ("phi_v", "dphi_v", "phi_p", "dphi_p", "w_ref", "cell_tabs")
_BOOL_FIELDS = ("u_active", "p_active", "u_dirichlet", "u_inlet")
_EDGE_FIELDS = ("Pvx", "Pvy", "Evx", "Evy", "Ppx", "Ppy")


@dataclasses.dataclass(frozen=True, eq=False)
class Disc:
    nx: int
    ny: int
    deg_v: int
    deg_p: int
    n_q1d: int
    hx: float
    hy: float

    cell_mask: torch.Tensor  # [ny, nx] dtype; 1.0 on active cells else 0.0
    u_active: torch.Tensor  # [NVy, NVx] bool
    p_active: torch.Tensor  # [NPy, NPx] bool
    u_dirichlet: torch.Tensor  # [NVy, NVx] bool (boundary ids 6, 7, 10)
    u_inlet: torch.Tensor  # [NVy, NVx] bool (boundary id 7)
    inlet_profile1: torch.Tensor  # [NVy] parabolic profile at u_max = 1
    neumann_rhs1: torch.Tensor  # [2, NVy, NVx] outlet Neumann rhs at p_out = 1
    cyl_face_mask: torch.Tensor  # [4, ny, nx] dtype; id-10 faces (lift/drag)

    # ---- element tables in dtype on device (_element_fields) ----
    phi_v: torch.Tensor  # [n_q, n_v]
    dphi_v: torch.Tensor  # [n_q, n_v, 2] reference-element derivatives
    phi_p: torch.Tensor  # [n_q, n_p]
    dphi_p: torch.Tensor  # [n_q, n_p, 2] (the pressure Laplacian, apply_Lp)
    w_ref: torch.Tensor  # [n_q] reference-element quadrature weights
    # fused cell kernel input (ops/cell_kernel.py): P, d/dx, d/dy stacked
    cell_tabs: torch.Tensor  # [3, n_q, n_v]
    # JxW, and JxW times the active-cell mask (the kernel's weights)
    w_q: torch.Tensor  # [n_q]
    cell_w: torch.Tensor  # [n_q, ny, nx]

    # Geometric-multigrid chain (precond/mg.py): link to the next-coarser
    # rediscretized level; None on the coarsest level / without MG.
    mg: "MGEdge | None" = None
    # (f, v) of the body force f(x, y) on the velocity lattice, added to
    # every residual; None without a force (make_disc's ``forcing``)
    forcing_rhs: torch.Tensor | None = None  # [2, NVy, NVx] dtype

    @property
    def dtype(self) -> torch.dtype:
        return self.cell_mask.dtype

    @property
    def device(self) -> torch.device:
        return self.cell_mask.device

    @property
    def tables(self):
        return make_taylor_hood(self.deg_v, self.deg_p, self.n_q1d)

    @property
    def NV(self) -> tuple[int, int]:
        return (self.deg_v * self.ny + 1, self.deg_v * self.nx + 1)

    @property
    def NP(self) -> tuple[int, int]:
        return (self.deg_p * self.ny + 1, self.deg_p * self.nx + 1)

    # The pressure-side masks are built once per Disc: eager PyTorch would
    # launch every mask operation again on each operator call.
    @functools.cached_property
    def p_outlet(self) -> torch.Tensor:
        """Existing pressure-lattice nodes on the outlet boundary (id 8,
        x = 2.2)."""
        NPy, NPx = self.NP
        col = torch.arange(NPx, device=self.device) == NPx - 1
        return col[None, :].expand(NPy, NPx) & self.p_active

    @functools.cached_property
    def p_free(self) -> torch.Tensor:
        """Existing pressure-lattice nodes off the outlet: the rows the
        pressure Laplacian, ``apply_Fp`` and ``apply_Mp_raw`` do not
        eliminate."""
        return self.p_active & ~self.p_outlet

    def zeros_u(self) -> torch.Tensor:
        return torch.zeros((2,) + self.NV, dtype=self.dtype, device=self.device)

    def zeros_p(self) -> torch.Tensor:
        return torch.zeros(self.NP, dtype=self.dtype, device=self.device)

    def replace(self, **kw) -> "Disc":
        return dataclasses.replace(self, **kw)

    def to(self, dtype: torch.dtype) -> "Disc":
        """The same discretization with every floating tensor in ``dtype``
        (the multigrid chain included); ``self`` when already there."""
        if dtype == self.dtype:
            return self
        kw = {f: getattr(self, f).to(dtype) for f in _FLOAT_FIELDS + _TABLE_FIELDS}
        kw.update(_weights(kw["w_ref"], self.hx, self.hy, kw["cell_mask"]))
        kw["mg"] = None if self.mg is None else self.mg.to(dtype)
        if self.forcing_rhs is not None:
            kw["forcing_rhs"] = self.forcing_rhs.to(dtype)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True, eq=False)
class MGEdge:
    """Link from one multigrid level to the next-coarser one.

    ``coarse`` is a rediscretized Disc of the same channel at lower cell
    resolution (its own ``mg`` continues the chain).  Transfers are dense
    1-D tensor factors over the velocity lattice:

      * prolongation (coarse -> fine): ``Pvy @ x @ Pvx^T``;
      * rhs restriction: the transpose sweep, ``Pvy^T @ r @ Pvx``;
      * state restriction (fine -> coarse, for the convection
        linearization): ``Evy @ u @ Evx^T``;
      * the same prolongation over the pressure lattice, ``Ppy @ x @ Ppx^T``
        (the pressure-Laplacian V-cycle, ``precond.mg.make_lp_vcycle``).
    """

    coarse: Disc
    Pvx: torch.Tensor  # [NVx_fine, NVx_coarse]
    Pvy: torch.Tensor  # [NVy_fine, NVy_coarse]
    Evx: torch.Tensor  # [NVx_coarse, NVx_fine]
    Evy: torch.Tensor  # [NVy_coarse, NVy_fine]
    Ppx: torch.Tensor  # [NPx_fine, NPx_coarse]
    Ppy: torch.Tensor  # [NPy_fine, NPy_coarse]

    def to(self, dtype: torch.dtype) -> "MGEdge":
        return MGEdge(
            coarse=self.coarse.to(dtype),
            **{k: getattr(self, k).to(dtype) for k in _EDGE_FIELDS},
        )


def _weights(w_ref: torch.Tensor, hx: float, hy: float, cell_mask: torch.Tensor) -> dict:
    """JxW and the kernel's masked weights, formed in the dtype of ``w_ref``
    as the JAX package forms them (the rounded reference weights times
    hx * hy), so an f32 disc has the JAX package's f32 weights."""
    w_q = w_ref * (hx * hy)
    return dict(w_q=w_q, cell_w=(w_q[:, None, None] * cell_mask).contiguous())


def _element_fields(t, hx: float, hy: float, cell_mask: torch.Tensor) -> dict:
    """The element-table fields of a Disc from the host tables ``t``, in the
    dtype and on the device of ``cell_mask``."""
    dt, dev = cell_mask.dtype, cell_mask.device
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)
    kw = dict(
        phi_v=put(t.phi_v),
        dphi_v=put(t.dphi_v),
        phi_p=put(t.phi_p),
        dphi_p=put(t.dphi_p),
        w_ref=put(t.w_q),
        cell_tabs=put(np.stack([t.phi_v, t.dphi_v[:, :, 0] / hx, t.dphi_v[:, :, 1] / hy])),
    )
    kw.update(_weights(kw["w_ref"], hx, hy, cell_mask))
    return kw


def _neumann_rhs_unit(space: FESpace) -> np.ndarray:
    """Outlet Neumann rhs at p_out = 1 (NSSolver.cpp:528-551), host-side.

    cell_rhs(i) -= p_out * (n . phi_i) * JxW_face over boundary-id-8 faces
    (state independent; already negated: this is the rhs contribution).
    """
    t = space.tables
    geo = space.geo
    k = t.deg_v
    out = np.zeros((2, space.NVy, space.NVx))
    face_h = [geo.hy, geo.hy, geo.hx, geo.hx]  # face lengths (W, E, S, N)
    for f in range(4):
        sel = geo.face_id[f] == BOUNDARY_OUTLET
        if not sel.any():
            continue
        n = t.normals[f]
        loc = -np.einsum("q,qm->m", t.w_qf * face_h[f], t.phi_v_face[f])
        iy, ix = np.nonzero(sel)
        n1 = k + 1
        for m in range(n1 * n1):
            a, b = divmod(m, n1)
            for c in range(2):
                if n[c] == 0.0:
                    continue
                np.add.at(out[c], (k * iy + a, k * ix + b), loc[m] * n[c])
    return out


def _forcing_rhs(space: FESpace, forcing) -> np.ndarray:
    """(f, v) projected onto the velocity test functions, host-side (the
    JAX package's order of summation)."""
    t = space.tables
    geo = space.geo
    k = t.deg_v
    out = np.zeros((2, space.NVy, space.NVx))
    w = t.w_q * geo.hx * geo.hy
    cx, cy = geo.cell_centers()
    x0s = cx - 0.5 * geo.hx
    y0s = cy - 0.5 * geo.hy
    qx = np.tile(t.q1d, t.n_q1d)
    qy = np.repeat(t.q1d, t.n_q1d)
    iy, ix = np.nonzero(geo.cell_active)
    # physical quadrature points per active cell
    X = x0s[ix][:, None] + qx[None, :] * geo.hx  # [n_cells, n_q]
    Y = y0s[iy][:, None] + qy[None, :] * geo.hy
    fx, fy = forcing(X, Y)  # broadcastable arrays [n_cells, n_q]
    loc_x = np.einsum("q,qm,cq->cm", w, t.phi_v, np.broadcast_to(fx, X.shape))
    loc_y = np.einsum("q,qm,cq->cm", w, t.phi_v, np.broadcast_to(fy, X.shape))
    n1 = k + 1
    for m in range(n1 * n1):
        a, b = divmod(m, n1)
        np.add.at(out[0], (k * iy + a, k * ix + b), loc_x[:, m])
        np.add.at(out[1], (k * iy + a, k * ix + b), loc_y[:, m])
    return out


def make_disc(
    space: FESpace, dtype: torch.dtype, device: torch.device | str, forcing=None
) -> Disc:
    """Lower a host FESpace to tensors of ``dtype`` on ``device``.

    ``forcing``: optional callable ``f(x, y) -> (fx, fy)`` (vectorized over
    arrays); its weak-form projection is added to every velocity rhs.
    """
    geo = space.geo
    t = space.tables
    fl = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    bl = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    cell_mask = fl(geo.cell_active)
    return Disc(
        nx=geo.nx,
        ny=geo.ny,
        deg_v=t.deg_v,
        deg_p=t.deg_p,
        n_q1d=t.n_q1d,
        hx=geo.hx,
        hy=geo.hy,
        cell_mask=cell_mask,
        u_active=bl(space.u_active),
        p_active=bl(space.p_active),
        u_dirichlet=bl(space.u_dirichlet),
        u_inlet=bl(space.u_inlet),
        inlet_profile1=fl(space.inlet_profile(1.0)),
        neumann_rhs1=fl(_neumann_rhs_unit(space)),
        cyl_face_mask=fl(geo.face_id == BOUNDARY_CYLINDER),
        forcing_rhs=None if forcing is None else fl(_forcing_rhs(space, forcing)),
        **_element_fields(t, geo.hx, geo.hy, cell_mask),
    )


def disc_from_numpy(
    leaves: dict,
    *,
    device: torch.device | str,
    dtype: torch.dtype | None = None,
) -> Disc:
    """Build a ``Disc`` from the JAX package's ``Disc`` fields as a dict of
    Python scalars and numpy arrays (``{name: np.asarray(value)}``).

    ``leaves["mg"]``, when present and not None, is the same kind of dict
    for the JAX ``MGEdge`` (its ``coarse`` a nested Disc dict), so a test
    can carry the exact reference hierarchy across, and
    ``leaves["forcing_rhs"]`` the body force's rhs.  The
    domain-decomposition halo settings must be unset.
    """
    if leaves.get("halo_axis") is not None or leaves.get("halo_axis_y") is not None:
        raise NotImplementedError(
            "decomposed discs are not ported yet (ROADMAP.md A.D9, dist/)"
        )
    if dtype is None:
        dtype = torch.float64 if np.asarray(leaves["cell_mask"]).dtype == np.float64 else torch.float32
    fl = lambda a: torch.as_tensor(np.array(a), device=device).to(dtype)
    bl = lambda a: torch.as_tensor(np.array(a, bool), device=device)
    mg = leaves.get("mg")
    edge = None
    if mg is not None:
        edge = MGEdge(
            coarse=disc_from_numpy(mg["coarse"], device=device, dtype=dtype),
            **{k: fl(mg[k]) for k in _EDGE_FIELDS},
        )
    deg = tuple(int(leaves[k]) for k in ("deg_v", "deg_p", "n_q1d"))
    hx, hy = float(leaves["hx"]), float(leaves["hy"])
    floats = {k: fl(leaves[k]) for k in _FLOAT_FIELDS}
    forcing = leaves.get("forcing_rhs")
    return Disc(
        nx=int(leaves["nx"]),
        ny=int(leaves["ny"]),
        deg_v=deg[0],
        deg_p=deg[1],
        n_q1d=deg[2],
        hx=hx,
        hy=hy,
        mg=edge,
        forcing_rhs=None if forcing is None else fl(forcing),
        **floats,
        **{k: bl(leaves[k]) for k in _BOOL_FIELDS},
        **_element_fields(make_taylor_hood(*deg), hx, hy, floats["cell_mask"]),
    )

"""Taylor-Hood reference element tables (host-side NumPy precompute).

The reference builds its FE space from deal.II ``FE_Q(degree_velocity)`` x dim
+ ``FE_Q(degree_pressure)`` (NSSolver.cpp:118-124) with quadrature
``QGauss(fe->degree + 1)`` (NSSolver.cpp:133) and the matching face rule
(NSSolver.cpp:138).  deal.II's ``FE_Q`` places its support points at
Gauss-Lobatto nodes, which we reproduce so that nodal interpolation of
boundary data (``VectorTools::interpolate_boundary_values``) matches.

All tables live on the unit reference cell [0,1]^2.  Local node numbering is
lexicographic: ``m = a_y * (deg+1) + a_x``.  Quadrature numbering likewise:
``q = q_y * n_q1d + q_x``.  Faces are ordered (W, E, S, N) with cell-outward
normals (-1,0), (1,0), (0,-1), (0,1).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = [
    "gauss_lobatto_01",
    "gauss_legendre_01",
    "lagrange_values",
    "lagrange_derivs",
    "TaylorHoodTables",
    "make_taylor_hood",
]


def gauss_lobatto_01(n: int) -> np.ndarray:
    """``n`` Gauss-Lobatto points on [0,1] (n >= 2), sorted ascending.

    These are deal.II's FE_Q support points (endpoints + roots of P'_{n-1}).
    """
    if n < 2:
        raise ValueError("Gauss-Lobatto needs n >= 2")
    if n == 2:
        pts = np.array([-1.0, 1.0])
    else:
        coeffs = np.zeros(n)
        coeffs[n - 1] = 1.0  # Legendre P_{n-1}
        dP = np.polynomial.legendre.legder(coeffs)
        interior = np.polynomial.legendre.legroots(dP)
        pts = np.concatenate([[-1.0], np.sort(np.real(interior)), [1.0]])
    return (pts + 1.0) / 2.0


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n``-point Gauss-Legendre rule on [0,1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis on ``nodes`` at points ``x``.

    Returns array of shape ``[len(x), len(nodes)]``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(nodes)
    out = np.ones((len(x), n))
    for j in range(n):
        for k in range(n):
            if k != j:
                out[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def lagrange_derivs(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """First derivatives of the Lagrange basis at points ``x``.

    Returns array of shape ``[len(x), len(nodes)]``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = len(nodes)
    out = np.zeros((len(x), n))
    for j in range(n):
        denom = np.prod([nodes[j] - nodes[k] for k in range(n) if k != j])
        for m in range(n):
            if m == j:
                continue
            term = np.ones(len(x))
            for k in range(n):
                if k != j and k != m:
                    term *= x - nodes[k]
            out[:, j] += term
        out[:, j] /= denom
    return out


# Face ordering: W (xi=0), E (xi=1), S (eta=0), N (eta=1).
FACE_NAMES = ("W", "E", "S", "N")
FACE_NORMALS = np.array(
    [[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]], dtype=np.float64
)


@dataclasses.dataclass(frozen=True)
class TaylorHoodTables:
    """Precomputed shape-function tables for one Taylor-Hood pair.

    Gradients are with respect to reference coordinates (xi, eta) in [0,1]^2;
    physical gradients require scaling by (1/hx, 1/hy) for affine rectangular
    cells (all cells of the structured channel grid are congruent).
    """

    deg_v: int
    deg_p: int
    n_q1d: int

    # 1D support points in [0,1]
    nodes_v: np.ndarray  # [deg_v + 1]
    nodes_p: np.ndarray  # [deg_p + 1]

    # Volume quadrature
    q1d: np.ndarray  # [n_q1d]
    w1d: np.ndarray  # [n_q1d]
    w_q: np.ndarray  # [n_q]    tensor weights, q = qy * n_q1d + qx

    # Shape tables at volume quadrature points
    phi_v: np.ndarray  # [n_q, n_v]
    dphi_v: np.ndarray  # [n_q, n_v, 2]   (d/dxi, d/deta)
    phi_p: np.ndarray  # [n_q, n_p]
    dphi_p: np.ndarray  # [n_q, n_p, 2]

    # Face tables (faces W, E, S, N), n_qf = n_q1d points per face
    phi_v_face: np.ndarray  # [4, n_qf, n_v]
    dphi_v_face: np.ndarray  # [4, n_qf, n_v, 2]
    phi_p_face: np.ndarray  # [4, n_qf, n_p]
    w_qf: np.ndarray  # [n_qf]
    normals: np.ndarray  # [4, 2] cell-outward reference normals

    @property
    def n_v(self) -> int:
        return (self.deg_v + 1) ** 2

    @property
    def n_p(self) -> int:
        return (self.deg_p + 1) ** 2

    @property
    def n_q(self) -> int:
        return self.n_q1d**2

    @property
    def n_qf(self) -> int:
        return self.n_q1d


def _tensor_tables(
    nodes: np.ndarray, pts_x: np.ndarray, pts_y: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """2D tensor-product shape values and gradients at points (pts_x, pts_y).

    ``pts_x``/``pts_y`` are parallel arrays of evaluation coordinates.
    Returns (phi [n_pts, n_loc], dphi [n_pts, n_loc, 2]) with lexicographic
    local numbering m = a_y * n1d + a_x.
    """
    vx = lagrange_values(nodes, pts_x)  # [n_pts, n1d]
    vy = lagrange_values(nodes, pts_y)
    dx = lagrange_derivs(nodes, pts_x)
    dy = lagrange_derivs(nodes, pts_y)
    n_pts = len(pts_x)
    n1d = len(nodes)
    phi = np.einsum("pa,pb->pab", vy, vx).reshape(n_pts, n1d * n1d)
    dphi = np.empty((n_pts, n1d * n1d, 2))
    dphi[:, :, 0] = np.einsum("pa,pb->pab", vy, dx).reshape(n_pts, n1d * n1d)
    dphi[:, :, 1] = np.einsum("pa,pb->pab", dy, vx).reshape(n_pts, n1d * n1d)
    return phi, dphi


@lru_cache(maxsize=None)
def make_taylor_hood(deg_v: int, deg_p: int, n_q1d: int | None = None) -> TaylorHoodTables:
    """Build tables for a Q(deg_v)/Q(deg_p) Taylor-Hood pair.

    Default quadrature matches the reference: ``QGauss(fe->degree + 1)`` where
    ``fe->degree = max(deg_v, deg_p) = deg_v`` (NSSolver.cpp:133) -- i.e.
    ``n_q1d = deg_v + 1`` points per direction.
    """
    if deg_p >= deg_v:
        raise ValueError("Taylor-Hood requires deg_p < deg_v")
    if n_q1d is None:
        n_q1d = deg_v + 1

    nodes_v = gauss_lobatto_01(deg_v + 1)
    nodes_p = gauss_lobatto_01(deg_p + 1)
    q1d, w1d = gauss_legendre_01(n_q1d)

    # Volume points: q = qy * n_q1d + qx
    qx = np.tile(q1d, n_q1d)
    qy = np.repeat(q1d, n_q1d)
    w_q = np.repeat(w1d, n_q1d) * np.tile(w1d, n_q1d)

    phi_v, dphi_v = _tensor_tables(nodes_v, qx, qy)
    phi_p, dphi_p = _tensor_tables(nodes_p, qx, qy)

    # Faces: W (0, t), E (1, t), S (t, 0), N (t, 1)
    zero = np.zeros_like(q1d)
    one = np.ones_like(q1d)
    face_pts = [(zero, q1d), (one, q1d), (q1d, zero), (q1d, one)]
    pvf, dvf, ppf = [], [], []
    for fx, fy in face_pts:
        pv, dv = _tensor_tables(nodes_v, fx, fy)
        pp, _ = _tensor_tables(nodes_p, fx, fy)
        pvf.append(pv)
        dvf.append(dv)
        ppf.append(pp)

    return TaylorHoodTables(
        deg_v=deg_v,
        deg_p=deg_p,
        n_q1d=n_q1d,
        nodes_v=nodes_v,
        nodes_p=nodes_p,
        q1d=q1d,
        w1d=w1d,
        w_q=w_q,
        phi_v=phi_v,
        dphi_v=dphi_v,
        phi_p=phi_p,
        dphi_p=dphi_p,
        phi_v_face=np.stack(pvf),
        dphi_v_face=np.stack(dvf),
        phi_p_face=np.stack(ppf),
        w_qf=w1d,
        normals=FACE_NORMALS,
    )

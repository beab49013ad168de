"""P2/P1 simplex (triangle) Taylor-Hood reference tables.

The reference's ``-M`` file-mesh path switches to ``FE_SimplexP(2)`` x dim +
``FE_SimplexP(1)`` with ``QGaussSimplex(fe->degree + 1)`` quadrature
(NSSolver.cpp:184-207, test.cpp:66-70).  Host-side NumPy precompute of the
shape values/gradients on the unit triangle {(x,y): x,y >= 0, x+y <= 1}.

Local P2 numbering (deal.II simplex convention: vertices then edge
midpoints): 0,1,2 = vertices (0,0),(1,0),(0,1); 3 = edge(0,1), 4 = edge(1,2),
5 = edge(2,0).  P1: the three vertices.  Quadrature: symmetric Gauss rules
on the triangle (degree-5-exact 7-point rule for the volume, matching the
polynomial degrees the reference integrates; 3-point Gauss on edges).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = ["SimplexTables", "make_simplex_tables", "EDGE_VERTICES"]

# local edges (by local vertex pair), deal.II ordering
EDGE_VERTICES = ((0, 1), (1, 2), (2, 0))


def _p2_values(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """P2 basis at points (x, y): [n_pts, 6]."""
    l0 = 1.0 - x - y
    l1 = x
    l2 = y
    return np.stack(
        [
            l0 * (2 * l0 - 1),
            l1 * (2 * l1 - 1),
            l2 * (2 * l2 - 1),
            4 * l0 * l1,
            4 * l1 * l2,
            4 * l2 * l0,
        ],
        axis=-1,
    )


def _p2_grads(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """P2 reference gradients: [n_pts, 6, 2]."""
    l0 = 1.0 - x - y
    l1 = x
    l2 = y
    dl0 = np.array([-1.0, -1.0])
    dl1 = np.array([1.0, 0.0])
    dl2 = np.array([0.0, 1.0])
    n = len(x)
    g = np.zeros((n, 6, 2))
    g[:, 0] = (4 * l0 - 1)[:, None] * dl0
    g[:, 1] = (4 * l1 - 1)[:, None] * dl1
    g[:, 2] = (4 * l2 - 1)[:, None] * dl2
    g[:, 3] = 4 * (l1[:, None] * dl0 + l0[:, None] * dl1)
    g[:, 4] = 4 * (l2[:, None] * dl1 + l1[:, None] * dl2)
    g[:, 5] = 4 * (l0[:, None] * dl2 + l2[:, None] * dl0)
    return g


def _p1_values(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.stack([1.0 - x - y, x, y], axis=-1)


def _p1_grads(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    n = len(x)
    g = np.zeros((n, 3, 2))
    g[:, 0] = [-1.0, -1.0]
    g[:, 1] = [1.0, 0.0]
    g[:, 2] = [0.0, 1.0]
    return g


# Degree-5-exact symmetric 7-point rule on the unit triangle (area 1/2).
_A1 = 0.0597158717897698
_B1 = 0.4701420641051151
_A2 = 0.7974269853530873
_B2 = 0.1012865073234563
_W0 = 0.225
_W1 = 0.1323941527885062
_W2 = 0.1259391805448271
_TRI_Q = np.array(
    [
        [1 / 3, 1 / 3, _W0],
        [_A1, _B1, _W1],
        [_B1, _A1, _W1],
        [_B1, _B1, _W1],
        [_A2, _B2, _W2],
        [_B2, _A2, _W2],
        [_B2, _B2, _W2],
    ]
)
# weights above sum to 1; scale by the reference-triangle area 1/2
_TRI_W_SCALE = 0.5

# 3-point Gauss on [0,1] (degree-5 exact) for edge integrals
_EDGE_T = np.array([0.5 - np.sqrt(15) / 10, 0.5, 0.5 + np.sqrt(15) / 10])
_EDGE_W = np.array([5 / 18, 8 / 18, 5 / 18])


@dataclasses.dataclass(frozen=True)
class SimplexTables:
    """Shape tables on the unit triangle (P2 velocity, P1 pressure)."""

    # volume quadrature
    q_xy: np.ndarray  # [n_q, 2]
    w_q: np.ndarray  # [n_q] (sums to 1/2, the reference-triangle area)
    phi_v: np.ndarray  # [n_q, 6]
    dphi_v: np.ndarray  # [n_q, 6, 2] reference gradients
    phi_p: np.ndarray  # [n_q, 3]
    dphi_p: np.ndarray  # [n_q, 3, 2]

    # edge quadrature (per local edge, parameterized v_a -> v_b)
    t_e: np.ndarray  # [n_qe] curve parameters
    w_e: np.ndarray  # [n_qe] weights on [0,1]
    phi_v_edge: np.ndarray  # [3, n_qe, 6]
    dphi_v_edge: np.ndarray  # [3, n_qe, 6, 2]
    phi_p_edge: np.ndarray  # [3, n_qe, 3]

    n_v: int = 6
    n_p: int = 3


@lru_cache(maxsize=None)
def make_simplex_tables() -> SimplexTables:
    q_xy = _TRI_Q[:, :2]
    w_q = _TRI_Q[:, 2] * _TRI_W_SCALE
    x, y = q_xy[:, 0], q_xy[:, 1]

    # edge points in reference coordinates
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    pv_e, dv_e, pp_e = [], [], []
    for (a, b) in EDGE_VERTICES:
        pts = verts[a][None, :] * (1 - _EDGE_T[:, None]) + verts[b][None, :] * _EDGE_T[:, None]
        ex, ey = pts[:, 0], pts[:, 1]
        pv_e.append(_p2_values(ex, ey))
        dv_e.append(_p2_grads(ex, ey))
        pp_e.append(_p1_values(ex, ey))

    return SimplexTables(
        q_xy=q_xy,
        w_q=w_q,
        phi_v=_p2_values(x, y),
        dphi_v=_p2_grads(x, y),
        phi_p=_p1_values(x, y),
        dphi_p=_p1_grads(x, y),
        t_e=_EDGE_T,
        w_e=_EDGE_W,
        phi_v_edge=np.stack(pv_e),
        dphi_v_edge=np.stack(dv_e),
        phi_p_edge=np.stack(pp_e),
    )

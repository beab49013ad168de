"""Reference-element tables for tensor-product Taylor-Hood elements.

A copy of the JAX package's NumPy-only ``elements`` module (that package's
``__init__`` imports jax, so the port carries its own): shape values and
gradients of a Q(deg_v)/Q(deg_p) pair at Gauss quadrature points, plus face
tables, precomputed host-side.
"""

from navier_stokes_solver_tpu_torch.elements.taylor_hood import (
    TaylorHoodTables,
    gauss_legendre_01,
    gauss_lobatto_01,
    lagrange_derivs,
    lagrange_values,
    make_taylor_hood,
)

__all__ = [
    "TaylorHoodTables",
    "make_taylor_hood",
    "gauss_lobatto_01",
    "gauss_legendre_01",
    "lagrange_values",
    "lagrange_derivs",
]

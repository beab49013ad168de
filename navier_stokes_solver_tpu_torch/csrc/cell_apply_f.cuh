// Per-cell arithmetic of the velocity-block apply F, shared by the cell
// kernel (cell_apply_f.cu) and the one-launch apply_F (apply_f_fused.cu).
//
// Both kernels stage a strip of the velocity lattice and the three tables
// in shared memory, then run the two steps below on it; one body of code
// serves both, so a cell's local result is the same bit for bit in both.
// Every rounding step is spelled out with an intrinsic: nvcc's default
// contraction (-fmad=true) may fuse a product into a neighbouring sum in
// either order, and chose differently for the two components in the
// port's first version; these keep its results and leave the compiler no
// choice.  Do not write plain a * b + c in this arithmetic.
//
// Layouts (C cells, the contiguous axis; B members; jm = q B + member):
//   tab   [3, n_q, n_v]        P, d/dx (scaled by 1/hx), d/dy (scaled by 1/hy)
//   w     [n_q, C]             JxW times the active-cell mask
//   uq    [n_q, B, 2, C]       u_k at the quadrature points
//   guq   [n_q, B, 2, 2, C]    grad u_k: component, derivative direction
//   f     [NF, n_q, cells]     the weighted fluxes, in shared memory

#pragma once

#include <cuda_runtime.h>

namespace nstt {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

template <int K>
struct Cell {
  static constexpr int N = (K + 1) * (K + 1);  // n_v = n_q
};

template <bool STOKES>
struct Flux {
  static constexpr int NF = STOKES ? 4 : 6;  // fluxes per (q, cell)
};

// Evaluate at quadrature point q of one cell: the gradients (and, in the
// Newton regime, the values) of both components over the local DoFs m
// ascending, then the weighted fluxes, written to f[0], f[fs], ...,
// f[(NF - 1) fs].  tab: the tables in shared memory.  x0, x1: the cell's
// local node (0, 0) of component 0 and 1 in a shared-memory strip whose
// rows are rs apart (node (a, b) at a rs + b).  c: the cell's column in w,
// uq and guq.
template <typename T, int K, bool STOKES>
__device__ __forceinline__ void cell_flux(const T* tab, int q, const T* x0, const T* x1, int rs,
                                          T nu, T inv_dt, const T* __restrict__ w,
                                          const T* __restrict__ uq, const T* __restrict__ guq,
                                          int jm, int C, int c, T* f, int fs) {
  constexpr int N = Cell<K>::N;
  const T* pq = tab + q * N;
  const T* dxq = tab + N * N + q * N;
  const T* dyq = tab + 2 * N * N + q * N;
  T gx0 = T(0), gy0 = T(0), gx1 = T(0), gy1 = T(0), v0 = T(0), v1 = T(0);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int off = (m / (K + 1)) * rs + m % (K + 1);
    const T xm0 = x0[off], xm1 = x1[off];
    gx0 = fmadd(dxq[m], xm0, gx0);
    gy0 = fmadd(dyq[m], xm0, gy0);
    gx1 = fmadd(dxq[m], xm1, gx1);
    gy1 = fmadd(dyq[m], xm1, gy1);
    if (!STOKES) {
      v0 = fmadd(pq[m], xm0, v0);
      v1 = fmadd(pq[m], xm1, v1);
    }
  }
  const T wq = w[q * C + c];
  f[0] = mul(mul(nu, gx0), wq);
  f[fs] = mul(mul(nu, gy0), wq);
  f[2 * fs] = mul(mul(nu, gx1), wq);
  f[3 * fs] = mul(mul(nu, gy1), wq);
  if (!STOKES) {
    const T u0 = uq[(2 * jm) * C + c], u1 = uq[(2 * jm + 1) * C + c];
    const T g00 = guq[(4 * jm + 0) * C + c], g01 = guq[(4 * jm + 1) * C + c];
    const T g10 = guq[(4 * jm + 2) * C + c], g11 = guq[(4 * jm + 3) * C + c];
    // (u_k . grad) x + (x . grad) u_k + x / dt, summed left to right
    T a0 = fmadd(u0, gx0, mul(u1, gy0));
    T a1 = fmadd(u0, gx1, mul(u1, gy1));
    a0 = fmadd(inv_dt, v0, fmadd(v1, g01, fmadd(v0, g00, a0)));
    a1 = fmadd(inv_dt, v1, fmadd(v1, g11, fmadd(v0, g10, a1)));
    f[4 * fs] = mul(a0, wq);
    f[5 * fs] = mul(a1, wq);
  }
}

// Project one cell's fluxes onto local DoF m: y = sum over q ascending of
// dx fgx + dy fgy (+ p fv).  tab: the tables in shared memory.  f: the
// cell's flux at q = 0; quadrature points qs apart, flux kinds fs apart
// (cell_flux's layout).
template <typename T, int K, bool STOKES>
__device__ __forceinline__ void cell_project(const T* tab, int m, const T* f, int qs, int fs,
                                             T& y0, T& y1) {
  constexpr int N = Cell<K>::N;
  const T* sP = tab;
  const T* sDx = tab + N * N;
  const T* sDy = tab + 2 * N * N;
  y0 = T(0);
  y1 = T(0);
#pragma unroll 4
  for (int q = 0; q < N; ++q) {
    const T* fq = f + q * qs;
    const T dx = sDx[q * N + m], dy = sDy[q * N + m];
    // the first version's contractions: dx first for component 0, dy
    // first for component 1
    T a0 = fmadd(dx, fq[0], mul(dy, fq[fs]));
    T a1 = fmadd(dy, fq[3 * fs], mul(dx, fq[2 * fs]));
    if (!STOKES) {
      const T p = sP[q * N + m];
      a0 = fmadd(p, fq[4 * fs], a0);
      a1 = fmadd(p, fq[5 * fs], a1);
    }
    y0 = add(y0, a0);
    y1 = add(y1, a1);
  }
}

}  // namespace nstt

// Fused per-cell velocity-block apply F for the structured Taylor-Hood grid.
//
// Replaces the JAX package's Pallas TPU kernel
// navier_stokes_solver_tpu/ops/pallas_cell.py::_run.  For every cell c it
// computes, with x the velocity DoFs of the cell, both components,
//
//   g = (Dx x, Dy x)           gradients at the n_q quadrature points
//   v = P x                    values (Newton regime only)
//   f_grad = nu * g
//   f_val  = (u_k . grad) x + (x . grad) u_k + x / dt   (Newton regime)
//   y = Dx^T (w f_grad_x) + Dy^T (w f_grad_y) [+ P^T (w f_val)]
//
// with w = JxW times the active-cell mask.
//
// Input.  x is read through the five element strides of a cell-local view
// [k+1, k+1, 2, ny, nx]: element [a, b, comp, iy, ix] is local DoF
// m = a (k+1) + b of component comp of cell (iy, ix).  On the velocity
// lattice [2, NY, NX] (ops/lattice.py::lattice_view, "lattice" below) that
// view reads the lattice in place, and neighbouring cells share their edge
// nodes; on gathered DoFs x_loc [n_v, 2, ny, nx] they do not.
//
// Other layouts (C = ny * nx cells, the contiguous axis; B members):
//   y     [n_v, B, 2, C]      local DoF m, member, component, cell
//   uq    [n_q, B, 2, C]      u_k at the quadrature points
//   guq   [n_q, B, 2, 2, C]   grad u_k: component, derivative direction
//   w     [n_q, C]            shared by the members
//   tabs  [3, n_q, n_v]       P, d/dx (scaled by 1/hx), d/dy (scaled by 1/hy)
//   nu_b  [B] or null         per-member viscosity; null: the scalar nu
//
// Member axis.  An ensemble (ensemble/sweep.py) advances B members, each
// with its own viscosity, through one launch: the member is blockIdx.y, and
// the input view gains a member stride.  A member's arithmetic is that of
// an unbatched launch on its operands, in the same order, so member b of a
// batched launch equals the unbatched launch bit for bit.  The viscosity
// comes through a device pointer, so a batched launch reads nothing back to
// the host.  The member indexing is a template parameter: an unbatched
// launch (B = 1, nu by value) runs the code without it, which the member
// arithmetic made 1-5% slower at 300x100 (H100; PERF.md).
//
// Bound.  At 100x70 f32 in the Newton regime one call reads the lattice
// (508 KB), u_k, grad u_k and w (3.1 MB) and writes y (896 KB): ~4.5 MB,
// 1.4 us at 3.35 TB/s; its ~46 MFLOP take 0.7 us at 67 TFLOP/s.  It is
// bound by memory (Stokes: ~1.85 MB, 0.55 us).
//
// Design.  A block owns a tile of T <= 20 consecutive cells of one cell
// row (T = nx / ceil(nx / 20), rounded up, so the tiles of a row are even:
// 350 blocks of 20 cells at 100x70) and runs n_q T threads in three steps:
//   1. stage: the three tables, and the tile's strip of x, [2][k+1][k T + 1]
//      lattice nodes (each shared edge node once), into shared memory,
//      loading along the lattice row (coalesced on a unit-stride row);
//   2. evaluate: one thread per (quadrature point q, cell) forms g (and v)
//      for both components from shared memory, reads u_k, grad u_k and w
//      at (q, c) -- coalesced along c -- and writes the 4 (Stokes) or 6
//      (Newton) weighted fluxes to shared memory;
//   3. project: one thread per (local DoF m, cell) sums y[m] over q and
//      writes y, coalesced.
// That is 16 threads per Q3 cell (112k at 100x70) where the first version
// ran one, with a few tens of registers each instead of 157-255.  Every
// input is read once.  On the H100, tiles of 20 cells ran 18-21% faster at
// 100x70 than tiles of 25 (at most 32), and faster than tiles of 16; loading
// each thread's u_k, grad u_k and w before the staging, to overlap their
// latency, changed the time by under 2% and was left out (PERF.md).
//
// The arithmetic is the first version's, rounding step for rounding step
// (g over m ascending; y over q ascending as a = dx fgx + dy fgy;
// a += p fv; y += a, with the fused multiply-adds it compiled to written
// out), so its f32 results are the same bit for bit.  Steps 2 and 3 live
// in cell_apply_f.cuh, which the one-launch apply_F (apply_f_fused.cu)
// calls too: the solver's apply_F runs that kernel, and this one stays as
// the card-side oracle it is held against bit for bit (with scatter_v.cu)
// and as the counterpart of the JAX cell_apply_F_pallas on gathered DoFs.
//
// Tensor cores are not used: their only f32 path is TF32, about three
// decimal digits, which the port turns off; f64 could use DMMA, but f64 is
// off the main path, and each contraction is only [16 x 16] by T cells.
//
// The kernel allocates nothing and runs on the caller's stream.
//
// Build (plain C interface, loaded with ctypes by _ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
//        -Xcompiler -fPIC cell_apply_f.cu

#include <cuda_runtime.h>

#include "cell_apply_f.cuh"

namespace {

using nstt::Cell;
using nstt::Flux;

constexpr int kMaxTile = 20;  // cells per block, at most

struct View {  // element strides of the [k+1, k+1, B, 2, ny, nx] input view
  int a, b, m, comp, iy, ix;
};

template <int K>
struct Tile {
  static constexpr int kThreads = Cell<K>::N * kMaxTile;  // per block, at most
  static constexpr int kRow = (K + 1) * kMaxTile;         // strip row in shared memory
};

template <typename T, int K, bool STOKES, bool BATCHED>
__global__ void __launch_bounds__(Tile<K>::kThreads)
cell_apply_f_kernel(const T* __restrict__ x, View s, int lattice,
                    const T* __restrict__ uq, const T* __restrict__ guq,
                    const T* __restrict__ w, const T* __restrict__ tabs,
                    T nu_scalar, const T* __restrict__ nu_b, T inv_dt,
                    T* __restrict__ y, int nx, int ny, int tile) {
  constexpr int N = Cell<K>::N;
  constexpr int R = Tile<K>::kRow;
  constexpr int NF = Flux<STOKES>::NF;
  __shared__ T s_tab[3 * N * N];
  __shared__ T s_x[2 * (K + 1) * R];
  __shared__ T s_f[NF * N * kMaxTile];

  const int C = nx * ny;
  const int tiles = (nx + tile - 1) / tile;
  const int iy = blockIdx.x / tiles;
  const int ix0 = (blockIdx.x - iy * tiles) * tile;
  const int tv = min(tile, nx - ix0);  // cells in this tile
  const int c0 = iy * nx + ix0;
  const int mb = BATCHED ? blockIdx.y : 0;  // member
  const int B = BATCHED ? gridDim.y : 1;
  const T nu = BATCHED && nu_b != nullptr ? nu_b[mb] : nu_scalar;

  // Thread (j, t): cell t of the tile, quadrature point j in step 2 and
  // local DoF j in step 3 (n_q = n_v).
  const int j = threadIdx.x / tile;
  const int t = threadIdx.x - j * tile;
  const bool live = t < tv;
  const int c = c0 + t;

  // 1. stage.  Local node (tc, b) of the tile is strip column tc W + b,
  // with W = k on the lattice (node b = k of cell tc is node 0 of cell
  // tc + 1) and W = k + 1 on gathered input.
  for (int i = threadIdx.x; i < 3 * N * N; i += blockDim.x) s_tab[i] = tabs[i];
  const int W = lattice ? K : K + 1;
  const int ncols = W * (tv - 1) + K + 1;
  const T* xt = x + mb * s.m + iy * s.iy + ix0 * s.ix;
  for (int i = threadIdx.x; i < 2 * (K + 1) * ncols; i += blockDim.x) {
    const int r = i / ncols;  // comp * (k + 1) + a
    const int u = i - r * ncols;
    int tc, b;
    if (lattice) {  // along the lattice row
      tc = u / K;
      b = u - tc * K;
    } else {  // cells fastest: the contiguous axis of gathered input
      tc = u % tv;
      b = u / tv;
    }
    const int comp = r / (K + 1), a = r - comp * (K + 1);
    s_x[r * R + tc * W + b] = xt[comp * s.comp + a * s.a + b * s.b + tc * s.ix];
  }
  __syncthreads();

  const int fs = N * tile;  // s_f[f][q][t] at f * fs + q * tile + t
  const int jm = j * B + mb;  // (quadrature point or local DoF j, member)

  // 2. evaluate at quadrature point q = j
  if (live) {
    nstt::cell_flux<T, K, STOKES>(s_tab, j, s_x + t * W, s_x + (K + 1) * R + t * W, R, nu, inv_dt,
                                  w, uq, guq, jm, C, c, s_f + threadIdx.x, fs);
  }
  __syncthreads();

  // 3. project onto local DoF m = j
  if (live) {
    T y0, y1;
    nstt::cell_project<T, K, STOKES>(s_tab, j, s_f + t, tile, fs, y0, y1);
    y[(2 * jm) * C + c] = y0;
    y[(2 * jm + 1) * C + c] = y1;
  }
}

template <typename T, int K>
void launch(int stokes, const void* x, View s, int lattice, const void* uq,
            const void* guq, const void* w, const void* tabs, double nu,
            const void* nu_b, double inv_dt, void* y, int nx, int ny,
            int batch, cudaStream_t stream) {
  const int tiles = (nx + kMaxTile - 1) / kMaxTile;
  const int tile = (nx + tiles - 1) / tiles;
  const dim3 grid(tiles * ny, batch), block(Cell<K>::N * tile);
  const bool batched = batch > 1 || nu_b != nullptr;
  auto kernel = stokes ? (batched ? cell_apply_f_kernel<T, K, true, true>
                                  : cell_apply_f_kernel<T, K, true, false>)
                       : (batched ? cell_apply_f_kernel<T, K, false, true>
                                  : cell_apply_f_kernel<T, K, false, false>);
  kernel<<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), s, lattice, static_cast<const T*>(uq),
      static_cast<const T*>(guq), static_cast<const T*>(w),
      static_cast<const T*>(tabs), T(nu), static_cast<const T*>(nu_b),
      T(inv_dt), static_cast<T*>(y), nx, ny, tile);
}

}  // namespace

extern "C" {

// k: velocity degree (2 or 3); s_*: element strides of the input view
// (s_m: between members); lattice: 1 when the view is a lattice's (shared
// edge nodes).  uq and guq may be null in the Stokes regime.  nu_b: [batch]
// viscosities on the device, or null to use nu for every member.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist.
int nstt_cell_apply_f(int is_f64, int k, int stokes, const void* x, int s_a,
                      int s_b, int s_m, int s_comp, int s_iy, int s_ix,
                      int lattice, const void* uq, const void* guq,
                      const void* w, const void* tabs, double nu,
                      const void* nu_b, double inv_dt, void* y, int nx,
                      int ny, int batch, void* stream) {
  if (nx <= 0 || ny <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const View s{s_a, s_b, s_m, s_comp, s_iy, s_ix};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64 && k == 3) {
    launch<double, 3>(stokes, x, s, lattice, uq, guq, w, tabs, nu, nu_b, inv_dt, y, nx, ny, batch, st);
  } else if (is_f64 && k == 2) {
    launch<double, 2>(stokes, x, s, lattice, uq, guq, w, tabs, nu, nu_b, inv_dt, y, nx, ny, batch, st);
  } else if (!is_f64 && k == 3) {
    launch<float, 3>(stokes, x, s, lattice, uq, guq, w, tabs, nu, nu_b, inv_dt, y, nx, ny, batch, st);
  } else if (!is_f64 && k == 2) {
    launch<float, 2>(stokes, x, s, lattice, uq, guq, w, tabs, nu, nu_b, inv_dt, y, nx, ny, batch, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

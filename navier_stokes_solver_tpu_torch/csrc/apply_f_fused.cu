// The velocity-block apply F of the structured Taylor-Hood lattice in one
// launch: the per-cell apply of cell_apply_f.cu and the ordered scatter of
// scatter_v.cu with apply_F's boundary rows, the cell-local results kept
// in shared memory.
//
// Replaces the JAX package's Pallas TPU kernel
// navier_stokes_solver_tpu/ops/pallas_cell.py::_run together with the
// XLA scatter and the two jnp.where of its apply_F
// (navier_stokes_solver_tpu/ops/matfree.py: _scatter, apply_F).  The
// port ran those as two launches, cell_apply_f.cu then scatter_v.cu, with
// the cell-local results y [n_v, B, 2, C] written to device memory by the
// first and read back by the second.  Per lattice node, member and
// component:
//
//   out[I, J] = sum over the (cell, m) that hold node (I, J), in ascending
//               local index m, from +0.0, of y[m, cell]
//   with bc:  out = active ? (dirichlet ? diag * x : out) : x
//
// where y is cell_apply_f.cu's result on the same cell.  The result
// equals the two launches' bit for bit: each cell's y comes from the same
// code (cell_apply_f.cuh) on the same operands, and each node adds its
// contributions in scatter_v.cu's order.
//
// Layouts (B members): x [B, 2, NY, NX] read through its four element
// strides (a permuted dense lattice too); out, diag [B, 2, NY, NX]
// contiguous; dirichlet, active [NY, NX] bool, shared by the members; uq,
// guq, w, tabs and nu_b as in cell_apply_f.cu.  NY = k ny + 1,
// NX = k nx + 1.  The member is blockIdx.y; member b of a batched launch
// equals the unbatched launch on its operands bit for bit.
//
// Design.  A block owns a tile of TY x TX cells, (iy0, ix0) its first,
// and the lattice nodes those cells start: I in [k iy0, k (iy0 + TY)),
// J in [k ix0, k (ix0 + TX)), plus the last lattice row (column) on the
// last tiles of a column (row).  The nodes on the tile's lower and left
// edges also hold contributions of cell row iy0 - 1 and cell column
// ix0 - 1, so the block recomputes that halo: it computes ROWS = TY + 1
// rows of L = TX + 1 cells (fewer on the domain's first row and column).
// No traffic between blocks, no atomics, no flags.  It runs one thread
// per (quadrature point or local DoF, computed cell), n_q L ROWS threads,
// in four steps:
//   1. stage: every global load of the block but the evaluation's -- the
//      tables, the strip of lattice nodes under the computed cells
//      ([2][k ROWS + 1][k L + 1], each node once, along the lattice row)
//      and, with the rows, diag and the two masks at the owned nodes --
//      issued together and then stored to shared memory, so the block
//      waits for device memory once; the strip and the nodes are walked
//      in rows of a power of two of threads, so no index divides;
//   2. evaluate: thread (q, row, column) forms the fluxes of its cell at
//      quadrature point q (cell_flux, the cell kernel's code) into shared
//      memory; at k = 3 the strip's row pitch makes the cell rows of a
//      warp read disjoint banks;
//   3. project: thread (m, row, column) projects them onto local DoF m
//      (cell_project) into s_y[m][comp][cell], in shared memory;
//   4. pull: one thread per owned (component, node), J fastest, sums its
//      up to four contributions from s_y in scatter_v.cu's order (s_y's
//      odd stride puts a node's m in different banks), applies the
//      boundary rows (x from the strip) and writes out once, coalesced
//      along J.
// y never reaches device memory, and one launch replaces two.  Per cell
// the work is the cell kernel's; the halo multiplies it by ROWS L /
// (TY TX) on an inner tile.  The block shapes (ROWS, L) are three at
// k = 3, (4, 16), (4, 8) and (3, 16) -- halo 1.42, 1.52 and 1.60 -- and
// two at k = 2, (7, 16) and (4, 16).  A larger tile recomputes less, a
// smaller one spreads a small mesh over more SMs, so a launch
// takes its shape from the cells it covers (ops/apply_f_kernel.py,
// block_shape; the shapes timed on the H100: PERF.md).  Every shape gives
// the same bits.  The first designs -- 4 x 16 tiles of 85 computed cells
// in passes of 32 threads per q, or with the tables in registers, each
// pass a round trip to device memory -- were slower than the two launches
// at every shape.  A decoupled look-back (blocks publishing their edge
// sums through flags) would avoid the recompute; it was not built.
//
// Bound.  At 100x70 f32 in the Newton regime with the boundary rows one
// call reads the lattice (508 KB), u_k, grad u_k and w (3.1 MB), diag
// (508 KB) and the masks (127 KB), and writes out (508 KB): ~4.8 MB,
// 1.4 us at 3.35 TB/s; its ~46 MFLOP take 0.7 us at 67 TFLOP/s.  Bound by
// memory.  At the multigrid chain's coarse levels the launch itself
// (a few us) is most of the time, which is why the scatter is an
// epilogue here and not a kernel of its own.
//
// Tensor cores are not used: their only f32 path is TF32, which the port
// turns off.
//
// Shared memory (dynamic; above 48 KB the launch raises the kernel's
// limit first): at k = 3, ROWS = 4, L = 16, f32, the Newton regime, 50 KB
// (tables 3 KB, strip 8.3 KB, fluxes 24.6 KB, y 8.2 KB, diag and masks
// 5.8 KB); launch bounds of two blocks an SM hold f32 to 32 registers.
//
// The kernel allocates nothing and runs on the caller's stream.
//
// Build (plain C interface, loaded with ctypes by _ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
//        -Xcompiler -fPIC apply_f_fused.cu

#include <cuda_runtime.h>

#include "cell_apply_f.cuh"

namespace {

using nstt::Cell;
using nstt::Flux;

constexpr int kMaxDevices = 64;   // per-device record of the raised limit
constexpr int kStaticLimit = 48 * 1024;

struct Lattice {  // element strides of the [B, 2, NY, NX] input
  int m, comp, y, x;
};

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// the strip's row pitch: at K = 3 the smallest above a row of L cells
// with 3 P = L (mod 32), so that the cell rows of a warp (32 / L of them)
// read disjoint banks
constexpr int pitch(int K, int L) {
  int p = K * L + 1;
  while (K == 3 && (3 * p - L) % 32 != 0) ++p;
  return p;
}

// One block's shape: ROWS computed cell rows of L computed cells (the
// tile, ROWS - 1 rows of L - 1 cells, and its halo row and column), one
// thread per (quadrature point or local DoF, cell): n_q L ROWS threads.
template <typename T, int K, bool STOKES, int ROWS, int L>
struct Shape {
  static constexpr int N = Cell<K>::N;
  static constexpr int NF = Flux<STOKES>::NF;
  static constexpr int TY = ROWS - 1, TX = L - 1;  // owned cells
  static constexpr int kThreads = N * L * ROWS;
  static constexpr int kSlots = ROWS * L;         // computed cells, at most
  static constexpr int SY = kSlots + 1;           // s_y's stride: odd, so a node's m differ in bank
  static constexpr int P = pitch(K, L);
  static constexpr int XS = (K * ROWS + 1) * P;   // strip component stride
  // the strip and the owned nodes are walked as rows of CW threads (a
  // power of two: no division), RS rows at a time
  static constexpr int CW = pow2_at_least(K * L + 1), RS = kThreads / CW;
  static constexpr int kNodeRows = K * TY + 1;     // owned node rows per component, at most
  static constexpr int kTabIt = cdiv(3 * N * N, kThreads);
  static constexpr int kStripIt = cdiv(2 * (K * ROWS + 1), RS);
  static constexpr int kNodeIt = cdiv(2 * kNodeRows, RS);
  // shared memory, in elements of T (the masks' bytes after them)
  static constexpr int kTab = 0, kX = 3 * N * N, kF = kX + 2 * XS, kY = kF + NF * N * kSlots,
                       kD = kY + 2 * N * SY, kEnd = kD + 2 * kNodeRows * CW;
  static constexpr size_t kBytes = sizeof(T) * kEnd + kNodeRows * CW;
};

template <typename T, int K, bool STOKES, bool BATCHED, int ROWS, int L>
__global__ void __launch_bounds__((Shape<T, K, STOKES, ROWS, L>::kThreads), (sizeof(T) == 4 ? 2 : 1))
apply_f_fused_kernel(const T* __restrict__ x, Lattice s,
                     const T* __restrict__ uq, const T* __restrict__ guq,
                     const T* __restrict__ w, const T* __restrict__ tabs,
                     T nu_scalar, const T* __restrict__ nu_b, T inv_dt,
                     const T* __restrict__ diag,
                     const unsigned char* __restrict__ dirichlet,
                     const unsigned char* __restrict__ active,
                     T* __restrict__ out, int nx, int ny) {
  using S = Shape<T, K, STOKES, ROWS, L>;
  constexpr int N = S::N, P = S::P, XS = S::XS, SL = S::kSlots, SY = S::SY, TH = S::kThreads;
  constexpr int CW = S::CW, RS = S::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_tab = reinterpret_cast<T*>(smem) + S::kTab;
  T* s_x = reinterpret_cast<T*>(smem) + S::kX;  // [2][K ROWS + 1][P]
  T* s_f = reinterpret_cast<T*>(smem) + S::kF;  // [NF][n_q][SL]
  T* s_y = reinterpret_cast<T*>(smem) + S::kY;  // [n_v][2][SY]
  T* s_d = reinterpret_cast<T*>(smem) + S::kD;  // diag at the owned nodes [2 nI][CW]
  unsigned char* s_m = smem + sizeof(T) * S::kEnd;  // active | dirichlet << 1, [nI][CW]

  const int NX = K * nx + 1, NY = K * ny + 1, C = nx * ny;
  const int tiles_x = (nx + S::TX - 1) / S::TX;
  const int tile_y = blockIdx.x / tiles_x;
  const int iy0 = tile_y * S::TY, ix0 = (blockIdx.x - tile_y * tiles_x) * S::TX;
  // the computed cells: the tile and its halo row and column
  const int cy0 = max(iy0 - 1, 0), cx0 = max(ix0 - 1, 0);
  const int ncy = min(iy0 + S::TY, ny) - cy0, ncx = min(ix0 + S::TX, nx) - cx0;
  const int rows = K * ncy + 1, cols = K * ncx + 1;  // the strip
  // the owned nodes
  const int I0 = K * iy0, J0 = K * ix0;
  const int nI = (iy0 + S::TY >= ny ? NY : K * (iy0 + S::TY)) - I0;
  const int nJ = (ix0 + S::TX >= nx ? NX : K * (ix0 + S::TX)) - J0;
  const int mb = BATCHED ? blockIdx.y : 0;  // member
  const int B = BATCHED ? gridDim.y : 1;
  const int mo = mb * 2 * NY * NX;  // the member's offset in out and diag
  const T nu = BATCHED && nu_b != nullptr ? nu_b[mb] : nu_scalar;
  const int tid = threadIdx.x;

  // 1. stage: every global load of the block but the evaluation's, issued
  // together, then stored.  Thread (rr0, u) walks column u of rows rr0,
  // rr0 + RS, ... of the strip (both components' rows in turn) and of the
  // owned nodes
  const int u = tid % CW, rr0 = tid / CW;
  const bool walker = rr0 < RS;
  {
    T tv[S::kTabIt], xv[S::kStripIt], dv[S::kNodeIt];
    unsigned char mv[S::kNodeIt];
    const T* xb = x + mb * s.m + K * cy0 * s.y + K * cx0 * s.x;
#pragma unroll
    for (int it = 0; it < S::kTabIt; ++it) {
      const int i = tid + it * TH;
      if (i < 3 * N * N) tv[it] = tabs[i];
    }
#pragma unroll
    for (int it = 0; it < S::kStripIt; ++it) {
      const int rr = rr0 + it * RS;
      if (walker && rr < 2 * rows && u < cols) {
        const int comp = rr >= rows, r = rr - comp * rows;
        xv[it] = xb[comp * s.comp + r * s.y + u * s.x];
      }
    }
    if (diag != nullptr) {
#pragma unroll
      for (int it = 0; it < S::kNodeIt; ++it) {
        const int rr = rr0 + it * RS;
        if (walker && rr < 2 * nI && u < nJ) {
          const int comp = rr >= nI;
          const int ij = (I0 + rr - comp * nI) * NX + J0 + u;
          dv[it] = diag[mo + comp * NY * NX + ij];
          if (!comp) mv[it] = active[ij] | (dirichlet[ij] << 1);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < S::kTabIt; ++it) {
      const int i = tid + it * TH;
      if (i < 3 * N * N) s_tab[i] = tv[it];
    }
#pragma unroll
    for (int it = 0; it < S::kStripIt; ++it) {
      const int rr = rr0 + it * RS;
      if (walker && rr < 2 * rows && u < cols) {
        const int comp = rr >= rows, r = rr - comp * rows;
        s_x[comp * XS + r * P + u] = xv[it];
      }
    }
    if (diag != nullptr) {
#pragma unroll
      for (int it = 0; it < S::kNodeIt; ++it) {
        const int rr = rr0 + it * RS;
        if (walker && rr < 2 * nI && u < nJ) {
          s_d[rr * CW + u] = dv[it];
          if (rr < nI) s_m[rr * CW + u] = mv[it];
        }
      }
    }
  }
  __syncthreads();

  // 2-3. thread (j, r, lane): quadrature point j in step 2 and local DoF j
  // in step 3 (n_q = n_v) of cell (r, lane) of the computed rows
  const int j = tid / SL;
  const int slot = tid - j * SL;
  const int r = slot / L, lane = slot - r * L;
  const bool live = lane < ncx && r < ncy;
  const int fs = N * SL;  // s_f[f][q][slot] at f * fs + q * SL + slot
  const int jm = j * B + mb;
  if (live) {
    const T* x0 = s_x + K * r * P + K * lane;
    nstt::cell_flux<T, K, STOKES>(s_tab, j, x0, x0 + XS, P, nu, inv_dt, w, uq, guq, jm, C,
                                  (cy0 + r) * nx + cx0 + lane, s_f + j * SL + slot, fs);
  }
  __syncthreads();
  if (live) {
    T y0, y1;
    nstt::cell_project<T, K, STOKES>(s_tab, j, s_f + slot, SL, fs, y0, y1);
    s_y[(2 * j) * SY + slot] = y0;
    s_y[(2 * j + 1) * SY + slot] = y1;
  }
  __syncthreads();

  // 4. pull: thread (rr0, u) takes node column J0 + u of the owned rows
  // rr0, rr0 + RS, ... (both components' rows in turn).  Row candidates of
  // node (I, J) in ascending a: (a = ra, cell row qa) when qa < ny, then
  // (a = k, cell row qa - 1) when the node is on a cell row boundary
  // (ra = 0) above the first; columns likewise.
#pragma unroll
  for (int it = 0; it < S::kNodeIt; ++it) {
    const int rr = rr0 + it * RS;
    if (!walker || rr >= 2 * nI || u >= nJ) continue;
    const int comp = rr >= nI, ir = rr - comp * nI;
    const int I = I0 + ir, J = J0 + u;
    const int qa = I / K, ra = I - qa * K;
    const int qb = J / K, rb = J - qb * K;
    T sum = T(0);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      if (ii == 0 ? qa >= ny : (ra != 0 || qa == 0)) continue;
      const int a = ii == 0 ? ra : K;
      const int ly = qa - ii - cy0;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (jj == 0 ? qb >= nx : (rb != 0 || qb == 0)) continue;
        const int b = jj == 0 ? rb : K;
        const int lx = qb - jj - cx0;
        sum = nstt::add(sum, s_y[(2 * (a * (K + 1) + b) + comp) * SY + ly * L + lx]);
      }
    }
    if (diag != nullptr) {
      const T xv = s_x[comp * XS + (I - K * cy0) * P + (J - K * cx0)];
      const unsigned char mask = s_m[ir * CW + u];
      if (!(mask & 1)) {
        sum = xv;
      } else if (mask & 2) {
        sum = nstt::mul(s_d[rr * CW + u], xv);
      }
    }
    out[mo + comp * NY * NX + I * NX + J] = sum;
  }
}

template <typename T, int K, bool STOKES, bool BATCHED, int ROWS, int L>
int launch_variant(const T* x, Lattice s, const T* uq, const T* guq, const T* w, const T* tabs,
                   T nu, const T* nu_b, T inv_dt, const T* diag, const unsigned char* dirichlet,
                   const unsigned char* active, T* out, int nx, int ny, int batch,
                   cudaStream_t stream) {
  using S = Shape<T, K, STOKES, ROWS, L>;
  auto kernel = apply_f_fused_kernel<T, K, STOKES, BATCHED, ROWS, L>;
  constexpr size_t bytes = S::kBytes;
  if (bytes > kStaticLimit) {
    // the limit is per device and per kernel; raise it once for each
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  const int tiles = ((nx + S::TX - 1) / S::TX) * ((ny + S::TY - 1) / S::TY);
  kernel<<<dim3(tiles, batch), S::kThreads, bytes, stream>>>(
      x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, dirichlet, active, out, nx, ny);
  return static_cast<int>(cudaGetLastError());
}

// The block shapes (ROWS, L) a launch may take, in the order of
// ops/apply_f_kernel.py's BLOCK_SHAPES, which picks one per launch
template <typename T, int K, bool STOKES, bool BATCHED>
int launch_shape(int variant, const T* x, Lattice s, const T* uq, const T* guq, const T* w,
                 const T* tabs, T nu, const T* nu_b, T inv_dt, const T* diag,
                 const unsigned char* dirichlet, const unsigned char* active, T* out, int nx,
                 int ny, int batch, cudaStream_t st) {
#define NSTT_GO(R, P) \
  launch_variant<T, K, STOKES, BATCHED, R, P>(x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, \
                                              dirichlet, active, out, nx, ny, batch, st)
  if constexpr (K == 3) {
    switch (variant) {
      case 0: return NSTT_GO(4, 16);
      case 1: return NSTT_GO(4, 8);
      case 2: return NSTT_GO(3, 16);
    }
  } else {
    switch (variant) {
      case 0: return NSTT_GO(7, 16);
      case 1: return NSTT_GO(4, 16);
    }
  }
#undef NSTT_GO
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int K>
int launch(int stokes, int variant, const void* x, Lattice s, const void* uq, const void* guq,
           const void* w, const void* tabs, double nu, const void* nu_b, double inv_dt,
           const void* diag, const void* dirichlet, const void* active, void* out, int nx,
           int ny, int batch, cudaStream_t stream) {
  const bool batched = batch > 1 || nu_b != nullptr;
  auto go = stokes ? (batched ? launch_shape<T, K, true, true> : launch_shape<T, K, true, false>)
                   : (batched ? launch_shape<T, K, false, true> : launch_shape<T, K, false, false>);
  return go(variant, static_cast<const T*>(x), s, static_cast<const T*>(uq),
            static_cast<const T*>(guq), static_cast<const T*>(w), static_cast<const T*>(tabs),
            T(nu), static_cast<const T*>(nu_b), T(inv_dt), static_cast<const T*>(diag),
            static_cast<const unsigned char*>(dirichlet),
            static_cast<const unsigned char*>(active), static_cast<T*>(out), nx, ny, batch,
            stream);
}

}  // namespace

extern "C" {

// k: velocity degree (2 or 3); s_*: element strides of the [B, 2, NY, NX]
// input lattice (s_m: between members); uq and guq may be null in the
// Stokes regime; nu_b: [batch] viscosities on the device, or null to use
// nu for every member; diag null: no boundary rows (dirichlet and active
// are then not read); shape: the block shape (BLOCK_SHAPES' index).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist.
int nstt_apply_f_fused(int is_f64, int k, int stokes, const void* x, int s_m, int s_comp,
                       int s_y, int s_x, const void* uq, const void* guq, const void* w,
                       const void* tabs, double nu, const void* nu_b, double inv_dt,
                       const void* diag, const void* dirichlet, const void* active, void* out,
                       int nx, int ny, int batch, int shape, void* stream) {
  if (nx <= 0 || ny <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Lattice s{s_m, s_comp, s_y, s_x};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64 && k == 3) {
    return launch<double, 3>(stokes, shape, x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, dirichlet, active, out, nx, ny, batch, st);
  } else if (is_f64 && k == 2) {
    return launch<double, 2>(stokes, shape, x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, dirichlet, active, out, nx, ny, batch, st);
  } else if (!is_f64 && k == 3) {
    return launch<float, 3>(stokes, shape, x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, dirichlet, active, out, nx, ny, batch, st);
  } else if (!is_f64 && k == 2) {
    return launch<float, 2>(stokes, shape, x, s, uq, guq, w, tabs, nu, nu_b, inv_dt, diag, dirichlet, active, out, nx, ny, batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Ordered scatter of the velocity block's cell-local results onto the
// velocity lattice, with apply_F's boundary rows fused.
//
// Replaces the scatter and the boundary epilogue of the JAX package's
// apply_F (navier_stokes_solver_tpu/ops/matfree.py: _scatter, a sum of
// dilated pads, and the two jnp.where of apply_F) -- XLA code on the TPU,
// not a Pallas kernel -- which the port ran as five strided PyTorch ops
// plus three elementwise ones.
//
//   out[comp, I, J] = sum over the (cell, m) that hold lattice node (I, J)
//                     of loc[m, comp, cell], in ascending m, from +0.0
//   with bc: out = active ? (dirichlet ? diag * x : out) : x
//
// Layouts (B members): loc [n_v, B, 2, ny, nx] contiguous; out, diag
// [B, 2, NY, NX] contiguous; dirichlet, active [NY, NX] bool, shared by the
// members; x [B, 2, NY, NX] read through its four element strides.
// NY = k ny + 1, NX = k nx + 1.  The member is blockIdx.y; each member's
// sums are those of an unbatched launch, so member b of a batched launch
// equals the unbatched launch bit for bit.  The member indexing is a
// template parameter, left out of an unbatched launch (B = 1).
//
// Design: a "pull" scatter, one thread per lattice node (127k at 100x70).
// Node (I, J) lies in at most two cell rows (I = k iy + a) and two cell
// columns; the thread adds its up to four contributions in ascending local
// index m = a (k+1) + b, starting from +0.0 -- the order of the JAX
// package's sum of pads and of the port's plain version, so the result is
// the same bit for bit and the same on every run.  No atomics.
//
// Bound: at 100x70 f32 it reads loc (896 KB), x, diag (508 KB each) and
// the masks, and writes 508 KB: ~2.5 MB, 0.75 us at 3.35 TB/s; a few
// additions per node, so memory.  Neighbouring threads read neighbouring
// (or the same) cells, so its loads coalesce.
//
// The kernel allocates nothing and runs on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int K, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
scatter_v_kernel(const T* __restrict__ loc, int nx, int ny,
                 const T* __restrict__ x, int sx_m, int sx_c, int sx_y,
                 int sx_x,
                 const T* __restrict__ diag,
                 const unsigned char* __restrict__ dirichlet,
                 const unsigned char* __restrict__ active,
                 T* __restrict__ out) {
  const int NX = K * nx + 1, NY = K * ny + 1;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= 2 * NY * NX) return;
  const int mb = BATCHED ? blockIdx.y : 0, B = BATCHED ? gridDim.y : 1;  // member
  const int mo = mb * 2 * NY * NX;  // the member's offset in out and diag
  const int J = node % NX;
  const int rest = node / NX;
  const int I = rest % NY;
  const int comp = rest / NY;
  const int C = nx * ny;
  const int qa = I / K, ra = I - qa * K;
  const int qb = J / K, rb = J - qb * K;

  // Row candidates in ascending a: (a = ra, iy = qa) when iy < ny, then
  // (a = k, iy = qa - 1) when the node is on a cell row boundary (ra = 0)
  // above the first; columns likewise.
  T s = T(0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 0 ? qa >= ny : (ra != 0 || qa == 0)) continue;
    const int a = i == 0 ? ra : K;
    const int iy = qa - i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 0 ? qb >= nx : (rb != 0 || qb == 0)) continue;
      const int b = j == 0 ? rb : K;
      const int ix = qb - j;
      s += loc[(((a * (K + 1) + b) * B + mb) * 2 + comp) * C + iy * nx + ix];
    }
  }
  if (diag != nullptr) {
    const int ij = I * NX + J;
    const T xv = x[mb * sx_m + comp * sx_c + I * sx_y + J * sx_x];
    if (!active[ij]) {
      s = xv;
    } else if (dirichlet[ij]) {
      s = diag[mo + node] * xv;
    }
  }
  out[mo + node] = s;
}

template <typename T, int K>
void launch(const void* loc, int nx, int ny, const void* x, int sx_m,
            int sx_c, int sx_y, int sx_x, const void* diag,
            const void* dirichlet, const void* active, void* out, int batch,
            cudaStream_t stream) {
  const int nodes = 2 * (K * ny + 1) * (K * nx + 1);
  const dim3 grid((nodes + kThreads - 1) / kThreads, batch);
  auto kernel = batch > 1 ? scatter_v_kernel<T, K, true> : scatter_v_kernel<T, K, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(loc), nx, ny, static_cast<const T*>(x), sx_m, sx_c,
      sx_y, sx_x, static_cast<const T*>(diag),
      static_cast<const unsigned char*>(dirichlet),
      static_cast<const unsigned char*>(active), static_cast<T*>(out));
}

}  // namespace

extern "C" {

// k: velocity degree (2 or 3); batch: members B.  diag null: no boundary
// rows (x, dirichlet and active are then not read).  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist.
int nstt_scatter_v(int is_f64, int k, const void* loc, int nx, int ny,
                   const void* x, int sx_m, int sx_c, int sx_y, int sx_x,
                   const void* diag, const void* dirichlet, const void* active,
                   void* out, int batch, void* stream) {
  if (nx <= 0 || ny <= 0 || batch <= 0) return 0;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64 && k == 3) {
    launch<double, 3>(loc, nx, ny, x, sx_m, sx_c, sx_y, sx_x, diag, dirichlet, active, out, batch, st);
  } else if (is_f64 && k == 2) {
    launch<double, 2>(loc, nx, ny, x, sx_m, sx_c, sx_y, sx_x, diag, dirichlet, active, out, batch, st);
  } else if (!is_f64 && k == 3) {
    launch<float, 3>(loc, nx, ny, x, sx_m, sx_c, sx_y, sx_x, diag, dirichlet, active, out, batch, st);
  } else if (!is_f64 && k == 2) {
    launch<float, 2>(loc, nx, ny, x, sx_m, sx_c, sx_y, sx_x, diag, dirichlet, active, out, batch, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

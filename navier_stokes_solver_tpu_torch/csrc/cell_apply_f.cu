// Fused per-cell velocity-block apply F for the structured Taylor-Hood grid.
//
// Replaces the JAX package's Pallas TPU kernel
// navier_stokes_solver_tpu/ops/pallas_cell.py::_run.  For every cell c it
// computes, with x the gathered velocity DoFs of both components,
//
//   g = (Dx x, Dy x)           gradients at the n_q quadrature points
//   v = P x                    values (Newton regime only)
//   f_grad = nu * g
//   f_val  = (u_k . grad) x + (x . grad) u_k + x / dt   (Newton regime)
//   y = Dx^T (w f_grad_x) + Dy^T (w f_grad_y) [+ P^T (w f_val)]
//
// with w = JxW times the active-cell mask.
//
// Layouts (C = ny * nx cells, the contiguous axis of every array):
//   x, y  [n_v, 2, C]      local DoF m, component, cell
//   uq    [n_q, 2, C]      u_k at the quadrature points
//   guq   [n_q, 2, 2, C]   grad u_k: component, derivative direction
//   w     [n_q, C]
//   tabs  [3, n_q, n_v]    P, d/dx (scaled by 1/hx), d/dy (scaled by 1/hy)
//
// Design: one thread per cell.  Each cell reads ~(2 n_v + 7 n_q) words and
// writes 2 n_v while doing ~10 n_q n_v flops per component: per byte, a
// memory-bound kernel.  At 100x70 (C = 7,000) it is bound by latency
// instead: one thread per cell gives about one 64-thread block per SM, too
// few warps to hide the load latency.  The design keeps the bytes minimal
// -- consecutive threads take consecutive cells, so every load and store
// of a warp is coalesced; the tables sit in shared memory and are read as
// warp-wide broadcasts; gradients, fluxes and the 2 n_v accumulators stay
// in registers; every input is read once -- and leaves filling the card to
// later work: more threads per cell (per quadrature point or per local
// DoF) and fusing the gather.  The ragged end of C is masked here (no
// padding).  The kernel allocates nothing and runs on the caller's stream.
//
// Build (plain C interface, loaded with ctypes by _ext.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libnstt_kernels.so cell_apply_f.cu

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <typename T, int N, bool STOKES>
__global__ void __launch_bounds__(kThreads)
cell_apply_f_kernel(const T* __restrict__ x, const T* __restrict__ uq,
                    const T* __restrict__ guq, const T* __restrict__ w,
                    const T* __restrict__ tabs, T nu, T inv_dt,
                    T* __restrict__ y, int C) {
  __shared__ T s_tab[3 * N * N];
  for (int i = threadIdx.x; i < 3 * N * N; i += blockDim.x) s_tab[i] = tabs[i];
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const T* sP = s_tab;
  const T* sDx = s_tab + N * N;
  const T* sDy = s_tab + 2 * N * N;

  T x0[N], x1[N], y0[N], y1[N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    x0[m] = x[(2 * m) * C + c];
    x1[m] = x[(2 * m + 1) * C + c];
    y0[m] = T(0);
    y1[m] = T(0);
  }

#pragma unroll 1
  for (int q = 0; q < N; ++q) {
    const T* dxq = sDx + q * N;
    const T* dyq = sDy + q * N;
    const T* pq = sP + q * N;
    T gx0 = T(0), gy0 = T(0), gx1 = T(0), gy1 = T(0), v0 = T(0), v1 = T(0);
#pragma unroll
    for (int m = 0; m < N; ++m) {
      gx0 += dxq[m] * x0[m];
      gy0 += dyq[m] * x0[m];
      gx1 += dxq[m] * x1[m];
      gy1 += dyq[m] * x1[m];
      if (!STOKES) {
        v0 += pq[m] * x0[m];
        v1 += pq[m] * x1[m];
      }
    }
    const T wq = w[q * C + c];
    const T fgx0 = nu * gx0 * wq, fgy0 = nu * gy0 * wq;
    const T fgx1 = nu * gx1 * wq, fgy1 = nu * gy1 * wq;
    T fv0 = T(0), fv1 = T(0);
    if (!STOKES) {
      const T u0 = uq[(2 * q) * C + c], u1 = uq[(2 * q + 1) * C + c];
      const T g00 = guq[(4 * q + 0) * C + c], g01 = guq[(4 * q + 1) * C + c];
      const T g10 = guq[(4 * q + 2) * C + c], g11 = guq[(4 * q + 3) * C + c];
      fv0 = (u0 * gx0 + u1 * gy0 + v0 * g00 + v1 * g01 + inv_dt * v0) * wq;
      fv1 = (u0 * gx1 + u1 * gy1 + v0 * g10 + v1 * g11 + inv_dt * v1) * wq;
    }
#pragma unroll
    for (int m = 0; m < N; ++m) {
      T a0 = dxq[m] * fgx0 + dyq[m] * fgy0;
      T a1 = dxq[m] * fgx1 + dyq[m] * fgy1;
      if (!STOKES) {
        a0 += pq[m] * fv0;
        a1 += pq[m] * fv1;
      }
      y0[m] += a0;
      y1[m] += a1;
    }
  }

#pragma unroll
  for (int m = 0; m < N; ++m) {
    y[(2 * m) * C + c] = y0[m];
    y[(2 * m + 1) * C + c] = y1[m];
  }
}

template <typename T, int N>
void launch(int stokes, const void* x, const void* uq, const void* guq,
            const void* w, const void* tabs, double nu, double inv_dt, void* y,
            int C, cudaStream_t stream) {
  const dim3 grid((C + kThreads - 1) / kThreads);
  const T* args[5] = {static_cast<const T*>(x), static_cast<const T*>(uq),
                      static_cast<const T*>(guq), static_cast<const T*>(w),
                      static_cast<const T*>(tabs)};
  if (stokes) {
    cell_apply_f_kernel<T, N, true><<<grid, kThreads, 0, stream>>>(
        args[0], args[1], args[2], args[3], args[4], T(nu), T(inv_dt),
        static_cast<T*>(y), C);
  } else {
    cell_apply_f_kernel<T, N, false><<<grid, kThreads, 0, stream>>>(
        args[0], args[1], args[2], args[3], args[4], T(nu), T(inv_dt),
        static_cast<T*>(y), C);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a variant that does not exist.
int nstt_cell_apply_f(int is_f64, int n_v, int stokes, const void* x,
                      const void* uq, const void* guq, const void* w,
                      const void* tabs, double nu, double inv_dt, void* y,
                      int C, void* stream) {
  if (C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64 && n_v == 16) {
    launch<double, 16>(stokes, x, uq, guq, w, tabs, nu, inv_dt, y, C, s);
  } else if (is_f64 && n_v == 9) {
    launch<double, 9>(stokes, x, uq, guq, w, tabs, nu, inv_dt, y, C, s);
  } else if (!is_f64 && n_v == 16) {
    launch<float, 16>(stokes, x, uq, guq, w, tabs, nu, inv_dt, y, C, s);
  } else if (!is_f64 && n_v == 9) {
    launch<float, 9>(stokes, x, uq, guq, w, tabs, nu, inv_dt, y, C, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

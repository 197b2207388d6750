// K7: the DFT grid -- atomic orbitals on the grid (K7a) and the density
// and its gradient from a density matrix (K7b).
//
// K7a replaces tuna_tpu/dft/grid.py::construct_basis_functions_on_grid
// (:80) and construct_basis_function_gradients_on_grid (:102), host NumPy
// there, over the Cartesian AOs; the spherical transform stays a
// torch.matmul in the wrapper (tuna_tpu_torch/dft/grid.py).  K7b replaces
// construct_density_on_grid (:137) and the density gradient
// (dft/__init__.py:46, dft/vv10.py:57 and :133), the product with P
// included: rho_k = sum_i phi_ik Y_ik and grad rho_k = 2 sum_i grad phi_ik
// Y_ik with Y_ik = sum_j P_ji phi_jk.
//
// What bounds them on an H100: bytes.  At N2/cc-pVTZ on the medium grid
// (70 Cartesian AOs, 80,724 points) K7a writes values and gradients,
// 4 x 70 x 80,724 doubles = 181 MB, for some 3e8 float64 operations; K7b
// reads phi and the gradients (4 x 60 x 80,724 doubles, 155 MB) and writes
// 4 doubles a point, for 2 n^2 = 7,200 operations a point (6e8 in all, under
// half the byte time at the data sheet's rates).
//
// Design: one thread per grid point in both.  Threads of a warp take
// neighbouring points, so every read and write of an (AO, point) array is
// coalesced.  K7a walks the AOs; the contracted primitives come in CSR form
// (prim_start per AO, coefficient x normalisation and exponent per
// primitive), and the AO data, the same for every thread, is served from
// L1.  It sums sum_k c_k e^(-a_k r^2) and sum_k c_k a_k e^(-a_k r^2) once
// and forms the value and the three gradient components from them.  The
// derivative of X^l is taken only for l > 0 (the reference's guard,
// grid.py:122-124): Lebedev directions hold X = 0, where an unguarded
// 0^(-1) gives inf x 0 = NaN.  K7b reads its point's column of phi from
// device memory once into shared memory (n doubles a thread, read back by
// that thread alone).  It then walks panels of kDensityPanel columns of P,
// each staged in shared memory by the whole block, and forms Y for
// kDensityRows AOs at a time in registers: each column entry, read once
// from shared memory, meets kDensityRows entries of a row of the panel,
// which are the same for every thread of the warp (a broadcast, two
// entries a load).  P is staged rather than read through L1 in the inner
// loop because the columns' shared memory leaves L1 too small to hold P
// (28.8 KB at n = 60), and its loads would go to L2.  Y is never stored.
// Every sum runs in a fixed order: deterministic, no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // threads (points) per block of K7a
constexpr int kDensityPoints = 64;  // threads (points) per block of K7b
constexpr int kDensityPanel = 32;   // columns of P that K7b stages at a time
constexpr int kDensityRows = 8;     // AOs of Y that K7b holds in registers at a time

__device__ __forceinline__ double int_pow(double x, int n) {
  double result = 1.0;
  for (int k = 0; k < n; ++k) result *= x;
  return result;
}

__global__ void __launch_bounds__(kThreads)
ao_on_grid_kernel(int n_ao, int n_points, int with_gradients, const double* __restrict__ points,
                  const double* __restrict__ origin, const int* __restrict__ lmn,
                  const int* __restrict__ prim_start, const double* __restrict__ exps,
                  const double* __restrict__ coefs, double* __restrict__ values,
                  double* __restrict__ gradients) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_points) return;
  const size_t G = static_cast<size_t>(n_points);
  const double x = points[k], y = points[G + k], z = points[2 * G + k];
  for (int mu = 0; mu < n_ao; ++mu) {
    const double X = x - origin[3 * mu], Y = y - origin[3 * mu + 1], Z = z - origin[3 * mu + 2];
    const double r2 = X * X + Y * Y + Z * Z;
    double s0 = 0.0, s1 = 0.0;  // sum c e^(-a r2), sum c a e^(-a r2)
    for (int p = prim_start[mu]; p < prim_start[mu + 1]; ++p) {
      const double term = coefs[p] * exp(-exps[p] * r2);
      s0 += term;
      s1 += exps[p] * term;
    }
    const int l = lmn[3 * mu], m = lmn[3 * mu + 1], n = lmn[3 * mu + 2];
    const double px = int_pow(X, l), py = int_pow(Y, m), pz = int_pow(Z, n);
    const double poly = px * py * pz;
    const size_t at = static_cast<size_t>(mu) * G + k;
    values[at] = s0 * poly;
    if (with_gradients) {
      const double dx = l > 0 ? l * int_pow(X, l - 1) * py * pz : 0.0;
      const double dy = m > 0 ? m * px * int_pow(Y, m - 1) * pz : 0.0;
      const double dz = n > 0 ? n * px * py * int_pow(Z, n - 1) : 0.0;
      const size_t plane = static_cast<size_t>(n_ao) * G;
      gradients[at] = dx * s0 - 2.0 * X * poly * s1;
      gradients[plane + at] = dy * s0 - 2.0 * Y * poly * s1;
      gradients[2 * plane + at] = dz * s0 - 2.0 * Z * poly * s1;
    }
  }
}

__global__ void __launch_bounds__(kDensityPoints)
density_on_grid_kernel(int n_ao, int n_points, int with_gradients, const double* __restrict__ P,
                       const double* __restrict__ phi, const double* __restrict__ grads,
                       double* __restrict__ density, double* __restrict__ gradient) {
  extern __shared__ double shared[];
  // column[j * kDensityPoints + t] = phi_j at thread t's point;
  // panel[j * kDensityPanel + c] = P_j,(i0 + c), zero past the last AO
  double* column = shared;
  double* panel = shared + static_cast<size_t>(n_ao) * kDensityPoints;
  const int t = threadIdx.x;
  const int k = blockIdx.x * kDensityPoints + t;
  const bool live = k < n_points;  // the others only help stage the panels
  const size_t G = static_cast<size_t>(n_points);
  const size_t plane = static_cast<size_t>(n_ao) * G;
  // both load loops unrolled so that eight loads are in flight at a time
#pragma unroll 8
  for (int j = 0; j < n_ao; ++j) column[j * kDensityPoints + t] = live ? phi[j * G + k] : 0.0;
  double rho = 0.0, gx = 0.0, gy = 0.0, gz = 0.0;
  for (int i0 = 0; i0 < n_ao; i0 += kDensityPanel) {
    __syncthreads();  // every thread is done with the previous panel
#pragma unroll 8
    for (int e = t; e < n_ao * kDensityPanel; e += kDensityPoints) {
      const int j = e / kDensityPanel, c = e % kDensityPanel;
      panel[e] = i0 + c < n_ao ? P[static_cast<size_t>(j) * n_ao + i0 + c] : 0.0;
    }
    __syncthreads();
    for (int i1 = 0; i1 < kDensityPanel && i0 + i1 < n_ao; i1 += kDensityRows) {
      double y[kDensityRows];  // Y_ik for i = i0 + i1 + r
#pragma unroll
      for (int r = 0; r < kDensityRows; ++r) y[r] = 0.0;
#pragma unroll 4
      for (int j = 0; j < n_ao; ++j) {
        const double f = column[j * kDensityPoints + t];
        const double2* row = reinterpret_cast<const double2*>(panel + j * kDensityPanel + i1);
#pragma unroll
        for (int r = 0; r < kDensityRows / 2; ++r) {
          const double2 p = row[r];
          y[2 * r] += p.x * f;
          y[2 * r + 1] += p.y * f;
        }
      }
      if (!live) continue;
#pragma unroll
      for (int r = 0; r < kDensityRows; ++r) {
        const int i = i0 + i1 + r;
        if (i < n_ao) {
          rho += column[i * kDensityPoints + t] * y[r];
          if (with_gradients) {
            const size_t at = static_cast<size_t>(i) * G + k;
            gx += grads[at] * y[r];
            gy += grads[plane + at] * y[r];
            gz += grads[2 * plane + at] * y[r];
          }
        }
      }
    }
  }
  if (!live) return;
  density[k] = rho;
  if (with_gradients) {
    gradient[k] = 2.0 * gx;
    gradient[G + k] = 2.0 * gy;
    gradient[2 * G + k] = 2.0 * gz;
  }
}

}  // namespace

// values (n_ao, n_points); gradients (3, n_ao, n_points), written only when
// with_gradients is non-zero (it may be null otherwise).
extern "C" int tuna_ao_on_grid(int n_ao, int n_points, int with_gradients, const double* points,
                               const double* origin, const int* lmn, const int* prim_start,
                               const double* exps, const double* coefs, double* values,
                               double* gradients, cudaStream_t stream) {
  if (n_points == 0 || n_ao == 0) return cudaSuccess;
  const int blocks = (n_points + kThreads - 1) / kThreads;
  ao_on_grid_kernel<<<blocks, kThreads, 0, stream>>>(n_ao, n_points, with_gradients, points,
                                                     origin, lmn, prim_start, exps, coefs,
                                                     values, gradients);
  return cudaGetLastError();
}

// density (n_points,); gradient (3, n_points), written only when
// with_gradients is non-zero (grads and gradient may be null otherwise).
// P (n_ao, n_ao), phi (n_ao, n_points), grads (3, n_ao, n_points).  A
// block's columns of phi and panel of P take n_ao x 768 bytes of shared
// memory: past the default 48 KB (n_ao > 64) the launch asks for more, and
// an n_ao past what the card holds (302 on an H100) fails with the CUDA
// error of that request.
extern "C" int tuna_density_on_grid(int n_ao, int n_points, int with_gradients, const double* P,
                                    const double* phi, const double* grads, double* density,
                                    double* gradient, cudaStream_t stream) {
  if (n_points == 0) return cudaSuccess;
  const size_t shared =
      static_cast<size_t>(n_ao) * (kDensityPoints + kDensityPanel) * sizeof(double);
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        density_on_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (status != cudaSuccess) return status;
  }
  const int blocks = (n_points + kDensityPoints - 1) / kDensityPoints;
  density_on_grid_kernel<<<blocks, kDensityPoints, shared, stream>>>(
      n_ao, n_points, with_gradients, P, phi, grads, density, gradient);
  return cudaGetLastError();
}

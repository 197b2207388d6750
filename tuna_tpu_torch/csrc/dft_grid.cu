// K7: the DFT grid -- atomic orbitals on the grid (K7a) and the density
// and its gradient from a density matrix (K7b).  K8c, the R-tangent of the
// density and its gradient on a moving grid, is described at its kernel
// below.
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

// K8c: the density, its gradient and their R-tangents at fixed P, when
// atom 1 moves along +z and the points of its half of the grid move with
// it.  An AO value moves by (s_k - s_mu) d phi/dz, s = 1 for what moves
// with atom 1 (a function and a point on the same atom move together), its
// gradient by (s_k - s_mu) d(grad phi)/dz, the z column of the AO's
// Hessian.  With Y = P phi and Y' = P phi' (P symmetric, Cartesian):
//   rho' = 2 phi' . Y,   grad rho' = 2 (grad phi . Y' + grad phi' . Y).
// One thread a point, as K7b; its columns phi and phi' in shared memory
// (2 n_ao doubles a thread), each row of P the same for the warp (served
// from L1), the AO gradients and Hessian columns recomputed from the
// primitives row by row.  Every sum runs in a fixed order.
constexpr int kDerivPoints = 32;  // threads (points) per block of K8c

__global__ void __launch_bounds__(kDerivPoints)
density_deriv_on_grid_kernel(int n_ao, int n_points, int first_moving, int with_gradients,
                             const double* __restrict__ points, const double* __restrict__ origin,
                             const int* __restrict__ ao_moves, const int* __restrict__ lmn,
                             const int* __restrict__ prim_start, const double* __restrict__ exps,
                             const double* __restrict__ coefs, const double* __restrict__ P,
                             double* __restrict__ density, double* __restrict__ gradient,
                             double* __restrict__ d_density, double* __restrict__ d_gradient) {
  extern __shared__ double shared[];
  double* phi = shared;                                            // phi[j * kDerivPoints + t]
  double* dphi = shared + static_cast<size_t>(n_ao) * kDerivPoints;  // its R-tangent
  const int t = threadIdx.x;
  const int k = blockIdx.x * kDerivPoints + t;
  if (k >= n_points) return;  // no barrier below
  const size_t G = static_cast<size_t>(n_points);
  const double x = points[k], y = points[G + k], z = points[2 * G + k];
  const double point_moves = k >= first_moving ? 1.0 : 0.0;
  for (int mu = 0; mu < n_ao; ++mu) {
    const double X = x - origin[3 * mu], Y = y - origin[3 * mu + 1], Z = z - origin[3 * mu + 2];
    const double r2 = X * X + Y * Y + Z * Z;
    double s0 = 0.0, s1 = 0.0;
    for (int p = prim_start[mu]; p < prim_start[mu + 1]; ++p) {
      const double term = coefs[p] * exp(-exps[p] * r2);
      s0 += term;
      s1 += exps[p] * term;
    }
    const int l = lmn[3 * mu], m = lmn[3 * mu + 1], n = lmn[3 * mu + 2];
    const double px = int_pow(X, l), py = int_pow(Y, m), pz = int_pow(Z, n);
    const double poly = px * py * pz;
    const double dz = n > 0 ? n * px * py * int_pow(Z, n - 1) : 0.0;
    phi[mu * kDerivPoints + t] = s0 * poly;
    dphi[mu * kDerivPoints + t] = (point_moves - ao_moves[mu]) * (dz * s0 - 2.0 * Z * poly * s1);
  }
  double rho = 0.0, drho = 0.0, g[3] = {0.0, 0.0, 0.0}, dg[3] = {0.0, 0.0, 0.0};
  for (int i = 0; i < n_ao; ++i) {
    const double* row = P + static_cast<size_t>(i) * n_ao;
    double Yi = 0.0, dYi = 0.0;
    for (int j = 0; j < n_ao; ++j) {
      Yi += row[j] * phi[j * kDerivPoints + t];
      dYi += row[j] * dphi[j * kDerivPoints + t];
    }
    rho += phi[i * kDerivPoints + t] * Yi;
    drho += dphi[i * kDerivPoints + t] * Yi;
    if (!with_gradients) continue;
    const double X = x - origin[3 * i], Y = y - origin[3 * i + 1], Z = z - origin[3 * i + 2];
    const double r2 = X * X + Y * Y + Z * Z;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;  // sum c a^q e^(-a r2), q = 0, 1, 2
    for (int p = prim_start[i]; p < prim_start[i + 1]; ++p) {
      const double term = coefs[p] * exp(-exps[p] * r2);
      s0 += term;
      s1 += exps[p] * term;
      s2 += exps[p] * exps[p] * term;
    }
    const int l = lmn[3 * i], m = lmn[3 * i + 1], n = lmn[3 * i + 2];
    const double px = int_pow(X, l), py = int_pow(Y, m), pz = int_pow(Z, n);
    const double poly = px * py * pz;
    // monomial derivatives, each only where its power is positive (the
    // Lebedev directions hold X = 0, where 0^(-1) would give NaN)
    const double dx = l > 0 ? l * int_pow(X, l - 1) * py * pz : 0.0;
    const double dy = m > 0 ? m * px * int_pow(Y, m - 1) * pz : 0.0;
    const double dz = n > 0 ? n * px * py * int_pow(Z, n - 1) : 0.0;
    const double dxz = l > 0 && n > 0 ? l * n * int_pow(X, l - 1) * py * int_pow(Z, n - 1) : 0.0;
    const double dyz = m > 0 && n > 0 ? m * n * px * int_pow(Y, m - 1) * int_pow(Z, n - 1) : 0.0;
    const double dzz = n > 1 ? n * (n - 1) * px * py * int_pow(Z, n - 2) : 0.0;
    const double grad[3] = {dx * s0 - 2.0 * X * poly * s1, dy * s0 - 2.0 * Y * poly * s1,
                            dz * s0 - 2.0 * Z * poly * s1};
    const double hess_z[3] = {
        dxz * s0 - 2.0 * Z * dx * s1 - 2.0 * X * dz * s1 + 4.0 * X * Z * poly * s2,
        dyz * s0 - 2.0 * Z * dy * s1 - 2.0 * Y * dz * s1 + 4.0 * Y * Z * poly * s2,
        dzz * s0 - 4.0 * Z * dz * s1 - 2.0 * poly * s1 + 4.0 * Z * Z * poly * s2};
    const double moves = point_moves - ao_moves[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g[c] += grad[c] * Yi;
      dg[c] += grad[c] * dYi + moves * hess_z[c] * Yi;
    }
  }
  density[k] = rho;
  d_density[k] = 2.0 * drho;
  if (with_gradients) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gradient[c * G + k] = 2.0 * g[c];
      d_gradient[c * G + k] = 2.0 * dg[c];
    }
  }
}

}  // namespace

// points (3, n_points), the points from first_moving on moving with atom 1;
// origin (n_ao, 3) and ao_moves (n_ao, 1 for an AO on atom 1) of the
// Cartesian AOs, lmn, prim_start, exps and coefs as for tuna_ao_on_grid;
// P (n_ao, n_ao) symmetric.  density and d_density (n_points,); gradient
// and d_gradient (3, n_points), written only when with_gradients is
// non-zero (they may be null otherwise).  A block's columns take
// 2 n_ao x 256 bytes of shared memory: past the default 48 KB (n_ao > 96)
// the launch asks for more.
extern "C" int tuna_density_deriv_on_grid(int n_ao, int n_points, int first_moving,
                                          int with_gradients, const double* points,
                                          const double* origin, const int* ao_moves,
                                          const int* lmn, const int* prim_start,
                                          const double* exps, const double* coefs,
                                          const double* P, double* density, double* gradient,
                                          double* d_density, double* d_gradient,
                                          cudaStream_t stream) {
  if (n_points == 0) return cudaSuccess;
  const size_t shared = 2 * static_cast<size_t>(n_ao) * kDerivPoints * sizeof(double);
  if (shared > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(density_deriv_on_grid_kernel,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(shared));
    if (status != cudaSuccess) return status;
  }
  const int blocks = (n_points + kDerivPoints - 1) / kDerivPoints;
  density_deriv_on_grid_kernel<<<blocks, kDerivPoints, shared, stream>>>(
      n_ao, n_points, first_moving, with_gradients, points, origin, ao_moves, lmn, prim_start,
      exps, coefs, P, density, gradient, d_density, d_gradient);
  return cudaGetLastError();
}

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

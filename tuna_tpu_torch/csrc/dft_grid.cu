// K7: the DFT grid -- atomic orbitals on the grid (K7a) and the density
// and its gradient from a density matrix (K7b; K7bt adds the kinetic
// energy density tau of the meta-GGAs).  K8c and K8cu, the R-tangent of the
// density and its gradient on a moving grid for one density and for both
// spins, and K8ct and K8cut, the same with tau and its tangent, are
// described at their kernels below.
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
// What bounds K7a on an H100: bytes.  At N2/cc-pVTZ on the medium grid
// (70 Cartesian AOs, 80,724 points) it writes values and gradients,
// 4 x 70 x 80,724 doubles = 181 MB, for some 3e8 float64 operations.
//
// K7a's design: one thread per grid point.  Threads of a warp take
// neighbouring points, so every read and write of an (AO, point) array is
// coalesced.  It walks the AOs; the contracted primitives come in CSR form
// (prim_start per AO, coefficient x normalisation and exponent per
// primitive), and the AO data, the same for every thread, is served from
// L1.  It sums sum_k c_k e^(-a_k r^2) and sum_k c_k a_k e^(-a_k r^2) once
// and forms the value and the three gradient components from them.  The
// derivative of X^l is taken only for l > 0 (the reference's guard,
// grid.py:122-124): Lebedev directions hold X = 0, where an unguarded
// 0^(-1) gives inf x 0 = NaN.
//
// K7b and K7bt are one template, density_on_grid_kernel<outputs, whole P>,
// over three output sets:
// * kDensityRho (K7b without gradients, the LDA branch, dft/__init__.py:59):
//   rho from one column (phi) and one product, Y_0 = P^T phi;
// * kDensityGradients (K7b, the GGA paths and VV10): rho and grad rho from
//   four columns [phi | d_x phi | d_y phi | d_z phi] and the one product Y_0;
// * kDensityTau (K7bt, tuna_tpu/dft/__init__.py:48-49): those and tau =
//   1/2 sum_a sum_ij P_ij d_a phi_i d_a phi_j from the four products Y_a =
//   P^T B_a (B_0 = phi, B_a = d_a phi).
// What bounds them on an H100: bytes, the columns read once (phi and d phi,
// 155 MB at N2/cc-pVTZ on the medium grid, 0.047 ms; phi alone 0.012 ms);
// the products (2 n^2 a point each) take 0.009 ms a product at the DMMA
// rate there.  K7b's first form took one thread a point with the
// products as dot products on the CUDA cores, P staged in panels with two
// barriers a panel and the gradient columns read from device memory in
// the epilogue: 0.115-0.159 ms a launch, 2.5-3.4x its bound.
// Design: persistent blocks of T / 8 warps take tiles of T points.  A block
// stages P^T once (zero-padded to the tiles) and each tile's columns with
// cp.async, coalesced along the points: the only read of phi and d phi.
// With two column buffers the next tile's cp.async is in flight while the
// block multiplies the current one.  Each warp takes 8 points and walks the
// 16-row tiles i of the AOs: the products Y_a[i, :] on mma.sync.m16n8k8 f64
// (the A fragment, P^T, shared by them), then the epilogue multiplies each
// accumulator entry by the staged column entries of the same (i, point)
// and adds them over i in registers: rho and grad rho from Y_0 against phi
// and d_a phi, tau from Y_a against d_a phi.  Y is never stored.  After the
// last tile of i the sums over the fragment rows go through three warp
// shuffles, in a fixed order: deterministic, no atomics, no other warp
// involved.  Y_0 and the rho and grad rho epilogue are the same code in
// every output set, and a point's sums do not depend on the tile, on P^T's
// staging or on the buffers, so K7b's rho and grad rho are K7bt's bit for
// bit.  The host picks T (32, 16 or 8), whether P^T fits whole and one or
// two column buffers (dft/grid.py::density_layout); where P^T does not fit
// whole, as at n = 203 with gradients, it is staged 16 rows at a time.  At
// N2/cc-pVTZ (n = 60, T = 32, P^T whole; chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700.00 W) two buffers (one block a multiprocessor) took 0.078 ms a
// launch back to back with gradients against 0.089 with one (two blocks),
// so K7b takes two; K7bt, four times the products, took 0.119 with one
// against 0.128, so it takes one; without gradients (one column) the two
// tied at 32 points (0.032) and one was ahead at 16 points and with P^T in
// rows (0.038 against 0.039, 0.047 against 0.056), so it takes one as
// well.  With one buffer K7b took 0.064 ms a
// launch on the B3LYP single point (1.4x its byte bound; the first form
// 0.115) and 0.078 on the UKS optimisation (0.159); without gradients
// 0.021-0.030 (bound 0.012).
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

#include "dmma.cuh"

namespace {

constexpr int kThreads = 128;       // threads (points) per block of K7a

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

// The multiprocessor count of the current device times the blocks of
// `kernel` one holds at `threads` threads and `shared` bytes of dynamic
// shared memory: the grid of a persistent kernel.  The CUDA runtime is
// asked once per (device, kernel, threads, shared) and the answer kept, so
// a launch adds no query; a kernel's shared memory attribute only grows,
// to the largest request so far.
struct Residency {
  int device;
  const void* kernel;
  int threads, shared, blocks;
};

cudaError_t resident_blocks(const void* kernel, int threads, int shared, int* blocks) {
  static std::mutex lock;
  static std::vector<Residency> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  int largest = -1;   // the kernel's shared memory attribute on this device, if set
  for (const Residency& r : known) {
    if (r.device != device || r.kernel != kernel) continue;
    if (r.threads == threads && r.shared == shared) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
    largest = r.shared > largest ? r.shared : largest;
  }
  if (shared > largest) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return err;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shared)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known.push_back({device, kernel, threads, shared, sms * per_sm});
  *blocks = sms * per_sm;
  return cudaSuccess;
}

constexpr int kDensityRho = 0;          // rho
constexpr int kDensityGradients = 1;    // and grad rho
constexpr int kDensityTau = 2;          // and tau
constexpr int kDensityMaxWarps = 4;     // warps (8 points each) a block at most

// The columns a tile holds: phi; with gradients (and tau) d_x, d_y, d_z phi too.
__host__ __device__ constexpr int density_columns(int outputs) {
  return outputs == kDensityRho ? 1 : 4;
}

// P^T rows [i0, i0 + rows) into Pt (rows, lda), zero past n_ao, by
// cp.async: every load in flight at once, in the group of the caller's
// next commit.
__device__ __forceinline__ void stage_p_transposed(int n_ao, int i0, int rows, int lda,
                                                   const double* __restrict__ P, double* Pt) {
  for (int e = threadIdx.x; e < rows * lda; e += blockDim.x) {
    const int r = e / lda, j = e - r * lda, i = i0 + r;
    const bool inside = i < n_ao && j < n_ao;
    cp_async8_zfill(Pt + e, P + (inside ? static_cast<size_t>(j) * n_ao + i : 0), inside);
  }
}

// K7b and K7bt (see the note at the top).  Shared memory: `buffers` (1 or
// 2) sets of the columns, (density_columns(kOutputs), mp, T + 4) each, rows
// past n_ao zero, then P^T (mp, lda) when kWholeP, else 16 rows of it.  mp
// = n_ao rounded up to 16 (the AO tiles), kp = n_ao rounded up to 8 (the
// products' depth), lda = kp + 4: a row stride of 4 or 12 mod 16 doubles,
// as T + 4 is, keeps every fragment load free of bank conflicts.  gradient
// is written only with gradients, tau only for kDensityTau.
template <int kOutputs, bool kWholeP>
__global__ void __launch_bounds__(32 * kDensityMaxWarps, 4)
density_on_grid_kernel(int n_ao, int n_points, int points, int buffers, int mp, int kp, int lda,
                       const double* __restrict__ P, const double* __restrict__ phi,
                       const double* __restrict__ grads, double* __restrict__ density,
                       double* __restrict__ gradient, double* __restrict__ tau) {
  constexpr int kColumns = density_columns(kOutputs);
  constexpr int kProducts = kOutputs == kDensityTau ? 4 : 1;
  // rho, grad rho (x, y, z) / 2, 2 tau
  constexpr int kSums = kOutputs == kDensityRho ? 1 : kOutputs == kDensityGradients ? 4 : 5;
  extern __shared__ __align__(16) double shared[];
  const int ldb = points + 4, column = mp * ldb;   // a column's doubles: (mp, ldb)
  const int set = kColumns * column;              // a buffer's
  double* Pt = shared + buffers * set;
  const int lane = threadIdx.x & 31, g = lane >> 2, quad = lane & 3;
  const int first = 8 * (threadIdx.x >> 5);        // this warp's points in the tile
  const size_t G = static_cast<size_t>(n_points), plane = static_cast<size_t>(n_ao) * G;
  const int padding = (mp - n_ao) * ldb;
  for (int e = threadIdx.x; e < buffers * kColumns * padding; e += blockDim.x) {
    const int c = e / padding;                     // buffer * kColumns + column
    shared[c * column + n_ao * ldb + e - c * padding] = 0.0;
  }
  // with the first tile's columns (its cp.async group)
  if constexpr (kWholeP) stage_p_transposed(n_ao, 0, mp, lda, P, Pt);
  // A tile's columns into a buffer, one cp.async group: thread (t, j0) takes
  // point t of rows j0, j0 + 4, ...; a warp reads 256 contiguous bytes of a
  // row (T = 32) or two rows' 128 (T = 16); zeros past the last point.
  const int t = threadIdx.x % points, j0 = threadIdx.x / points;
  auto load = [&](int tile, double* columns) {
    const int k = tile * points + t;
    const bool inside = k < n_points;
    const size_t at = inside ? k : 0;
#pragma unroll
    for (int a = 0; a < kColumns; ++a) {
      const double* from = (a == 0 ? phi : grads + (a - 1) * plane) + at;
      for (int j = j0; j < n_ao; j += 4) {
        cp_async8_zfill(columns + a * column + j * ldb + t, from + j * G, inside);
      }
    }
    cp_async_commit();
  };
  const int tiles = (n_points + points - 1) / points;
  int buffer = 0;
  if (buffers == 2) load(blockIdx.x, shared);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const double* columns = shared + buffer * set;
    if (buffers == 2) {        // the next tile's loads fly while this one is multiplied
      const int next = tile + gridDim.x;
      if (next < tiles) load(next, shared + (buffer ^ 1) * set); else cp_async_commit();
      cp_async_wait<1>();
      buffer ^= 1;
    } else {
      load(tile, shared);
      cp_async_wait<0>();
    }
    __syncthreads();
    double sums[kSums][2] = {};   // at points first + 2 quad + r
    for (int i0 = 0; i0 < mp; i0 += 16) {
      const double* A = Pt + i0 * lda;
      if constexpr (!kWholeP) {
        __syncthreads();      // every warp is done with the previous rows
        stage_p_transposed(n_ao, i0, 16, lda, P, Pt);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        A = Pt;
      }
      double y[kProducts][4] = {};   // Y_a for AOs i0 + g (+ 8) at points first + 2 quad (+ 1)
      for (int kk = quad; kk < kp; kk += 8) {
        const double a[4] = {A[g * lda + kk], A[(g + 8) * lda + kk], A[g * lda + kk + 4],
                             A[(g + 8) * lda + kk + 4]};
        const double* b = columns + kk * ldb + first + g;
#pragma unroll
        for (int c = 0; c < kProducts; ++c) {
          mma_f64(y[c], a, b[c * column], b[c * column + 4 * ldb]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const double* at = columns + (i0 + g + 8 * h) * ldb + first + 2 * quad + r;
          const double y0 = y[0][2 * h + r];
          sums[0][r] += at[0] * y0;
          if constexpr (kOutputs != kDensityRho) {
            const double dx = at[column], dy = at[2 * column], dz = at[3 * column];
            sums[1][r] += dx * y0;
            sums[2][r] += dy * y0;
            sums[3][r] += dz * y0;
            if constexpr (kOutputs == kDensityTau) {
              sums[4][r] += dx * y[1][2 * h + r] + dy * y[2][2 * h + r] + dz * y[3][2 * h + r];
            }
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kSums; ++v) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        double x = sums[v][r];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        sums[v][r] = x;
      }
    }
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = tile * points + first + 2 * quad + r;
        if (k < n_points) {
          density[k] = sums[0][r];
          if constexpr (kOutputs != kDensityRho) {
            gradient[k] = 2.0 * sums[1][r];
            gradient[G + k] = 2.0 * sums[2][r];
            gradient[2 * G + k] = 2.0 * sums[3][r];
          }
          if constexpr (kOutputs == kDensityTau) tau[k] = 0.5 * sums[4][r];
        }
      }
    }
    __syncthreads();          // every warp is done with the tile's columns
  }
}

template <int kOutputs>
cudaError_t launch_density(int n_ao, int n_points, int points, int whole_p, int buffers,
                           const double* P, const double* phi, const double* grads,
                           double* density, double* gradient, double* tau, cudaStream_t stream) {
  if (n_points == 0) return cudaSuccess;
  if (n_ao < 1 || points < 8 || points % 8 != 0 || points > 8 * kDensityMaxWarps ||
      (buffers != 1 && buffers != 2))
    return cudaErrorInvalidValue;
  const int mp = (n_ao + 15) / 16 * 16, kp = (n_ao + 7) / 8 * 8, lda = kp + 4;
  const size_t doubles =
      static_cast<size_t>(buffers) * density_columns(kOutputs) * mp * (points + 4) +
      static_cast<size_t>(whole_p ? mp : 16) * lda;
  const int shared = static_cast<int>(doubles * sizeof(double));
  auto kernel = whole_p ? density_on_grid_kernel<kOutputs, true>
                        : density_on_grid_kernel<kOutputs, false>;
  const int threads = 4 * points;   // a warp for each 8 points
  int resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, shared, &resident);
  if (err != cudaSuccess) return err;
  const int tiles = (n_points + points - 1) / points;
  const int blocks = tiles < resident ? tiles : resident;
  kernel<<<blocks, threads, shared, stream>>>(n_ao, n_points, points, buffers, mp, kp, lda, P,
                                             phi, grads, density, gradient, tau);
  return cudaGetLastError();
}

// The moving-grid kernel (moving_grid_kernel<S, outputs, whole P>): K8c and
// K8cu, K8ct and K8cut, one template over S = 1 or 2 densities (the spins)
// and three output sets.  They replace tuna_tpu/drivers/gradients.py:123-160
// (and :184-211 for both spins): basis_on_grid and density_quantities on
// the moving grid under jax.grad.  At fixed P, when atom 1 moves along +z
// and the points of its half of the grid move with it, an AO value moves by
// (s_k - s_mu) d phi/dz (s = 1 for what moves with atom 1: a function and a
// point on the same atom move together), its gradient by (s_k - s_mu)
// d(grad phi)/dz, the z column of the AO's Hessian.  With Y = P phi, Y' =
// P phi' and Y_c = P d_c phi (P symmetric, Cartesian), the outputs are
// * kDerivRho (the LDA branch, K8c and K8cu without gradients): rho = phi
//   . Y and rho' = 2 phi' . Y;
// * kDerivGradients (K8c and K8cu): those and grad rho = 2 grad phi . Y,
//   grad rho' = 2 (grad phi . Y' + grad phi' . Y);
// * kDerivTau (K8ct and K8cut, :157-159): those and the meta-GGAs' tau =
//   1/2 sum_c d_c phi . Y_c and tau' = sum_c (d_c phi)' . Y_c.
//
// What bounds them on an H100: operations (chip_smoke.py density_deriv_ms,
// at N2/cc-pVTZ, 70 Cartesian AOs and 80,724 points: 0.0442 ms for K8c,
// 0.0854 for K8ct).  A density takes two products of 2 n^2 a point (Y, Y')
// with gradients, five with tau, one (Y) without gradients, 4e9 operations
// for tau, 0.059 ms at the DMMA rate; the columns (phi, grad phi and the
// moving Hessian z column of every AO at every point, ~160 operations an
// (AO, point)) take 0.026 ms on the CUDA cores; the bytes (points in, ten
// outputs a point and density out) under 0.01 ms.
//
// Design, after K7bt's (the first forms, one thread a point with the
// products as dot products on the CUDA cores, ran at ~3% of the DMMA rate):
// * Persistent blocks take tiles of T points.  The whole block forms the
//   tile's columns in shared memory, a thread an AO at two points of the
//   tile in step (two independent chains of arithmetic, which ran faster
//   than one point a thread at n = 70; the AO's data read once for both):
//   with gradients phi, d_x phi, d_y phi, d_z phi and the moving Hessian z
//   column (s_k - s_mu) d(d_c phi)/dz, c = x, y, z, each primitive's
//   exponential once an (AO, point); without, phi and d_z phi.  phi' =
//   (s_k - s_mu) d_z phi gets no column of its own: it is formed from the
//   d_z phi column where it is read, as a B fragment of Y' and in the
//   epilogue (two multiplies), which keeps the columns to seven and lets
//   T = 32 with P whole at n = 70 for S = 1.  Rows past n_ao and points past
//   n_points are zero.
// * The products on mma.sync.m16n8k8 f64, P (each density's, row-major,
//   zero-padded: (mp, lda) with mp = n_ao rounded up to 16, the AO tiles,
//   and the depth kp = n_ao rounded up to 8) staged once a block when it
//   fits, else 16 rows at a time; lda = kp + 4 and T + 4, 4 or 12 mod 16
//   doubles, keep the fragment loads free of bank conflicts.
// * A block has 2S warps for each 8 points: for each density one warp
//   takes {Y, Y'} (2 products on one A fragment; Y alone without
//   gradients) and, with tau, one {Y_x, Y_y, Y_z} (3).  Without tau the
//   second warp of the pair forms columns and waits through the products:
//   the columns keep the threads of K8ct's block, and the {Y, Y'} warp runs
//   exactly K8ct's code, so K8c's outputs are K8ct's first four bit for
//   bit.  S = 2 doubles the warps, not a warp's registers, and each density
//   runs exactly the code of S = 1: each spin of K8cu (K8cut) is K8c's
//   (K8ct's) on that spin's density, bit for bit.  The two kinds alternate
//   over the multiprocessor's four schedulers (warp w goes to scheduler w %
//   4).
// * The epilogue in registers: each accumulator entry meets the staged
//   column entries of the same (AO, point): rho += phi Y, rho' += phi' Y,
//   g_c += d_c phi Y, g'_c += d_c phi Y' + (d_c phi)' Y from the {Y, Y'}
//   warp; tau += sum_c d_c phi Y_c, tau' += sum_c (d_c phi)' Y_c from the
//   other.  Summed over the AO tiles in registers, then across the
//   fragment rows by three warp shuffles in a fixed order: deterministic,
//   no atomics.  The outputs are disjoint between warps, so no sum
//   crosses a warp.
// The host picks T (32 / S, 16 or 8: at most 256 threads a block, which
// leaves a thread up to 255 registers) and whether P is staged whole (dft/
// grid.py::density_deriv_layout).  At n = 70 with gradients: S = 1 takes
// T = 32 and P whole, 210,560 B of shared memory and 8 warps a block; S = 2
// T = 16, 187,520 B and 8 warps; one block a multiprocessor, 120 registers
// a thread without tau and 160 with it (ptxas), no spills.  There K8c takes
// 0.241 ms a launch on the B3LYP optimisation and K8cu 0.425 on the UKS
// one, 5.5-6.1x the bound, most of it forming the columns; K8ct 0.279 on
// the R2SCAN optimisation and K8cut 0.500 on the UKS TPSS one, 3.3-3.4x
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py).  That block beat T = 16
// with P in 16 rows, two blocks a multiprocessor; reading P through L1
// instead of staging it was slower for S = 1 and about as fast for S = 2.
// Without gradients two columns leave room for two blocks a multiprocessor
// at n = 70, so the registers are held to 128 there.
constexpr int kDerivRho = 0;              // rho, rho'
constexpr int kDerivGradients = 1;        // and grad rho, grad rho'
constexpr int kDerivTau = 2;              // and tau, tau'
constexpr int kDerivMaxThreads = 256;     // 2 S warps for each 8 of at most 32 / S points

// The columns a tile holds: phi, d_x, d_y, d_z phi, (d_x, d_y, d_z of
// d_z phi)' with gradients; phi and d_z phi without.
__host__ __device__ constexpr int deriv_columns(int outputs) {
  return outputs == kDerivRho ? 2 : 7;
}

// x^n for each of two values, 1 for n <= 0.
__device__ __forceinline__ void powers(double (&out)[2], const double (&x)[2], int n) {
  out[0] = out[1] = 1.0;
  for (int i = 0; i < n; ++i) {
    out[0] *= x[0];
    out[1] *= x[1];
  }
}

// P rows [i0, i0 + rows) into to (rows, lda), zero past n_ao.
__device__ __forceinline__ void stage_p_rows(int n_ao, int i0, int rows, int lda,
                                             const double* __restrict__ P, double* to) {
  for (int e = threadIdx.x; e < rows * lda; e += blockDim.x) {
    const int r = e / lda, j = e - r * lda, i = i0 + r;
    to[e] = (i < n_ao && j < n_ao) ? P[static_cast<size_t>(i) * n_ao + j] : 0.0;
  }
}

// Shared memory: the columns (deriv_columns(kOutputs), mp, T + 4), then
// ao_moves as doubles (mp, zero past n_ao), then each density's P, (mp,
// lda) when kWholeP, else (16, lda).  gradient and d_gradient are not written
// for kDerivRho, tau and d_tau only for kDerivTau.
template <int S, int kOutputs, bool kWholeP>
__global__ void __launch_bounds__(kDerivMaxThreads, kOutputs == kDerivRho ? 2 : 1)
moving_grid_kernel(int n_ao, int n_points, int first_moving, int points, int mp, int kp, int lda,
                   const double* __restrict__ xyz, const double* __restrict__ origin,
                   const int* __restrict__ ao_moves, const int* __restrict__ lmn,
                   const int* __restrict__ prim_start, const double* __restrict__ exps,
                   const double* __restrict__ coefs, const double* __restrict__ P,
                   double* __restrict__ density, double* __restrict__ gradient,
                   double* __restrict__ d_density, double* __restrict__ d_gradient,
                   double* __restrict__ tau, double* __restrict__ d_tau) {
  constexpr bool kGradients = kOutputs != kDerivRho;
  constexpr int kColumns = deriv_columns(kOutputs), kDz = kGradients ? 3 : 1;   // d_z phi's
  extern __shared__ __align__(16) double shared[];
  const int ldb = points + 4, column = mp * ldb;   // a column's doubles: (mp, ldb)
  double* columns = shared;
  double* moves_ao = shared + kColumns * column;
  double* Ps = moves_ao + mp;
  const int rows = kWholeP ? mp : 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, quad = lane & 3;
  // warp w: kind 0 ({Y, Y'}) or 1 ({Y_c} with tau, else columns only),
  // alternating over w % 4; then its density and its 8 points
  const int warp = threadIdx.x >> 5, kind = (warp ^ (warp >> 2)) & 1, unit = warp >> 1;
  const int s = unit % S, first = 8 * (unit / S);
  const double* Pd = Ps + s * rows * lda;
  const size_t G = static_cast<size_t>(n_points), nn = static_cast<size_t>(n_ao) * n_ao;
  const int padding = (mp - n_ao) * ldb;
  for (int e = threadIdx.x; e < kColumns * padding; e += blockDim.x) {
    const int c = e / padding;
    columns[c * column + n_ao * ldb + e - c * padding] = 0.0;
  }
  for (int i = threadIdx.x; i < mp; i += blockDim.x) moves_ao[i] = i < n_ao ? ao_moves[i] : 0.0;
  if constexpr (kWholeP) {
    for (int d = 0; d < S; ++d) stage_p_rows(n_ao, 0, mp, lda, P + d * nn, Ps + d * mp * lda);
  }
  const int tiles = (n_points + points - 1) / points, half = points / 2;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int k0 = tile * points;
    // the tile's columns: thread e takes AO e / (T / 2) at the points t and
    // t + T / 2, t = e % (T / 2), in step (two independent chains)
    for (int e = threadIdx.x; e < n_ao * half; e += blockDim.x) {
      const int mu = e / half, t = e - mu * half;
      const int l = lmn[3 * mu], m = lmn[3 * mu + 1], n = lmn[3 * mu + 2];
      // s_q = sum c a^q e^(-a r2), q = 0, 1, 2 (2 only with gradients), at
      // each of the two points
      double X[2], Y[2], Z[2], r2[2], s0[2] = {}, s1[2] = {};
      [[maybe_unused]] double s2[2] = {};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = min(k0 + t + q * half, n_points - 1);   // past the last point: not stored
        X[q] = xyz[k] - origin[3 * mu];
        Y[q] = xyz[G + k] - origin[3 * mu + 1];
        Z[q] = xyz[2 * G + k] - origin[3 * mu + 2];
        r2[q] = X[q] * X[q] + Y[q] * Y[q] + Z[q] * Z[q];
      }
      for (int p = prim_start[mu]; p < prim_start[mu + 1]; ++p) {
        const double a = exps[p], c = coefs[p];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const double term = c * exp(-a * r2[q]);
          s0[q] += term;
          s1[q] += a * term;
          if constexpr (kGradients) s2[q] += a * a * term;
        }
      }
      // X^l, X^(l-1) (l > 0), ... and Z^(n-2) (n > 1): the monomial
      // derivatives only where the power is positive (0^(-1) is NaN)
      double px[2], py[2], pz[2], px1[2], py1[2], pz1[2], pz2[2];
      powers(px1, X, l - 1);
      powers(py1, Y, m - 1);
      powers(pz2, Z, n - 2);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        px[q] = l > 0 ? px1[q] * X[q] : 1.0;
        py[q] = m > 0 ? py1[q] * Y[q] : 1.0;
        pz1[q] = n > 0 ? (n > 1 ? pz2[q] * Z[q] : 1.0) : 0.0;
        pz[q] = n > 0 ? pz1[q] * Z[q] : 1.0;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        double* at = columns + mu * ldb + t + q * half;
        if (k0 + t + q * half >= n_points) {
#pragma unroll
          for (int c = 0; c < kColumns; ++c) at[c * column] = 0.0;
          continue;
        }
        const double poly = px[q] * py[q] * pz[q];
        const double dz = n > 0 ? n * px[q] * py[q] * pz1[q] : 0.0;
        const double z = Z[q], f0 = s0[q], f1 = s1[q];
        at[0] = f0 * poly;
        at[kDz * column] = dz * f0 - 2.0 * z * poly * f1;
        if constexpr (kGradients) {
          const double x = X[q], y = Y[q], f2 = s2[q];
          const double dx = l > 0 ? l * px1[q] * py[q] * pz[q] : 0.0;
          const double dy = m > 0 ? m * px[q] * py1[q] * pz[q] : 0.0;
          const double dxz = l > 0 && n > 0 ? l * n * px1[q] * py[q] * pz1[q] : 0.0;
          const double dyz = m > 0 && n > 0 ? m * n * px[q] * py1[q] * pz1[q] : 0.0;
          const double dzz = n > 1 ? n * (n - 1) * px[q] * py[q] * pz2[q] : 0.0;
          const double moves = (k0 + t + q * half >= first_moving ? 1.0 : 0.0) - ao_moves[mu];
          at[column] = dx * f0 - 2.0 * x * poly * f1;
          at[2 * column] = dy * f0 - 2.0 * y * poly * f1;
          at[4 * column] =
              moves * (dxz * f0 - 2.0 * z * dx * f1 - 2.0 * x * dz * f1 + 4.0 * x * z * poly * f2);
          at[5 * column] =
              moves * (dyz * f0 - 2.0 * z * dy * f1 - 2.0 * y * dz * f1 + 4.0 * y * z * poly * f2);
          at[6 * column] =
              moves * (dzz * f0 - 4.0 * z * dz * f1 - 2.0 * poly * f1 + 4.0 * z * z * poly * f2);
        }
      }
    }
    __syncthreads();
    // whether the point of this lane's B fragment column, and of its
    // accumulator columns first + 2 quad + r, moves with atom 1
    [[maybe_unused]] const double b_moves = k0 + first + g >= first_moving ? 1.0 : 0.0;
    const double c_moves[2] = {k0 + first + 2 * quad >= first_moving ? 1.0 : 0.0,
                               k0 + first + 2 * quad + 1 >= first_moving ? 1.0 : 0.0};
    // kind 0: rho, rho', grad rho / 2, grad rho' / 2; kind 1: 2 tau, tau'
    double sums[8][2] = {};
    for (int i0 = 0; i0 < mp; i0 += 16) {
      const double* A = Pd + i0 * lda;
      if constexpr (!kWholeP) {
        __syncthreads();      // every warp is done with the previous rows
        for (int d = 0; d < S; ++d) stage_p_rows(n_ao, i0, 16, lda, P + d * nn, Ps + d * 16 * lda);
        __syncthreads();
        A = Pd;
      }
      if (kind == 0) {
        double y[2][4] = {};  // Y, Y' for AOs i0 + g (+ 8) at points first + 2 quad (+ 1)
        for (int kk = quad; kk < kp; kk += 8) {
          const double a[4] = {A[g * lda + kk], A[(g + 8) * lda + kk], A[g * lda + kk + 4],
                               A[(g + 8) * lda + kk + 4]};
          const double* b = columns + kk * ldb + first + g;
          mma_f64(y[0], a, b[0], b[4 * ldb]);
          if constexpr (kGradients) {
            const double* bz = b + 3 * column;
            mma_f64(y[1], a, (b_moves - moves_ao[kk]) * bz[0],
                    (b_moves - moves_ao[kk + 4]) * bz[4 * ldb]);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = i0 + g + 8 * h;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const double* at = columns + i * ldb + first + 2 * quad + r;
            const double f = at[0], dz = at[kDz * column];
            const double fm = (c_moves[r] - moves_ao[i]) * dz;
            const double y0 = y[0][2 * h + r];
            sums[0][r] += f * y0;
            sums[1][r] += fm * y0;
            if constexpr (kGradients) {
              const double dx = at[column], dy = at[2 * column];
              const double hx = at[4 * column], hy = at[5 * column], hz = at[6 * column];
              const double y1 = y[1][2 * h + r];
              sums[2][r] += dx * y0;
              sums[3][r] += dy * y0;
              sums[4][r] += dz * y0;
              sums[5][r] += dx * y1 + hx * y0;
              sums[6][r] += dy * y1 + hy * y0;
              sums[7][r] += dz * y1 + hz * y0;
            }
          }
        }
      } else if constexpr (kOutputs == kDerivTau) {
        double y[3][4] = {};  // Y_x, Y_y, Y_z, as above
        for (int kk = quad; kk < kp; kk += 8) {
          const double a[4] = {A[g * lda + kk], A[(g + 8) * lda + kk], A[g * lda + kk + 4],
                               A[(g + 8) * lda + kk + 4]};
          const double* b = columns + column + kk * ldb + first + g;
#pragma unroll
          for (int c = 0; c < 3; ++c) mma_f64(y[c], a, b[c * column], b[c * column + 4 * ldb]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const double* at = columns + (i0 + g + 8 * h) * ldb + first + 2 * quad + r;
            const double yx = y[0][2 * h + r], yy = y[1][2 * h + r], yz = y[2][2 * h + r];
            sums[0][r] += at[column] * yx + at[2 * column] * yy + at[3 * column] * yz;
            sums[1][r] += at[4 * column] * yx + at[5 * column] * yy + at[6 * column] * yz;
          }
        }
      }
    }
    // the sums each warp holds (the same for the whole warp)
    const int values = kind == 0 ? (kGradients ? 8 : 2) : (kOutputs == kDerivTau ? 2 : 0);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      if (v < values) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          double x = sums[v][r];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          sums[v][r] = x;
        }
      }
    }
    if (g == 0 && values > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t k = k0 + first + 2 * quad + r;
        if (k >= G) continue;
        if (kind == 0) {
          density[s * G + k] = sums[0][r];
          d_density[s * G + k] = 2.0 * sums[1][r];
          if constexpr (kGradients) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              gradient[(3 * s + c) * G + k] = 2.0 * sums[2 + c][r];
              d_gradient[(3 * s + c) * G + k] = 2.0 * sums[5 + c][r];
            }
          }
        } else {
          tau[s * G + k] = 0.5 * sums[0][r];
          d_tau[s * G + k] = sums[1][r];
        }
      }
    }
    __syncthreads();          // every warp is done with the tile's columns
  }
}

template <int S, int kOutputs>
cudaError_t launch_moving_grid(int n_ao, int n_points, int first_moving, int points, int whole_p,
                               const double* xyz, const double* origin, const int* ao_moves,
                               const int* lmn, const int* prim_start, const double* exps,
                               const double* coefs, const double* P, double* density,
                               double* gradient, double* d_density, double* d_gradient,
                               double* tau, double* d_tau, cudaStream_t stream) {
  if (n_points == 0) return cudaSuccess;
  if (n_ao < 1 || points < 8 || points % 8 != 0 || points * S > 32) return cudaErrorInvalidValue;
  const int mp = (n_ao + 15) / 16 * 16, kp = (n_ao + 7) / 8 * 8, lda = kp + 4;
  const size_t doubles = deriv_columns(kOutputs) * static_cast<size_t>(mp) * (points + 4) + mp +
                         static_cast<size_t>(S) * (whole_p ? mp : 16) * lda;
  const int shared = static_cast<int>(doubles * sizeof(double));
  auto kernel = whole_p ? moving_grid_kernel<S, kOutputs, true>
                        : moving_grid_kernel<S, kOutputs, false>;
  const int threads = 8 * points * S;   // 2 S warps for each 8 points
  int resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, shared, &resident);
  if (err != cudaSuccess) return err;
  const int tiles = (n_points + points - 1) / points;
  const int blocks = tiles < resident ? tiles : resident;
  kernel<<<blocks, threads, shared, stream>>>(n_ao, n_points, first_moving, points, mp, kp, lda,
                                             xyz, origin, ao_moves, lmn, prim_start, exps, coefs,
                                             P, density, gradient, d_density, d_gradient, tau,
                                             d_tau);
  return cudaGetLastError();
}

}  // namespace

// K8c: points (3, n_points), the points from first_moving on moving with
// atom 1; origin (n_ao, 3) and ao_moves (n_ao, 1 for an AO on atom 1) of the
// Cartesian AOs, lmn, prim_start, exps and coefs as for tuna_ao_on_grid;
// P (n_ao, n_ao) symmetric.  density and d_density (n_points,); gradient
// and d_gradient (3, n_points), written only when with_gradients is
// non-zero (they may be null otherwise).  points (8, 16 or 32 / S: the
// tile) and whole_p (P staged whole, else 16 rows at a time) come from the
// host (dft/grid.py::density_deriv_layout); the shared memory follows from
// them, n_ao and with_gradients, and a layout past what the card holds
// fails with the CUDA error of that request.
extern "C" int tuna_density_deriv_on_grid(int n_ao, int n_points, int first_moving,
                                          int with_gradients, int points, int whole_p,
                                          const double* xyz, const double* origin,
                                          const int* ao_moves, const int* lmn,
                                          const int* prim_start, const double* exps,
                                          const double* coefs, const double* P, double* density,
                                          double* gradient, double* d_density, double* d_gradient,
                                          cudaStream_t stream) {
  auto launch = with_gradients ? launch_moving_grid<1, kDerivGradients>
                               : launch_moving_grid<1, kDerivRho>;
  return launch(n_ao, n_points, first_moving, points, whole_p, xyz, origin, ao_moves, lmn,
                prim_start, exps, coefs, P, density, gradient, d_density, d_gradient, nullptr,
                nullptr, stream);
}

// K8cu: as tuna_density_deriv_on_grid over the two spins' symmetric
// densities P (2, n_ao, n_ao) in one pass; density and d_density (2,
// n_points), gradient and d_gradient (2, 3, n_points).
extern "C" int tuna_density_deriv_on_grid_spin(int n_ao, int n_points, int first_moving,
                                               int with_gradients, int points, int whole_p,
                                               const double* xyz, const double* origin,
                                               const int* ao_moves, const int* lmn,
                                               const int* prim_start, const double* exps,
                                               const double* coefs, const double* P,
                                               double* density, double* gradient,
                                               double* d_density, double* d_gradient,
                                               cudaStream_t stream) {
  auto launch = with_gradients ? launch_moving_grid<2, kDerivGradients>
                               : launch_moving_grid<2, kDerivRho>;
  return launch(n_ao, n_points, first_moving, points, whole_p, xyz, origin, ao_moves, lmn,
                prim_start, exps, coefs, P, density, gradient, d_density, d_gradient, nullptr,
                nullptr, stream);
}

// K8ct: as tuna_density_deriv_on_grid (with_gradients non-zero, else the
// call returns cudaErrorInvalidValue: tau reads the AO gradients), plus tau
// and d_tau (n_points,).
extern "C" int tuna_density_tau_deriv_on_grid(int n_ao, int n_points, int first_moving,
                                              int with_gradients, int points, int whole_p,
                                              const double* xyz, const double* origin,
                                              const int* ao_moves, const int* lmn,
                                              const int* prim_start, const double* exps,
                                              const double* coefs, const double* P,
                                              double* density, double* gradient,
                                              double* d_density, double* d_gradient, double* tau,
                                              double* d_tau, cudaStream_t stream) {
  if (!with_gradients && n_points > 0) return cudaErrorInvalidValue;
  return launch_moving_grid<1, kDerivTau>(n_ao, n_points, first_moving, points, whole_p, xyz,
                                          origin, ao_moves, lmn, prim_start, exps, coefs, P,
                                          density, gradient, d_density, d_gradient, tau, d_tau,
                                          stream);
}

// K8cut: K8ct over the two spins' P (2, n_ao, n_ao) in one pass; tau and
// d_tau (2, n_points), the other outputs as for K8cu.
extern "C" int tuna_density_tau_deriv_on_grid_spin(int n_ao, int n_points, int first_moving,
                                                   int with_gradients, int points, int whole_p,
                                                   const double* xyz, const double* origin,
                                                   const int* ao_moves, const int* lmn,
                                                   const int* prim_start, const double* exps,
                                                   const double* coefs, const double* P,
                                                   double* density, double* gradient,
                                                   double* d_density, double* d_gradient,
                                                   double* tau, double* d_tau,
                                                   cudaStream_t stream) {
  if (!with_gradients && n_points > 0) return cudaErrorInvalidValue;
  return launch_moving_grid<2, kDerivTau>(n_ao, n_points, first_moving, points, whole_p, xyz,
                                          origin, ao_moves, lmn, prim_start, exps, coefs, P,
                                          density, gradient, d_density, d_gradient, tau, d_tau,
                                          stream);
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

// K7b: density (n_points,); gradient (3, n_points), written only when
// with_gradients is non-zero (grads and gradient may be null otherwise).
// P (n_ao, n_ao), phi (n_ao, n_points), grads (3, n_ao, n_points).  points
// (8, 16 or 32: the tile, 8 a warp), whole_p (P^T staged whole, else 16
// rows at a time) and buffers (1 or 2 sets of the tile's columns) come from
// the host (dft/grid.py::density_layout); the shared memory follows from
// them, n_ao and with_gradients, and a layout past what the card holds
// fails with the CUDA error of that request.
extern "C" int tuna_density_on_grid(int n_ao, int n_points, int with_gradients, int points,
                                    int whole_p, int buffers, const double* P, const double* phi,
                                    const double* grads, double* density, double* gradient,
                                    cudaStream_t stream) {
  auto launch = with_gradients ? launch_density<kDensityGradients> : launch_density<kDensityRho>;
  return launch(n_ao, n_points, points, whole_p, buffers, P, phi, grads, density, gradient,
                nullptr, stream);
}

// K7bt: as tuna_density_on_grid with the gradients, plus tau (n_points,).
extern "C" int tuna_density_tau_on_grid(int n_ao, int n_points, int points, int whole_p,
                                        int buffers, const double* P, const double* phi,
                                        const double* grads, double* density, double* gradient,
                                        double* tau, cudaStream_t stream) {
  return launch_density<kDensityTau>(n_ao, n_points, points, whole_p, buffers, P, phi, grads,
                                     density, gradient, tau, stream);
}

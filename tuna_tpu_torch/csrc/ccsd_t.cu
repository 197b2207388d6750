// K2: restricted (T) / [T] triples energy, spin-adapted Lee formulation.
//
// Replaces tuna_tpu/post/cc.py::_restricted_T_tensors and the contraction
// in restricted_CCSD_T (cc.py:1775):
//   raw[ijkabc] = sum_f <ib|af> t2[kjcf] - sum_m <ij|am> t2[mkbc]
//   W  = raw summed over the six simultaneous (ia)(jb)(kc) permutations
//   V  = s (<jk|bc> t1[ia] + <ik|ac> t1[jb] + <ij|ab> t1[kc]),  s = 1 (CC), 2 (QCISD)
//   Ww = 4 W[ijk] + W[jki] + W[kij] - 4 W[kji] - W[ikj] - W[jik]
//   E  = 1/3 sum (W + V) Ww / (e_i + e_j + e_k - e_a - e_b - e_c)
//
// What bounds it on an H100: float64 arithmetic.  At N2/6-311G (o = 7,
// v = 19) W takes o^3 v^3 x 6 (v + o) = 3.7e8 multiply-adds, reading
// t2 and <ov|vv> (~0.5 MB together) from L2; the JAX version instead
// materialises V, W, W_weighted and the denominator, four o^3 v^3 tensors
// of 19 MB each, and streams them through device memory.
//
// Design: one block per virtual triple (a, b, c), threads over the occupied
// triples (i, j, k).  Each thread forms W[ijk, abc] from the six raw terms
// and stores it in an o^3 slice in shared memory (343 doubles at o = 7);
// after a barrier each thread reads the five permuted entries it needs for
// W_weighted, forms V inline and takes the denominator from eps_o and eps_v,
// so no o^3 v^3 tensor is ever built.  A fixed-order tree reduction leaves
// one partial per block in a (v^3,) buffer that the wrapper sums: the
// result is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// raw[i,j,k,a,b,c] for one index assignment.
__device__ __forceinline__ double raw_term(int no, int nv, int i, int j, int k, int a, int b, int c,
                                           const double* __restrict__ g_ovvv,
                                           const double* __restrict__ g_oovo,
                                           const double* __restrict__ t2) {
  // sum_f g_ovvv[i,b,a,f] t2[k,j,c,f]
  const double* g1 = g_ovvv + ((static_cast<size_t>(i) * nv + b) * nv + a) * nv;
  const double* t2a = t2 + ((static_cast<size_t>(k) * no + j) * nv + c) * nv;
  double sum = 0.0;
  for (int f = 0; f < nv; ++f) sum += g1[f] * t2a[f];
  // - sum_m g_oovo[i,j,a,m] t2[m,k,b,c]
  const double* g2 = g_oovo + ((static_cast<size_t>(i) * no + j) * nv + a) * no;
  const size_t stride_m = static_cast<size_t>(no) * nv * nv;
  const double* t2b = t2 + (static_cast<size_t>(k) * nv + b) * nv + c;
  for (int m = 0; m < no; ++m) sum -= g2[m] * t2b[m * stride_m];
  return sum;
}

__global__ void __launch_bounds__(kThreads)
ccsd_t_kernel(int no, int nv, const double* __restrict__ g_oovv,
              const double* __restrict__ g_ovvv, const double* __restrict__ g_oovo,
              const double* __restrict__ t1, const double* __restrict__ t2,
              const double* __restrict__ eps_o, const double* __restrict__ eps_v, double v_scale,
              double* __restrict__ partial) {
  extern __shared__ double smem[];
  const int o3 = no * no * no;
  double* W = smem;              // (o, o, o) slice of W for this (a, b, c)
  double* reduce = smem + o3;    // kThreads partial sums

  const int abc = blockIdx.x;
  const int a = abc / (nv * nv), b = (abc / nv) % nv, c = abc % nv;

  for (int ijk = threadIdx.x; ijk < o3; ijk += blockDim.x) {
    const int i = ijk / (no * no), j = (ijk / no) % no, k = ijk % no;
    W[ijk] = raw_term(no, nv, i, j, k, a, b, c, g_ovvv, g_oovo, t2) +
             raw_term(no, nv, j, i, k, b, a, c, g_ovvv, g_oovo, t2) +
             raw_term(no, nv, k, j, i, c, b, a, g_ovvv, g_oovo, t2) +
             raw_term(no, nv, i, k, j, a, c, b, g_ovvv, g_oovo, t2) +
             raw_term(no, nv, j, k, i, b, c, a, g_ovvv, g_oovo, t2) +
             raw_term(no, nv, k, i, j, c, a, b, g_ovvv, g_oovo, t2);
  }
  __syncthreads();

  const double eps_abc = eps_v[a] + eps_v[b] + eps_v[c];
  const size_t vv = static_cast<size_t>(nv) * nv;
  double acc = 0.0;
  for (int ijk = threadIdx.x; ijk < o3; ijk += blockDim.x) {
    const int i = ijk / (no * no), j = (ijk / no) % no, k = ijk % no;
    auto at = [no](int x, int y, int z) { return (x * no + y) * no + z; };
    const double w = W[ijk];
    const double w_weighted = 4.0 * w + W[at(j, k, i)] + W[at(k, i, j)] - 4.0 * W[at(k, j, i)] -
                              W[at(i, k, j)] - W[at(j, i, k)];
    // g_oovv[x, y, d, e] at ((x * no + y) * nv + d) * nv + e
    const double v = v_scale *
                     (g_oovv[(static_cast<size_t>(j) * no + k) * vv + b * nv + c] * t1[i * nv + a] +
                      g_oovv[(static_cast<size_t>(i) * no + k) * vv + a * nv + c] * t1[j * nv + b] +
                      g_oovv[(static_cast<size_t>(i) * no + j) * vv + a * nv + b] * t1[k * nv + c]);
    const double denominator = 1.0 / (eps_o[i] + eps_o[j] + eps_o[k] - eps_abc);
    acc += (w + v) * w_weighted * denominator;
  }
  reduce[threadIdx.x] = acc;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) reduce[threadIdx.x] += reduce[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[abc] = reduce[0];
}

}  // namespace

// Shared memory per block: o^3 + kThreads doubles (4.8 KB at o = 7).
extern "C" int tuna_ccsd_t_energy(int no, int nv, const double* g_oovv, const double* g_ovvv,
                                  const double* g_oovo, const double* t1, const double* t2,
                                  const double* eps_o, const double* eps_v, double v_scale,
                                  double* partial, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(nv) * nv * nv;
  if (blocks == 0) return cudaSuccess;
  const size_t smem = (static_cast<size_t>(no) * no * no + kThreads) * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(ccsd_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ccsd_t_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      no, nv, g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale, partial);
  return cudaGetLastError();
}

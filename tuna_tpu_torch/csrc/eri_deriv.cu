// K8b: the R-tangent of the two-electron energy at a fixed density,
//   dE_2/dR = sum over AO quartets of d(ij|kl)/dR x
//             [1/2 P_ij P_kl - hfx/4 P_ik P_jl],
// when atom 1 moves along +z, as one float64 scalar.  No derivative
// integral is stored and neither J' nor K' is formed.
//
// Replaces the forward-mode part of tuna_tpu/drivers/gradients.py:286
// (jax.grad of total_energy) that differentiates IntegralPlan.eri
// (gradients.py:248, the K1 sweep, tuna_tpu/ops/integrals.py:470) and
// contracts it with P (gradients.py:267-271, restricted).
//
// What bounds it on an H100: as K1 (eri.cu), latency and load balance,
// not bytes or FLOPs: the work list of N2/cc-pVTZ holds 808,279
// parity-matched AO-pair quartets, ~5.8M primitive quartets of a few dozen
// to a few hundred float64 operations each, one order above K1's; P (39 KB)
// and the pair rows stay in L1/L2.
//
// Design, on the quartet engine's work list (quartet.cuh):
//   * the work list is K1's: a z derivative leaves the x and y Hermite
//     rows, and so their parities, as they are, so a quartet whose x or y
//     parities differ stays an exact zero;
//   * deriv_rows_kernel builds per primitive pair the rows E_x, E_y, E_z
//     and the z tangent dE_z = cA (2a E^{i+1,j} - i E^{i-1,j})
//     + cB (2b E^{i,j+1} - j E^{i,j-1}) (cA, cB = 1 on atom 1), one order
//     longer;
//   * a derivative quartet is [d bra | ket] + [bra | d ket]: both share
//     alpha, P - Q and the x/y pairing, so one Hermite Coulomb table of
//     order L_bra + L_ket + 1 takes the sum of the two z products, with
//     Boys of that order;
//   * quartets whose four functions sit on one atom are skipped (their
//     tangent vanishes by translation invariance);
//   * each quartet's value is weighted by its degeneracy and P at once;
//     light quartets one thread each, heavy ones one warp each (lanes over
//     the primitive quartets, rows read through L1, a fixed-order shuffle
//     reduction), one kernel a class part on the side streams;
//   * each block writes one partial sum (a fixed-order tree), and one block
//     sums the partials in a fixed order: two calls give the same bits.
#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

constexpr int kReduceThreads = 256;

// One primitive pair's derivative row cut to T Hermite orders an axis (the
// tangent to T + 1), from a row of tl orders: E_x, E_y, E_z (tl each), dE_z
// (tl + 1), p, P_z, coefficient.
template <int T>
struct DerivRow {
  double ex[T], ey[T], ez[T], dz[T + 1], p, Pz, coef;

  __device__ __forceinline__ void load(const double* __restrict__ R, int tl) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ex[t] = R[t];
      ey[t] = R[tl + t];
      ez[t] = R[2 * tl + t];
    }
#pragma unroll
    for (int t = 0; t <= T; ++t) dz[t] = R[3 * tl + t];
    p = R[4 * tl + 1];
    Pz = R[4 * tl + 2];
    coef = R[4 * tl + 3];
  }
};

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
deriv_rows_kernel(int n_prim_pairs, const double* __restrict__ coords,
                  const double* __restrict__ a, const double* __restrict__ b,
                  const double* __restrict__ coef, const int* __restrict__ l1,
                  const int* __restrict__ l2, const int* __restrict__ atom1,
                  const int* __restrict__ atom2, double* __restrict__ rows) {
  constexpr int TL = 2 * LMAX + 1, RS = 4 * TL + 4;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_prim_pairs) return;
  const double* A = coords + 3 * atom1[k];
  const double* B = coords + 3 * atom2[k];
  const double ak = a[k], bk = b[k];
  double* out = rows + static_cast<size_t>(k) * RS;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    double e[TL];
    tuna::hermite_row(l1[3 * k + axis], l2[3 * k + axis], ak, bk, A[axis] - B[axis], e);
#pragma unroll
    for (int t = 0; t < TL; ++t) out[axis * TL + t] = e[t];
  }
  const int i = l1[3 * k + 2], j = l2[3 * k + 2];
  const double ABz = A[2] - B[2];
  double dz[TL + 1];
#pragma unroll
  for (int t = 0; t <= TL; ++t) dz[t] = 0.0;
  const int di[4] = {1, -1, 0, 0}, dj[4] = {0, 0, 1, -1};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const bool moves = n < 2 ? atom1[k] == 1 : atom2[k] == 1;
    if (!moves || i + di[n] < 0 || j + dj[n] < 0) continue;
    const double w = n == 0 ? 2.0 * ak : n == 1 ? -i : n == 2 ? 2.0 * bk : -j;
    double e[TL + 1];
    tuna::hermite_row(i + di[n], j + dj[n], ak, bk, ABz, e);
#pragma unroll
    for (int t = 0; t <= TL; ++t) dz[t] += w * e[t];
  }
#pragma unroll
  for (int t = 0; t <= TL; ++t) out[3 * TL + t] = dz[t];
  const double p = ak + bk;
  out[4 * TL + 1] = p;
  out[4 * TL + 2] = (ak * A[2] + bk * B[2]) / p;
  out[4 * TL + 3] = coef[k];
}

// The R-tangent of one primitive quartet of class (LA, LB): Boys from the
// Taylor table `tab` of order LA + LB + 1 (shared memory).
template <int LA, int LB>
__device__ __forceinline__ double primitive_deriv(const DerivRow<LA + 1>& A,
                                                  const DerivRow<LB + 1>& C,
                                                  const double* __restrict__ tab) {
  using S = ClassShape<LA, LB>;
  constexpr int NM = S::NM + 1;
  double gz[NM + 1], axy[S::NXY + 1];
  xy_pairing<LA, LB>(A, C, axy);
#pragma unroll
  for (int n = 0; n <= NM; ++n) gz[n] = 0.0;
  // [d bra | ket] + [bra | d ket]; both tangents at their top order meet
  // only each other's zero, so t + u stays <= NM
#pragma unroll
  for (int t = 0; t <= S::TA; ++t) {
#pragma unroll
    for (int u = 0; u <= S::TB; ++u) {
      if (t + u <= NM) {
        const double sign = (u & 1) ? -1.0 : 1.0;
        const double ez_a = t < S::TA ? A.ez[t] : 0.0;
        const double ez_c = u < S::TB ? C.ez[u] : 0.0;
        gz[t + u] += sign * (A.dz[t] * ez_c + ez_a * C.dz[u]);
      }
    }
  }
  return quartet_value<NM, S::NXY>(A.p, C.p, A.Pz, C.Pz, A.coef * C.coef, gz, axy, tab);
}

// One part of the work list with its derivative rows and its place in the
// block partials.
struct DerivPart {
  const int2* quartets;
  int count;
  const int* pair_start;
  const int* atom1;       // atom of each primitive pair's first function
  const int* atom2;
  const double* rows;     // derivative rows, tl Hermite orders an axis
  int tl;
  const double* boys;     // Taylor table of the class's Boys order
  double* partials;       // this part's first block partial
};

// The energy weight of an unordered AO-pair quartet (A, B): its
// degeneracy times 1/2 P_ij P_kl - hfx/8 (P_ik P_jl + P_il P_jk).
struct EnergyWeight {
  const int* pid_i;
  const int* pid_j;
  const double* P;
  int n;
  double hfx;

  __device__ __forceinline__ double operator()(int A, int B) const {
    const int i = pid_i[A], j = pid_j[A], k = pid_i[B], l = pid_j[B];
    const double degeneracy = (i != j ? 2.0 : 1.0) * (k != l ? 2.0 : 1.0) * (A != B ? 2.0 : 1.0);
    const double coulomb = 0.5 * P[i * n + j] * P[k * n + l];
    const double exchange = 0.125 * hfx * (P[i * n + k] * P[j * n + l] + P[i * n + l] * P[j * n + k]);
    return degeneracy * (coulomb - exchange);
  }
};

// True when the four functions of the quartet (bra, ket) sit on one atom.
__device__ __forceinline__ bool one_atom(const DerivPart& part, int2 q) {
  const int r = part.pair_start[q.x], c = part.pair_start[q.y];
  const int atom = part.atom1[r];
  return part.atom2[r] == atom && part.atom1[c] == atom && part.atom2[c] == atom;
}

// Fixed-order tree over the block's values; thread 0 writes the partial.
__device__ __forceinline__ void block_partial(double* __restrict__ red, double* __restrict__ out) {
  __syncthreads();
#pragma unroll
  for (int s = kQuartetThreads / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

template <int LA, int LB>
__global__ void __launch_bounds__(kQuartetThreads)
deriv_light_kernel(DerivPart part, EnergyWeight weight) {
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  __shared__ double red[kQuartetThreads];
  tuna::load_boys_table(tab, part.boys);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double value = 0.0;
  if (idx < part.count) {
    const int2 q = part.quartets[idx];
    if (!one_atom(part, q)) {
      const int rs = 4 * part.tl + 4;
      const int r1 = part.pair_start[q.x + 1];
      const int c0 = part.pair_start[q.y], c1 = part.pair_start[q.y + 1];
      double sum = 0.0;
      for (int r = part.pair_start[q.x]; r < r1; ++r) {
        DerivRow<LA + 1> bra;
        bra.load(part.rows + static_cast<size_t>(r) * rs, part.tl);
        for (int c = c0; c < c1; ++c) {
          DerivRow<LB + 1> ket;
          ket.load(part.rows + static_cast<size_t>(c) * rs, part.tl);
          sum += primitive_deriv<LA, LB>(bra, ket, tab);
        }
      }
      value = sum * weight(q.x, q.y);
    }
  }
  red[threadIdx.x] = value;
  block_partial(red, part.partials + blockIdx.x);
}

template <int LA, int LB>
__global__ void __launch_bounds__(kQuartetThreads)
deriv_heavy_kernel(DerivPart part, EnergyWeight weight) {
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  __shared__ double red[kQuartetThreads];
  tuna::load_boys_table(tab, part.boys);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int idx = blockIdx.x * kHeavyWarps + warp;
  double sum = 0.0;
  const bool in_range = idx < part.count;  // the block's other warps still join its tree
  const int2 q = in_range ? part.quartets[idx] : make_int2(0, 0);
  const bool live = in_range && !one_atom(part, q);
  if (live) {
    const int rs = 4 * part.tl + 4;
    const int r0 = part.pair_start[q.x], nr = part.pair_start[q.x + 1] - r0;
    const int c0 = part.pair_start[q.y], nc = part.pair_start[q.y + 1] - c0;
    for (int k = lane; k < nr * nc; k += 32) {
      const int r = k / nc, c = k - r * nc;
      DerivRow<LA + 1> bra;
      bra.load(part.rows + static_cast<size_t>(r0 + r) * rs, part.tl);
      DerivRow<LB + 1> ket;
      ket.load(part.rows + static_cast<size_t>(c0 + c) * rs, part.tl);
      sum += primitive_deriv<LA, LB>(bra, ket, tab);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset);
  }
  red[threadIdx.x] = (lane == 0 && live) ? sum * weight(q.x, q.y) : 0.0;
  block_partial(red, part.partials + blockIdx.x);
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(int n, const double* __restrict__ partials, double* __restrict__ out) {
  __shared__ double red[kReduceThreads];
  double sum = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) sum += partials[i];
  red[threadIdx.x] = sum;
  __syncthreads();
#pragma unroll
  for (int s = kReduceThreads / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

int light_blocks(const ClassPart& cls) {
  return (cls.split - cls.begin + kQuartetThreads - 1) / kQuartetThreads;
}

int heavy_blocks(const ClassPart& cls) {
  return (cls.end - cls.split + kHeavyWarps - 1) / kHeavyWarps;
}

template <int LA, int LB>
cudaError_t launch_deriv_class(const ClassPart& cls, DerivPart part, const EnergyWeight& weight,
                               cudaStream_t light, cudaStream_t heavy) {
  const int2* quartets = part.quartets;
  part.boys += static_cast<size_t>(LA + LB + 1) * TUNA_BOYS_TABLE_SIZE;
  if (cls.split > cls.begin) {
    part.quartets = quartets + cls.begin;
    part.count = cls.split - cls.begin;
    deriv_light_kernel<LA, LB><<<light_blocks(cls), kQuartetThreads, 0, light>>>(part, weight);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    part.partials += light_blocks(cls);
  }
  if (cls.end > cls.split) {
    part.quartets = quartets + cls.split;
    part.count = cls.end - cls.split;
    deriv_heavy_kernel<LA, LB><<<heavy_blocks(cls), kQuartetThreads, 0, heavy>>>(part, weight);
  }
  return cudaGetLastError();
}

cudaError_t launch_deriv_class_part(const ClassPart& cls, const DerivPart& part,
                                    const EnergyWeight& weight, cudaStream_t light,
                                    cudaStream_t heavy) {
  switch (cls.la * 16 + cls.lb) {
#define TUNA_DERIV_CLASS_CASE(A, B) \
  case A * 16 + B:                  \
    return launch_deriv_class<A, B>(cls, part, weight, light, heavy);
    TUNA_QUARTET_CLASSES(TUNA_DERIV_CLASS_CASE)
#undef TUNA_DERIV_CLASS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_deriv_rows(int lmax, int n_prim_pairs, const double* coords, const double* a,
                              const double* b, const double* coef, const int* l1, const int* l2,
                              const int* atom1, const int* atom2, double* rows,
                              cudaStream_t stream) {
  if (n_prim_pairs <= 0) return cudaSuccess;
  const int blocks = (n_prim_pairs + kQuartetThreads - 1) / kQuartetThreads;
  switch (lmax) {
#define TUNA_DERIV_ROWS(L)                                                                   \
  case L:                                                                                    \
    deriv_rows_kernel<L><<<blocks, kQuartetThreads, 0, stream>>>(n_prim_pairs, coords, a, b, \
                                                                 coef, l1, l2, atom1, atom2, \
                                                                 rows);                      \
    break;
    TUNA_DERIV_ROWS(0)
    TUNA_DERIV_ROWS(1)
    TUNA_DERIV_ROWS(2)
    TUNA_DERIV_ROWS(3)
#undef TUNA_DERIV_ROWS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// quartets, classes and boys_tables (orders 0..4 lmax + 1) as for
// tuna_eri_packed (eri.cu); P the symmetric Cartesian density; rows
// (n_prim_pairs x (4 (2 lmax + 1) + 4)) and partials (n_partials, at least
// one) scratch; out one double.  n_partials must equal the blocks of all
// class parts (ops/integrals.py::IntegralPlan.deriv_partial_count).
extern "C" int tuna_eri_deriv_energy(int lmax, int n_prim_pairs, int n_basis,
                                     const double* coords, const double* a, const double* b,
                                     const double* coef, const int* l1, const int* l2,
                                     const int* atom1, const int* atom2, const int* pair_start,
                                     const int* pid_i, const int* pid_j, const int* quartets,
                                     int n_classes, const int* classes, const double* boys_tables,
                                     const double* P, double hfx, double* rows, int n_partials,
                                     double* partials, double* out, cudaStream_t stream) {
  const ClassPart* parts = reinterpret_cast<const ClassPart*>(classes);
  int expected = 0;
  for (int i = 0; i < n_classes; ++i) expected += light_blocks(parts[i]) + heavy_blocks(parts[i]);
  if (expected != n_partials) return cudaErrorInvalidValue;
  cudaError_t err = launch_deriv_rows(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1,
                                      atom2, rows, stream);
  if (err != cudaSuccess) return err;

  SideStreams* side = nullptr;
  err = fork_side_streams(stream, &side);
  if (side == nullptr) return err;
  DerivPart part{reinterpret_cast<const int2*>(quartets), 0, pair_start, atom1, atom2, rows,
                 2 * lmax + 1, boys_tables, partials};
  const EnergyWeight weight{pid_i, pid_j, P, n_basis, hfx};
  for (int i = 0; i < n_classes && err == cudaSuccess; ++i) {
    err = launch_deriv_class_part(parts[i], part, weight, side->stream[(2 * i) % kSideStreams],
                                  side->stream[(2 * i + 1) % kSideStreams]);
    part.partials += light_blocks(parts[i]) + heavy_blocks(parts[i]);
  }
  err = join_side_streams(side, stream, err);
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<1, kReduceThreads, 0, stream>>>(n_partials, partials, out);
  return cudaGetLastError();
}

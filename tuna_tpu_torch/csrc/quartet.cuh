// The quartet engine shared by the packed ERI sweep (K1, eri.cu) and the
// direct Fock build (K4, fock_direct.cu), so the two kernels cannot drift;
// the R-tangent of the two-electron energy (K8b, eri_deriv.cu) walks the
// same work list with the same x/y pairing, Coulomb table and side streams.
//
// Work list.  IntegralPlan.work_list (ops/integrals.py) builds, once per
// basis, the unordered AO-pair quartets whose x and y Hermite parities match
// (the others vanish for molecules on the z axis, the rule of
// tuna_tpu/ops/integrals.py:226-239).  Each is stored as (bra, ket) with the
// bra the pair of the larger total angular momentum L = |l1| + |l2|, and
// grouped by class (L_bra, L_ket).  A class splits at a threshold on the
// count of primitive quartets into a light part (one thread a quartet) and
// a heavy part (one warp a quartet), each sorted by count, largest first,
// so that the lanes of a warp do equal work and the longest start first.
// The host passes one ClassPart row per non-empty class.
//
// Kernels.  pair_rows_kernel builds the per-primitive-pair rows once (the
// Hermite rows E_t of x, y and z with 2 lmax + 1 orders an axis, p, P_z and
// the contraction coefficient).  The class kernels are templated on
// (L_bra, L_ket): every Hermite loop runs to L + 1 orders of its pair, the
// Boys order is L_bra + L_ket, and the x/y pairing and the Hermite Coulomb
// table follow.  The terms that a molecule-wide LMAX would add are exact
// zeros (E_t = 0 for t > l1 + l2 on an axis).  The Boys Taylor table of the
// class's own order sits in shared memory.  A heavy quartet's warp stages
// its bra and ket rows in shared memory, its lanes stride over the
// flattened primitive-quartet index, and the partial sums meet in a
// fixed-order shuffle reduction, so K1 is deterministic.
//
// Launches.  One kernel a non-empty part of a class, in the host's order
// (the longest serial chain first), spread round-robin over side streams
// forked from the caller's stream and joined back into it: small classes
// run beside large ones instead of leaving the card idle at the tail of
// each.
//
// No tensor-core path applies at this grain: a quartet's Hermite
// contraction is at most 7 x 7 an axis and differs from lane to lane.
// Sharing the Boys values and R^n_00v of a primitive quartet across the
// Cartesian components of a shell pair would turn it into small matrix
// products for the float64 tensor cores (ROADMAP, queue 2).
//
// Everything here has internal linkage: each translation unit that includes
// the header gets its own copy of the kernels and of the side streams.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

#include "boys.cuh"
#include "hermite.cuh"

namespace {

constexpr double kTwoPiPow2_5 = 34.986836655249725;  // 2 pi^(5/2)
constexpr int kQuartetThreads = 128;
// heavy quartets a block; ops/integrals.py::heavy_shared_bytes counts their
// shared memory, and the host refuses a work list whose rows do not fit
constexpr int kHeavyWarps = kQuartetThreads / 32;
constexpr int kSideStreams = 8;
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// Pair rows
// ---------------------------------------------------------------------------

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
pair_rows_kernel(int n_prim_pairs, const double* __restrict__ coords,
                 const double* __restrict__ a, const double* __restrict__ b,
                 const double* __restrict__ coef, const int* __restrict__ l1,
                 const int* __restrict__ l2, const int* __restrict__ atom1,
                 const int* __restrict__ atom2, double* __restrict__ rows) {
  constexpr int TL = 2 * LMAX + 1, RS = 3 * TL + 3;
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
  const double p = ak + bk;
  out[3 * TL] = p;
  out[3 * TL + 1] = (ak * A[2] + bk * B[2]) / p;
  out[3 * TL + 2] = coef[k];
}

// Launches pair_rows_kernel over every primitive pair: rows of 3 (2 lmax + 1)
// + 3 doubles.
cudaError_t launch_pair_rows(int lmax, int n_prim_pairs, const double* coords, const double* a,
                             const double* b, const double* coef, const int* l1, const int* l2,
                             const int* atom1, const int* atom2, double* rows,
                             cudaStream_t stream) {
  if (n_prim_pairs <= 0) return cudaSuccess;
  const int blocks = (n_prim_pairs + kQuartetThreads - 1) / kQuartetThreads;
  switch (lmax) {
#define TUNA_PAIR_ROWS(L)                                                                   \
  case L:                                                                                   \
    pair_rows_kernel<L><<<blocks, kQuartetThreads, 0, stream>>>(n_prim_pairs, coords, a, b, \
                                                                coef, l1, l2, atom1, atom2, \
                                                                rows);                      \
    break;
    TUNA_PAIR_ROWS(0)
    TUNA_PAIR_ROWS(1)
    TUNA_PAIR_ROWS(2)
    TUNA_PAIR_ROWS(3)
#undef TUNA_PAIR_ROWS
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One primitive quartet of class (LA, LB)
// ---------------------------------------------------------------------------

template <int LA, int LB>
struct ClassShape {
  static constexpr int TA = LA + 1, TB = LB + 1;  // Hermite orders of bra and ket an axis
  static constexpr int NM = LA + LB;             // Boys order and highest z order
  static constexpr int NXY = NM / 2;             // highest m_x + m_y of the x/y pairing
  // A staged row (E_x, E_y, E_z, p, P_z, coef) has an odd stride, so that
  // the float64 reads of a half-warp from 16 rows fall in distinct banks.
  static constexpr int RA = (3 * TA + 3) | 1, RB = (3 * TB + 3) | 1;
};

// One primitive pair's row cut to T Hermite orders an axis, in registers.
template <int T>
struct PairRow {
  double ex[T], ey[T], ez[T], p, Pz, coef;

  // From a row with `tl` orders an axis: a pair row (tl = 2 lmax + 1) or a
  // staged row (tl = T).
  __device__ __forceinline__ void load(const double* __restrict__ R, int tl) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ex[t] = R[t];
      ey[t] = R[tl + t];
      ez[t] = R[2 * tl + t];
    }
    p = R[3 * tl];
    Pz = R[3 * tl + 1];
    coef = R[3 * tl + 2];
  }
};

// The x/y pairing of one primitive quartet of class (LA, LB), from rows
// with TA and TB orders of E_x and E_y: even total orders 2m only
// (matching parities), with the ket's (-1)^u sign and the (2m - 1)!!
// weight of R_{TUV} on an axis of zero separation.  Shared by the forward
// quartet (primitive_quartet) and K8b's derivative quartet (eri_deriv.cu).
template <int LA, int LB, class RowA, class RowC>
__device__ __forceinline__ void xy_pairing(const RowA& A, const RowC& C,
                                           double (&axy)[ClassShape<LA, LB>::NXY + 1]) {
  using S = ClassShape<LA, LB>;
  double gx[S::NXY + 1], gy[S::NXY + 1];
#pragma unroll
  for (int m = 0; m <= S::NXY; ++m) gx[m] = gy[m] = axy[m] = 0.0;
#pragma unroll
  for (int t = 0; t < S::TA; ++t) {
#pragma unroll
    for (int u = 0; u < S::TB; ++u) {
      if (((t + u) & 1) == 0) {
        const double sign = (u & 1) ? -1.0 : 1.0;
        gx[(t + u) / 2] += A.ex[t] * sign * C.ex[u];
        gy[(t + u) / 2] += A.ey[t] * sign * C.ey[u];
      }
    }
  }
#pragma unroll
  for (int mx = 0; mx <= S::NXY; ++mx) {
#pragma unroll
    for (int my = 0; mx + my <= S::NXY; ++my) {
      axy[mx + my] += gx[mx] * tuna::odd_double_factorial(mx) * gy[my] *
                      tuna::odd_double_factorial(my);
    }
  }
}

// The contracted value of a primitive quartet from its z products gz (up
// to order NM) and x/y pairing axy: Boys of order NM from the Taylor table
// `tab` (shared memory), the z Hermite Coulomb table in registers.
template <int NM, int NXY>
__device__ __forceinline__ double quartet_value(double p, double q, double Pz, double Qz,
                                                double coef, const double (&gz)[NM + 1],
                                                const double (&axy)[NXY + 1],
                                                const double* __restrict__ tab) {
  const double psum = p + q;
  const double alpha = p * q / psum;
  const double PQz = Pz - Qz;
  double F[NM + 1];
  tuna::boys_eval<NM>(alpha * PQz * PQz, tab, F);
  const double value = tuna::hermite_coulomb<NM, NM, NXY, 2>(F, alpha, PQz, gz, axy);
  return coef * kTwoPiPow2_5 / (p * q * sqrt(psum)) * value;
}

// The value of one primitive quartet of class (LA, LB), Boys of order
// LA + LB.
template <int LA, int LB>
__device__ __forceinline__ double primitive_quartet(const PairRow<LA + 1>& A,
                                                    const PairRow<LB + 1>& C,
                                                    const double* __restrict__ tab) {
  using S = ClassShape<LA, LB>;
  double gz[S::NM + 1], axy[S::NXY + 1];
  xy_pairing<LA, LB>(A, C, axy);
#pragma unroll
  for (int n = 0; n <= S::NM; ++n) gz[n] = 0.0;
#pragma unroll
  for (int t = 0; t < S::TA; ++t) {
#pragma unroll
    for (int u = 0; u < S::TB; ++u) {
      const double sign = (u & 1) ? -1.0 : 1.0;
      gz[t + u] += A.ez[t] * sign * C.ez[u];
    }
  }
  return quartet_value<S::NM, S::NXY>(A.p, C.p, A.Pz, C.Pz, A.coef * C.coef, gz, axy, tab);
}

// ---------------------------------------------------------------------------
// The class kernels
// ---------------------------------------------------------------------------

// One part of the work list, as a kernel reads it.
struct QuartetPart {
  const int2* quartets;   // (bra, ket) AO pairs, L_bra >= L_ket
  int count;              // quartets in the part
  const int* pair_start;  // CSR offsets of each AO pair's primitive pairs
  const double* rows;     // pair rows, tl Hermite orders an axis
  int tl;
  const double* boys;     // Taylor table of the class's Boys order
};

// One thread a quartet: the bra row in registers, the ket rows read through
// L1.  out(value, bra, ket) takes the contracted value.
template <int LA, int LB, class Out>
__global__ void __launch_bounds__(kQuartetThreads)
quartet_light_kernel(QuartetPart part, Out out) {
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  tuna::load_boys_table(tab, part.boys);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= part.count) return;
  const int2 q = part.quartets[idx];
  const int rs = 3 * part.tl + 3;
  const int r1 = part.pair_start[q.x + 1];
  const int c0 = part.pair_start[q.y], c1 = part.pair_start[q.y + 1];
  double sum = 0.0;
  for (int r = part.pair_start[q.x]; r < r1; ++r) {
    PairRow<LA + 1> bra;
    bra.load(part.rows + static_cast<size_t>(r) * rs, part.tl);
    for (int c = c0; c < c1; ++c) {
      PairRow<LB + 1> ket;
      ket.load(part.rows + static_cast<size_t>(c) * rs, part.tl);
      sum += primitive_quartet<LA, LB>(bra, ket, tab);
    }
  }
  out(sum, q.x, q.y);
}

// Copies the n rows from `first` on, cut to T orders an axis, into `dst`
// with stride R; the lanes of a warp stride over the entries.
template <int T, int R>
__device__ __forceinline__ void stage_rows(double* __restrict__ dst,
                                           const double* __restrict__ rows, int first, int n,
                                           int tl, int lane) {
  constexpr int W = 3 * T + 3;
  const int rs = 3 * tl + 3;
  for (int k = lane; k < n * W; k += 32) {
    const int r = k / W, e = k - r * W;
    const int src = e < 3 * T ? (e / T) * tl + e % T : 3 * tl + (e - 3 * T);
    dst[r * R + e] = rows[static_cast<size_t>(first + r) * rs + src];
  }
}

// One warp a quartet: bra and ket rows staged in shared memory (at most
// max_bra and max_ket rows), the lanes over the flattened primitive-quartet
// index, a fixed-order shuffle reduction.
template <int LA, int LB, class Out>
__global__ void __launch_bounds__(kQuartetThreads)
quartet_heavy_kernel(QuartetPart part, int max_bra, int max_ket, Out out) {
  using S = ClassShape<LA, LB>;
  __shared__ double tab[TUNA_BOYS_TABLE_SIZE];
  extern __shared__ double stage[];
  tuna::load_boys_table(tab, part.boys);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int idx = blockIdx.x * kHeavyWarps + warp;
  if (idx >= part.count) return;  // the whole warp
  const int2 q = part.quartets[idx];
  const int r0 = part.pair_start[q.x], nr = part.pair_start[q.x + 1] - r0;
  const int c0 = part.pair_start[q.y], nc = part.pair_start[q.y + 1] - c0;
  double* bra = stage + warp * (max_bra * S::RA + max_ket * S::RB);
  double* ket = bra + max_bra * S::RA;
  stage_rows<S::TA, S::RA>(bra, part.rows, r0, nr, part.tl, lane);
  stage_rows<S::TB, S::RB>(ket, part.rows, c0, nc, part.tl, lane);
  __syncwarp();
  double sum = 0.0;
  for (int k = lane; k < nr * nc; k += 32) {
    const int r = k / nc, c = k - r * nc;
    PairRow<S::TA> A;
    A.load(bra + r * S::RA, S::TA);
    PairRow<S::TB> C;
    C.load(ket + c * S::RB, S::TB);
    sum += primitive_quartet<LA, LB>(A, C, tab);
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset);
  }
  if (lane == 0) out(sum, q.x, q.y);
}

// ---------------------------------------------------------------------------
// Launching a work list
// ---------------------------------------------------------------------------

// One row of the host's class table: the class (la, lb), its light part
// [begin, split) and heavy part [split, end) of the work list, and the most
// primitive pairs of a bra and of a ket in the heavy part.
struct ClassPart {
  int la, lb, begin, split, end, max_bra, max_ket;
};

template <int LA, int LB, class Out>
cudaError_t launch_class(const ClassPart& cls, QuartetPart part, Out out, cudaStream_t light,
                         cudaStream_t heavy) {
  using S = ClassShape<LA, LB>;
  const int2* quartets = part.quartets;
  part.boys += static_cast<size_t>(S::NM) * TUNA_BOYS_TABLE_SIZE;
  if (cls.split > cls.begin) {
    part.quartets = quartets + cls.begin;
    part.count = cls.split - cls.begin;
    quartet_light_kernel<LA, LB, Out>
        <<<(part.count + kQuartetThreads - 1) / kQuartetThreads, kQuartetThreads, 0, light>>>(
            part, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (cls.end > cls.split) {
    const size_t bytes = sizeof(double) * kHeavyWarps *
                         (static_cast<size_t>(cls.max_bra) * S::RA +
                          static_cast<size_t>(cls.max_ket) * S::RB);
    // refused when the rows exceed the card's shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(quartet_heavy_kernel<LA, LB, Out>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    part.quartets = quartets + cls.split;
    part.count = cls.end - cls.split;
    quartet_heavy_kernel<LA, LB, Out>
        <<<(part.count + kHeavyWarps - 1) / kHeavyWarps, kQuartetThreads, bytes, heavy>>>(
            part, cls.max_bra, cls.max_ket, out);
  }
  return cudaGetLastError();
}

// Every class with L_bra >= L_ket up to 2 KERNEL_MAX_LMAX = 6.
#define TUNA_QUARTET_CLASSES(X)                                                                \
  X(0, 0) X(1, 0) X(1, 1) X(2, 0) X(2, 1) X(2, 2) X(3, 0) X(3, 1) X(3, 2) X(3, 3) X(4, 0)       \
  X(4, 1) X(4, 2) X(4, 3) X(4, 4) X(5, 0) X(5, 1) X(5, 2) X(5, 3) X(5, 4) X(5, 5) X(6, 0)       \
  X(6, 1) X(6, 2) X(6, 3) X(6, 4) X(6, 5) X(6, 6)

template <class Out>
cudaError_t launch_class_part(const ClassPart& cls, const QuartetPart& part, const Out& out,
                              cudaStream_t light, cudaStream_t heavy) {
  switch (cls.la * 16 + cls.lb) {
#define TUNA_CLASS_CASE(A, B) \
  case A * 16 + B:            \
    return launch_class<A, B, Out>(cls, part, out, light, heavy);
    TUNA_QUARTET_CLASSES(TUNA_CLASS_CASE)
#undef TUNA_CLASS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

struct SideStreams {
  cudaStream_t stream[kSideStreams];
  cudaEvent_t fork, join[kSideStreams];
};

// The side streams of the current device, made at first use and kept for
// the life of the process.
cudaError_t side_streams(SideStreams** out) {
  static std::mutex lock;
  static SideStreams pools[kMaxDevices];
  static bool ready[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  SideStreams& side = pools[device];
  if (!ready[device]) {
    err = cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming);
    for (int s = 0; s < kSideStreams && err == cudaSuccess; ++s) {
      err = cudaStreamCreateWithFlags(&side.stream[s], cudaStreamNonBlocking);
      if (err == cudaSuccess) err = cudaEventCreateWithFlags(&side.join[s], cudaEventDisableTiming);
    }
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  *out = &side;
  return cudaSuccess;
}

// Makes the side streams wait for `stream`: work enqueued on `stream`
// before runs first.
cudaError_t fork_side_streams(cudaStream_t stream, SideStreams** side) {
  cudaError_t err = side_streams(side);
  if (err == cudaSuccess) err = cudaEventRecord((*side)->fork, stream);
  for (int s = 0; s < kSideStreams && err == cudaSuccess; ++s) {
    err = cudaStreamWaitEvent((*side)->stream[s], (*side)->fork, 0);
  }
  return err;
}

// Makes `stream` wait for the side streams, after an error of the launches
// (`err`) too, so `stream` never runs ahead of a launch; returns the first
// error.
cudaError_t join_side_streams(SideStreams* side, cudaStream_t stream, cudaError_t err) {
  for (int s = 0; s < kSideStreams; ++s) {
    const cudaError_t join = cudaEventRecord(side->join[s], side->stream[s]);
    const cudaError_t wait =
        join == cudaSuccess ? cudaStreamWaitEvent(stream, side->join[s], 0) : join;
    if (err == cudaSuccess) err = wait;
  }
  return err;
}

// Launches every class of the work list on the side streams, forked from
// and joined back into `stream`: work enqueued on `stream` before the call
// runs first, work enqueued after runs after.
template <class Out>
cudaError_t launch_work_list(int n_classes, const ClassPart* classes, const QuartetPart& part,
                             const Out& out, cudaStream_t stream) {
  SideStreams* side = nullptr;
  cudaError_t err = fork_side_streams(stream, &side);
  if (side == nullptr) return err;
  for (int i = 0; i < n_classes && err == cudaSuccess; ++i) {
    err = launch_class_part(classes[i], part, out, side->stream[(2 * i) % kSideStreams],
                            side->stream[(2 * i + 1) % kSideStreams]);
  }
  return join_side_streams(side, stream, err);
}

}  // namespace

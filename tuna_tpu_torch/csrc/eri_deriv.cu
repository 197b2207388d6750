// K8b: the R-tangent of the two-electron energy at a fixed density,
//   dE_2/dR = sum over AO quartets of d(ij|kl)/dR x
//             [1/2 P_ij P_kl - hfx/4 P_ik P_jl],
// when atom 1 moves along +z, as one float64 scalar.  No derivative
// integral is stored and neither J' nor K' is formed.  K8bu is the same
// sweep with the unrestricted weight, exchange per spin:
//   [1/2 Pt_ij Pt_kl - hfx/2 (Pa_ik Pa_jl + Pb_ik Pb_jl)],  Pt = Pa + Pb.
//
// Replaces the forward-mode part of tuna_tpu/drivers/gradients.py:286
// (jax.grad of total_energy) that differentiates IntegralPlan.eri
// (gradients.py:248, the K1 sweep, tuna_tpu/ops/integrals.py:470) and
// contracts it with P (gradients.py:267-271, restricted; :272-275, UHF and
// UKS, for K8bu).
//
// What bounds it on an H100: the float64 arithmetic and the loads of ~5M
// (AO quartet, primitive quartet) items at N2/cc-pVTZ, and the latency of
// their dependent chains; P (39 KB), the rows and the tables of the cut
// runs stay in L1/L2.
//
// Design.  The unit of work is the shell quartet (IntegralPlan.
// shell_quartets, built on the host once per basis): the AOs of one atom
// with one L and the same exponents form a shell, so every AO pair of a
// shell pair has the same primitive pairs' p and P_z, and every AO-pair
// quartet of a shell quartet (a component) the same primitive quartets'
// alpha, T, Boys values and Hermite Coulomb table.
//   * deriv_rows_kernel builds per primitive pair the rows E_x, E_y, E_z
//     and the z tangent dE_z = cA (2a E^{i+1,j} - i E^{i-1,j})
//     + cB (2b E^{i,j+1} - j E^{i,j-1}) (cA, cB = 1 on atom 1), one order
//     longer, with p, P_z and the coefficient, field-major (a field of
//     consecutive primitive pairs is contiguous);
//   * deriv_weights_kernel forms each component's weight once, its
//     degeneracy times the Coulomb and exchange products: the only pass
//     that reads the densities, and the only code in which K8bu differs
//     from K8b (the class kernels below are the same kernels for both);
//   * one block a task (IntegralPlan.deriv_schedule: a run of up to 128
//     primitive quartets of one shell quartet with its components): thread
//     g forms primitive quartet g's shared part -- alpha, T, Boys of order
//     L_bra + L_ket + 1 (a derivative quartet [d bra | ket] + [bra | d ket]
//     takes the sum of both z products in one table), the R^n_00v
//     recursion and the prefactor -- into the task's table in shared
//     memory; then the threads stride over the task's (component, primitive
//     quartet) items, each the own part on the CUDA cores in its separable
//     on-axis form (the x/y pairing of even orders, the two z products,
//     their contraction with the table), times the coefficients and the
//     component's weight;
//   * a run whose components take more than a task's budget of own part is
//     cut into several tasks; deriv_shared_kernel forms the shared parts of
//     such runs beforehand, a thread each (IntegralPlan.deriv_tables), and
//     each of their tasks copies them into shared memory.  So every
//     primitive quartet's shared part is formed once, for all of its shell
//     quartet's components;
//   * quartets whose four functions sit on one atom are not listed (their
//     tangent vanishes by translation invariance), and neither are those
//     whose x or y parities differ (exact zeros, as in K1's work list);
//   * one kernel a class (L_bra, L_ket) on the side streams; each warp's
//     lanes meet in a fixed-order shuffle, each block writes its task's
//     partial (its warps in order), and one block sums the partials in a
//     fixed order: no float atomics, two calls give the same bits.
#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

constexpr int kReduceThreads = 256;
constexpr int kWeightThreads = 256;
constexpr int kSharedThreads = 128;
// a task's threads (one block), and so the most primitive quartets of a
// task, one a thread; ops/integrals.py::SHELL_TASK_THREADS
constexpr int kTaskThreads = 128;
constexpr int kTaskWarps = kTaskThreads / 32;

// The Coulomb table of a derivative quartet with L_bra + L_ket = S: its
// Boys order NM (the highest z order), the highest m_x + m_y of the x/y
// pairing, and the entries R^n_00v that the own part reads, n <= NXY and
// v + 2n <= NM, stored v by v: width(v) entries from offset(v) on
// (ops/integrals.py::coulomb_entries counts them).
template <int S>
struct CoulombShape {
  static constexpr int NM = S + 1;
  static constexpr int NXY = S / 2;
  __host__ __device__ static constexpr int width(int v) {
    return ((NM - v) / 2 < NXY ? (NM - v) / 2 : NXY) + 1;
  }
  __host__ __device__ static constexpr int offset(int v) {
    int o = 0;
    for (int u = 0; u < v; ++u) o += width(u);
    return o;
  }
  static constexpr int NR = offset(NM + 1);
};

// The shape of a derivative quartet of class (LA, LB).
template <int LA, int LB>
struct DerivShape : CoulombShape<LA + LB> {
  static constexpr int TA = LA + 1, TB = LB + 1;
  using CoulombShape<LA + LB>::NR;
  // a block's shared memory for tasks of at most `prims` primitive
  // quartets: the table (NR x prims doubles), each warp's sum, and the bra
  // and ket primitive pair of each primitive quartet
  __host__ __device__ static constexpr int bytes(int prims) {
    return 8 * NR * prims + 8 * kTaskWarps + 2 * 4 * prims;
  }
};

// Field f of primitive pair k sits at rows[f * n + k]; a row has tl Hermite
// orders an axis: E_x, E_y, E_z (tl each), dE_z (tl + 1), p, P_z, coefficient.
__host__ __device__ constexpr int field_p(int tl) { return 4 * tl + 1; }
__host__ __device__ constexpr int field_pz(int tl) { return 4 * tl + 2; }
__host__ __device__ constexpr int field_coef(int tl) { return 4 * tl + 3; }

template <int LMAX>
__global__ void __launch_bounds__(kQuartetThreads)
deriv_rows_kernel(int n_prim_pairs, const double* __restrict__ coords,
                  const double* __restrict__ a, const double* __restrict__ b,
                  const double* __restrict__ coef, const int* __restrict__ l1,
                  const int* __restrict__ l2, const int* __restrict__ atom1,
                  const int* __restrict__ atom2, double* __restrict__ rows) {
  constexpr int TL = 2 * LMAX + 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_prim_pairs) return;
  const int n = n_prim_pairs;
  const double* A = coords + 3 * atom1[k];
  const double* B = coords + 3 * atom2[k];
  const double ak = a[k], bk = b[k];
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    double e[TL];
    tuna::hermite_row(l1[3 * k + axis], l2[3 * k + axis], ak, bk, A[axis] - B[axis], e);
#pragma unroll
    for (int t = 0; t < TL; ++t) rows[(axis * TL + t) * n + k] = e[t];
  }
  const int i = l1[3 * k + 2], j = l2[3 * k + 2];
  const double ABz = A[2] - B[2];
  double dz[TL + 1];
#pragma unroll
  for (int t = 0; t <= TL; ++t) dz[t] = 0.0;
  const int di[4] = {1, -1, 0, 0}, dj[4] = {0, 0, 1, -1};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const bool moves = m < 2 ? atom1[k] == 1 : atom2[k] == 1;
    if (!moves || i + di[m] < 0 || j + dj[m] < 0) continue;
    const double w = m == 0 ? 2.0 * ak : m == 1 ? -i : m == 2 ? 2.0 * bk : -j;
    double e[TL + 1];
    tuna::hermite_row(i + di[m], j + dj[m], ak, bk, ABz, e);
#pragma unroll
    for (int t = 0; t <= TL; ++t) dz[t] += w * e[t];
  }
#pragma unroll
  for (int t = 0; t <= TL; ++t) rows[(3 * TL + t) * n + k] = dz[t];
  const double p = ak + bk;
  rows[field_p(TL) * n + k] = p;
  rows[field_pz(TL) * n + k] = (ak * A[2] + bk * B[2]) / p;
  rows[field_coef(TL) * n + k] = coef[k];
}

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

// The unrestricted energy weight of an unordered AO-pair quartet (A, B):
// its degeneracy times 1/2 Pt_ij Pt_kl - hfx/4 (Pa_ik Pa_jl + Pb_ik Pb_jl
// + Pa_il Pa_jk + Pb_il Pb_jk).  At Pa = Pb = P/2 (Pt = P) this is
// EnergyWeight's value up to rounding.
struct UnrestrictedEnergyWeight {
  const int* pid_i;
  const int* pid_j;
  const double* Pt;
  const double* Pa;
  const double* Pb;
  int n;
  double hfx;

  __device__ __forceinline__ double operator()(int A, int B) const {
    const int i = pid_i[A], j = pid_j[A], k = pid_i[B], l = pid_j[B];
    const double degeneracy = (i != j ? 2.0 : 1.0) * (k != l ? 2.0 : 1.0) * (A != B ? 2.0 : 1.0);
    const double coulomb = 0.5 * Pt[i * n + j] * Pt[k * n + l];
    const double ik_jl = Pa[i * n + k] * Pa[j * n + l] + Pb[i * n + k] * Pb[j * n + l];
    const double il_jk = Pa[i * n + l] * Pa[j * n + k] + Pb[i * n + l] * Pb[j * n + k];
    const double exchange = 0.25 * hfx * (ik_jl + il_jk);
    return degeneracy * (coulomb - exchange);
  }
};

// One thread a component: its weight.
template <class Weight>
__global__ void __launch_bounds__(kWeightThreads)
deriv_weights_kernel(int n_components, const int2* __restrict__ components, Weight weight,
                     double* __restrict__ weights) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_components) return;
  const int2 q = components[idx];
  weights[idx] = weight(q.x, q.y);
}

// The shared part of one primitive quartet (bra primitive pair `bra`, ket
// `ket`) with L_bra + L_ket = S: alpha, T, the Boys values of order S + 1
// (Taylor table `boys`), the R^n_00v recursion and the prefactor
// 2 pi^(5/2) / (p q sqrt(p + q)), written as the prefactor times the table
// entries that the own part reads, entry e to column[e * stride].
template <int S>
__device__ __forceinline__ void shared_part(const double* __restrict__ rows, int n, int tl,
                                            int bra, int ket, const double* __restrict__ boys,
                                            double* __restrict__ column, int stride) {
  using D = CoulombShape<S>;
  constexpr int NM = D::NM;
  const double p = rows[field_p(tl) * n + bra], Pz = rows[field_pz(tl) * n + bra];
  const double q = rows[field_p(tl) * n + ket], Qz = rows[field_pz(tl) * n + ket];
  const double psum = p + q;
  const double alpha = p * q / psum;
  const double PQz = Pz - Qz;
  double F[NM + 1];
  tuna::boys_eval<NM>(alpha * PQz * PQz, boys, F);
  double r_older[NM + 1], r_old[NM + 1], r_new[NM + 1];
  double scale = kTwoPiPow2_5 / (p * q * sqrt(psum));
#pragma unroll
  for (int m = 0; m <= NM; ++m) {
    r_old[m] = scale * F[m];
    r_older[m] = 0.0;
    scale *= -2.0 * alpha;
  }
#pragma unroll
  for (int m = 0; m < D::width(0); ++m) column[(D::offset(0) + m) * stride] = r_old[m];
#pragma unroll
  for (int v = 1; v <= NM; ++v) {
#pragma unroll
    for (int m = 0; m + v <= NM; ++m) r_new[m] = PQz * r_old[m + 1] + (v - 1) * r_older[m + 1];
#pragma unroll
    for (int m = 0; m < D::width(v); ++m) column[(D::offset(v) + m) * stride] = r_new[m];
#pragma unroll
    for (int m = 0; m <= NM; ++m) {
      r_older[m] = r_old[m];
      r_old[m] = (m + v <= NM) ? r_new[m] : 0.0;
    }
  }
}

// One thread a primitive quartet of the runs that several tasks share
// (IntegralPlan.deriv_tables: a row of 8 ints a run -- the first primitive
// pair of its shell quartet's bra and of its ket, nc, L_bra + L_ket, the
// run's first primitive quartet g0 and its count n, the offset of its
// tables, its first primitive quartet in the flat count -- and the run of
// each primitive quartet): its shared part, once, entry e of the run's
// primitive quartet k to tables[offset + e * n + k].
__global__ void __launch_bounds__(kSharedThreads)
deriv_shared_kernel(int n_prim_quartets, const int4* __restrict__ runs,
                    const int* __restrict__ owner, const double* __restrict__ rows, int n,
                    int tl, const double* __restrict__ boys_tables,
                    double* __restrict__ tables) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_prim_quartets) return;
  const int run = owner[idx];
  const int4 head = runs[2 * run], tail = runs[2 * run + 1];
  const int k = idx - tail.w, g = tail.x + k, r = g / head.z, c = g - r * head.z;
  double* column = tables + tail.z + k;
  const double* boys = boys_tables + static_cast<size_t>(head.w + 1) * TUNA_BOYS_TABLE_SIZE;
  switch (head.w) {
#define TUNA_SHARED_CASE(S)                                                      \
  case S:                                                                       \
    shared_part<S>(rows, n, tl, head.x + r, head.y + c, boys, column, tail.y);  \
    break;
    TUNA_SHARED_CASE(0) TUNA_SHARED_CASE(1) TUNA_SHARED_CASE(2) TUNA_SHARED_CASE(3)
    TUNA_SHARED_CASE(4) TUNA_SHARED_CASE(5) TUNA_SHARED_CASE(6) TUNA_SHARED_CASE(7)
    TUNA_SHARED_CASE(8) TUNA_SHARED_CASE(9) TUNA_SHARED_CASE(10) TUNA_SHARED_CASE(11)
    TUNA_SHARED_CASE(12)
#undef TUNA_SHARED_CASE
    default:
      break;
  }
}

// One primitive pair's own rows cut to T Hermite orders an axis (the
// tangent to T + 1) and its coefficient.
template <int T>
struct OwnRow {
  double ex[T], ey[T], ez[T], dz[T + 1], coef;

  __device__ __forceinline__ void load(const double* __restrict__ rows, int n, int tl, int k) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      ex[t] = rows[t * n + k];
      ey[t] = rows[(tl + t) * n + k];
      ez[t] = rows[(2 * tl + t) * n + k];
    }
#pragma unroll
    for (int t = 0; t <= T; ++t) dz[t] = rows[(3 * tl + t) * n + k];
    coef = rows[field_coef(tl) * n + k];
  }
};

// The own part of one item: the x/y pairing (quartet.cuh), the z products
// of [d bra | ket] + [bra | d ket] (both tangents at their top order meet
// only each other's zero, so t + u stays <= NM), and their contraction with
// the primitive quartet's column of the table (entry e at column[e * stride]).
template <int LA, int LB>
__device__ __forceinline__ double own_part(const OwnRow<LA + 1>& A, const OwnRow<LB + 1>& C,
                                           const double* __restrict__ column, int stride) {
  using S = ClassShape<LA, LB>;
  using D = DerivShape<LA, LB>;
  constexpr int NM = D::NM;
  double gz[NM + 1], axy[S::NXY + 1];
  xy_pairing<LA, LB>(A, C, axy);
#pragma unroll
  for (int v = 0; v <= NM; ++v) gz[v] = 0.0;
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
  double total = 0.0;
#pragma unroll
  for (int v = 0; v <= NM; ++v) {
    double dot = 0.0;
#pragma unroll
    for (int m = 0; m < D::width(v); ++m) dot += axy[m] * column[(D::offset(v) + m) * stride];
    total += gz[v] * dot;
  }
  return total;
}

// One class's tasks, as a kernel reads them.
struct ShellPart {
  const int4* tasks;           // two int4 a task (IntegralPlan.deriv_schedule)
  int prims;                   // the most primitive quartets of a task of the class
  const int2* component_rows;  // first primitive pair of each component's A and B
  const double* weights;       // each component's weight (deriv_weights_kernel)
  const double* rows;          // derivative rows, field-major
  int n;                       // primitive pairs
  int tl;
  const double* boys;          // Taylor table of the class's Boys order
  const double* tables;        // the shared parts of runs cut into several tasks
  double* partials;            // this class's first task's partial
};

// One block a task: thread g forms the shared part of the task's primitive
// quartet g (or, for a run cut into several tasks, the block copies the
// run's shared parts from deriv_shared_kernel's tables), then the threads
// stride over the task's items; a fixed-order shuffle a warp, then the warps
// in order, give the task's partial.
template <int LA, int LB>
__global__ void __launch_bounds__(kTaskThreads)
deriv_shell_kernel(ShellPart part) {
  using D = DerivShape<LA, LB>;
  extern __shared__ double shared[];  // DerivShape::bytes(part.prims)
  const int stride = part.prims;
  double* table = shared;
  double* red = table + D::NR * stride;
  int* bra_of = reinterpret_cast<int*>(red + kTaskWarps);
  int* ket_of = bra_of + stride;
  const int tid = threadIdx.x;
  const int4 head = part.tasks[2 * blockIdx.x], tail = part.tasks[2 * blockIdx.x + 1];
  const int nc = head.z, n_prim = tail.x, c0 = tail.y, c1 = tail.z, formed = tail.w;
  if (formed >= 0) {  // entry e of primitive quartet k at tables[formed + e * n_prim + k]
    for (int x = tid; x < D::NR * n_prim; x += kTaskThreads) {
      const int e = x / n_prim;
      table[e * stride + x - e * n_prim] = part.tables[formed + x];
    }
  }
  if (tid < n_prim) {
    const int g = head.w + tid, r = g / nc, c = g - r * nc;
    bra_of[tid] = r;
    ket_of[tid] = c;
    if (formed < 0) {
      shared_part<LA + LB>(part.rows, part.n, part.tl, head.x + r, head.y + c, part.boys,
                           table + tid, stride);
    }
  }
  __syncthreads();
  // item i: component c0 + i / n_prim, primitive quartet i % n_prim
  const int n_items = n_prim * (c1 - c0);
  const int dj = kTaskThreads / n_prim, dk = kTaskThreads - dj * n_prim;
  int j = c0 + tid / n_prim, k = tid % n_prim;
  double sum = 0.0;
  for (int i = tid; i < n_items; i += kTaskThreads) {
    const int2 first = part.component_rows[j];
    OwnRow<D::TA> A;
    A.load(part.rows, part.n, part.tl, first.x + bra_of[k]);
    OwnRow<D::TB> C;
    C.load(part.rows, part.n, part.tl, first.y + ket_of[k]);
    sum += part.weights[j] * (A.coef * C.coef * own_part<LA, LB>(A, C, table + k, stride));
    k += dk;
    j += dj;
    if (k >= n_prim) {
      k -= n_prim;
      ++j;
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset /= 2) {
    sum += __shfl_down_sync(0xffffffffu, sum, offset);
  }
  if (tid % 32 == 0) red[tid / 32] = sum;
  __syncthreads();
  if (tid == 0) {
    double partial = red[0];
#pragma unroll
    for (int w = 1; w < kTaskWarps; ++w) partial += red[w];
    part.partials[blockIdx.x] = partial;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
deriv_reduce_kernel(int n, const double* __restrict__ partials, double* __restrict__ out) {
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

// One row of the host's class table: the class (la, lb), its tasks
// [begin, end) and the most primitive quartets of one of them.
struct ShellClass {
  int la, lb, begin, end, prims;
};

template <int LA, int LB>
cudaError_t launch_shell_class(const ShellClass& cls, ShellPart part, cudaStream_t stream) {
  using D = DerivShape<LA, LB>;
  if (cls.prims < 1 || cls.prims > kTaskThreads) return cudaErrorInvalidValue;
  const int bytes = D::bytes(cls.prims);
  if (bytes > 48 * 1024) {  // above a block's default limit
    const cudaError_t err = cudaFuncSetAttribute(
        deriv_shell_kernel<LA, LB>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  part.tasks += 2 * static_cast<size_t>(cls.begin);
  part.prims = cls.prims;
  part.boys += static_cast<size_t>(D::NM) * TUNA_BOYS_TABLE_SIZE;
  deriv_shell_kernel<LA, LB><<<cls.end - cls.begin, kTaskThreads, bytes, stream>>>(part);
  return cudaGetLastError();
}

cudaError_t launch_shell_class_part(const ShellClass& cls, const ShellPart& part,
                                    cudaStream_t stream) {
  if (cls.end <= cls.begin) return cudaSuccess;
  switch (cls.la * 16 + cls.lb) {
#define TUNA_SHELL_CLASS_CASE(A, B) \
  case A * 16 + B:                  \
    return launch_shell_class<A, B>(cls, part, stream);
    TUNA_QUARTET_CLASSES(TUNA_SHELL_CLASS_CASE)
#undef TUNA_SHELL_CLASS_CASE
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

// The whole sweep with one weight: the rows and the weights, the class
// kernels on the side streams, then the fixed-order sum of the task
// partials into out.
template <class Weight>
cudaError_t eri_deriv_energy(int lmax, int n_prim_pairs, const double* coords, const double* a,
                             const double* b, const double* coef, const int* l1, const int* l2,
                             const int* atom1, const int* atom2, int n_components,
                             const int* components, const int* component_rows, const int* tasks,
                             int n_classes, const int* classes, int n_shared,
                             const int* shared_runs, const int* shared_owner,
                             const double* boys_tables, const Weight& weight, double* rows,
                             double* weights, double* tables, int n_partials, double* partials,
                             double* out, cudaStream_t stream) {
  const ShellClass* parts = reinterpret_cast<const ShellClass*>(classes);
  int expected = 0;
  for (int i = 0; i < n_classes; ++i) expected += parts[i].end - parts[i].begin;
  if (expected != n_partials) return cudaErrorInvalidValue;
  cudaError_t err = launch_deriv_rows(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1,
                                      atom2, rows, stream);
  if (err != cudaSuccess) return err;
  if (n_components > 0) {
    deriv_weights_kernel<Weight>
        <<<(n_components + kWeightThreads - 1) / kWeightThreads, kWeightThreads, 0, stream>>>(
            n_components, reinterpret_cast<const int2*>(components), weight, weights);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_shared > 0) {
    deriv_shared_kernel<<<(n_shared + kSharedThreads - 1) / kSharedThreads, kSharedThreads, 0,
                          stream>>>(n_shared, reinterpret_cast<const int4*>(shared_runs),
                                    shared_owner, rows, n_prim_pairs, 2 * lmax + 1, boys_tables,
                                    tables);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  SideStreams* side = nullptr;
  err = fork_side_streams(stream, &side);
  if (side == nullptr) return err;
  ShellPart part{reinterpret_cast<const int4*>(tasks), 0,
                 reinterpret_cast<const int2*>(component_rows), weights, rows, n_prim_pairs,
                 2 * lmax + 1, boys_tables, tables, partials};
  for (int i = 0; i < n_classes && err == cudaSuccess; ++i) {
    err = launch_shell_class_part(parts[i], part, side->stream[i % kSideStreams]);
    part.partials += parts[i].end - parts[i].begin;
  }
  err = join_side_streams(side, stream, err);
  if (err != cudaSuccess) return err;
  deriv_reduce_kernel<<<1, kReduceThreads, 0, stream>>>(n_partials, partials, out);
  return cudaGetLastError();
}

}  // namespace

// components (n_components x 2: AO pairs A, B), component_rows (their
// first primitive pairs), tasks (8 ints a task) and classes (5 ints a row,
// host memory) from IntegralPlan.shell_quartets and deriv_schedule;
// shared_runs (8 ints a run) and shared_owner (the run of each of their
// n_shared primitive quartets) from IntegralPlan.deriv_tables; boys_tables
// orders 0..4 lmax + 1 as for tuna_eri_packed (eri.cu); P the symmetric
// Cartesian density; rows ((4 (2 lmax + 1) + 4) x n_prim_pairs), weights
// (n_components), tables (deriv_tables' count of doubles) and partials
// (n_partials, at least one) scratch; out one double.  n_partials must
// equal the tasks of all classes (IntegralPlan.deriv_partial_count).
extern "C" int tuna_eri_deriv_energy(
    int lmax, int n_prim_pairs, int n_basis, const double* coords, const double* a,
    const double* b, const double* coef, const int* l1, const int* l2, const int* atom1,
    const int* atom2, const int* pid_i, const int* pid_j, int n_components,
    const int* components, const int* component_rows, const int* tasks, int n_classes,
    const int* classes, int n_shared, const int* shared_runs, const int* shared_owner,
    const double* boys_tables, const double* P, double hfx, double* rows, double* weights,
    double* tables, int n_partials, double* partials, double* out, cudaStream_t stream) {
  const EnergyWeight weight{pid_i, pid_j, P, n_basis, hfx};
  return eri_deriv_energy(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                          n_components, components, component_rows, tasks, n_classes, classes,
                          n_shared, shared_runs, shared_owner, boys_tables, weight, rows,
                          weights, tables, n_partials, partials, out, stream);
}

// K8bu: as tuna_eri_deriv_energy, with the symmetric Cartesian densities
// Pt = Pa + Pb, Pa and Pb (n_basis x n_basis each) in place of P.
extern "C" int tuna_eri_deriv_energy_unrestricted(
    int lmax, int n_prim_pairs, int n_basis, const double* coords, const double* a,
    const double* b, const double* coef, const int* l1, const int* l2, const int* atom1,
    const int* atom2, const int* pid_i, const int* pid_j, int n_components,
    const int* components, const int* component_rows, const int* tasks, int n_classes,
    const int* classes, int n_shared, const int* shared_runs, const int* shared_owner,
    const double* boys_tables, const double* Pt, const double* Pa, const double* Pb, double hfx,
    double* rows, double* weights, double* tables, int n_partials, double* partials,
    double* out, cudaStream_t stream) {
  const UnrestrictedEnergyWeight weight{pid_i, pid_j, Pt, Pa, Pb, n_basis, hfx};
  return eri_deriv_energy(lmax, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
                          n_components, components, component_rows, tasks, n_classes, classes,
                          n_shared, shared_runs, shared_owner, boys_tables, weight, rows,
                          weights, tables, n_partials, partials, out, stream);
}

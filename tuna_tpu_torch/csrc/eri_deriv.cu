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
//   * one kernel a class (L_bra, L_ket) on the side streams, up to (10, 10)
//     (lmax 5, Boys order 21; the class kernels are in eri_deriv.cuh, those
//     of L_bra = 7..10 built in eri_deriv_l7.cu .. eri_deriv_l10.cu); each
//     warp's lanes meet in a fixed-order shuffle, each block writes its
//     task's partial (its warps in order), and one block sums the partials
//     in a fixed order: no float atomics, two calls give the same bits;
//   * registers: a class up to (6, 6) holds the item's bra and ket rows in
//     registers; above, a row of 11 orders an axis would take 46 doubles,
//     so the own part reads the bra's entries through L1 where they are
//     used and the ket's one field at a time (eri_deriv.cuh,
//     own_part_streamed).
#include <cuda_runtime.h>

#include "eri_deriv.cuh"

namespace {

constexpr int kReduceThreads = 256;
constexpr int kWeightThreads = 256;
constexpr int kSharedThreads = 128;

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
    TUNA_SHARED_CASE(12) TUNA_SHARED_CASE(13) TUNA_SHARED_CASE(14) TUNA_SHARED_CASE(15)
    TUNA_SHARED_CASE(16) TUNA_SHARED_CASE(17) TUNA_SHARED_CASE(18) TUNA_SHARED_CASE(19)
    TUNA_SHARED_CASE(20)
#undef TUNA_SHARED_CASE
    default:
      break;
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
      break;
  }
  if (cls.lb < 0 || cls.lb > cls.la) return cudaErrorInvalidValue;
  switch (cls.la) {
    case 7:
      return tuna_deriv::launch_high_class<7>(cls, part, stream);
    case 8:
      return tuna_deriv::launch_high_class<8>(cls, part, stream);
    case 9:
      return tuna_deriv::launch_high_class<9>(cls, part, stream);
    case 10:
      return tuna_deriv::launch_high_class<10>(cls, part, stream);
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
    TUNA_DERIV_ROWS(4)
    TUNA_DERIV_ROWS(5)
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

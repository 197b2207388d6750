// The class kernels of K8b and K8bu (eri_deriv.cu): one block a task of one
// shell quartet, its primitive quartets' shared parts in shared memory,
// then the threads over the task's (component, primitive quartet) items.
// The classes (L_bra, L_ket) up to (6, 6) are instantiated in eri_deriv.cu;
// those of L_bra = 7..10, which only g and h shells reach, in
// eri_deriv_l7.cu .. eri_deriv_l10.cu, one source an L_bra, so that nvcc
// builds them beside the others (launch_high_class).
//
// Everything here but the types of namespace tuna_deriv has internal
// linkage, as in quartet.cuh: each translation unit that includes the header
// gets its own copy of the kernels.
#pragma once

#include <cuda_runtime.h>

#include "quartet.cuh"

namespace {

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

// The contraction of the z products gz with the x/y pairing axy and the
// primitive quartet's column of the table (entry e at column[e * stride]).
template <int LA, int LB>
__device__ __forceinline__ double contract_column(const double (&gz)[LA + LB + 2],
                                                  const double (&axy)[(LA + LB) / 2 + 1],
                                                  const double* __restrict__ column,
                                                  int stride) {
  using D = DerivShape<LA, LB>;
  double total = 0.0;
#pragma unroll
  for (int v = 0; v <= D::NM; ++v) {
    double dot = 0.0;
#pragma unroll
    for (int m = 0; m < D::width(v); ++m) dot += axy[m] * column[(D::offset(v) + m) * stride];
    total += gz[v] * dot;
  }
  return total;
}

// The own part of one item: the x/y pairing (quartet.cuh), the z products
// of [d bra | ket] + [bra | d ket] (both tangents at their top order meet
// only each other's zero, so t + u stays <= NM), and their contraction with
// the primitive quartet's column of the table.  The classes up to (6, 6)
// hold both rows in registers (OwnRow).
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
  return contract_column<LA, LB>(gz, axy, column, stride);
}

// The same own part for the classes of L_bra >= 7 (g and h shells): two
// rows of 11 orders an axis would take 92 doubles, so no row lives in
// registers whole.  The bra's entries are read through L1 where they are
// used, the ket's one field at a time (E_x and E_y for the pairing, then
// E_z and dE_z for the z products), and each sum keeps only its
// accumulators: the pairing's 2 (NXY + 1), then axy and gz.  ka and kc are
// the bra's and the ket's primitive pairs.
template <int LA, int LB>
__device__ __forceinline__ double own_part_streamed(const double* __restrict__ rows, int n,
                                                    int tl, int ka, int kc,
                                                    const double* __restrict__ column,
                                                    int stride) {
  using S = ClassShape<LA, LB>;
  using D = DerivShape<LA, LB>;
  constexpr int NM = D::NM;
  double axy[S::NXY + 1];
  {
    double cx[S::TB], cy[S::TB], gx[S::NXY + 1], gy[S::NXY + 1];
#pragma unroll
    for (int u = 0; u < S::TB; ++u) {
      cx[u] = rows[u * n + kc];
      cy[u] = rows[(tl + u) * n + kc];
    }
#pragma unroll
    for (int m = 0; m <= S::NXY; ++m) gx[m] = gy[m] = axy[m] = 0.0;
#pragma unroll
    for (int t = 0; t < S::TA; ++t) {
      const double ax = rows[t * n + ka], ay = rows[(tl + t) * n + ka];
#pragma unroll
      for (int u = 0; u < S::TB; ++u) {
        if (((t + u) & 1) == 0) {
          const double sign = (u & 1) ? -1.0 : 1.0;
          gx[(t + u) / 2] += ax * sign * cx[u];
          gy[(t + u) / 2] += ay * sign * cy[u];
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
  double gz[NM + 1];
  {
    double cz[S::TB], cdz[S::TB + 1];
#pragma unroll
    for (int u = 0; u < S::TB; ++u) cz[u] = rows[(2 * tl + u) * n + kc];
#pragma unroll
    for (int u = 0; u <= S::TB; ++u) cdz[u] = rows[(3 * tl + u) * n + kc];
#pragma unroll
    for (int v = 0; v <= NM; ++v) gz[v] = 0.0;
#pragma unroll
    for (int t = 0; t <= S::TA; ++t) {
      const double dz_a = rows[(3 * tl + t) * n + ka];
      const double ez_a = t < S::TA ? rows[(2 * tl + t) * n + ka] : 0.0;
#pragma unroll
      for (int u = 0; u <= S::TB; ++u) {
        if (t + u <= NM) {
          const double sign = (u & 1) ? -1.0 : 1.0;
          const double ez_c = u < S::TB ? cz[u] : 0.0;
          gz[t + u] += sign * (dz_a * ez_c + ez_a * cdz[u]);
        }
      }
    }
  }
  return contract_column<LA, LB>(gz, axy, column, stride);
}

}  // namespace

// The types that cross translation units (the classes of L_bra = 7..10 are
// launched from eri_deriv_l7.cu .. eri_deriv_l10.cu) have external linkage.
namespace tuna_deriv {

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

// One row of the host's class table: the class (la, lb), its tasks
// [begin, end) and the most primitive quartets of one of them.
struct ShellClass {
  int la, lb, begin, end, prims;
};

// Launches the kernel of one class with L_bra = LA, 7 <= LA <= 10; defined
// in eri_deriv_l<LA>.cu.
template <int LA>
cudaError_t launch_high_class(const ShellClass& cls, const ShellPart& part, cudaStream_t stream);

}  // namespace tuna_deriv

namespace {

using tuna_deriv::ShellClass;
using tuna_deriv::ShellPart;

// One block a task: thread g forms the shared part of the task's primitive
// quartet g (or, for a run cut into several tasks, the block copies the
// run's shared parts from deriv_shared_kernel's tables), then the threads
// stride over the task's items; a fixed-order shuffle a warp, then the warps
// in order, give the task's partial.
template <int LA, int LB>
__global__ void __launch_bounds__(kTaskThreads)
deriv_shell_kernel(ShellPart part) {
  using D = DerivShape<LA, LB>;
  constexpr bool kRowsInRegisters = LA <= 6;
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
    if constexpr (kRowsInRegisters) {
      OwnRow<D::TA> A;
      A.load(part.rows, part.n, part.tl, first.x + bra_of[k]);
      OwnRow<D::TB> C;
      C.load(part.rows, part.n, part.tl, first.y + ket_of[k]);
      sum += part.weights[j] * (A.coef * C.coef * own_part<LA, LB>(A, C, table + k, stride));
    } else {
      const int ka = first.x + bra_of[k], kc = first.y + ket_of[k];
      const double coef_a = part.rows[field_coef(part.tl) * part.n + ka];
      const double coef_c = part.rows[field_coef(part.tl) * part.n + kc];
      sum += part.weights[j] *
             (coef_a * coef_c *
              own_part_streamed<LA, LB>(part.rows, part.n, part.tl, ka, kc, table + k, stride));
    }
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

// The kernel of class (LA, cls.lb) for LB <= cls.lb <= LA.
template <int LA, int LB>
cudaError_t launch_shell_class_from(const ShellClass& cls, const ShellPart& part,
                                    cudaStream_t stream) {
  if constexpr (LB > LA) {
    return cudaErrorInvalidValue;
  } else {
    if (cls.lb == LB) return launch_shell_class<LA, LB>(cls, part, stream);
    return launch_shell_class_from<LA, LB + 1>(cls, part, stream);
  }
}

}  // namespace

// The classes (LA, 0) .. (LA, LA), in eri_deriv_l<LA>.cu.
#define TUNA_DERIV_HIGH_CLASS_SOURCE(LA)                                                   \
  namespace tuna_deriv {                                                                   \
  template <int A>                                                                         \
  cudaError_t launch_high_class(const ShellClass& cls, const ShellPart& part,              \
                                cudaStream_t stream) {                                     \
    return launch_shell_class_from<A, 0>(cls, part, stream);                               \
  }                                                                                        \
  template cudaError_t launch_high_class<LA>(const ShellClass&, const ShellPart&,          \
                                             cudaStream_t);                                \
  }

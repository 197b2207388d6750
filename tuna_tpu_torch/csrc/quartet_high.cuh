// The quartet classes of K1 (eri.cu) and K4 (fock_direct.cu) with L_bra =
// 7..10, the classes that only g and h shells reach (quartet.cuh), one
// source an L_bra (quartet_l7.cu .. quartet_l10.cu): their kernels, fully
// unrolled at Boys orders up to 20, are the longest of the build, and nvcc
// builds each source beside the others.  Only those sources include this
// header, so eri.cu and fock_direct.cu see launch_high_class declared and
// never instantiate it.
#pragma once

#include "quartet.cuh"

namespace tuna_quartet {

template <int LA, class Out>
cudaError_t launch_high_class(const ClassPart& cls, const QuartetPart& part, const Out& out,
                              cudaStream_t light, cudaStream_t heavy) {
  return launch_class_from<LA, 0, Out>(cls, part, out, light, heavy);
}

}  // namespace tuna_quartet

// The classes (LA, 0) .. (LA, LA) of both kernels.
#define TUNA_HIGH_CLASS_SOURCE(LA)                                                     \
  template cudaError_t tuna_quartet::launch_high_class<LA, tuna_quartet::PackedOut>(   \
      const tuna_quartet::ClassPart&, const tuna_quartet::QuartetPart&,                \
      const tuna_quartet::PackedOut&, cudaStream_t, cudaStream_t);                     \
  template cudaError_t tuna_quartet::launch_high_class<LA, tuna_quartet::FockOut>(     \
      const tuna_quartet::ClassPart&, const tuna_quartet::QuartetPart&,                \
      const tuna_quartet::FockOut&, cudaStream_t, cudaStream_t);

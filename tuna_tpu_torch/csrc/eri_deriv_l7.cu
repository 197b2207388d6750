// K8b's and K8bu's class kernels (L_bra = 7) (eri_deriv.cuh).
#include "eri_deriv.cuh"

TUNA_DERIV_HIGH_CLASS_SOURCE(7)

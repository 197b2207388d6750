// K1's and K4's quartet classes (7, 0) .. (7, 7) (quartet_high.cuh).
#include "quartet_high.cuh"

TUNA_HIGH_CLASS_SOURCE(7)

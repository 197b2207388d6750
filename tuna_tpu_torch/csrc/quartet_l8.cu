// K1's and K4's quartet classes (8, 0) .. (8, 8) (quartet_high.cuh).
#include "quartet_high.cuh"

TUNA_HIGH_CLASS_SOURCE(8)

// K1's and K4's quartet classes (9, 0) .. (9, 9) (quartet_high.cuh).
#include "quartet_high.cuh"

TUNA_HIGH_CLASS_SOURCE(9)

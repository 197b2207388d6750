// K1's and K4's quartet classes (10, 0) .. (10, 10) (quartet_high.cuh).
#include "quartet_high.cuh"

TUNA_HIGH_CLASS_SOURCE(10)

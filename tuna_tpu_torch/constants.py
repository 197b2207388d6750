"""Physical constants and unit conversions (CODATA 2022).

Mirrors the constant definitions of the reference implementation
(/root/reference/TUNA/tuna_util.py:26-141) so that all derived unit
conversions agree to machine precision.  Values are plain Python floats so
they can be folded into jitted JAX computations as compile-time constants.
"""

import math

# --- Fundamental constants (CODATA 2022) --------------------------------

PLANCK_J_S = 6.62607015e-34
ELEMENTARY_CHARGE_C = 1.602176634e-19
ELECTRON_MASS_KG = 9.1093837139e-31
VACUUM_PERMITTIVITY_F_PER_M = 8.8541878188e-12

SPEED_OF_LIGHT_M_PER_S = 299792458
BOLTZMANN_J_PER_K = 1.380649e-23
AVOGADRO = 6.02214076e23

# --- Emergent conversions (Hartree atomic units) -------------------------

AMU_IN_KG = 0.001 / AVOGADRO
HBAR_J_S = PLANCK_J_S / (2 * math.pi)
BOHR_IN_METRES = (
    4 * math.pi * VACUUM_PERMITTIVITY_F_PER_M * HBAR_J_S**2
    / (ELECTRON_MASS_KG * ELEMENTARY_CHARGE_C**2)
)
HARTREE_IN_JOULES = HBAR_J_S**2 / (ELECTRON_MASS_KG * BOHR_IN_METRES**2)
ATOMIC_TIME_IN_SECONDS = HBAR_J_S / HARTREE_IN_JOULES
ATOMIC_TIME_IN_FS = ATOMIC_TIME_IN_SECONDS * 1e15
BOHR_IN_ANGSTROM = BOHR_IN_METRES * 1e10

PASCAL_IN_AU = HARTREE_IN_JOULES / BOHR_IN_METRES**3
PER_CM_IN_HARTREE = HARTREE_IN_JOULES / (SPEED_OF_LIGHT_M_PER_S * PLANCK_J_S * 1e2)
PER_CM_IN_GHZ = HARTREE_IN_JOULES / (PLANCK_J_S * PER_CM_IN_HARTREE * 1e9)
AMU_IN_ELECTRON_MASS = AMU_IN_KG / ELECTRON_MASS_KG
EV_IN_HARTREE = HARTREE_IN_JOULES / ELEMENTARY_CHARGE_C

C_AU = SPEED_OF_LIGHT_M_PER_S * ATOMIC_TIME_IN_SECONDS / BOHR_IN_METRES
K_AU = BOLTZMANN_J_PER_K / HARTREE_IN_JOULES
H_AU = 2 * math.pi

# --- Finite-difference step sizes for numerical derivatives --------------
# (kept as a validation mode; autodiff is the primary derivative path)

FIRST_GEOM_DERIVATIVE_STEP = 0.00005
FIRST_ELEC_DERIVATIVE_STEP = 0.00001
SECOND_GEOM_DERIVATIVE_STEP = 0.01
SECOND_ELEC_DERIVATIVE_STEP = 0.001
THIRD_GEOM_DERIVATIVE_STEP = 0.025
THIRD_ELEC_DERIVATIVE_STEP = 0.0015

# --- Numerical-hygiene floors for DFT grids -------------------------------

DENSITY_FLOOR = 1e-23
EXPONENT_CEILING = 600
SIGMA_FLOOR = DENSITY_FLOOR**2

# --- Fixed thresholds -----------------------------------------------------

ORB_HESS_EIG_THRESH = -1e-5
COMPLEX_EIG_THRESH = 1e-5
MOMENT_THRESH = 1e-5

# --- Convergence tiers ----------------------------------------------------

SCF_CONVERGENCE = {
    "loose": {"delta_E": 1e-6, "max_DP": 1e-5, "RMS_DP": 1e-6, "commutator": 1e-4, "name": "loose"},
    "medium": {"delta_E": 1e-7, "max_DP": 1e-6, "RMS_DP": 1e-7, "commutator": 1e-5, "name": "medium"},
    "tight": {"delta_E": 1e-9, "max_DP": 1e-8, "RMS_DP": 1e-9, "commutator": 1e-7, "name": "tight"},
    "extreme": {"delta_E": 1e-11, "max_DP": 1e-10, "RMS_DP": 1e-11, "commutator": 1e-9, "name": "extreme"},
}

OPT_CONVERGENCE = {
    "loose": {"gradient": 1e-3, "step": 1e-2, "name": "loose"},
    "medium": {"gradient": 1e-4, "step": 1e-4, "name": "medium"},
    "tight": {"gradient": 1e-6, "step": 1e-5, "name": "tight"},
    "extreme": {"gradient": 1e-8, "step": 1e-7, "name": "extreme"},
}

GRID_TIERS = {
    "loose": {"integral_accuracy": 3, "extent_multiplier": 0.7, "name": "loose"},
    "medium": {"integral_accuracy": 4, "extent_multiplier": 0.9, "name": "medium"},
    "tight": {"integral_accuracy": 5, "extent_multiplier": 1, "name": "tight"},
    "extreme": {"integral_accuracy": 7, "extent_multiplier": 1.3, "name": "extreme"},
}


def bohr_to_angstrom(x):
    return x * BOHR_IN_ANGSTROM


def angstrom_to_bohr(x):
    return x / BOHR_IN_ANGSTROM

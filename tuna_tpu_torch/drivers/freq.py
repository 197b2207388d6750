"""Vibrational frequencies: harmonic (with IR intensity and thermochemistry)
and VPT1/VPT2 perturbative anharmonicity.

Twin of tuna_tpu/drivers/freq.py; its stencils batch through
opt._batched_displaced_energies when more than one device is visible.  The
dipole derivative is the seminumerical one; the fully numerical route
(DIPOLE) needs the finite-field electric properties, which the energy
driver refuses, and the scanned-PES anharmonic frequency (ANHARM) is not
ported yet.  Every tensor lives on `device`.
"""

from __future__ import annotations

import numpy as np

from .. import constants, props
from ..containers import to_numpy
from ..output import log, log_spacer, timer, warning
from ..stencils import first_derivative, fourth_derivative, third_derivative
from . import energy as energ
from . import opt, thermo


def calculate_transition_intensity(frequency_per_cm, dipole_matrix):
    """IR intensity in km/mol from frequency and dipole derivative (Neugebauer 2002)."""
    prefactor = (constants.ELEMENTARY_CHARGE_C**2 / constants.ELECTRON_MASS_KG
                 * constants.AVOGADRO
                 / (6000 * constants.VACUUM_PERMITTIVITY_F_PER_M
                    * constants.SPEED_OF_LIGHT_M_PER_S**2))
    frequency_hartree = frequency_per_cm / constants.PER_CM_IN_HARTREE
    return prefactor * dipole_matrix**2 * frequency_hartree


def check_sign_of_hessian(hessian, reduced_mass):
    if hessian > 0:
        frequency_hartree = np.sqrt(hessian / reduced_mass)
        zero_point_energy = frequency_hartree / 2
    else:
        frequency_hartree = np.sqrt(-hessian / reduced_mass)
        zero_point_energy = 0
        warning("Imaginary frequency calculated! Zero-point energy and "
                "vibrational thermochemical parameters set to zero!\n")
    return frequency_hartree, zero_point_energy


def calculate_dipole_derivative(coordinates, molecule, SCF_forward, SCF_backward,
                                P_forward, P_backward, calculation, step):
    """Seminumerical, gauge-invariant dipole derivative in normal coordinates."""
    timer("Dipole derivative", 0)
    prod = np.array([[0.0, 0.0, -molecule.masses[1] * step],
                     [0.0, 0.0, molecule.masses[0] * step]]) / molecule.total_mass
    forward_coords = coordinates + prod
    backward_coords = coordinates - prod

    log(" Calculating seminumerical dipole derivative...       ", calculation, 1, end="")
    mu_f, _, _ = props.calculate_analytical_dipole_moment(
        molecule.centre_of_mass, molecule.charges, forward_coords, to_numpy(P_forward),
        to_numpy(SCF_forward.integrals.D))
    mu_b, _, _ = props.calculate_analytical_dipole_moment(
        molecule.centre_of_mass, molecule.charges, backward_coords, to_numpy(P_backward),
        to_numpy(SCF_backward.integrals.D))

    dipole_derivative = first_derivative(mu_b, mu_f, step) / np.sqrt(molecule.reduced_mass)
    log("[Done]\n", calculation, 1)
    timer("Dipole derivative", 1)
    return dipole_derivative


def calculate_harmonic_frequency(calculation, atomic_symbols=None, coordinates=None,
                                 molecule=None, energy=None, device="cuda"):
    """Hessian -> frequency, ZPE, IR intensity, optional VPT, thermochemistry.
    Returns (hessian, reduced mass, frequency per cm, zero-point energy)."""
    timer("Harmonic frequency", 0)

    if calculation.calculation_type == "FREQ":
        timer("Energy evaluation", 0)
        _, molecule, energy, _ = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates, device=device)
        timer("Energy evaluation", 1)

    # VPT needs the second- and third-derivative steps to match
    do_vpt = calculation.first_order_vpt or calculation.second_order_vpt
    hessian_step = (constants.THIRD_GEOM_DERIVATIVE_STEP if do_vpt
                    else constants.SECOND_GEOM_DERIVATIVE_STEP)

    bond_length = molecule.bond_length
    atomic_symbols = molecule.atomic_symbols
    coordinates = molecule.coordinates
    masses = molecule.masses
    reduced_mass = molecule.reduced_mass

    log_spacer(calculation, 1, start="\n", space="")
    log(" Beginning harmonic frequency calculation...", calculation, 1)
    log_spacer(calculation, 1, space="")
    log(f"\n Hessian will be calculated at a bond length of "
        f"{constants.bohr_to_angstrom(bond_length):.5f} angstroms.", calculation, 1)

    # Five-point Hessian (with the VPT-compatible step when needed)
    saved_step = constants.SECOND_GEOM_DERIVATIVE_STEP
    constants.SECOND_GEOM_DERIVATIVE_STEP = hessian_step
    try:
        (hessian, SCF_forward, P_forward, SCF_backward, P_backward,
         displaced_energies) = opt.calculate_hessian(coordinates, calculation,
                                                     atomic_symbols, energy,
                                                     allow_analytic=not do_vpt, device=device)
    finally:
        constants.SECOND_GEOM_DERIVATIVE_STEP = saved_step

    frequency_hartree, zero_point_energy = check_sign_of_hessian(hessian, reduced_mass)
    imaginary_unit = "i" if zero_point_energy == 0 else " "
    frequency_per_cm = frequency_hartree * constants.PER_CM_IN_HARTREE

    dipole_derivative = calculate_dipole_derivative(
        coordinates, molecule, SCF_forward, SCF_backward, P_forward, P_backward,
        calculation, hessian_step)
    # Vibrational overlap contribution (matches ORCA convention)
    dipole_derivative /= np.sqrt(2 * frequency_hartree)
    intensity = calculate_transition_intensity(frequency_per_cm, dipole_derivative)

    log(f" Using atomic mass of {masses[0] / constants.AMU_IN_ELECTRON_MASS:.6f} amu "
        f"for {atomic_symbols[0].capitalize()}, "
        f"{masses[1] / constants.AMU_IN_ELECTRON_MASS:.6f} amu for "
        f"{atomic_symbols[1].capitalize()}.", calculation, 3)
    log(" Dipole moment derivative already includes vibrational overlap.\n", calculation, 1)

    bar = " " + "~" * 38 + "     " + "~" * 39
    log(bar, calculation, 1)
    log("           Harmonic Frequency                         Transition Intensity", calculation, 1)
    log(bar, calculation, 1)
    log(f"  Force constant:           {hessian:10.5f}       Dipole moment derivative:  {dipole_derivative:10.5f}", calculation, 1)
    log(f"  Reduced mass:           {reduced_mass:12.5f}       Squared derivative:        {dipole_derivative**2:10.5f}", calculation, 1)
    log(f"\n  Frequency (per cm):         {imaginary_unit}{frequency_per_cm:7.2f}       Intensity (km per mol):       {intensity:7.2f}", calculation, 1)
    log(bar, calculation, 1)
    timer("Harmonic frequency", 1)

    if do_vpt:
        frequency_hartree, zero_point_energy = vibrational_perturbation_theory(
            frequency_hartree, energy, calculation, atomic_symbols, coordinates,
            molecule, displaced_energies, device=device)

    thermo.calculate_thermochemical_corrections(
        molecule, calculation, frequency_hartree, energy, zero_point_energy)

    return hessian, reduced_mass, frequency_per_cm, zero_point_energy


def vibrational_perturbation_theory(frequency_hartree, energy, calculation,
                                    atomic_symbols, coordinates, molecule,
                                    displaced_energies, device="cuda"):
    """VPT1/VPT2 fundamental from 3rd/4th derivative stencils (tuna_freq.py:822-959)."""
    timer("Perturbative anharmonic frequency", 0)
    h = constants.THIRD_GEOM_DERIVATIVE_STEP
    log("\n Initialising vibrational perturbation theory..   \n", calculation)
    log_spacer(calculation)
    title = "VPT2" if calculation.second_order_vpt else "VPT1"
    log(f"              {title} Frequency Correction", calculation)
    log_spacer(calculation)
    log(f"  Using finite difference of {h} a.u.   \n", calculation)

    prod = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, h]])
    E_fb, E_b, E_f, E_ff = displaced_energies
    if E_fb is None or E_ff is None:
        # The analytic-Hessian branch of calculate_hessian only evaluates the
        # +/-h energies; VPT stencils need all four five-point energies, so the
        # caller must have passed allow_analytic=False.
        raise ValueError("VPT needs all four displaced energies; the Hessian "
                         "must be computed on the five-point path")

    extra = {}
    multiples = (-4, -3, 3, 4)
    batched = opt._batched_displaced_energies(
        coordinates, calculation, atomic_symbols, [m * h for m in multiples],
        silent=True, energies_only=True, device=device)
    if batched is not None:
        log("  Calculating 4 displaced energies in one sharded batch...     ",
            calculation, end="")
        extra = dict(zip(multiples, batched[0]))
        log("[Done]", calculation)
    else:
        for label, mult in (("1 of 4", -4), ("2 of 4", -3), ("3 of 4", 3), ("4 of 4", 4)):
            log(f"  Calculating displaced energy {label}...     ", calculation, end="")
            _, _, E, _ = energ.evaluate_molecular_energy(
                calculation, atomic_symbols, coordinates + mult * prod, silent=True,
                device=device)
            extra[mult] = E
            log("[Done]", calculation)

    d3E = third_derivative(extra[-4], extra[-3], E_fb, E_b, E_f, E_ff, extra[3], extra[4], h)
    d4E = fourth_derivative(extra[-4], extra[-3], E_fb, E_b, energy, E_f, E_ff,
                            extra[3], extra[4], h)

    third_term = -d3E**2 / (molecule.reduced_mass**3 * frequency_hartree**4)
    fourth_term = d4E / (molecule.reduced_mass**2 * frequency_hartree**2)
    if calculation.first_order_vpt:
        third_term = 0.0

    def level(n):
        E_n = frequency_hartree * (n + 0.5)
        E_n += (1 / 16) * fourth_term * (n**2 + n + 0.5)
        E_n += third_term * (15 / 144 * (n + 0.5)**2 + 7 / 576)
        return E_n

    anharmonicity = (5 / 48) * third_term + (1 / 16) * fourth_term
    chi = -anharmonicity / frequency_hartree
    zero_point_energy = level(0)
    fundamental = level(1) - level(0)
    first_overtone = level(2) - level(0)
    second_overtone = level(3) - level(0)

    log(f"\n  Anharmonicity constant:                {chi:10.5f}", calculation)
    log(f"  Anharmonicity parameter:               {anharmonicity:10.5f}", calculation, priority=3)
    log(f"\n  Zero-point energy:               {zero_point_energy:16.10f}", calculation)
    log(f"  Equilibrium energy:              {energy + zero_point_energy:16.10f}", calculation)
    log(f"\n  Fundamental frequency (per cm):        {fundamental * constants.PER_CM_IN_HARTREE:10.2f}", calculation)
    log(f"  First overtone (per cm):               {first_overtone * constants.PER_CM_IN_HARTREE:10.2f}", calculation)
    log(f"  Second overtone (per cm):              {second_overtone * constants.PER_CM_IN_HARTREE:10.2f}", calculation, priority=3)
    log_spacer(calculation)
    timer("Perturbative anharmonic frequency", 1)
    return fundamental, zero_point_energy

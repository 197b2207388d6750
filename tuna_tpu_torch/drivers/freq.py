"""Vibrational frequencies: harmonic (with IR intensity and thermochemistry),
VPT1/VPT2 perturbative anharmonicity, and fully anharmonic frequencies via a
scanned PES and grid nuclear Schrodinger equation.

Twin of tuna_tpu/drivers/freq.py; its stencils batch through
opt._batched_displaced_energies when more than one device is visible.  The
dipole derivative is seminumerical, or fully numerical (finite fields)
under DIPOLE.  Plotting the vibrational wavefunctions (VIBPLOT) is not
ported yet.  Every tensor lives on `device`.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate, linalg

from .. import constants, props
from ..containers import to_numpy
from ..output import error, log, log_big_spacer, log_spacer, timer, warning
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
                                P_forward, P_backward, calculation, step, device="cuda"):
    """Seminumerical, gauge-invariant dipole derivative in normal coordinates;
    fully numerical (finite fields at each displaced geometry) under DIPOLE."""
    timer("Dipole derivative", 0)
    prod = np.array([[0.0, 0.0, -molecule.masses[1] * step],
                     [0.0, 0.0, molecule.masses[0] * step]]) / molecule.total_mass
    forward_coords = coordinates + prod
    backward_coords = coordinates - prod

    if calculation.dipole:
        log(" Calculating fully numerical dipole derivative...     ", calculation, 1, end="")
        from . import electric
        mu_f = electric.calculate_numerical_dipole_moment(
            molecule, calculation, True, calculation.atomic_symbols,
            forward_coords, SCF_forward.integrals, device=device)
        mu_b = electric.calculate_numerical_dipole_moment(
            molecule, calculation, True, calculation.atomic_symbols,
            backward_coords, SCF_backward.integrals, device=device)
    else:
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
        calculation, hessian_step, device=device)
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


# ---------------------------------------------------------------------------
# Anharmonic frequencies via a scanned PES
# ---------------------------------------------------------------------------

def interpolate_function(F_raw, x_raw, n_grid_points):
    x = np.linspace(np.min(x_raw), np.max(x_raw), n_grid_points)
    return x, interpolate.interp1d(x_raw, F_raw, kind="cubic")(x)


def solve_nuclear_schroedinger(x_values, V_values, reduced_mass, scan_extent,
                               grid_density, dipole_moments, n_states=6):
    """Cubic-spline PES -> tridiagonal FD Hamiltonian -> lowest eigenstates."""
    n_grid = int(grid_density * scan_extent)
    x, V = interpolate_function(V_values, x_values, n_grid)
    _, dipoles = interpolate_function(dipole_moments, x_values, n_grid)

    dx = x[1] - x[0]
    T = 1 / (reduced_mass * dx**2)
    main_diag = T + V
    off_diag = np.full(len(V) - 1, -T / 2)
    levels, wavefunctions = linalg.eigh_tridiagonal(
        main_diag, off_diag, select="i", select_range=(0, n_states - 1))
    return levels, wavefunctions, dipoles, x, V


def calculate_anharmonic_frequency(calculation, atomic_symbols,
                                   harmonic_frequency_per_cm, molecule, device="cuda"):
    """Iteratively widen the scanned PES until the fundamental converges."""
    timer("Anharmonic frequency", 0)
    GRID_DENSITY = 1000
    SCAN_EXTENT = 0.35
    calculation.step = 0.05 if calculation.step is None else calculation.step
    transition_per_cm = 0.0

    log_spacer(calculation, 1, start="\n", space="")
    log(" Beginning anharmonic frequency calculation...", calculation, 1)
    log_spacer(calculation, 1, space="")
    log(f"\n Using a scan step length of {calculation.step} angstroms.\n", calculation, 1)

    log(" Calculating initial potential energy surface around minimum...  ",
        calculation, 1, end="")
    calculation.number_of_steps = int(SCAN_EXTENT / calculation.step) + 1
    coordinates = molecule.coordinates.copy()
    coordinates_right = molecule.coordinates.copy()
    coordinates_left = molecule.coordinates.copy()
    coordinates[1][2] -= constants.angstrom_to_bohr(SCAN_EXTENT) / 2

    x_values, V_values, dipole_moments = energ.scan_coordinate(
        calculation, atomic_symbols, coordinates, silent=True, device=device)
    log("[Done]\n", calculation, 1)

    calculation.number_of_steps = int(SCAN_EXTENT / calculation.step / 3) + 1

    log_big_spacer(calculation, 1)
    log("                                          Anharmonic Frequency", calculation, 1)
    log_big_spacer(calculation, 1)
    log("  Step       Fundamental Freq. (per cm)         Chi        Harmonic Freq. "
        "(per cm)     Bond Length Range", calculation, 1)
    log_big_spacer(calculation, 1)

    for iteration in range(30):
        transition_old = transition_per_cm
        scan_extent_bohr = max(x_values) - min(x_values)
        coordinates_right[1][2] = np.max(x_values)
        coordinates_left[1][2] = np.min(x_values)

        xr, Vr, dr = energ.scan_coordinate(calculation, atomic_symbols,
                                           coordinates_right, silent=True, device=device)
        xl, Vl, dl = energ.scan_coordinate(calculation, atomic_symbols,
                                           coordinates_left, silent=True, reverse=True,
                                           device=device)

        x_values = np.concatenate((np.array(xl[1:][::-1]), np.array(x_values), np.array(xr[1:])))
        V_values = np.concatenate((np.array(Vl[1:][::-1]), np.array(V_values), np.array(Vr[1:])))
        dipole_moments = np.concatenate((np.array(dl[1:][::-1]), np.array(dipole_moments),
                                         np.array(dr[1:])))

        levels, wavefunctions, dipoles, x, V = solve_nuclear_schroedinger(
            x_values, V_values, molecule.reduced_mass, scan_extent_bohr,
            GRID_DENSITY, dipole_moments)

        transition_matrix = np.abs(levels[:, None] - levels[None, :])
        transition_per_cm = transition_matrix[0][1] * constants.PER_CM_IN_HARTREE
        chi = ((transition_matrix[0][1] - transition_matrix[1][2])
               / (2 * harmonic_frequency_per_cm / constants.PER_CM_IN_HARTREE))

        log(f"    {iteration + 1}               {transition_per_cm:8.2f}          "
            f"       {chi:8.5f}             {harmonic_frequency_per_cm:8.2f}      "
            f"       {constants.bohr_to_angstrom(min(x_values)):.5f} - "
            f"{constants.bohr_to_angstrom(max(x_values)):.5f}", calculation, 1)

        if abs(transition_per_cm - transition_old) < calculation.anharm_convergence:
            log_big_spacer(calculation, 1)
            _process_anharmonic_output(calculation, wavefunctions, levels,
                                       transition_matrix, chi, dipoles, x, V, molecule)
            timer("Anharmonic frequency", 1)
            return levels

    error("Anharmonic frequency calculation did not converge!")


def _process_anharmonic_output(calculation, wavefunctions, levels,
                               transition_matrix, chi, dipoles, x, V, molecule):
    zero_point_energy = levels[0] - np.min(V)
    frequency_matrix = transition_matrix * constants.PER_CM_IN_HARTREE
    wavelength_matrix = 1e7 / np.where(frequency_matrix != 0, frequency_matrix, 1)

    log(f"\n Final fundamental frequency (per cm):  {frequency_matrix[0][1]:6.2f}", calculation, 1)
    log(f" Final anharmonicity constant:  {chi:7.5f}", calculation, 1)
    log(f"\n Zero-point energy:   {zero_point_energy:13.10f}", calculation, 1)
    log(f" Equilibrium energy:  {levels[0]:13.10f}", calculation, 1)

    dipole_matrix = np.einsum("ni,n,nj->ij", wavefunctions, dipoles, wavefunctions)
    intensity_matrix = calculate_transition_intensity(frequency_matrix, dipole_matrix)

    log_big_spacer(calculation, 1, start="\n")
    log("                                        Anharmonic Absorption Spectrum", calculation, 1)
    log_big_spacer(calculation, 1)
    log("  Transition         Energy          Frequency (per cm)       Wavelength (nm)"
        "     Intensity (km per mol)", calculation, 1)
    log_big_spacer(calculation, 1)
    for i in range(3):
        for j in range(i + 1, 4):
            log(f"    {i} -> {j}    {transition_matrix[i][j]:16.10f}    "
                f"{frequency_matrix[i][j]:16.2f}       {wavelength_matrix[i][j]:16.2f}"
                f"       {intensity_matrix[i][j]:16.2f}", calculation, 1)
    log_big_spacer(calculation, 1)

    if calculation.additional_print:
        thermo.calculate_thermochemical_corrections(
            molecule, calculation, transition_matrix[0][1], levels[0], zero_point_energy)

    if calculation.plot_vibrational_wavefunctions:
        from .. import plotting
        plotting.plot_vibrational_wavefunctions(
            calculation, constants.bohr_to_angstrom(x), V, levels, wavefunctions)

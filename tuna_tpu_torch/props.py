"""Molecular properties and analysis: multipole moments, Koopmans parameters,
energy decomposition, spin contamination, Mulliken/Lowdin/Mayer population
analysis, and molecular-orbital tables.

Capability parity with /root/reference/TUNA/tuna_props.py.
"""

from __future__ import annotations

import numpy as np

from . import constants
from .output import log, log_spacer, warning


# --- Multipole moments ------------------------------------------------------

def calculate_nuclear_dipole_moment(dipole_origin, charges, coordinates):
    return float(np.sum((np.asarray(coordinates)[:, 2] - dipole_origin) * np.asarray(charges)))


def calculate_nuclear_quadrupole_moment(quadrupole_origin, charges, coordinates):
    return float(np.sum((np.asarray(coordinates)[:, 2] - quadrupole_origin) ** 2 * np.asarray(charges)))


def calculate_analytical_dipole_moment(centre_of_mass, charges, coordinates, P, D):
    nuclear = calculate_nuclear_dipole_moment(centre_of_mass, charges, coordinates)
    electronic = -float(np.sum(np.asarray(P) * np.asarray(D[2])))
    return nuclear + electronic, nuclear, electronic


def calculate_analytical_quadrupole_moment(centre_of_mass, charges, coordinates, P, Q):
    nuclear = calculate_nuclear_quadrupole_moment(centre_of_mass, charges, coordinates)
    # Reference convention: Q[0] is the xx and Q[1] treated as zz component
    electronic_xx = -float(np.sum(np.asarray(P) * np.asarray(Q[0])))
    electronic_zz = -float(np.sum(np.asarray(P) * np.asarray(Q[1])))
    anisotropic = electronic_zz + nuclear - electronic_xx
    isotropic = (nuclear + electronic_zz + electronic_xx * 2) / 3
    return isotropic, nuclear, anisotropic


def calculate_and_print_multipole_moments(P, molecule, SCF_output, calculation):
    com = molecule.centre_of_mass
    log(f"\n Multipole moment origin is the centre of mass, "
        f"{constants.bohr_to_angstrom(com):.5f} angstroms from the first atom.",
        calculation, 2)

    total_d, nuc_d, elec_d = calculate_analytical_dipole_moment(
        com, molecule.charges, molecule.coordinates, P, SCF_output.D)
    iso_q, nuc_q, aniso_q = calculate_analytical_quadrupole_moment(
        com, molecule.charges, molecule.coordinates, P, SCF_output.Q)

    def diagram(value, pos, neg):
        if value > constants.MOMENT_THRESH:
            text = f"  {molecule.molecular_structure}  {pos}"
        elif value < -constants.MOMENT_THRESH:
            text = f"  {molecule.molecular_structure}  {neg}"
        else:
            text = f"      {molecule.molecular_structure}      "
        return text.center(25)

    d_diag = diagram(total_d, "+--->   ", "<---+   ")
    q_diag = diagram(iso_q, "+-> <-+   ", "<--+-->  ")

    bar = " " + "~" * 50 + "     " + "~" * 49
    log("\n" + bar, calculation, 2)
    log("                    Dipole Moment                                        Quadrupole Moment", calculation, 2)
    log(bar, calculation, 2)
    log(f"  Nuclear: {nuc_d:11.7f}     Electronic: {elec_d:11.7f}       "
        f"Nuclear: {nuc_q:11.7f}   Anisotropic: {aniso_q:11.7f}\n", calculation, 2)
    log(f"  Total: {total_d:11.7f}      {d_diag}      Isotropic: {iso_q:11.7f}  {q_diag}",
        calculation, 2)
    log(bar, calculation, 2)
    return total_d


# --- Koopmans parameters ----------------------------------------------------

def calculate_koopmans_parameters(epsilons, n_occ, calculation):
    epsilons = np.asarray(epsilons)
    ionisation_potential = -float(epsilons[n_occ - 1])
    if len(epsilons) > n_occ:
        electron_affinity = -float(epsilons[n_occ])
        band_gap = ionisation_potential - electron_affinity
        ea_str, gap_str = f"{electron_affinity:9.6f}", f"{band_gap:9.6f}"
    else:
        electron_affinity = band_gap = None
        ea_str = gap_str = " --------"
        warning("Size of basis is too small for electron affinity calculation!")
    log(f"\n Koopmans' theorem ionisation potential:  {ionisation_potential:9.6f}", calculation, 2)
    log(f" Koopmans' theorem electron affinity:     {ea_str}", calculation, 2)
    log(f" Energy gap between HOMO and LUMO:        {gap_str}", calculation, 2)
    return ionisation_potential, electron_affinity, band_gap


# --- Energy components ------------------------------------------------------

def print_energy_components(SCF_output, V_NN, calculation, silent=False):
    one_electron = (SCF_output.nuclear_electron_energy + SCF_output.kinetic_energy
                    + SCF_output.electric_field_energy
                    + SCF_output.electric_field_gradient_energy)
    two_electron = (SCF_output.exchange_energy + SCF_output.coulomb_energy
                    + SCF_output.correlation_energy)
    electronic = one_electron + two_electron
    total = electronic + V_NN
    virial_ratio = -(total - SCF_output.kinetic_energy) / SCF_output.kinetic_energy

    log_spacer(calculation, priority=2, silent=silent)
    log("                  Energy Components       ", calculation, 2, silent=silent)
    log_spacer(calculation, priority=2, silent=silent)
    log(f"  Kinetic energy:                   {SCF_output.kinetic_energy:15.10f}", calculation, 2, silent=silent)
    log(f"  Coulomb energy:                   {SCF_output.coulomb_energy:15.10f}", calculation, 2, silent=silent)
    log(f"  Exchange energy:                  {SCF_output.exchange_energy:15.10f}", calculation, 2, silent=silent)
    if calculation.method.density_functional_method:
        log(f"  Correlation energy:               {SCF_output.correlation_energy:15.10f}", calculation, 2, silent=silent)
    log(f"  Nuclear repulsion energy:         {V_NN:15.10f}", calculation, 2, silent=silent)
    log(f"  Nuclear attraction energy:        {SCF_output.nuclear_electron_energy:15.10f}", calculation, 2, silent=silent)
    if np.linalg.norm(calculation.electric_field) > 0:
        log(f"  Electric field energy:            {SCF_output.electric_field_energy:15.10f}", calculation, 2, silent=silent)
    if np.linalg.norm(calculation.electric_field_gradient) > 0:
        log(f"  Electric field gradient energy:   {SCF_output.electric_field_gradient_energy:15.10f}", calculation, 2, silent=silent)
    log(f"\n  One-electron energy:              {one_electron:15.10f}", calculation, 2, silent=silent)
    log(f"  Two-electron energy:              {two_electron:15.10f}", calculation, 2, silent=silent)
    if calculation.method.density_functional_method:
        log(f"  Exchange-correlation energy:      {SCF_output.exchange_correlation_energy:15.10f}", calculation, 2, silent=silent)
    log(f"  Electronic energy:                {electronic:15.10f}\n", calculation, 2, silent=silent)
    log(f"  Virial ratio:                     {virial_ratio:15.10f}\n", calculation, 2, silent=silent)
    log(f"  Total energy:                     {total:15.10f}", calculation, 2, silent=silent)
    log_spacer(calculation, priority=2, silent=silent)


# --- Spin contamination -----------------------------------------------------

def calculate_spin_contamination(P_alpha, P_beta, n_alpha, n_beta, S, calculation,
                                 kind, silent=False):
    s_squared_exact = (n_alpha - n_beta) / 2 * ((n_alpha - n_beta) / 2 + 1)
    P_alpha, P_beta, S = np.asarray(P_alpha), np.asarray(P_beta), np.asarray(S)
    spin_contamination = n_beta - float(np.trace(P_alpha.T @ S @ P_beta.T @ S))
    s_squared = s_squared_exact + spin_contamination

    priority = 2 if kind in ("UHF", "UKS") else 3
    if calculation.reference != "UHF":
        return s_squared, spin_contamination

    title = kind.title() if kind == "Coupled cluster" else kind
    space1, space2 = ("       ", "            ") if len(kind) == 3 else ("", "")
    log_spacer(calculation, silent=silent, priority=priority)
    log(f"   {space1}       {title} Spin Contamination       ", calculation, priority, silent=silent)
    log_spacer(calculation, silent=silent, priority=priority)
    log(f"  Exact S^2 expectation value:            {s_squared_exact:9.6f}", calculation, priority, silent=silent)
    log(f"  {kind} S^2 expectation value:  {space2}{s_squared:9.6f}", calculation, priority, silent=silent)
    log(f"\n  Spin contamination:                     {spin_contamination:9.6f}", calculation, priority, silent=silent)
    log_spacer(calculation, silent=silent, priority=priority)
    return s_squared, spin_contamination


# --- Population analysis ----------------------------------------------------

def calculate_population_analysis(P, S, R, partition_ranges, charges):
    """Mulliken, Lowdin and Mayer populations, charges, bond orders, valences."""
    P, S, R = np.asarray(P), np.asarray(S), np.asarray(R)
    PS = P @ S
    RS = R @ S
    S_vals, S_vecs = np.linalg.eigh(S)
    S_sqrt = (S_vecs * np.sqrt(S_vals)) @ S_vecs.T
    P_Lowdin = S_sqrt @ P @ S_sqrt

    A = slice(0, partition_ranges[0])
    B = slice(partition_ranges[0], partition_ranges[0] + partition_ranges[1])

    bond_order_Mayer = float(np.sum(PS[A, B] * PS[B, A].T + RS[A, B] * RS[B, A].T))
    bond_order_Lowdin = float(np.sum(P_Lowdin[A, B] ** 2))
    bond_order_Mulliken = 2 * float(np.sum(P[A, B] * S[A, B]))

    populations_Mulliken = np.array([np.trace(PS[A, A]), np.trace(PS[B, B])])
    populations_Lowdin = np.array([np.trace(P_Lowdin[A, A]), np.trace(P_Lowdin[B, B])])
    bonded = np.array([np.einsum("ij,ji->", PS[A, A], PS[A, A]),
                       np.einsum("ij,ji->", PS[B, B], PS[B, B])])

    charges_Mulliken = np.asarray(charges) - populations_Mulliken
    charges_Lowdin = np.asarray(charges) - populations_Lowdin
    total_valences = 2 * populations_Mulliken - bonded
    free_valences = total_valences - bond_order_Mayer

    return {
        "charges_Mulliken": charges_Mulliken,
        "charges_Lowdin": charges_Lowdin,
        "bond_order_Mulliken": bond_order_Mulliken,
        "bond_order_Lowdin": bond_order_Lowdin,
        "bond_order_Mayer": bond_order_Mayer,
        "total_valences": total_valences,
        "free_valences": free_valences,
        "populations_Mulliken": populations_Mulliken,
        "populations_Lowdin": populations_Lowdin,
    }


def print_population_analysis(P, S, R, partition_ranges, atomic_symbols, charges,
                              calculation):
    res = calculate_population_analysis(P, S, R, partition_ranges, charges)
    atoms_formatted = []
    for symbol in atomic_symbols:
        symbol = symbol.lower().capitalize()
        atoms_formatted.append(symbol + "  :" if len(symbol) == 1 else symbol + " :")

    bar = ("\n " + "~" * 26 + "     " + "~" * 26 + "     " + "~" * 42)
    log(bar, calculation, 2)
    log("      Mulliken Charges                Lowdin Charges                Mayer Free, Bonded, Total Valence", calculation, 2)
    log(bar.strip("\n"), calculation, 2)
    for i in range(2):
        log(f"  {atoms_formatted[i]} {res['charges_Mulliken'][i]:8.5f}                  "
            f"{atoms_formatted[i]} {res['charges_Lowdin'][i]:8.5f}                  "
            f"{atoms_formatted[i]} {res['free_valences'][i]:8.5f},  "
            f"{res['bond_order_Mayer']:8.5f},  {res['total_valences'][i]:8.5f}",
            calculation, 2)
    log(f"\n  Sum of charges: {np.sum(res['charges_Mulliken']):8.5f}       "
        f"Sum of charges: {np.sum(res['charges_Lowdin']):8.5f}", calculation, 2)
    log(f"  Bond order: {res['bond_order_Mulliken']:8.5f}           "
        f"Bond order: {res['bond_order_Lowdin']:8.5f}           "
        f"Bond order: {res['bond_order_Mayer']:8.5f}", calculation, 2)
    log(bar.strip("\n"), calculation, 2)
    return res


# --- Molecular orbital tables -----------------------------------------------

def print_molecular_orbital_eigenvalues(calculation, epsilons, occupancies, spin_labels):
    log_spacer(calculation, priority=2, start="\n")
    log("     Molecular Orbital Eigenvalues", calculation, 2)
    log_spacer(calculation, priority=2)
    log("   N     Occ    Spin       Epsilon ", calculation, 2)
    log_spacer(calculation, priority=2)
    for i, (eps, occ, spin) in enumerate(zip(np.asarray(epsilons), occupancies, spin_labels)):
        log(f"  {i + 1:2}      {occ}      {spin}     {eps:13.8f}", calculation, 2)
    log_spacer(calculation, priority=2)


_SHELL_COMPONENTS_SPHERICAL = {
    "s": [""], "p": ["x", "y", "z"], "d": ["xy", "xz", "yz", "xxyy", "zz"],
    "f": ["-3", "-2", "-1", "0", "+1", "+2", "+3"],
    "g": ["-4", "-3", "-2", "-1", "0", "+1", "+2", "+3", "+4"],
    "h": ["-5", "-4", "-3", "-2", "-1", "0", "+1", "+2", "+3", "+4", "+5"],
}
_SHELL_COMPONENTS_CARTESIAN = {
    "s": [""], "p": ["x", "y", "z"],
    "d": ["xx", "xy", "xz", "yy", "yz", "zz"],
    "f": ["xxx", "xxy", "xxz", "xyy", "xyz", "xzz", "yyy", "yyz", "yzz", "zzz"],
    "g": [f"c{i}" for i in range(1, 16)],
    "h": [f"c{i}" for i in range(1, 22)],
}
_CARTESIAN_CAPACITY = {"s": 1, "p": 3, "d": 6, "f": 10, "g": 15, "h": 21}
_STARTING_N = {"s": 1, "p": 2, "d": 3, "f": 4, "g": 5, "h": 6}


def _ao_labels(molecule, calculation):
    """Per-AO labels like "2px", "3dz" by walking the shell structure."""
    components = (_SHELL_COMPONENTS_CARTESIAN if calculation.cartesian_harmonics
                  else _SHELL_COMPONENTS_SPHERICAL)
    labels = []
    current_n = dict(_STARTING_N)
    atom_1_cutoff = molecule.partition_ranges[0]
    i = 0
    while i < len(molecule.angular_momentum_list):
        if len(labels) == atom_1_cutoff:
            current_n = dict(_STARTING_N)
        letter = molecule.angular_momentum_list[i]
        n = current_n[letter]
        for comp in components[letter]:
            labels.append(f"{n}{letter}{comp}")
        i += _CARTESIAN_CAPACITY[letter]
        current_n[letter] += 1
    return labels


def print_molecular_orbital_coefficients(molecule, calculation, SCF_output,
                                         occupancies, spin_labels,
                                         natural_orbitals=None,
                                         natural_occupancies=None):
    """MO (or natural-orbital) coefficient tables with orbital-type labels
    (parity: tuna_props.py:534-804; served by the PRINTMOS keyword)."""
    do_natorbs = natural_orbitals is not None
    priority = 1 if calculation.print_molecular_orbitals else 3
    orbitals = np.asarray(natural_orbitals if do_natorbs
                          else SCF_output.molecular_orbitals)
    energies = np.asarray(SCF_output.epsilons)

    title = ("Natural Orbital Coefficients" if do_natorbs
             else "Molecular Orbital Coefficients")
    log_spacer(calculation, priority=priority, start="\n")
    log(f"          {title}", calculation, priority)
    log_spacer(calculation, priority=priority)

    labels = _ao_labels(molecule, calculation)
    cut = molecule.partition_ranges[0]
    atom_labels = [(molecule.atoms[min(1, 1 if ao >= cut else 0)].symbol_formatted
                    if molecule.n_atoms > 1 and ao >= cut
                    else molecule.atoms[0].symbol_formatted, labels[ao])
                   for ao in range(len(labels))]
    n_print = min(orbitals.shape[1], calculation.n_orbitals_to_print)
    kind = "NO" if do_natorbs else "MO"

    for mo in range(n_print):
        if do_natorbs:
            header = f"\n  {kind} {mo + 1:<3}   N = {natural_occupancies[mo]:14.10f}"
        else:
            occ = "Occupied" if occupancies[mo] in (1, 2) else "Virtual"
            spin = (f"  ({'alpha' if spin_labels[mo] == 'a' else 'beta'})"
                    if calculation.reference == "UHF" and spin_labels[mo] in ("a", "b")
                    else "")
            header = (f"\n  {kind} {mo + 1:<3} {occ}{spin}"
                      f"   E = {energies[mo]:14.10f}")
        log(header, calculation, priority)
        for ao in range(orbitals.shape[0]):
            coeff = orbitals[ao, mo]
            if abs(coeff) < 1e-8:
                continue
            atom, label = atom_labels[ao]
            log(f"    {atom:<3} {label:<7}: {coeff:11.5f}", calculation, priority)
    log("", calculation, priority)
    log_spacer(calculation, priority=priority)


def calculate_molecular_properties(molecule, calculation, P, S, SCF_output,
                                   P_alpha=None, P_beta=None, natural_orbitals=None,
                                   natural_occupancies=None, print_orbitals=True):
    """Post-SCF property driver: multipoles, Koopmans, populations, MO tables."""
    if calculation.reference == "UHF":
        epsilons = SCF_output.epsilons_combined
        n_occ = molecule.n_occ
    else:
        epsilons = SCF_output.epsilons
        n_occ = molecule.n_doubly_occ

    if print_orbitals:
        if calculation.reference == "UHF":
            eps_a = np.asarray(SCF_output.epsilons_alpha)
            eps_b = np.asarray(SCF_output.epsilons_beta)
            combined = np.concatenate([eps_a, eps_b])
            labels = ["a"] * len(eps_a) + ["b"] * len(eps_b)
            occs = ([1 if i < molecule.n_alpha else 0 for i in range(len(eps_a))]
                    + [1 if i < molecule.n_beta else 0 for i in range(len(eps_b))])
            order = np.argsort(combined)
            print_molecular_orbital_eigenvalues(
                calculation, combined[order],
                [occs[k] for k in order], [labels[k] for k in order])
        else:
            occs = [2 if i < n_occ else 0 for i in range(len(np.asarray(epsilons)))]
            order = np.arange(len(occs))
            labels = ["-"] * len(occs)
            print_molecular_orbital_eigenvalues(
                calculation, epsilons, occs, labels)

        sorted_occs = [(occs[k] if calculation.reference != "UHF" else occs[k])
                       for k in order]
        sorted_labels = [labels[k] for k in order]
        print_molecular_orbital_coefficients(
            molecule, calculation, SCF_output, sorted_occs, sorted_labels,
            natural_orbitals=natural_orbitals,
            natural_occupancies=natural_occupancies)

    calculate_koopmans_parameters(np.sort(np.asarray(epsilons)), n_occ, calculation)

    if molecule.n_atoms == 2 and not molecule.ghost_atom_present:
        R_spin = (np.asarray(P_alpha) - np.asarray(P_beta)
                  if P_alpha is not None else np.zeros_like(np.asarray(P)))
        print_population_analysis(P, S, R_spin, molecule.partition_ranges,
                                  molecule.atomic_symbols, molecule.charges,
                                  calculation)

    calculate_and_print_multipole_moments(P, molecule, SCF_output, calculation)

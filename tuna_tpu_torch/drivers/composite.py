"""Composite calculation types: ionisation potential, electron affinity and
counterpoise-corrected bond dissociation energy.

Twin of tuna_tpu/drivers/composite.py, which uses no JAX: the same code,
with the `device` of every energy, optimisation and frequency passed down.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..output import log, log_spacer, timer
from . import energy as energ
from .opt import optimise_geometry


def calculate_charged_state_energies(calculation, atomic_symbols, coordinates,
                                     charge_delta, device="cuda"):
    """Vertical (or adiabatic) reference and charged-state energies."""
    if calculation.vertical or calculation.monatomic:
        log_spacer(calculation, start="\n", space="")
        log("Calculating energy of original system...", calculation)
        log_spacer(calculation, space="")
        method = calculation.method
        reference_SCF, reference_molecule, reference_energy, _ = \
            energ.evaluate_molecular_energy(calculation, atomic_symbols, coordinates, device=device)

        calculation.charge += charge_delta * calculation.n_electrons_for_ip_or_ea
        log_spacer(calculation, start="\n", space="")
        log("Calculating energy of charged system...", calculation)
        log_spacer(calculation, space="")
        calculation.method = method
        _, charged_molecule, charged_energy, _ = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates,
            integrals=reference_SCF.integrals, device=device)
    else:
        log_spacer(calculation, start="\n", space="")
        log("Optimising energy of original molecule...", calculation)
        log_spacer(calculation, space="")
        method = calculation.method
        reference_molecule, reference_energy = optimise_geometry(
            calculation, atomic_symbols, coordinates, device=device)

        calculation.charge += charge_delta * calculation.n_electrons_for_ip_or_ea
        log_spacer(calculation, start="\n", space="")
        log("Optimising energy of charged molecule...", calculation)
        log_spacer(calculation, space="")
        calculation.method = method
        charged_molecule, charged_energy = optimise_geometry(
            calculation, atomic_symbols, reference_molecule.coordinates, device=device)

    return reference_energy, charged_energy, reference_molecule, charged_molecule


def run_charge_change(calculation, atomic_symbols, coordinates, charge_delta, device="cuda"):
    """IP (+1) or EA (-1) driver with summary printing."""
    reference_energy, charged_energy, reference_molecule, charged_molecule = \
        calculate_charged_state_energies(calculation, atomic_symbols, coordinates,
                                         charge_delta, device=device)

    delta_E = charged_energy - reference_energy
    if charge_delta < 0:
        delta_E = -delta_E  # EA = E(neutral) - E(anion)
    kind = "Ionisation potential" if charge_delta > 0 else "Electron affinity"
    adiabatic = "" if (calculation.vertical or calculation.monatomic) else "adiabatic "

    log_spacer(calculation, start="\n")
    log(f"              {kind}", calculation, 1)
    log_spacer(calculation)
    log(f"  Energy of original system:        {reference_energy:16.10f}", calculation, 1)
    log(f"  Energy of charged system:         {charged_energy:16.10f}", calculation, 1)
    log(f"\n  {adiabatic.capitalize()}{kind.lower()}:".ljust(36)
        + f"{delta_E:15.10f}", calculation, 1)
    log(f"  In electron-volts:                {delta_E * constants.EV_IN_HARTREE:16.10f}",
        calculation, 1)
    log_spacer(calculation)
    return delta_E


def calculate_bond_dissociation_energy(calculation, atomic_symbols, coordinates, device="cuda"):
    """Counterpoise-corrected BDE with optional ZPE (tuna_opt.py:575-648)."""
    timer("Bond dissociation energy", 0)

    optimised_molecule, optimised_energy = optimise_geometry(
        calculation, atomic_symbols, coordinates, device=device)

    zero_point_energy = 0.0
    if calculation.do_ZPE_correction:
        from . import freq
        _, _, _, zero_point_energy = freq.calculate_harmonic_frequency(
            calculation, molecule=optimised_molecule, energy=optimised_energy, device=device)

    log_spacer(calculation, start="\n", space="")
    if calculation.no_counterpoise_correction:
        log("Calculating energy on atoms", calculation)
    else:
        log("Calculating counterpoise-corrected atomic energies...", calculation)
    log_spacer(calculation, space="")

    if calculation.no_counterpoise_correction:
        atomic_coordinates = np.array([[0.0, 0.0, 0.0]])
    else:
        atomic_coordinates = np.array([[0.0, 0.0, 0.0],
                                       [0.0, 0.0, optimised_molecule.bond_length]])

    # SAD/SCF guesses don't work with ghost atoms
    calculation.monatomic, calculation.diatomic, calculation.core_guess = True, False, True
    original_symbols = atomic_symbols

    symbols_1 = ([original_symbols[0]] if calculation.no_counterpoise_correction
                 else [original_symbols[0], "X" + original_symbols[1]])
    _, _, first_atom_energy, _ = energ.evaluate_molecular_energy(
        calculation, symbols_1, atomic_coordinates, device=device)

    if optimised_molecule.heteronuclear:
        symbols_2 = ([original_symbols[1]] if calculation.no_counterpoise_correction
                     else [original_symbols[1], "X" + original_symbols[0]])
        _, _, second_atom_energy, _ = energ.evaluate_molecular_energy(
            calculation, symbols_2, atomic_coordinates, device=device)
    else:
        second_atom_energy = first_atom_energy

    dissociation_energy = first_atom_energy + second_atom_energy - optimised_energy
    corrected = dissociation_energy - zero_point_energy

    log_spacer(calculation, start="\n")
    log("           Bond Dissociation Energy", calculation, 1)
    log_spacer(calculation)
    log(f"  Energy of optimised molecule:     {optimised_energy:16.10f}", calculation, 1)
    log(f"  Energy of first atom:             {first_atom_energy:16.10f}", calculation, 1)
    log(f"  Energy of second atom:            {second_atom_energy:16.10f}", calculation, 1)
    if calculation.do_ZPE_correction:
        log(f"  Zero-point energy:                {zero_point_energy:16.10f}", calculation, 1)
    log(f"\n  Bond dissociation energy:         {corrected:16.10f}", calculation, 1)
    log(f"  In electron-volts:                {corrected * constants.EV_IN_HARTREE:16.10f}",
        calculation, 1)
    log_spacer(calculation)
    timer("Bond dissociation energy", 1)
    return corrected

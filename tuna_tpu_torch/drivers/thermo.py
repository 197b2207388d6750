"""Thermochemistry: translational/rotational/vibrational/electronic internal
energies and entropies, ZPE, enthalpy and Gibbs free energy at TEMP/PRES.

Capability parity with /root/reference/TUNA/tuna_thermo.py.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..output import log

k = constants.K_AU
h = constants.H_AU
c = constants.C_AU


def translational_internal_energy(temperature):
    return 1.5 * k * temperature


def rotational_internal_energy(temperature):
    return k * temperature


def vibrational_temperature(vibrational_frequency):
    return vibrational_frequency / k


def vibrational_internal_energy(vibrational_frequency, temperature):
    theta = vibrational_temperature(vibrational_frequency)
    with np.errstate(divide="ignore", over="ignore"):
        return k * theta / (np.exp(theta / temperature) - 1)


def translational_entropy(temperature, pressure, mass):
    pressure_au = pressure / constants.PASCAL_IN_AU
    return k * (2.5 + np.log(np.sqrt(mass * k * temperature / h) ** 3
                             * (k * temperature / pressure_au)))


def rotational_entropy(point_group, temperature, rotational_constant_per_m):
    rotational_constant_per_bohr = constants.bohr_to_angstrom(rotational_constant_per_m) * 1e-10
    symmetry_number = 2 if point_group == "Dinfh" else 1
    return k * float(1 + np.log(k * temperature
                                / (symmetry_number * rotational_constant_per_bohr * h * c)))


def vibrational_entropy(vibrational_frequency, temperature):
    theta = vibrational_temperature(vibrational_frequency)
    with np.errstate(divide="ignore", over="ignore"):
        return k * (theta / (temperature * (np.exp(theta / temperature) - 1))
                    - np.log(1 - np.exp(-theta / temperature)))


def electronic_entropy(multiplicity):
    return k * np.log(multiplicity)


def calculate_thermochemical_corrections(molecule, calculation,
                                         vibrational_frequency, energy,
                                         zero_point_energy):
    """Full thermochemistry table; returns the Gibbs free energy."""
    temperature = calculation.temperature
    pressure = calculation.pressure
    point_group = molecule.point_group

    log(f"\n Temperature used is {temperature:.2f} K, pressure used is "
        f"{pressure:.0f} Pa.", calculation, 2)
    log("\n Entropies multiplied by temperature to give units of energy.", calculation, 2)
    log(f" Using symmetry number derived from {point_group} point group for "
        "rotational entropy.", calculation, 2)

    if temperature == 0:
        # Everything thermal vanishes at 0 K
        U_trans = U_rot = U_vib = 0.0
        S_trans = S_rot = S_vib = S_elec = S = 0.0
        internal = energy + zero_point_energy
        H = internal
        G = H
    else:
        U_trans = translational_internal_energy(temperature)
        U_rot = rotational_internal_energy(temperature)
        U_vib = (vibrational_internal_energy(vibrational_frequency, temperature)
                 if zero_point_energy != 0 else 0.0)
        internal = energy + zero_point_energy + U_trans + U_rot + U_vib
        H = internal + k * temperature
        S_trans = translational_entropy(temperature, pressure, molecule.total_mass)
        S_rot = rotational_entropy(point_group, temperature,
                                   molecule.rotational_constant_per_cm * 100)
        S_vib = (vibrational_entropy(vibrational_frequency, temperature)
                 if zero_point_energy != 0 else 0.0)
        S_elec = electronic_entropy(molecule.multiplicity)
        S = S_trans + S_rot + S_vib + S_elec
        G = H - temperature * S

    bar = " " + "~" * 82
    log("\n" + bar, calculation, 2)
    log("                                   Thermochemistry", calculation, 2)
    log(bar, calculation, 2)
    log(f"  Electronic energy:   {energy:16.10f}     Electronic entropy:   {temperature * S_elec:16.10f}", calculation, 2)
    log(f"\n  Translational energy:{U_trans:16.10f}     Translational entropy:{temperature * S_trans:16.10f}", calculation, 2)
    log(f"  Rotational energy:   {U_rot:16.10f}     Rotational entropy:   {temperature * S_rot:16.10f}", calculation, 2)
    log(f"  Vibrational energy:  {U_vib:16.10f}     Vibrational entropy:  {temperature * S_vib:16.10f}  ", calculation, 2)
    log(f"  Zero-point energy:   {zero_point_energy:16.10f}", calculation, 2)
    log(f"\n  Internal energy:     {internal:16.10f}", calculation, 2)
    log(f"  Enthalpy:            {H:16.10f}     Entropy:              {temperature * S:16.10f}", calculation, 2)
    log(f"\n  Gibbs free energy:   {G:16.10f}     Non-electronic energy:{energy - G:16.10f}", calculation, 2)
    log(bar, calculation, 2)
    return G

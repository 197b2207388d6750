"""Ab initio molecular dynamics: NVE velocity-Verlet with Maxwell-Boltzmann
initial velocities, z-axis realignment each step (keeping the integral
engine's diatomic symmetry valid) and MOREAD density carrying.

Twin of tuna_tpu/drivers/md.py (reference: tuna_md.py), with every tensor
on `device`.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..output import log, log_big_spacer
from . import energy as energ
from . import opt


def calculate_accelerations(forces, masses):
    return forces / masses[:, None]


def calculate_kinetic_energy(masses, velocities):
    return 0.5 * float(np.einsum("i,ij->", masses, velocities**2))


def calculate_temperature(masses, velocities, degrees_of_freedom):
    return 2 * calculate_kinetic_energy(masses, velocities) / (degrees_of_freedom * constants.K_AU)


def calculate_initial_velocities(masses, requested_temperature, degrees_of_freedom):
    velocities = np.sqrt(constants.K_AU * requested_temperature / masses)[:, None] \
        * np.random.normal(0, 1, (2, 3))
    if requested_temperature > 0:
        linear_momentum = np.einsum("i,ij->j", masses, velocities)
        velocities -= linear_momentum / np.sum(masses)
        temperature = calculate_temperature(masses, velocities, degrees_of_freedom)
        velocities *= np.sqrt(requested_temperature / temperature)
    return velocities


def calculate_forces(coordinates, calculation, atomic_symbols, rotation_matrix,
                     molecule=None, SCF_output=None, device="cuda"):
    """Force along the bond, rotated back to the lab frame (analytic when a
    converged restricted SCF state is supplied, finite differences
    otherwise)."""
    force = opt.calculate_gradient(coordinates, calculation, atomic_symbols,
                                   silent=True, molecule=molecule,
                                   SCF_output=SCF_output, device=device)
    force_3D = np.array([0.0, 0.0, force]) @ rotation_matrix
    return np.array([force_3D, -force_3D])


def rotate_coordinates_to_z_axis(difference_vector):
    """Rodrigues rotation aligning the bond vector with z."""
    normalised = difference_vector / np.linalg.norm(difference_vector)
    z_axis = np.array([0.0, 0.0, 1.0])
    rotation_axis = np.cross(normalised, z_axis)
    axis_norm = np.linalg.norm(rotation_axis)
    if axis_norm < 1e-10:
        rotation_matrix = np.eye(3)
    else:
        rotation_axis = rotation_axis / axis_norm
        cos_theta = np.dot(normalised, z_axis)
        K = np.array([[0.0, -rotation_axis[2], rotation_axis[1]],
                      [rotation_axis[2], 0.0, -rotation_axis[0]],
                      [-rotation_axis[1], rotation_axis[0], 0.0]])
        rotation_matrix = np.eye(3) + axis_norm * K + (1 - cos_theta) * (K @ K)
    return rotation_matrix @ difference_vector, rotation_matrix


def _print_step(time, iteration, masses, velocities, starting_energy,
                degrees_of_freedom, electronic_energy, calculation, molecule):
    kinetic = calculate_kinetic_energy(masses, velocities)
    total = kinetic + electronic_energy
    temperature = calculate_temperature(masses, velocities, degrees_of_freedom)
    drift = total - starting_energy
    log(f" {iteration + 1:4.0f}    {time:5.2f}     "
        f"{constants.bohr_to_angstrom(molecule.bond_length):.4f}    "
        f"{temperature:10.2f}     {electronic_energy:12.6f}   {kinetic:12.6f}     "
        f"{total:12.6f}   {drift:12.6f}", calculation, 1)


def run_molecular_dynamics_simulation(calculation, atomic_symbols, coordinates,
                                      device="cuda"):
    """NVE Born-Oppenheimer MD (tuna_md.py:316-439); returns the electronic
    energy of every step."""
    time = 0.0
    degrees_of_freedom = 5  # linear molecule
    timestep_fs = calculation.step if calculation.step is not None else 0.1
    timestep_au = timestep_fs / constants.ATOMIC_TIME_IN_FS
    coordinates = np.array(coordinates, dtype=np.float64)

    log(f"\nBeginning TUNA molecular dynamics calculation with "
        f"{calculation.number_of_steps} steps in the NVE ensemble...\n", calculation, 1)
    log(f"Using timestep of {timestep_fs:.3f} femtoseconds and initial temperature "
        f"of {calculation.temperature:.2f} K.", calculation, 1)
    if calculation.trajectory:
        log(f'Printing trajectory data to "{calculation.trajectory_path}".', calculation, 1)
        open(calculation.trajectory_path, "w").close()

    log_big_spacer(calculation, start="\n")
    log("                                  Ab Initio Molecular Dynamics Simulation",
        calculation, 1)
    log_big_spacer(calculation)
    log("  Step    Time    Distance    Temperature    Pot. Energy     Kin. Energy"
        "        Energy          Drift", calculation, 1)
    log_big_spacer(calculation)

    SCF_output, molecule, electronic_energy, _ = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates, silent=True, device=device)
    masses = molecule.masses

    forces = calculate_forces(coordinates, calculation, atomic_symbols, np.eye(3),
                              molecule=molecule, SCF_output=SCF_output, device=device)
    accelerations = calculate_accelerations(forces, masses)
    velocities = calculate_initial_velocities(masses, calculation.temperature,
                                              degrees_of_freedom)
    initial_energy = electronic_energy + calculate_kinetic_energy(masses, velocities)
    _print_step(0, 1, masses, velocities, initial_energy, degrees_of_freedom,
                electronic_energy, calculation, molecule)

    P_guess = P_guess_alpha = P_guess_beta = E_guess = None
    energies = [electronic_energy]

    for iteration in range(1, calculation.number_of_steps):
        coordinates = coordinates + velocities * timestep_au \
            + 0.5 * accelerations * timestep_au**2

        if calculation.MO_read:
            P_guess = SCF_output.P
            P_guess_alpha = SCF_output.P_alpha
            P_guess_beta = SCF_output.P_beta
            E_guess = SCF_output.energy

        difference_vector = coordinates[0] - coordinates[1]
        difference_rotated, rotation_matrix = rotate_coordinates_to_z_axis(difference_vector)
        aligned_coordinates = np.array([[0.0, 0.0, 0.0], -difference_rotated])

        SCF_output, molecule, electronic_energy, _ = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, aligned_coordinates, P_guess=P_guess,
            E_guess=E_guess, P_guess_alpha=P_guess_alpha, P_guess_beta=P_guess_beta,
            silent=not calculation.additional_print, device=device)

        forces = calculate_forces(aligned_coordinates, calculation, atomic_symbols,
                                  rotation_matrix, molecule=molecule,
                                  SCF_output=SCF_output, device=device)
        accelerations_new = calculate_accelerations(forces, masses)
        velocities = velocities + 0.5 * timestep_au * (accelerations + accelerations_new)
        accelerations = accelerations_new
        time += timestep_fs
        energies.append(electronic_energy)

        _print_step(time, iteration, masses, velocities, initial_energy,
                    degrees_of_freedom, electronic_energy, calculation, molecule)

        if calculation.trajectory:
            from .. import plotting
            plotting.save_trajectory_to_file(molecule, electronic_energy,
                                             coordinates, calculation.trajectory_path)

    log_big_spacer(calculation)
    return energies

"""Finite-field electric properties: numerical dipole, quadrupole,
polarisability and hyperpolarisability.

Twin of tuna_tpu/drivers/electric.py, which uses no JAX: the same code, with
the `device` of every energy passed down.  With more than one device
visible, a stencil's field displacements are solved in one batch
(`_prefetch_field_energies`, parallel.field_energies_parallel); otherwise
they walk serially, and the integrals object is reused across all field
displacements (only the field contraction changes).
"""

from __future__ import annotations

import numpy as np

from .. import constants, props
from ..output import log, log_spacer, timer
from ..stencils import first_derivative, second_derivative, third_derivative


def _energy_at_field(calculation, atomic_symbols, coordinates, integrals, field,
                     device="cuda"):
    from .energy import evaluate_molecular_energy
    calculation.electric_field = field
    _, _, E, _ = evaluate_molecular_energy(calculation, atomic_symbols,
                                           coordinates, silent=True,
                                           integrals=integrals, device=device)
    return E


def _energy_at_gradient(calculation, atomic_symbols, coordinates, integrals, grad,
                        device="cuda"):
    from .energy import evaluate_molecular_energy
    calculation.electric_field_gradient = grad
    _, _, E, _ = evaluate_molecular_energy(calculation, atomic_symbols,
                                           coordinates, silent=True,
                                           integrals=integrals, device=device)
    return E


def _prefetch_field_energies(calculation, atomic_symbols, coordinates,
                             fields=None, gradients=None, device="cuda"):
    """The energies of every field displacement of a stencil, in the order
    of `fields` or `gradients`, from one batch over the devices like
    `device` (parallel.field_energies_parallel) when more than one device
    is visible and the method batches: mean-field HF and Kohn-Sham, and,
    at zero base field, restricted MP2 and CC/CI.  None when the stencil
    must walk serially: one device, another method, or a batch that did
    not converge (the reference always walks serially,
    tuna_energy.py:315-759)."""
    from .. import parallel
    batchable = (parallel.mean_field_batchable(calculation, atomic_symbols, fields_free=False)
                 or parallel.mp2_scan_batchable(calculation, atomic_symbols)
                 or parallel.cc_scan_batchable(calculation, atomic_symbols))
    if parallel.device_count() <= 1 or not batchable:
        return None
    # the axis not being displaced keeps its user-applied base value
    n = len(fields) if fields is not None else len(gradients)
    if fields is None:
        fields = [calculation.electric_field] * n
    if gradients is None:
        gradients = [calculation.electric_field_gradient] * n
    energies, converged = parallel.field_energies_parallel(
        calculation, atomic_symbols, coordinates, fields, gradients,
        parallel.devices_like(device))
    if not converged.all():
        log(" Sharded field stencil did not fully converge; falling back to the serial "
            "walk.", calculation, 1)
        return None
    return [float(E) for E in energies]


def calculate_polarisability(molecule, calculation, energy, silent, atomic_symbols,
                             coordinates, integrals, device="cuda"):
    timer("Polarisability", 0)
    original = calculation.electric_field.copy()
    h = constants.SECOND_ELEC_DERIVATIVE_STEP
    field_x = np.array([h, 0.0, 0.0])
    field_z = np.array([0.0, 0.0, h])

    log("\n Beginning dipole-dipole polarisability calculation... ", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent, start="\n")
    log("                    Polarisability", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    log(f"  Using a finite field magnitude of {h:.5f} au.", calculation, 1, silent=silent)

    stencil_fields = [original + field_z * 2, original + field_z,
                      original - field_z, original - field_z * 2,
                      original + field_x * 2, original + field_x,
                      original - field_x, original - field_x * 2]
    batch = _prefetch_field_energies(calculation, atomic_symbols, coordinates,
                                     fields=stencil_fields, device=device)

    def second_field_derivative(field, batch_offset):
        if batch is not None:
            E_ff, E_f, E_b, E_bb = batch[batch_offset:batch_offset + 4]
        else:
            E_ff = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original + field * 2, device=device)
            E_f = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original + field, device=device)
            E_b = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original - field, device=device)
            E_bb = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original - field * 2, device=device)
        return -second_derivative(E_bb, E_b, energy, E_f, E_ff, h), E_b, E_f

    log("\n  Calculating parallel derivative...         ", calculation, 1, silent=silent, end="")
    alpha_parallel, E_b_par, E_f_par = second_field_derivative(field_z, 0)
    electronic_dipole = -first_derivative(E_b_par, E_f_par, h)
    log("[Done]", calculation, 1, silent=silent)

    log("  Calculating perpendicular derivative...    ", calculation, 1, silent=silent, end="")
    alpha_perpendicular, _, _ = second_field_derivative(field_x, 4)
    log("[Done]", calculation, 1, silent=silent)

    calculation.electric_field = original

    anisotropic = alpha_parallel - alpha_perpendicular
    isotropic = (alpha_perpendicular * 2 + alpha_parallel) / 3
    nuclear_dipole = props.calculate_nuclear_dipole_moment(
        molecule.centre_of_mass, molecule.charges, coordinates)
    total_dipole = electronic_dipole + nuclear_dipole

    log(f"\n  Dipole moment:                         {total_dipole:10.4f}", calculation, 1, silent=silent)
    log(f"\n  Parallel component:                    {alpha_parallel:10.4f}", calculation, 3, silent=silent)
    log(f"  Perpendicular component:               {alpha_perpendicular:10.4f}", calculation, 3, silent=silent)
    log(f"\n  Ansotropic polarisability:             {anisotropic:10.4f}", calculation, 1, silent=silent)
    log(f"  Isotropic polarisability:              {isotropic:10.4f}", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    timer("Polarisability", 1)
    return isotropic


def calculate_hyperpolarisability(molecule, calculation, silent, atomic_symbols,
                                  coordinates, integrals, device="cuda"):
    timer("Hyperpolarisability", 0)
    original = calculation.electric_field.copy()
    h = constants.THIRD_ELEC_DERIVATIVE_STEP
    field_x = np.array([h, 0.0, 0.0])
    field_z = np.array([0.0, 0.0, h])

    log("\n Beginning dipole-dipole-dipole hyperpolarisability calculation... ",
        calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent, start="\n")
    log("                 Hyperpolarisability", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    log(f"  Using a finite field magnitude of {h:.5f} au.", calculation, 1, silent=silent)

    log("\n  Calculating parallel derivative...         ", calculation, 1, silent=silent, end="")

    multiples = [1, 2, 3, 4, -1, -2, -3, -4]
    stencil_fields = ([original + field_z * m for m in multiples]
                      + [original + field_x + field_z,
                         original - field_x + field_z,
                         original + field_x - field_z,
                         original - field_x - field_z])
    batch = _prefetch_field_energies(calculation, atomic_symbols, coordinates,
                                     fields=stencil_fields, device=device)

    def E_at(multiple):
        if batch is not None:
            return batch[multiples.index(multiple)]
        return _energy_at_field(calculation, atomic_symbols, coordinates,
                                integrals, original + field_z * multiple, device=device)

    E_p1, E_p2, E_p3, E_p4 = E_at(1), E_at(2), E_at(3), E_at(4)
    E_m1, E_m2, E_m3, E_m4 = E_at(-1), E_at(-2), E_at(-3), E_at(-4)
    beta_parallel = -third_derivative(E_m4, E_m3, E_m2, E_m1, E_p1, E_p2, E_p3, E_p4, h)
    log("[Done]", calculation, 1, silent=silent)

    log("  Calculating perpendicular derivative...    ", calculation, 1, silent=silent, end="")
    if batch is not None:
        E_fp, E_bp, E_fm, E_bm = batch[8:12]
    else:
        E_fp = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original + field_x + field_z, device=device)
        E_bp = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original - field_x + field_z, device=device)
        E_fm = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original + field_x - field_z, device=device)
        E_bm = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original - field_x - field_z, device=device)
    beta_perpendicular = -(E_bp - 2 * E_p1 + E_fp - E_bm + 2 * E_m1 - E_fm) / (2 * h**3)
    log("[Done]", calculation, 1, silent=silent)

    electronic_dipole = -first_derivative(E_m1, E_p1, h)
    calculation.electric_field = original
    nuclear_dipole = props.calculate_nuclear_dipole_moment(
        molecule.centre_of_mass, molecule.charges, coordinates)
    total_dipole = electronic_dipole + nuclear_dipole

    log(f"\n  Dipole moment:                         {total_dipole:10.4f}", calculation, 1, silent=silent)
    log(f"\n  Parallel hyperpolarisability:          {beta_parallel:10.4f}", calculation, 1, silent=silent)
    log(f"  Perpendicular hyperpolarisability:     {beta_perpendicular:10.4f}", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    timer("Hyperpolarisability", 1)
    return beta_parallel, beta_perpendicular


def calculate_numerical_dipole_moment(molecule, calculation, silent, atomic_symbols,
                                      coordinates, integrals, device="cuda"):
    timer("Dipole moment", 0)
    original = calculation.electric_field.copy()
    h = constants.FIRST_ELEC_DERIVATIVE_STEP
    field_z = np.array([0.0, 0.0, h])

    log("\n Beginning dipole moment calculation... ", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent, start="\n")
    log("                    Dipole Moment", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    log(f"  Using a finite field magnitude of {h:.5f} au.", calculation, 1, silent=silent)
    log("\n  Calculating parallel derivative...         ", calculation, 1, silent=silent, end="")

    batch = _prefetch_field_energies(calculation, atomic_symbols, coordinates,
                                     fields=[original + field_z,
                                             original - field_z], device=device)
    if batch is not None:
        E_f, E_b = batch
    else:
        E_f = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original + field_z, device=device)
        E_b = _energy_at_field(calculation, atomic_symbols, coordinates, integrals, original - field_z, device=device)
    electronic_dipole = -first_derivative(E_b, E_f, h)
    log("[Done]", calculation, 1, silent=silent)

    calculation.electric_field = original
    nuclear_dipole = props.calculate_nuclear_dipole_moment(
        molecule.centre_of_mass, molecule.charges, coordinates)
    total_dipole = electronic_dipole + nuclear_dipole

    log(f"\n  Nuclear dipole moment:                 {nuclear_dipole:10.5f}", calculation, 1, silent=silent)
    log(f"  Electronic dipole moment:              {electronic_dipole:10.5f}", calculation, 1, silent=silent)
    log(f"\n  Total dipole moment:                   {total_dipole:10.5f}", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    timer("Dipole moment", 1)
    return total_dipole


def calculate_numerical_quadrupole_moment(molecule, calculation, silent,
                                          atomic_symbols, coordinates, integrals, device="cuda"):
    timer("Quadrupole moment", 0)
    original = calculation.electric_field_gradient.copy()
    h = constants.FIRST_ELEC_DERIVATIVE_STEP
    grad_x = np.array([h, 0.0, 0.0])
    grad_z = np.array([0.0, 0.0, h])

    log("\n Beginning quadrupole moment calculation... ", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent, start="\n")
    log("                   Quadrupole Moment", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    log(f"  Using a finite gradient magnitude of {h:.5f} au.", calculation, 1, silent=silent)

    batch = _prefetch_field_energies(
        calculation, atomic_symbols, coordinates,
        gradients=[original + grad_z, original - grad_z,
                   original + grad_x, original - grad_x], device=device)

    log("\n  Calculating parallel derivative...         ", calculation, 1, silent=silent, end="")
    if batch is not None:
        E_f, E_b = batch[0], batch[1]
    else:
        E_f = _energy_at_gradient(calculation, atomic_symbols, coordinates, integrals, original + grad_z, device=device)
        E_b = _energy_at_gradient(calculation, atomic_symbols, coordinates, integrals, original - grad_z, device=device)
    electronic_z = -first_derivative(E_b, E_f, h)
    log("[Done]", calculation, 1, silent=silent)

    log("  Calculating perpendicular derivative...    ", calculation, 1, silent=silent, end="")
    if batch is not None:
        E_f, E_b = batch[2], batch[3]
    else:
        E_f = _energy_at_gradient(calculation, atomic_symbols, coordinates, integrals, original + grad_x, device=device)
        E_b = _energy_at_gradient(calculation, atomic_symbols, coordinates, integrals, original - grad_x, device=device)
    electronic_x = -first_derivative(E_b, E_f, h)
    log("[Done]", calculation, 1, silent=silent)

    calculation.electric_field_gradient = original
    nuclear = props.calculate_nuclear_quadrupole_moment(
        molecule.centre_of_mass, molecule.charges, coordinates)
    quadrupole_z = electronic_z + nuclear
    anisotropic = quadrupole_z - electronic_x
    isotropic = (2 * electronic_x + quadrupole_z) / 3

    log(f"\n  Nuclear quadrupole moment:             {nuclear:10.5f}", calculation, 1, silent=silent)
    log(f"\n  Electronic quadrupole moment (x):      {electronic_x:10.5f}", calculation, 1, silent=silent)
    log(f"  Electronic quadrupole moment (z):      {electronic_z:10.5f}", calculation, 1, silent=silent)
    log(f"\n  Anisotropic quadrupole moment:         {anisotropic:10.5f}", calculation, 1, silent=silent)
    log(f"  Isotropic quadrupole moment:           {isotropic:10.5f}", calculation, 1, silent=silent)
    log_spacer(calculation, 1, silent=silent)
    timer("Quadrupole moment", 1)
    return isotropic

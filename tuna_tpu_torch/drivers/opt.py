"""Geometry optimisation: Newton steps with approximate (gradient-update) or
exact Hessian, trust radius, convexity guard and MOREAD warm starts.

Twin of the single-device path of tuna_tpu/drivers/opt.py: the
multi-device stencil batch (_batched_displaced_energies) is not ported, so
every displaced energy is solved in turn, as tuna_tpu does on one device.
The gradient is analytic (drivers/gradients.py) for restricted HF and KS,
a central finite difference of full energy evaluations otherwise.  Every
tensor lives on `device`.
"""

from __future__ import annotations

import numpy as np

from .. import constants, props
from ..containers import to_numpy
from ..output import error, log, log_big_spacer, log_spacer, timer, warning
from ..stencils import first_derivative, second_derivative
from . import energy as energ
from . import gradients


def calculate_gradient(coordinates, calculation, atomic_symbols, silent=False,
                       molecule=None, SCF_output=None, device="cuda"):
    """dE/dR along the bond: analytic for restricted HF and KS, central
    finite differences of full energy evaluations otherwise
    (tuna_opt.py:37-76)."""
    if (molecule is not None and SCF_output is not None
            and gradients.analytic_gradient_available(calculation, molecule)):
        log(" Calculating analytic gradient (autodiff)...          ",
            calculation, 1, end="", silent=silent)
        gradient = gradients.calculate_analytic_gradient(
            molecule, calculation, SCF_output, coordinates)
        log("[Done]", calculation, 1, silent=silent)
        return gradient

    h = constants.FIRST_GEOM_DERIVATIVE_STEP
    prod = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, h]])

    log(" Calculating energy on displaced geometry 1 of 2...   ", calculation, 1,
        end="", silent=silent)
    _, _, E_forward, _ = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates + prod, silent=True, device=device)
    log("[Done]", calculation, 1, silent=silent)
    log(" Calculating energy on displaced geometry 2 of 2...   ", calculation, 1,
        end="", silent=silent)
    _, _, E_backward, _ = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates - prod, silent=True, device=device)
    log("[Done]", calculation, 1, silent=silent)
    return first_derivative(E_backward, E_forward, h)


def calculate_hessian(coordinates, calculation, atomic_symbols, energy, silent=False,
                      allow_analytic=True, device="cuda"):
    """d2E/dR2, returning displaced wavefunctions for dipole derivatives.

    With an analytic gradient the Hessian is a central difference of
    gradients (two displaced SCF solves); callers that need the +/-2h
    energies (VPT stencils) pass allow_analytic=False for the five-point
    path (tuna_opt.py:87-147)."""
    h = constants.SECOND_GEOM_DERIVATIVE_STEP
    prod = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, h]])

    has_ghost = any(str(s).upper().startswith("X") for s in atomic_symbols)
    if (allow_analytic and not has_ghost
            and gradients.analytic_gradient_available(calculation)):
        log("\n Calculating analytic gradient on displaced geometry 1 of 2...   ",
            calculation, 1, end="", silent=silent)
        SCF_forward, mol_f, E_f, P_forward = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates + prod, silent=True, device=device)
        g_f = gradients.calculate_analytic_gradient(mol_f, calculation,
                                                    SCF_forward, coordinates + prod)
        log("[Done]", calculation, 1, silent=silent)
        log(" Calculating analytic gradient on displaced geometry 2 of 2...   ",
            calculation, 1, end="", silent=silent)
        SCF_backward, mol_b, E_b, P_backward = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates - prod, silent=True, device=device)
        g_b = gradients.calculate_analytic_gradient(mol_b, calculation,
                                                    SCF_backward, coordinates - prod)
        log("[Done]\n", calculation, 1, silent=silent)
        hessian = (g_f - g_b) / (2 * h)
        return (hessian, SCF_forward, P_forward, SCF_backward, P_backward,
                (None, E_b, E_f, None))

    log("\n Calculating energy on displaced geometry 1 of 4...   ",
        calculation, 1, end="", silent=silent)
    _, _, E_ff, _ = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates + 2 * prod, silent=True, device=device)
    log("[Done]", calculation, 1, silent=silent)

    log(" Calculating energy on displaced geometry 2 of 4...   ",
        calculation, 1, end="", silent=silent)
    SCF_forward, _, E_f, P_forward = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates + prod, silent=True, device=device)
    log("[Done]", calculation, 1, silent=silent)

    log(" Calculating energy on displaced geometry 3 of 4...   ",
        calculation, 1, end="", silent=silent)
    SCF_backward, _, E_b, P_backward = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates - prod, silent=True, device=device)
    log("[Done]", calculation, 1, silent=silent)

    log(" Calculating energy on displaced geometry 4 of 4...   ",
        calculation, 1, end="", silent=silent)
    _, _, E_bb, _ = energ.evaluate_molecular_energy(
        calculation, atomic_symbols, coordinates - 2 * prod, silent=True, device=device)
    log("[Done]\n", calculation, 1, silent=silent)

    hessian = second_derivative(E_bb, E_b, energy, E_f, E_ff, h)
    displaced_energies = (E_bb, E_b, E_f, E_ff)
    return hessian, SCF_forward, P_forward, SCF_backward, P_backward, displaced_energies


def optimisation_is_converged(iteration, gradient, step, calculation):
    converged = (abs(gradient) < calculation.geom_conv["gradient"]
                 and abs(step) < calculation.geom_conv["step"])
    if converged:
        log_spacer(calculation, start="\n", space="")
        log(f"      Optimisation converged in {iteration} iterations!", calculation, 1)
        log_spacer(calculation, space="")
    return converged


def update_hessian(calculation, coordinates, atomic_symbols, energy, bond_length,
                   old_bond_length, gradient, old_gradient, device="cuda"):
    """Approximate dg/dx Hessian (or exact) with convexity guard."""
    hessian = calculation.default_hessian
    if calculation.calc_hess:
        log("\n Beginning calculation of exact hessian...    ", calculation, 1)
        candidate, *_ = calculate_hessian(coordinates, calculation, atomic_symbols,
                                          energy, silent=False, device=device)
    else:
        candidate = (gradient - old_gradient) / (bond_length - old_bond_length)

    if calculation.opt_max and candidate < -0.01:
        hessian = -candidate
    elif not calculation.opt_max and candidate > 0.01:
        hessian = candidate
    return hessian


def _print_convergence(gradient, step, calculation):
    gc = calculation.geom_conv["gradient"]
    sc = calculation.geom_conv["step"]
    yes_no = lambda ok: " Yes" if ok else " No "
    log_spacer(calculation, start="\n")
    log("   Factor        Value       Criteria    Converged?", calculation, 1)
    log_spacer(calculation)
    log(f"  Gradient   {gradient:11.8f}   {gc:11.8f}      {yes_no(abs(gradient) < gc)} ", calculation, 1)
    log(f"    Step     {step:11.8f}   {sc:11.8f}      {yes_no(abs(step) < sc)} ", calculation, 1)
    log_spacer(calculation)


def optimise_geometry(calculation, atomic_symbols, coordinates,
                      multiple_iterations=True, device="cuda"):
    """Newton optimisation of the bond length (tuna_opt.py:330-484).
    Returns (molecule, energy), or None when FORCE stops after one
    iteration."""
    timer("Geometry optimisation", 0)
    max_geom_iter = calculation.geom_max_iter

    log("\nInitialising geometry optimisation...\n", calculation, 1)
    if calculation.trajectory:
        log(f'Printing trajectory data to "{calculation.trajectory_path}"\n', calculation, 1)
        open(calculation.trajectory_path, "w").close()

    hessian_type = "exact" if calculation.calc_hess else "approximate"
    log(f"Using {hessian_type} hessian in convex region, hessian of "
        f"{calculation.default_hessian:.3f} outside.\n", calculation, 1)
    log(f"Convergence criteria for gradient is {calculation.geom_conv['gradient']:.8f}, "
        f"step convergence is {calculation.geom_conv['step']:.8f} angstroms.", calculation, 1)
    log(f"Geometry iterations will not exceed {max_geom_iter}, maximum step is "
        f"{calculation.max_step} angstroms.", calculation, 1)

    P_guess = P_guess_alpha = P_guess_beta = E_guess = None
    old_bond_length = old_gradient = None

    for iteration in range(1, max_geom_iter + 1):
        if iteration > 1 and not multiple_iterations:
            break

        bond_length = float(np.linalg.norm(coordinates[1] - coordinates[0]))
        log_big_spacer(calculation, start="\n", space="")
        log(f"Beginning energy and gradient iteration {iteration} with bond length "
            f"of {constants.bohr_to_angstrom(bond_length):5f} angstroms...", calculation, 1)
        log_big_spacer(calculation, space="")

        terse = not calculation.additional_print
        timer("Energy evaluation", 0)
        SCF_output, molecule, energy, P = energ.evaluate_molecular_energy(
            calculation, atomic_symbols, coordinates, P_guess,
            P_guess_alpha=P_guess_alpha, P_guess_beta=P_guess_beta,
            E_guess=E_guess, terse=terse, device=device)
        timer("Energy evaluation", 1)

        if calculation.MO_read:
            P_guess = SCF_output.P
            P_guess_alpha = SCF_output.P_alpha
            P_guess_beta = SCF_output.P_beta
            E_guess = SCF_output.energy

        log("\n Beginning gradient calculation...  \n", calculation, 1)
        timer("Gradient", 0)
        gradient = calculate_gradient(coordinates, calculation, atomic_symbols,
                                      silent=False, molecule=molecule,
                                      SCF_output=SCF_output, device=device)
        timer("Gradient", 1)

        bond_length = molecule.bond_length
        hessian = (update_hessian(calculation, coordinates, atomic_symbols, energy,
                                  bond_length, old_bond_length, gradient, old_gradient,
                                  device=device)
                   if iteration > 1 else calculation.default_hessian)

        step = gradient / hessian
        _print_convergence(gradient, step, calculation)

        if calculation.trajectory:
            from .. import plotting
            plotting.save_trajectory_to_file(molecule, energy, coordinates,
                                             calculation.trajectory_path)

        if optimisation_is_converged(iteration, gradient, step, calculation):
            props.calculate_molecular_properties(
                molecule, calculation, to_numpy(P), to_numpy(SCF_output.S),
                SCF_output.host_view(), to_numpy(SCF_output.P_alpha),
                to_numpy(SCF_output.P_beta))
            log(f"\n Optimisation converged in {iteration} iterations to bond "
                f"length of {constants.bohr_to_angstrom(bond_length):.5f} angstroms!",
                calculation, 1)
            log(f"\n Final single point energy: {energy:.10f}", calculation, 1)
            timer("Geometry optimisation", 1)
            return molecule, energy

        if abs(step) > calculation.max_step:
            step = np.sign(step) * calculation.max_step
            warning("Calculated step is outside of trust radius, taking maximum step instead.")

        direction = -1 if calculation.opt_max else 1
        coordinates = np.array([[0.0, 0.0, 0.0],
                                [0.0, 0.0, coordinates[1][2] - direction * step]])
        if coordinates[1][2] < 0.01:
            error("Optimisation generated negative bond length! Decrease maximum step!")

        old_bond_length = bond_length
        old_gradient = gradient

    if multiple_iterations:
        error(f"Geometry optimisation did not converge in {max_geom_iter} "
              "iterations! Increase the maximum or give up!")
    timer("Geometry optimisation", 1)
    return None

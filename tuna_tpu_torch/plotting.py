"""Output artifacts: XYZ trajectories, 1D scan plots, vibrational wavefunction
plots, 2D density/orbital plots and broadened absorbance spectra.

Twin of tuna_tpu/plotting.py; only show_two_dimensional_plot differs: it
evaluates the AOs on the plane with dft.grid.basis_on_grid (K7a on the
card) and each density with density_on_grid (K7b, rho alone), on the device
of the orbitals.  Matplotlib is imported lazily so headless compute runs
never touch it.
"""

from __future__ import annotations

import pickle

import numpy as np

from . import constants
from .output import error, log


def save_trajectory_to_file(molecule, energy, coordinates, trajectory_path):
    """Append one XYZ frame (coordinates in angstrom, energy in comment)."""
    with open(trajectory_path, "a") as f:
        f.write(f"{molecule.n_atoms}\n")
        f.write(f"Energy: {energy:.10f}\n")
        for atom, xyz in zip(molecule.atoms, np.asarray(coordinates)):
            x, y, z = constants.bohr_to_angstrom(np.asarray(xyz, dtype=float))
            f.write(f"{atom.symbol_formatted:<4} {x:14.8f} {y:14.8f} {z:14.8f}\n")


def _pyplot(calculation):
    import matplotlib
    matplotlib.use("Agg" if getattr(calculation, "save_plot", False) else
                   matplotlib.get_backend())
    import matplotlib.pyplot as plt
    return plt


def _finish_plot(plt, calculation):
    if calculation.save_plot:
        plt.savefig(calculation.save_plot_filepath)
        log(f'\n Plot saved to "{calculation.save_plot_filepath}".', calculation, 1)
    else:
        plt.show()


_OVERLAY_CACHE = "tuna-plot-overlay.pickle"


def generate_one_dimensional_plot(calculation, x_values, y_values, label):
    """Scan plots with ADDPLOT/DELPLOT pickle-based overlays."""
    plt = _pyplot(calculation)
    linestyle = ("--" if calculation.plot_dashed_lines
                 else ":" if calculation.plot_dotted_lines else "-")

    overlays = []
    if calculation.add_plot:
        try:
            with open(_OVERLAY_CACHE, "rb") as f:
                overlays = pickle.load(f)
        except (FileNotFoundError, EOFError):
            overlays = []
    if calculation.delete_plot:
        overlays = []

    for old_x, old_y, old_style, old_colour in overlays:
        plt.plot(old_x, old_y, old_style, color=old_colour)
    plt.plot(np.asarray(x_values), np.asarray(y_values), linestyle,
             color=calculation.scan_plot_colour)

    if calculation.add_plot or calculation.delete_plot:
        overlays.append((np.asarray(x_values), np.asarray(y_values), linestyle,
                         calculation.scan_plot_colour))
        with open(_OVERLAY_CACHE, "wb") as f:
            pickle.dump(overlays, f)

    plt.xlabel("Bond length (angstrom)")
    plt.ylabel("Energy (hartree)")
    plt.title(f"TUNA {label}")
    _finish_plot(plt, calculation)


def plot_vibrational_wavefunctions(calculation, x_angstrom, V, levels, wavefunctions):
    plt = _pyplot(calculation)
    plt.plot(x_angstrom, V, "k-")
    scale = 0.3 * (np.max(V) - np.min(V)) / max(np.max(np.abs(wavefunctions)), 1e-12)
    for i in range(wavefunctions.shape[1]):
        plt.axhline(levels[i], color="grey", linestyle=":", linewidth=0.5)
        plt.plot(x_angstrom, levels[i] + scale * wavefunctions[:, i])
    plt.xlabel("Bond length (angstrom)")
    plt.ylabel("Energy (hartree)")
    plt.title("TUNA vibrational wavefunctions")
    _finish_plot(plt, calculation)


def generate_absorbance_spectrum(calculation, excitation_energies, oscillator_strengths):
    """Gaussian-broadened UV/vis spectrum (PEAKWIDTH in nm)."""
    plt = _pyplot(calculation)
    energies_per_cm = np.asarray(excitation_energies) * constants.PER_CM_IN_HARTREE
    wavelengths = 1e7 / np.where(energies_per_cm > 0, energies_per_cm, 1)
    x = np.linspace(max(1.0, wavelengths.min() - 100), wavelengths.max() + 100, 2000)
    width = calculation.peak_width
    spectrum = np.zeros_like(x)
    for wl, f in zip(wavelengths, np.asarray(oscillator_strengths)):
        spectrum += f * np.exp(-((x - wl) / width) ** 2)
    plt.plot(x, spectrum, color=calculation.scan_plot_colour)
    plt.xlabel("Wavelength (nm)")
    plt.ylabel("Absorbance (arbitrary units)")
    plt.title("TUNA absorption spectrum")
    _finish_plot(plt, calculation)


def show_two_dimensional_plot(calculation, molecule, P, P_alpha, P_beta,
                              P_diff_alpha, P_diff_beta, P_diff,
                              molecular_orbitals, natural_orbitals):
    """(x, z)-plane density / MO / spin-density plots."""
    import torch

    from .containers import to_numpy
    from .dft.grid import basis_on_grid, density_on_grid

    extent = molecule.bond_length + 8.0
    n = 160
    xs = np.linspace(-extent / 2, extent / 2, n)
    zs = np.linspace(-extent / 2 + molecule.bond_length / 2,
                     extent / 2 + molecule.bond_length / 2, n)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    device = molecular_orbitals.device
    points = torch.as_tensor(np.stack([X, np.zeros_like(X), Z]), dtype=torch.float64,
                             device=device)
    bfs, _ = basis_on_grid(molecule.cartesian_basis_functions, points,
                           molecule.spherical_transformation, False)

    def density_of(matrix):
        return density_on_grid(torch.as_tensor(matrix, dtype=torch.float64, device=device),
                               bfs)[0]

    plt = _pyplot(calculation)
    if calculation.plot_density:
        field, title = density_of(P), "Electron density"
    elif calculation.plot_spin_density:
        field, title = density_of(P_alpha - P_beta), "Spin density"
    elif calculation.plot_difference_density and P_diff is not None:
        field, title = density_of(P_diff), "Difference density"
    elif calculation.plot_difference_spin_density and P_diff_alpha is not None:
        field, title = density_of(P_diff_alpha - P_diff_beta), "Difference spin density"
    else:
        mos = (natural_orbitals if calculation.plot_natural_orbital
               and natural_orbitals is not None else molecular_orbitals)
        mos = torch.as_tensor(mos, dtype=torch.float64, device=device)
        if calculation.plot_HOMO:
            idx = molecule.n_doubly_occ - 1
        elif calculation.plot_LUMO:
            idx = molecule.n_doubly_occ
        elif calculation.plot_natural_orbital:
            idx = calculation.natural_orbital_to_plot - 1
        else:
            idx = calculation.molecular_orbital_to_plot - 1
        orbital = torch.tensordot(mos[:, idx], bfs, dims=1)
        field, title = orbital, f"Orbital {idx + 1}"

    plt.contourf(constants.bohr_to_angstrom(X), constants.bohr_to_angstrom(Z),
                 to_numpy(field), levels=40)
    plt.colorbar()
    plt.xlabel("x (angstrom)")
    plt.ylabel("z (angstrom)")
    plt.title(f"TUNA: {title}")
    _finish_plot(plt, calculation)

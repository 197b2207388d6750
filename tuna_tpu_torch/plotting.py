"""Output artifacts: XYZ trajectories.

Twin of save_trajectory_to_file in tuna_tpu/plotting.py (numpy only); the
plotting functions are not ported yet.
"""

from __future__ import annotations

import numpy as np

from . import constants


def save_trajectory_to_file(molecule, energy, coordinates, trajectory_path):
    """Append one XYZ frame (coordinates in angstrom, energy in comment)."""
    with open(trajectory_path, "a") as f:
        f.write(f"{molecule.n_atoms}\n")
        f.write(f"Energy: {energy:.10f}\n")
        for atom, xyz in zip(molecule.atoms, np.asarray(coordinates)):
            x, y, z = constants.bohr_to_angstrom(np.asarray(xyz, dtype=float))
            f.write(f"{atom.symbol_formatted:<4} {x:14.8f} {y:14.8f} {z:14.8f}\n")

"""Atomic data: charges, masses, dispersion parameters, core counts and
spherically-averaged minimal-basis SAD densities for H-Ar plus the ghost atom.

Data is loaded from tuna_tpu/basis/data/atoms.json (extracted physical data;
reference table at /root/reference/TUNA/tuna_util.py:1676-1925).
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass

import numpy as np

_DATA = (pathlib.Path(__file__).parent.parent / "tuna_tpu" / "basis" / "data"
         / "atoms.json")

with open(_DATA) as _f:
    ATOMIC_PROPERTIES: dict[str, dict] = json.load(_f)

for _props in ATOMIC_PROPERTIES.values():
    if _props["sad_density"] is not None:
        _props["sad_density"] = np.array(_props["sad_density"], dtype=np.float64)


@dataclass
class Atom:
    """One atom (possibly a ghost: real basis functions, zero charge/mass)."""

    basis_charge: int          # Z used to pick basis functions
    mass: float                # AMU
    origin: np.ndarray         # bohr
    C6: float
    vdw_radius: float
    real_vdw_radius: float
    symbol: str
    core_orbitals: int
    sad_density: np.ndarray | None
    ghost: bool

    @property
    def charge(self) -> int:
        return 0 if self.ghost else self.basis_charge

    @property
    def symbol_formatted(self) -> str:
        if self.ghost:
            return "X" + self.symbol[1:].capitalize()
        return self.symbol.capitalize()


def make_atom(symbol: str, origin) -> Atom:
    """Build an Atom from its (upper-case) symbol, handling X-prefixed ghosts."""
    origin = np.asarray(origin, dtype=np.float64)
    if "X" in symbol:
        if symbol == "X":
            from .output import error
            error("One or more atom types not recognised! Check the manual for available atoms.")
        ghost_props = ATOMIC_PROPERTIES["X"]
        real_props = ATOMIC_PROPERTIES[symbol.split("X")[1]]
        return Atom(real_props["charge"], ghost_props["mass"], origin, ghost_props["C6"],
                    ghost_props["vdw_radius"], ghost_props["real_vdw_radius"], symbol,
                    ghost_props["core_orbitals"], ghost_props["sad_density"], ghost=True)
    props = ATOMIC_PROPERTIES[symbol]
    return Atom(props["charge"], props["mass"], origin, props["C6"], props["vdw_radius"],
                props["real_vdw_radius"], symbol, props["core_orbitals"],
                props["sad_density"], ghost=False)

"""Basis-set library: built-in tables, user-typed-name resolution and the
ORCA-style custom basis file parser.

The built-in tables live in basis/data/basis_sets.json (shells per element,
extracted physical data; reference tables at
/root/reference/TUNA/tuna_basis.py:247-3041).  generate_basis mirrors the
name-mangling lookup of tuna_basis.py:186-236; parse_custom_basis mirrors the
file grammar of tuna_basis.py:34-175 (element-name blocks, "S 3"-style shell
headers, Fortran D exponents, and combined "L" shells split into S+P).
"""

from __future__ import annotations

import json
import pathlib
import re

from ..output import error
from ..periodic import ATOMIC_PROPERTIES

_DATA = (pathlib.Path(__file__).parent.parent.parent / "tuna_tpu" / "basis"
         / "data" / "basis_sets.json")

with open(_DATA) as _f:
    _RAW = json.load(_f)

# {mangled_name: {Z: [(ang_letter, [(exp, coeff), ...]), ...]}}
BASIS_TABLES: dict[str, dict[int, list]] = {
    name: {int(z): [(ang, [tuple(p) for p in prims]) for ang, prims in shells]
           for z, shells in table.items()}
    for name, table in _RAW.items()
}

del _RAW


def mangle_basis_name(basis_set: str) -> str:
    """Convert a user-typed basis name into the internal table key."""
    key = (basis_set.upper()
           .replace("-", "_").replace("*", "STAR").replace("+", "PLUS")
           .replace("[", "BRA").replace("(", "BRA")
           .replace(",", "COMMA")
           .replace("]", "KET").replace(")", "KET"))
    if key and key[0].isdigit():
        key = "_" + key
    return key


def generate_basis(basis_set: str, atomic_number: int, calculation=None) -> dict[int, list]:
    """Return {Z: shells} for one element in the requested basis set."""
    if basis_set.upper() == "CUSTOM":
        path = getattr(calculation, "custom_basis_file", None)
        table = parse_custom_basis(path)
        if atomic_number not in table:
            error(f"The custom basis set is not parameterised for element Z={atomic_number}!")
        return {atomic_number: table[atomic_number]}

    key = mangle_basis_name(basis_set)
    table = BASIS_TABLES.get(key)
    if table is None:
        error(f'Basis set "{basis_set}" is not supported.')
    shells = table.get(atomic_number)
    if shells is None:
        symbol = next((sym for sym, props in ATOMIC_PROPERTIES.items()
                       if props.get("charge") == atomic_number), None)
        name = symbol.lower().capitalize() if symbol else f"Z={atomic_number}"
        error(f"The chosen basis set, {basis_set}, is not parameterised for {name}!")
    return {atomic_number: shells}


def parse_custom_basis(filepath: str | None) -> dict[int, list]:
    """Parse a .tuna / ORCA-style basis file into {Z: shells}."""
    if filepath is None:
        error('A custom basis was requested but no filepath given via "BASIS [filepath.tuna]" keyword!')
    try:
        with open(filepath) as f:
            text = f.read()
    except FileNotFoundError:
        error(f'Basis path "{filepath}" not found!')

    element_map = {props["name"].upper(): props["charge"]
                   for sym, props in ATOMIC_PROPERTIES.items() if sym != "X"}

    basis: dict[int, list] = {}
    current_Z = None
    current_block: list = []
    orb_type = None
    nlines_expected = 0
    data_lines: list = []

    for line in text.strip().splitlines():
        line = line.strip()
        if not line or line.startswith("$"):
            continue

        if line in element_map:
            if current_Z and current_block:
                basis[current_Z] = current_block
                current_block = []
            current_Z = element_map[line]
            continue

        if re.match(r"^[A-Z]\s+\d+", line):
            parts = line.split()
            orb_type, nlines_expected = parts[0], int(parts[1])
            data_lines = []
            continue

        if orb_type:
            nums = [x.replace("D", "E") for x in line.split()]
            data_lines.append((float(nums[1]), *[float(x) for x in nums[2:]]))
            nlines_expected -= 1
            if nlines_expected == 0:
                if orb_type == "L":
                    # Combined sp shell: one exponent list, two coefficient columns
                    current_block.append(("S", [(e, c[0]) for e, *c in data_lines]))
                    current_block.append(("P", [(e, c[1]) for e, *c in data_lines]))
                else:
                    current_block.append((orb_type, [(e, c) for e, c in data_lines]))
                orb_type = None

    if current_Z and current_block:
        basis[current_Z] = current_block

    if not basis:
        error("Basis set malformed! If using a custom basis set, check the file format carefully.")
    return basis

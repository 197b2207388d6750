"""Molecular system model: Cartesian basis-function construction, electron
bookkeeping, point groups and method-complexity reduction.

Capability parity with the reference molecule layer
(/root/reference/TUNA/tuna_molecule.py), restructured for a functional TPU
core: the Molecule is a host-side description whose arrays feed jitted
kernels.  Primitive/contraction normalisation follows the reference Basis
convention (tuna_integral.pyx:174-210) so AO matrices agree element-wise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dataclass_replace

import numpy as np

from . import constants, spherical
from .basis import generate_basis
from .methods import Method
from .output import error
from .periodic import Atom, make_atom

_ANGULAR_LETTERS = "SPDFGH"
_L_TO_LETTER = {0: "s", 1: "p", 2: "d", 3: "f", 4: "g", 5: "h", 6: "i"}


@dataclass
class BasisFunction:
    """One contracted Cartesian Gaussian AO."""

    origin: np.ndarray            # (3,) bohr
    lmn: tuple[int, int, int]     # Cartesian angular momentum exponents
    exps: np.ndarray              # (K,) primitive exponents
    coefs: np.ndarray             # (K,) contraction coefficients (normalised)
    norms: np.ndarray             # (K,) primitive normalisation constants
    atom_index: int

    @property
    def l_total(self) -> int:
        return sum(self.lmn)

    @property
    def num_exps(self) -> int:
        return len(self.exps)


def _double_factorial(n: int) -> float:
    result = 1.0
    while n > 1:
        result *= n
        n -= 2
    return result


def normalise_contracted(lmn, exps, coefs):
    """Primitive norms + contracted renormalisation (reference convention).

    Primitive norm N_k = sqrt(2^(2L+1.5) a_k^(L+1.5) / ((2l-1)!!(2m-1)!!(2n-1)!! pi^1.5)).
    The contraction coefficients are then rescaled so the contracted function
    has unit self-overlap.
    """
    l, m, n = lmn
    L = l + m + n
    exps = np.asarray(exps, dtype=np.float64)
    coefs = np.asarray(coefs, dtype=np.float64)

    dfact = (_double_factorial(2 * l - 1) * _double_factorial(2 * m - 1)
             * _double_factorial(2 * n - 1))
    norms = np.sqrt(2.0 ** (2 * L + 1.5) * exps ** (L + 1.5) / dfact / np.pi ** 1.5)

    prefactor = np.pi ** 1.5 * dfact / 2.0 ** L
    pair_sum = np.sum(
        (norms[:, None] * norms[None, :] * coefs[:, None] * coefs[None, :])
        / (exps[:, None] + exps[None, :]) ** (L + 1.5)
    )
    coefs = coefs / np.sqrt(prefactor * pair_sum)
    return exps, coefs, norms


def subshell_components(letter: str) -> list[tuple[int, int, int]]:
    """Cartesian (lx,ly,lz) triples for one shell letter, x-major order."""
    L = _ANGULAR_LETTERS.find(letter.upper())
    if L == -1:
        error('Only up to "H" type basis functions are implemented!')
    return spherical.cartesian_components(L)


def build_basis_functions(atoms: list[Atom], basis_data: dict, decontract: bool) -> list[BasisFunction]:
    basis_functions: list[BasisFunction] = []
    try:
        for atom_index, atom in enumerate(atoms):
            for letter, prims in basis_data[atom.basis_charge]:
                exps = [e for e, _ in prims]
                coefs = [c for _, c in prims]
                for lmn in subshell_components(letter):
                    if decontract:
                        for e in exps:
                            ex, co, no = normalise_contracted(lmn, [e], [1.0])
                            basis_functions.append(BasisFunction(atom.origin, lmn, ex, co, no, atom_index))
                    else:
                        ex, co, no = normalise_contracted(lmn, exps, coefs)
                        basis_functions.append(BasisFunction(atom.origin, lmn, ex, co, no, atom_index))
    except (KeyError, TypeError, IndexError):
        error("Basis set malformed! If using a custom basis set, check the file format carefully.")
    return basis_functions


def shell_l_sequence(basis_functions: list[BasisFunction]) -> list[int]:
    """Total angular momentum per shell, walking the AO list shell by shell."""
    ls = []
    i = 0
    while i < len(basis_functions):
        L = basis_functions[i].l_total
        ls.append(L)
        i += spherical.n_cartesian(L)
    return ls


def determine_point_group(atoms: list[Atom], ghost_atom_present: bool):
    point_group = "K"
    if len(atoms) == 2 and not ghost_atom_present:
        point_group = "Dinfh" if atoms[0].symbol == atoms[1].symbol else "Cinfv"
    return point_group, point_group == "Dinfh", point_group == "Cinfv"


def determine_molecular_structure(atoms: list[Atom]) -> str:
    if len(atoms) == 2:
        if atoms[0].ghost:
            return atoms[1].symbol_formatted
        if atoms[1].ghost:
            return atoms[0].symbol_formatted
        return atoms[0].symbol_formatted + " --- " + atoms[1].symbol_formatted
    return atoms[0].symbol_formatted


def calculate_bond_length(coordinates: np.ndarray) -> float:
    return float(np.linalg.norm(coordinates[1] - coordinates[0]))


def calculate_reduced_mass(masses: np.ndarray) -> float:
    return float(np.prod(masses) / np.sum(masses))


def calculate_centre_of_mass(masses: np.ndarray, coordinates: np.ndarray) -> float:
    """z-coordinate of the centre of mass (molecules live on the z-axis)."""
    return float(np.einsum("i,iz->z", masses, coordinates)[2] / np.sum(masses)) if len(masses) > 1 else float(coordinates[0][2])


def rotational_constant_per_cm(reduced_mass: float, bond_length: float) -> tuple[float, float]:
    rot_hartree = 1 / (2 * reduced_mass * bond_length**2)
    per_bohr = rot_hartree / (constants.H_AU * constants.C_AU)
    per_cm = per_bohr / (100 * constants.BOHR_IN_METRES)
    return per_cm, constants.PER_CM_IN_GHZ * per_cm


def reduce_method_complexity(molecule: "Molecule", calculation) -> Method:
    """Downgrade methods that exceed full CI for the electron count."""
    method = calculation.method
    unrestricted = calculation.reference == "UHF"

    if molecule.n_electrons == 1 and method.correlated_method:
        return Method("HF", "Hartree-Fock theory", unrestricted=unrestricted)
    if molecule.n_electrons == 2 and method.name in (
            "CCSD[T]", "CCSD(T)", "QCISD[T]", "QCISD(T)", "CISDT", "CCSDT",
            "CCSDT[Q]", "CCSDT(Q)", "CCSDTQ"):
        return Method("CISD", "configuration interaction singles and doubles",
                      method_base="CC", unrestricted=unrestricted)
    if molecule.n_electrons == 3 and method.name in ("CCSDT[Q]", "CCSDT(Q)", "CCSDTQ"):
        return Method("CISDT", "configuration interaction singles, doubles and triples",
                      method_base="CC", unrestricted=unrestricted)
    return method


class Molecule:
    """Host-side molecular system built once per energy evaluation."""

    def __init__(self, atomic_symbols: list[str], coordinates, calculation, do_correlation: bool = True):
        self.atomic_symbols = atomic_symbols
        self.coordinates = np.asarray(coordinates, dtype=np.float64)
        self.calculation = calculation
        self.do_correlation = do_correlation

        self.basis = calculation.basis
        self.charge = calculation.charge
        self.multiplicity = calculation.multiplicity
        self.diatomic = calculation.diatomic
        self.monatomic = calculation.monatomic

        self._prepare(calculation)

        self.bond_length = 0.0
        if self.diatomic:
            self.bond_length = calculate_bond_length(self.coordinates)
            self.reduced_mass = calculate_reduced_mass(self.masses)
            self.rotational_constant_per_cm, self.rotational_constant_GHz = (
                rotational_constant_per_cm(self.reduced_mass, self.bond_length))
            self.centre_of_mass = calculate_centre_of_mass(self.masses, self.coordinates)

    # -- construction ------------------------------------------------------

    def _prepare(self, calculation) -> None:
        self.atoms = [make_atom(sym, self.coordinates[i]) for i, sym in enumerate(self.atomic_symbols)]
        self.n_atoms = len(self.atoms)

        self.basis_charges = np.array([a.basis_charge for a in self.atoms])
        self.charges = np.array([a.charge for a in self.atoms])
        self.masses = np.array([a.mass for a in self.atoms]) * constants.AMU_IN_ELECTRON_MASS
        self.total_mass = float(np.sum(self.masses))

        self.basis_data = generate_basis(self.basis, int(self.basis_charges[0]), calculation)
        if self.n_atoms == 2 and self.basis_charges[0] != self.basis_charges[1]:
            self.basis_data |= generate_basis(self.basis, int(self.basis_charges[1]), calculation)

        self.cartesian_basis_functions = build_basis_functions(
            self.atoms, self.basis_data, calculation.decontract)
        self.n_cartesian_basis = len(self.cartesian_basis_functions)

        self.shell_ls = shell_l_sequence(self.cartesian_basis_functions)
        if calculation.cartesian_harmonics:
            self.spherical_transformation = np.eye(self.n_cartesian_basis)
        else:
            self.spherical_transformation = spherical.build_transformation_matrix(self.shell_ls)

        self.primitive_Gaussians = [bf.num_exps for bf in self.cartesian_basis_functions]
        self.angular_momentum_list = [_L_TO_LETTER[bf.l_total] for bf in self.cartesian_basis_functions]

        self.centre_of_mass = 0.0

        for i, mass in enumerate([calculation.custom_mass_1, calculation.custom_mass_2]):
            if mass is not None and i < self.n_atoms:
                self.masses[i] = mass * constants.AMU_IN_ELECTRON_MASS

        self.n_electrons = int(np.sum(self.charges)) - self.charge
        if self.n_electrons < 0:
            error("Negative number of electrons specified!")
        elif self.n_electrons == 0:
            error("Zero electrons specified!")

        self.ghost_atom_present = any(a.ghost for a in self.atoms)
        self.point_group, self.homonuclear, self.heteronuclear = determine_point_group(
            self.atoms, self.ghost_atom_present)
        self.molecular_structure = determine_molecular_structure(self.atoms)

    def process_basis_functions(self, calculation, n_basis: int) -> None:
        """Electron/orbital bookkeeping once the (spherical) basis size is known."""
        self.n_basis = n_basis

        # Per-atom AO counts (Cartesian, and spherical unless CARTHARM)
        groups = [[bf for bf in self.cartesian_basis_functions if bf.atom_index == i]
                  for i in range(self.n_atoms)]
        if calculation.cartesian_harmonics:
            self.partition_ranges = [len(g) for g in groups]
        else:
            self.partition_ranges = []
            for g in groups:
                n_sph = 0
                i = 0
                while i < len(g):
                    L = g[i].l_total
                    n_sph += spherical.n_spherical(L)
                    i += spherical.n_cartesian(L)
                self.partition_ranges.append(n_sph)

        if calculation.default_multiplicity and self.n_electrons % 2 != 0:
            self.multiplicity = 2

        calculation.reference = ("RHF" if self.multiplicity == 1
                                 and not calculation.method.unrestricted else "UHF")
        if not calculation.method.restricted_available:
            calculation.reference = "UHF"

        self.n_unpaired_electrons = self.multiplicity - 1
        self.n_alpha = (self.n_electrons + self.n_unpaired_electrons) // 2
        self.n_beta = self.n_electrons - self.n_alpha
        self.n_doubly_occ = min(self.n_alpha, self.n_beta)
        self.n_occ = self.n_alpha + self.n_beta
        self.n_SO = 2 * self.n_basis
        self.n_virt = self.n_SO - self.n_occ
        self.n_doubly_virt = self.n_basis - self.n_doubly_occ
        self.n_orbitals = self.n_SO if calculation.reference == "UHF" else self.n_basis

        self.n_core_orbitals = (sum(a.core_orbitals for a in self.atoms)
                                if calculation.freeze_core else 0)
        self.n_core_alpha_electrons = self.n_core_orbitals
        self.n_core_beta_electrons = self.n_core_orbitals
        self.n_core_spin_orbitals = self.n_core_orbitals * 2
        if isinstance(calculation.freeze_n_orbitals, int):
            self.n_core_spin_orbitals = calculation.freeze_n_orbitals
            self.n_core_orbitals = calculation.freeze_n_orbitals

        calculation.n_electrons_per_orbital = 2 if calculation.reference == "RHF" else 1

        calculation.MO_read = not (
            calculation.reference == "UHF" and self.multiplicity == 1
            and not calculation.MO_read_requested and not calculation.no_rotate_guess
        ) and not calculation.no_MO_read and not calculation.rotate_guess

        if "OMP2" in calculation.method.name and calculation.reference == "RHF":
            self.n_core_spin_orbitals *= 2

        self._validate(calculation)
        calculation.method = reduce_method_complexity(self, calculation)

    def _validate(self, calculation) -> None:
        if self.n_electrons % 2 == 0 and self.multiplicity % 2 == 0:
            error("Impossible charge and multiplicity combination (both even)!")
        if self.n_electrons % 2 != 0 and self.multiplicity % 2 != 0:
            error("Impossible charge and multiplicity combination (both odd)!")
        if self.n_electrons - self.multiplicity < -1:
            error("Multiplicity too high for number of electrons!")
        if self.multiplicity < 1:
            error("Multiplicity must be at least 1!")
        if self.n_electrons > self.n_SO:
            error("Too many electrons for size of basis set!")
        if (calculation.reference == "UHF" and self.n_electrons > self.n_basis
                and self.n_electrons % 2 == 0 and self.multiplicity > self.n_electrons):
            error("Too many electrons for size of basis set!")
        if calculation.reference == "RHF" or calculation.method.name == "RHF":
            if self.n_electrons % 2 != 0:
                error("Restricted Hartree-Fock is not compatible with an odd number of electrons!")
            if self.multiplicity != 1:
                error("Restricted Hartree-Fock is not compatible non-singlet states!")

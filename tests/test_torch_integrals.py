"""The port's integral engine (tuna_tpu_torch.ops) against tuna_tpu's.

Both packages integrate identical primitive data: the port's plan is built
from the JAX plan's arrays (IntegralPlan.from_arrays).  Tolerances: 1e-12
absolute for integrals (the same Hermite recursions in float64, summed in
another order), 1e-14 absolute for the Boys function (the same table and
recursions).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.ops import boys as jax_boys
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.ops.integrals import cross_overlap as jax_cross_overlap
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import boys
from tuna_tpu_torch.ops.integrals import IntegralPlan, cross_overlap
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
SYSTEMS = [
    (("H", "H"), 0.74, "STO-3G"),
    (("LI", "H"), 1.60, "STO-3G"),
    (("N", "N"), 1.10, "6-31G"),
    (("H", "F"), 0.95, "6-31G**"),   # d shells on F
]


def _coordinates(bond_angstrom, n_atoms):
    return np.array([[0.0, 0.0, 0.0],
                     [0.0, 0.0, jax_constants.angstrom_to_bohr(bond_angstrom)]])[:n_atoms]


def _molecules(symbols, bond, basis):
    symbols = list(symbols)
    coords = _coordinates(bond, len(symbols))
    jax_cfg = JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis, symbols,
                        suppress_output=True)
    cfg = Config("SPE", lookup_method("HF"), 0.0, [], basis, symbols, suppress_output=True)
    return JaxMolecule(symbols, coords, jax_cfg), Molecule(symbols, coords, cfg)


@functools.lru_cache(maxsize=None)
def _reference(symbols, bond, basis):
    """(molecule, port plan from the JAX plan's arrays, JAX one-electron
    matrices, JAX packed ERI, JAX dense ERI) for one system."""
    jax_molecule, _ = _molecules(symbols, bond, basis)
    jax_plan = JaxPlan(jax_molecule.cartesian_basis_functions, jax_molecule.n_atoms)
    plan = IntegralPlan.from_arrays(
        *[np.asarray(getattr(jax_plan, name)) for name in PLAN_FIELDS],
        n_atoms=jax_molecule.n_atoms)
    one_electron = [np.asarray(x) for x in jax_plan.one_electron(
        jax_molecule.coordinates, jax_molecule.charges.astype(float),
        jax_molecule.centre_of_mass)]
    packed = np.asarray(jax_plan.eri_pair_packed(jax_molecule.coordinates))
    dense = np.asarray(jax_plan.eri(jax_molecule.coordinates))
    return jax_molecule, plan, one_electron, packed, dense


@pytest.mark.parametrize("symbols,bond,basis", [
    (("H", "H"), 0.74, "STO-3G"),
    (("N", "N"), 1.10, "6-311G"),
])
def test_plan_arrays_match_tuna_tpu(symbols, bond, basis):
    jax_molecule, molecule = _molecules(symbols, bond, basis)
    jax_plan = JaxPlan(jax_molecule.cartesian_basis_functions, jax_molecule.n_atoms)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(plan, name),
                                      np.asarray(getattr(jax_plan, name)), err_msg=name)
    assert (plan.n_basis, plan.n_pairs, plan.n_prim_pairs, plan.lmax) == (
        jax_plan.n_basis, jax_plan.n_pairs, jax_plan.n_prim_pairs, jax_plan.lmax)
    # CSR offsets: AO pair p owns primitive pairs pair_start[p]:pair_start[p+1]
    counts = np.bincount(np.asarray(jax_plan.pair_id), minlength=jax_plan.n_pairs)
    np.testing.assert_array_equal(np.diff(plan.pair_start), counts)


@pytest.mark.parametrize("nmax", [0, 2, 4, 12])
def test_boys_table_matches_tuna_tpu(nmax):
    rng = np.random.default_rng(nmax)
    T = np.concatenate([np.linspace(0.0, 60.0, 2401), rng.uniform(0.0, 60.0, 2000),
                        [29.95, 30.0, 30.05, 0.05, 0.15]])
    expected = np.asarray(jax_boys.boys_table(nmax, jnp.asarray(T)))
    got = boys.boys_table(nmax, torch.as_tensor(T, dtype=torch.float64)).numpy()
    assert got.shape == (T.size, nmax + 1)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-14)


@pytest.mark.parametrize("symbols,bond,basis", SYSTEMS)
def test_one_electron_matches_tuna_tpu(symbols, bond, basis):
    molecule, plan, expected, _, _ = _reference(symbols, bond, basis)
    got = plan.one_electron(torch.as_tensor(molecule.coordinates, dtype=torch.float64),
                            torch.as_tensor(molecule.charges, dtype=torch.float64),
                            molecule.centre_of_mass)
    for name, g, e in zip("STVDQ", got, expected):
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("symbols,bond,basis", SYSTEMS)
def test_eri_matches_tuna_tpu(symbols, bond, basis):
    molecule, plan, _, packed, dense = _reference(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    np.testing.assert_allclose(plan.eri_pair_packed(coords).numpy(), packed,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(plan.eri(coords).numpy(), dense, rtol=0, atol=1e-12)


def test_cross_overlap_matches_tuna_tpu():
    jax_target, target = _molecules(("N", "N"), 1.10, "6-31G")
    jax_minimal, minimal = _molecules(("N", "N"), 1.10, "STO-3G")
    expected = jax_cross_overlap(jax_target.cartesian_basis_functions,
                                 jax_minimal.cartesian_basis_functions)
    got = cross_overlap(target.cartesian_basis_functions, minimal.cartesian_basis_functions)
    assert got.shape == (target.n_cartesian_basis, minimal.n_cartesian_basis)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12)


def test_kernels_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; a device
    with no kernel raises instead of falling back."""
    molecule, plan, _, _, _ = _reference(("H", "H"), 0.74, "STO-3G")
    _kernels.reset_launch_counts()
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64)
    plan.one_electron(coords, charges, molecule.centre_of_mass)
    plan.eri_pair_packed(coords)
    assert all(count == 0 for count in _kernels.launches.values())
    with pytest.raises(ValueError):
        plan.eri_pair_packed(coords.to("meta"))
    with pytest.raises(ValueError):
        plan.one_electron(coords.to("meta"), charges.to("meta"), 0.0)

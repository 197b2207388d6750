"""Bases with g and h shells (lmax 4 and 5) in the port against tuna_tpu.

On the card every kernel takes lmax up to 5, K1, K4 and K3 and the
gradient kernels K8a, K8b and K8bu (ops/integrals.py::KERNEL_MAX_LMAX;
the gradient kernels' plain versions meet tuna_tpu in
tests/test_torch_high_l_gradients.py).  The CUDA kernels run only there
(tests/test_torch_gpu.py, chip_smoke.py phases 25 and 26); here
the plain versions, which the wrappers take for CPU tensors, meet
tuna_tpu on the same inputs.  Reduced plans hold a few shells of a large
basis, the same subset in both packages (ops/integrals.py::shell_subset):
the g shell of He/cc-pV5Z, and the h shell of H/cc-pV6Z with an s shell on
the other H.  Tolerances: 1e-12 absolute for the integrals (the same
Hermite recursions in float64, summed in another order); 1e-10 Ha for the
line end to end, with equal SCF cycles and CC iterations.
"""

import functools
import re

import numpy as np
import pytest
import torch

import tuna_tpu.constants as jax_constants
from tuna_tpu.cli import run as jax_run
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.system import Molecule as JaxMolecule

from ported_lines import assert_line_matches_tuna_tpu

from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops.integrals import KERNEL_MAX_LMAX, IntegralPlan, shell_subset
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
# (symbols, bond in angstrom, basis, the shells kept as (atom, l)), lmax
REDUCED = [
    ((("HE",), 0.0, "CC-PV5Z", ((0, 4),)), 4),
    ((("H", "H"), 0.74, "CC-PV6Z", ((0, 5), (1, 0))), 5),
]


def _reduced_molecules(symbols, bond, basis, keep):
    """tuna_tpu's and the port's molecule, each holding the same subset of
    its Cartesian basis functions."""
    symbols = list(symbols)
    coords = np.array([[0.0, 0.0, 0.0],
                       [0.0, 0.0, jax_constants.angstrom_to_bohr(bond)]])[:len(symbols)]
    molecules = (
        JaxMolecule(symbols, coords, JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis,
                                               symbols, suppress_output=True)),
        Molecule(symbols, coords, Config("SPE", lookup_method("HF"), 0.0, [], basis, symbols,
                                         suppress_output=True)))
    for molecule in molecules:
        molecule.cartesian_basis_functions = shell_subset(molecule.cartesian_basis_functions,
                                                          keep)
    return molecules


@functools.lru_cache(maxsize=None)
def _reference(system):
    """(port molecule, port plan, tuna_tpu plan, its one-electron matrices,
    packed ERI and dense ERI) of a reduced system."""
    jax_molecule, molecule = _reduced_molecules(*system)
    jax_plan = JaxPlan(jax_molecule.cartesian_basis_functions, jax_molecule.n_atoms)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    one_electron = [np.asarray(x) for x in jax_plan.one_electron(
        jax_molecule.coordinates, jax_molecule.charges.astype(float),
        jax_molecule.centre_of_mass)]
    packed = np.asarray(jax_plan.eri_pair_packed(jax_molecule.coordinates))
    # tuna_tpu's eri() is this expansion of its packed matrix, jitted with
    # the sweep (tuna_tpu/ops/integrals.py::_eri_impl); done here in NumPy,
    # it spares a second compile of the sweep at lmax 5
    pair_index = np.asarray(jax_plan.pair_index)
    dense = packed[pair_index[:, :, None, None], pair_index[None, None, :, :]]
    return molecule, plan, jax_plan, one_electron, packed, dense


@pytest.mark.parametrize("system,lmax", REDUCED)
def test_reduced_plan_arrays_match_tuna_tpu(system, lmax):
    _, plan, jax_plan, _, _, _ = _reference(system)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(plan, name), np.asarray(getattr(jax_plan, name)),
                                      err_msg=name)
    assert (plan.n_basis, plan.n_pairs, plan.n_prim_pairs, plan.lmax) == (
        jax_plan.n_basis, jax_plan.n_pairs, jax_plan.n_prim_pairs, jax_plan.lmax)
    assert plan.lmax == lmax


@pytest.mark.parametrize("system,lmax", REDUCED)
def test_reduced_one_electron_matches_tuna_tpu(system, lmax):
    molecule, plan, _, expected, _, _ = _reference(system)
    got = plan.one_electron(torch.as_tensor(molecule.coordinates, dtype=torch.float64),
                            torch.as_tensor(molecule.charges, dtype=torch.float64),
                            molecule.centre_of_mass)
    for name, g, e in zip("STVDQ", got, expected):
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("system,lmax", REDUCED)
def test_reduced_eri_matches_tuna_tpu(system, lmax):
    molecule, plan, _, _, packed, dense = _reference(system)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    np.testing.assert_allclose(plan.eri_pair_packed(coords).numpy(), packed, rtol=0, atol=1e-12)
    np.testing.assert_allclose(plan.eri(coords).numpy(), dense, rtol=0, atol=1e-12)


def test_kernel_lmax_limits():
    """The check before each launch (no card needed): all six kernels, K1,
    K4, K3, K8a, K8b and K8bu, take lmax 4 and 5 and refuse 6, each by
    name."""
    labels = {"eri_packed": "K1", "fock_direct": "K4", "one_electron": "K3",
              "one_electron_deriv": "K8a", "eri_deriv_energy": "K8b",
              "eri_deriv_energy_unrestricted": "K8bu"}
    assert KERNEL_MAX_LMAX == {kernel: (label, 5) for kernel, label in labels.items()}
    for system, lmax in REDUCED:
        _, plan, _, _, _, _ = _reference(system)
        assert plan.lmax == lmax
        for kernel in labels:
            plan._check_kernel_lmax(kernel)
    # an i shell (l = 6) on one atom: beyond every kernel
    plan = IntegralPlan.from_arrays([1.0], [1.0], [1.0], [(6, 0, 0)], [(6, 0, 0)], [0], [0],
                                    [0], [0], [0], [[0]], n_atoms=1)
    for kernel, label in labels.items():
        with pytest.raises(NotImplementedError,
                           match=rf"^{label} \({kernel}\) is not yet ported to tuna_tpu_torch "
                                 rf"above lmax 5; this basis has lmax 6$"):
            plan._check_kernel_lmax(kernel)


_CC_ROW = re.compile(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", re.MULTILINE)
_CYCLES = r"converged in (\d+) cycles"


def test_ccsd_at_g_shells_matches_tuna_tpu(capsys):
    """The slice as a whole: `SPE : HE : CCSD CC-PV5Z : TIGHTSCF` (g shells,
    70 Cartesian functions) through both CLIs, the port on the CPU: the
    total energy within 1e-10 Ha, equal SCF cycles and CC iterations."""
    line = "SPE : HE : CCSD CC-PV5Z : TIGHTSCF"
    capsys.readouterr()
    _, _, jax_energy, _ = jax_run(line)
    jax_printed = capsys.readouterr().out
    scf, molecule, energy, _ = run(line, device="cpu")
    printed = capsys.readouterr().out
    assert molecule.n_cartesian_basis == 70
    assert abs(energy - jax_energy) <= 1e-10
    assert len(_CC_ROW.findall(printed)) == len(_CC_ROW.findall(jax_printed)) > 0
    assert len(scf.correlation_iteration_seconds) == len(_CC_ROW.findall(printed))
    assert re.findall(_CYCLES, printed) == re.findall(_CYCLES, jax_printed)


def test_memory_wall_matches_tuna_tpu():
    """N2/cc-pV5Z without DIRECT: 252 Cartesian functions, 8 N^4 = 32 GB
    above the 12 GB wall of drivers/common.py, refused in tuna_tpu's
    words (after the STO-3G guess)."""
    expected, _ = assert_line_matches_tuna_tpu("SPE : N N 1.1 : HF CC-PV5Z")
    assert "Not enough memory to store two-electron integrals!" in expected["error"]

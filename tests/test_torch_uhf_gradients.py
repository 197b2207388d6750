"""The port's unrestricted analytic gradients (UHF and UKS) against
tuna_tpu.

* The plain twin of K8bu (IntegralPlan.eri_deriv_energy_unrestricted)
  against jax.grad of tuna_tpu's unrestricted two-electron energy on
  identical primitive data and a seeded pair of density-like Pa != Pb:
  1e-12 absolute.
* The plain twin of K8cu (dft.grid.density_deriv_on_grid_spin) spin by
  spin against the single-density plain K8c: bitwise.
* The full gradient given tuna_tpu's own converged Pa, Pb and W, against
  its calculate_analytic_gradient: 1e-10 Ha/bohr.
* The analytic UHF gradient against a central difference of the port's
  own energies: 5e-7 Ha/bohr (tuna_tpu's tests/test_drivers.py:51).
* The forward-mode substitute for tuna_tpu's jax.grad, which gave
  chip_smoke.py its cc-pVTZ constants, against jax.grad: 1e-12 Ha/bohr.
* A UKS optimisation end to end against tuna_tpu's printed numbers: bond
  length 1e-6 angstrom, energy 1e-8 Ha, the iteration count and the
  printed gradients.  The UHF drivers run end to end in
  tests/test_torch_uhf.py.
"""

import contextlib
import functools
import io
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.cli import parse_input as jax_parse_input, process_method as jax_process
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.drivers import energy as jax_energy
from tuna_tpu.drivers import gradients as jax_gradients
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import grid
from tuna_tpu_torch.drivers import energy, gradients
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread, as tests/test_torch_dft.py's fixture of
    that name gives the functionals."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch_coords(R):
    return torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, R]], dtype=torch.float64)


@pytest.mark.parametrize("symbols,bond,basis", [(("O", "H"), 0.97, "STO-3G"),
                                                (("H", "F"), 0.95, "6-31G**")])
def test_unrestricted_eri_tangent_matches_jax_grad(symbols, bond, basis):
    """K8bu's plain version against jax.grad of tuna_tpu's E_2 with exchange
    per spin (drivers/gradients.py:266-275) on the same primitive data."""
    symbols = list(symbols)
    R = jax_constants.angstrom_to_bohr(bond)
    cfg = JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis, symbols,
                    suppress_output=True)
    molecule = JaxMolecule(symbols, np.array([[0.0, 0.0, 0.0], [0.0, 0.0, R]]), cfg)
    jax_plan = JaxPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    plan = IntegralPlan.from_arrays(*[np.asarray(getattr(jax_plan, name))
                                      for name in PLAN_FIELDS], n_atoms=molecule.n_atoms)
    N = plan.n_basis
    rng = np.random.default_rng(7)
    C_a, C_b = (rng.standard_normal((N, k)) / np.sqrt(N) for k in (5, 4))
    P_a, P_b, hfx = C_a @ C_a.T, C_b @ C_b.T, 0.3

    def energy_2(r):
        ERI = jax_plan.eri(jnp.stack([jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]) * r]))
        J = jnp.einsum("ijkl,kl->ij", ERI, P_a + P_b)
        K_a = jnp.einsum("ilkj,kl->ij", ERI, P_a)
        K_b = jnp.einsum("ilkj,kl->ij", ERI, P_b)
        return (0.5 * jnp.sum((P_a + P_b) * J)
                - 0.5 * hfx * (jnp.sum(P_a * K_a) + jnp.sum(P_b * K_b)))

    _kernels.reset_launch_counts()
    got = plan.eri_deriv_energy_unrestricted(_torch_coords(R), torch.as_tensor(P_a),
                                             torch.as_tensor(P_b), hfx)
    assert _kernels.launches["eri_deriv_energy_unrestricted"] == 0
    assert abs(float(got) - float(jax.grad(energy_2)(R))) <= 1e-12
    # at Pa = Pb the unrestricted energy is the restricted one of P = 2 Pa
    same = plan.eri_deriv_energy_unrestricted(_torch_coords(R), torch.as_tensor(P_a),
                                              torch.as_tensor(P_a), hfx)
    restricted = plan.eri_deriv_energy(_torch_coords(R), torch.as_tensor(2 * P_a), hfx)
    assert abs(float(same) - float(restricted)) <= 1e-13


@pytest.mark.parametrize("with_gradients", [True, False])
def test_spin_density_deriv_plain_is_k8c_plain_per_spin(with_gradients):
    """density_deriv_on_grid_spin on the CPU gives, spin by spin, the
    single-density plain K8c's outputs bit for bit, stacked (2, G) and (2,
    3, G)."""
    calculation = Config("SPE", process_method("B3LYP"), 0.0, ["LOOSEGRID"], "6-31G",
                         ["O", "H"], suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(0.97)]])
    molecule = Molecule(["O", "H"], coords, calculation)
    points_np, _ = grid.build_molecular_grid(*grid.grid_parameters(molecule, calculation),
                                             molecule.bond_length, molecule.atoms)
    G = points_np.shape[1] * points_np.shape[2]
    points = torch.as_tensor(points_np.reshape(3, G))
    basis = grid.GridBasis(molecule.cartesian_basis_functions)
    origin = torch.as_tensor(basis.origin)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32)
    rng = np.random.default_rng(8)
    C = [rng.standard_normal((basis.n_ao, k)) / np.sqrt(basis.n_ao) for k in (5, 4)]
    P_stack = torch.stack([torch.as_tensor(c @ c.T) for c in C])
    _kernels.reset_launch_counts()
    got = grid.density_deriv_on_grid_spin(basis, origin, moves, points, G // 2, P_stack,
                                          with_gradients)
    assert _kernels.launches["density_deriv_on_grid_spin"] == 0
    for s in range(2):
        single = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2, P_stack[s],
                                            with_gradients)
        for g, one in zip(got, single):
            if one is None:
                assert g is None
            else:
                assert g.shape[0] == 2 and torch.equal(g[s], one)


@functools.lru_cache(maxsize=None)
def _tuna_tpu_scf(line):
    """tuna_tpu's converged SCF of `line`: (calculation, SCF output,
    molecule, coordinates)."""
    calc_type, method, basis, symbols, coordinates, params = jax_parse_input(line)
    calculation = JaxConfig(calc_type, jax_process(method), 0.0, params, basis, symbols,
                            suppress_output=True)
    SCF_output, molecule, _, _ = jax_energy.evaluate_molecular_energy(
        calculation, symbols, coordinates, silent=True)
    return calculation, SCF_output, molecule, coordinates


@functools.lru_cache(maxsize=None)
def _tuna_tpu_gradient(line):
    """tuna_tpu's analytic gradient at its converged SCF of `line`: (Pa, Pb,
    W, dE/dR) as numpy."""
    calculation, SCF_output, molecule, coordinates = _tuna_tpu_scf(line)
    gradient = jax_gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                         coordinates)
    W = jax_gradients._energy_weighted_density(SCF_output, molecule,
                                               calculation.reference == "RHF")
    return (np.asarray(SCF_output.P_alpha), np.asarray(SCF_output.P_beta), np.asarray(W),
            gradient)


@pytest.mark.parametrize("line", [
    "SPE : O H 0.97 : HF STO-3G",                  # UHF
    "SPE : O O 1.21 : SVWN STO-3G : ML 3",         # UKS, LDA
    "SPE : O O 1.21 : B3LYP STO-3G : ML 3",        # UKS, hybrid GGA
    "SPE : O H 0.97 : PBE STO-3G",                 # UKS, GGA
    "SPE : H HE 0.9 : UB3LYP STO-3G : ML 2",       # tuna_tpu's tests/test_drivers.py:37
])
def test_unrestricted_gradient_at_tuna_tpu_density_matches(line, one_torch_thread):
    P_a, P_b, W, expected = _tuna_tpu_gradient(line)
    calc_type, method, basis, symbols, coordinates, params = parse_input(line)
    calculation = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                         suppress_output=True)
    molecule = Molecule(symbols, coordinates, calculation)
    molecule.process_basis_functions(calculation, molecule.spherical_transformation.shape[0])
    assert calculation.reference == "UHF"
    assert gradients.analytic_gradient_available(calculation, molecule)
    gradient_fn = gradients._build_gradient_fn(molecule, calculation, torch.device("cpu"))
    _kernels.reset_launch_counts()
    got = gradient_fn(float(coordinates[1, 2]), torch.tensor(P_a), torch.tensor(P_b),
                      torch.tensor(W))
    assert all(count == 0 for count in _kernels.launches.values())
    assert abs(got - expected) <= 1e-10, (got, expected)


@pytest.mark.parametrize("line", ["SPE : O H 0.97 : HF STO-3G",
                                  "SPE : O O 1.21 : B3LYP STO-3G : ML 3"])
def test_jvp_substitute_matches_jax_grad(line, monkeypatch):
    """chip_smoke.py's cc-pVTZ gradient constants come from tuna_tpu with
    jax.grad(total_energy) replaced by its forward-mode derivative
    (jax.grad needs > 30 GB of host memory there): on a UHF and a UKS line
    the substitute's gradient at tuna_tpu's density equals jax.grad's to
    1e-12 Ha/bohr."""
    _, _, _, expected = _tuna_tpu_gradient(line)
    calculation, SCF_output, molecule, coordinates = _tuna_tpu_scf(line)

    def forward_grad(f, argnums=0):
        return lambda R, *args: jax.jvp(lambda r: f(r, *args), (R,), (1.0,))[1]

    monkeypatch.setattr(jax_gradients, "jax", types.SimpleNamespace(jit=jax.jit,
                                                                   grad=forward_grad))
    monkeypatch.setattr(jax_gradients, "_GRAD_CACHE", {})
    got = jax_gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                    coordinates)
    assert abs(got - expected) <= 1e-12, (got, expected)


def test_uhf_gradient_matches_finite_difference():
    """The analytic UHF gradient of the doublet OH/6-31G against a central
    difference of the port's own TIGHTSCF energies (h = 1e-4 bohr)."""
    line = "SPE : O H 0.97 : HF 6-31G : TIGHTSCF"
    calc_type, method, basis, symbols, coordinates, params = parse_input(line)
    calculation = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                         suppress_output=True)
    SCF_output, molecule, _, _ = energy.evaluate_molecular_energy(
        calculation, symbols, coordinates, silent=True, device="cpu")
    analytic = gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                     coordinates)
    h = 1e-4
    shift = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, h]])
    E_forward = energy.evaluate_molecular_energy(calculation, symbols, coordinates + shift,
                                                 silent=True, device="cpu")[2]
    E_backward = energy.evaluate_molecular_energy(calculation, symbols, coordinates - shift,
                                                  silent=True, device="cpu")[2]
    assert abs(analytic - (E_forward - E_backward) / (2 * h)) <= 5e-7


def test_uks_optimisation_matches_tuna_tpu():
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     m, E = run("OPT : O O 1.21 : B3LYP STO-3G : ML 3"); \
    #     print(repr(m.bond_length), repr(E))'
    # and the "Gradient" rows of its printout ("Optimisation converged in 5
    # iterations!")
    _kernels.reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        molecule, energy_opt = run("OPT : O O 1.21 : B3LYP STO-3G : ML 3", device="cpu")
    printed = printed.getvalue()
    assert all(count == 0 for count in _kernels.launches.values())
    assert abs(molecule.bond_length - 2.4291005059331745) <= angstrom_to_bohr(1e-6)
    assert abs(energy_opt - -148.2204950126887) <= 1e-8
    assert "Optimisation converged in 5 iterations!" in printed
    assert re.findall(r"Gradient\s+(-?\d+\.\d+)", printed) == [
        "-0.15288945", "0.04522951", "0.00996190", "-0.00091775", "0.00001651"]
    assert "UKS Spin Contamination" in printed

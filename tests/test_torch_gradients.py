"""The port's analytic gradients and the OPT, FREQ and MD drivers against
tuna_tpu.

* The plain twins of K8a (IntegralPlan.one_electron_deriv) and K8b
  (eri_deriv_energy, and the packed ERI tangent it contracts) against
  jax.jacfwd of tuna_tpu's plan.one_electron and plan.eri in the bond
  length, on identical primitive data: 1e-12 absolute (the same Hermite
  recursions in float64; the tangent's raised and lowered powers against
  forward-mode differentiation of them).
* The full gradient given tuna_tpu's own converged P and W, against its
  calculate_analytic_gradient: 1e-10 Ha/bohr.
* End to end against numbers tuna_tpu printed on the JAX CPU backend (the
  commands are in the comments): bond length 1e-6 angstrom (in bohr here),
  energies 1e-8 Ha, frequency 0.01 per cm, thermochemistry at its printed
  precision (1e-10 Ha), equal iteration counts.
"""

import contextlib
import functools
import io
import re

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
from tuna_tpu.ops import boys as jax_boys
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.drivers import gradients, md
from tuna_tpu_torch.ops import boys
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
SLOW = pytest.mark.slow   # JAX's compile of each system's jacfwd or grad takes 10-20 s
SYSTEMS = [
    (("H", "H"), 0.74, "STO-3G"),
    (("C", "O"), 1.13, "6-31G"),
    pytest.param(("N", "N"), 1.10, "6-311G", marks=SLOW),
    (("H", "F"), 0.95, "6-31G**"),   # d shells on F
]
ERI_SYSTEMS = [SYSTEMS[0], pytest.param(*SYSTEMS[1], marks=SLOW), SYSTEMS[2], SYSTEMS[3]]


@functools.lru_cache(maxsize=None)
def _plans(symbols, bond, basis):
    """(JAX plan, port plan on its arrays, R, charges, mass fraction)."""
    symbols = list(symbols)
    R = jax_constants.angstrom_to_bohr(bond)
    cfg = JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis, symbols,
                    suppress_output=True)
    molecule = JaxMolecule(symbols, np.array([[0.0, 0.0, 0.0], [0.0, 0.0, R]]), cfg)
    jax_plan = JaxPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    plan = IntegralPlan.from_arrays(*[np.asarray(getattr(jax_plan, name))
                                      for name in PLAN_FIELDS], n_atoms=molecule.n_atoms)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    return jax_plan, plan, R, molecule.charges.astype(float), float(masses[1] / masses.sum())


def _jax_coords(R):
    return jnp.stack([jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]) * R])


def _torch_coords(R):
    return torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, R]], dtype=torch.float64)


def test_boys_order_13_matches_tuna_tpu():
    """The derivative quartets of an f-shell basis need Boys order
    4 lmax + 1 = 13: its table builds, and the function matches tuna_tpu's
    and the host series."""
    T = np.concatenate([np.linspace(0.0, 30.0, 301) + 0.013, [30.0, 31.5, 45.0, 80.0]])
    ours = boys.boys_table(13, torch.as_tensor(T)).numpy()
    theirs = np.asarray(jax_boys.boys_table(13, jnp.asarray(T)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-14)
    small = T < 30.0
    series = boys._host_boys_top(13, T[small])
    np.testing.assert_allclose(ours[small, 13], series, rtol=1e-13, atol=0)
    assert boys.taylor_table(13, "cpu").shape == (301, 10)


@pytest.mark.parametrize("symbols,bond,basis", SYSTEMS)
def test_one_electron_tangent_matches_jacfwd(symbols, bond, basis):
    jax_plan, plan, R, charges, fraction = _plans(symbols, bond, basis)
    expected = jax.jacfwd(lambda r: jax_plan.one_electron(
        _jax_coords(r), jnp.asarray(charges), fraction * r))(R)
    got = plan.one_electron_deriv(_torch_coords(R), torch.as_tensor(charges), fraction * R,
                                  fraction)
    assert _kernels.launches["one_electron_deriv"] == 0
    for name, e, g in zip("STVDQ", expected, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("symbols,bond,basis", ERI_SYSTEMS)
def test_eri_tangent_matches_jacfwd(symbols, bond, basis):
    """The plain sweep's derivative values (the parity-matched quartets only,
    one-atom quartets zero) against forward-mode differentiation of the whole
    dense ERI, and the energy tangent K8b's plain twin contracts from them
    against jax.grad of tuna_tpu's E_2 with a density-like P."""
    jax_plan, plan, R, _, _ = _plans(symbols, bond, basis)
    expected = np.asarray(jax.jacfwd(lambda r: jax_plan.eri(_jax_coords(r)))(R))
    packed = plan._eri_packed_plain(_torch_coords(R), derivative=True)
    pidx = plan.tensors("cpu")["pair_index"]
    dense = packed[pidx[:, :, None, None], pidx[None, None, :, :]].numpy()
    np.testing.assert_allclose(dense, expected, rtol=0, atol=1e-12)

    N = plan.n_basis
    C = np.random.default_rng(5).standard_normal((N, 3)) / np.sqrt(N)
    P, hfx = C @ C.T, 0.3

    def energy(r):
        ERI = jax_plan.eri(_jax_coords(r))
        J = jnp.einsum("ijkl,kl->ij", ERI, P)
        K = jnp.einsum("ilkj,kl->ij", ERI, P)
        return 0.5 * jnp.sum(P * J) - 0.25 * hfx * jnp.sum(P * K)

    got = plan.eri_deriv_energy(_torch_coords(R), torch.as_tensor(P), hfx)
    assert abs(float(got) - float(jax.grad(energy)(R))) <= 1e-12
    assert _kernels.launches["eri_deriv_energy"] == 0


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread, as tests/test_torch_dft.py's fixture of
    that name gives the functionals (two threads once gave 3.6e-11 errors
    in the first B88 evaluation of a process)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _tuna_tpu_gradient(line):
    """tuna_tpu's converged SCF of `line` and its analytic gradient: (P, W,
    dE/dR) as numpy."""
    calc_type, method, basis, symbols, coordinates, params = jax_parse_input(line)
    calculation = JaxConfig(calc_type, jax_process(method), 0.0, params, basis, symbols,
                            suppress_output=True)
    SCF_output, molecule, _, _ = jax_energy.evaluate_molecular_energy(
        calculation, symbols, coordinates, silent=True)
    gradient = jax_gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                         coordinates)
    W = jax_gradients._energy_weighted_density(SCF_output, molecule, True)
    return (np.asarray(SCF_output.P_alpha + SCF_output.P_beta), np.asarray(W), gradient)


@pytest.mark.parametrize("line", [
    pytest.param("SPE : H H 0.74 : HF STO-3G", marks=SLOW),
    "SPE : LI H 1.6 : HF STO-3G : EZ 0.02 EGZ 0.01",
    "SPE : LI H 1.6 : B3LYP STO-3G : D2",
    pytest.param("SPE : H H 0.74 : SVWN 6-31G", marks=SLOW),
])
def test_gradient_at_tuna_tpu_density_matches(line, one_torch_thread):
    P, W, expected = _tuna_tpu_gradient(line)
    calc_type, method, basis, symbols, coordinates, params = parse_input(line)
    calculation = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                         suppress_output=True)
    molecule = Molecule(symbols, coordinates, calculation)
    molecule.process_basis_functions(calculation, molecule.spherical_transformation.shape[0])
    assert gradients.analytic_gradient_available(calculation, molecule)
    gradient_fn = gradients._build_gradient_fn(molecule, calculation, torch.device("cpu"))
    half = torch.tensor(P) / 2   # a restricted gradient reads only P_a + P_b
    got = gradient_fn(float(coordinates[1, 2]), half, half, torch.tensor(W))
    assert abs(got - expected) <= 1e-10, (got, expected)


def _run(line):
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        result = run(line, device="cpu")
    return result, buffer.getvalue()


def test_opt_matches_tuna_tpu():
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     m, E = run("OPT : H H 1.0 : B3LYP 6-31G"); print(repr(m.bond_length), repr(E))'
    # ("Optimisation converged in 7 iterations!" in its printout), and the
    # energy and RMS density change of the first two SCF iterations at each
    # of its seven geometries as it printed them: the MOREAD guess and the
    # plan cache give tuna_tpu's iterates.  From the third iteration on, the
    # DIIS Gram matrix of this 4-function basis has a condition number of
    # ~1e19, so rounding decides the extrapolation (the port's own SCF cycle
    # counts change with torch's thread count) and later iterates are not
    # compared; the converged energies are.
    expected = [[(-1.1462079521, 0.0673482485), (-1.1414017503, 0.0067097859)],
                [(-1.1574500997, 0.0157062386), (-1.1573868960, 0.0019249190)],
                [(-1.1682131889, 0.0176042739), (-1.1673831995, 0.0026327475)],
                [(-1.1690447670, 0.0134251314), (-1.1680098497, 0.0022524480)],
                [(-1.1684384754, 0.0061262992), (-1.1687509834, 0.0009749749)],
                [(-1.1687511100, 0.0007106320), (-1.1687108731, 0.0001139473)],
                [(-1.1687199295, 0.0000709156), (-1.1687159287, 0.0000113759)]]
    (molecule, energy), printed = _run("OPT : H H 1.0 : B3LYP 6-31G")
    assert abs(molecule.bond_length - 1.4042649853470401) <= jax_constants.angstrom_to_bohr(1e-6)
    assert abs(energy - -1.1687164812924133) <= 1e-8
    assert "Optimisation converged in 7 iterations!" in printed
    geometries = printed.split("Beginning energy and gradient iteration")[1:]
    assert len(geometries) == len(expected)
    for block, rows in zip(geometries, expected):
        found = re.findall(r"^\s+[12]\s+(-?\d+\.\d+)\s+-?\d+\.\d+\s+(\d+\.\d+)", block, re.M)
        assert [(float(e), float(rms)) for e, rms in found[:2]] == rows
    assert "Calculating analytic gradient" in printed


def test_freq_matches_tuna_tpu():
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     print(run("FREQ : C O 1.13 : HF 6-31G"))'
    # and the thermochemistry table of its printout
    (hessian, reduced_mass, frequency, zpe), printed = _run("FREQ : C O 1.13 : HF 6-31G")
    assert abs(frequency - 2291.503343670439) <= 0.01
    assert abs(zpe - 0.00522042873347617) <= 1e-8
    assert abs(hessian - 1.3624371113561518) <= 1e-8
    assert reduced_mass == 12498.103900045217
    expected = {"Zero-point energy:": 0.0052204287, "Internal energy:": -112.6596397757,
                "Enthalpy:": -112.6586955909, "Entropy:": 0.0224299949,
                "Gibbs free energy:": -112.6811255857}
    for label, value in expected.items():
        found = re.search(re.escape(label) + r"\s+(-?\d+\.\d+)", printed)
        assert found is not None, label
        assert abs(float(found.group(1)) - value) <= 1.5e-10, label


def test_md_matches_tuna_tpu(monkeypatch):
    # tuna_tpu's md._print_step wrapped to record molecule.bond_length and
    # the electronic energy of each step of
    #   run("MD : C O 1.13 : HF 6-31G : NUM 4 NOTRAJ")  (JAX CPU backend)
    expected = [(2.1353905222743963, -112.6672208310967),
                (2.135391701441666, -112.66722083319698),
                (2.1353952367469513, -112.66722083926815),
                (2.1354011216048256, -112.66722084934422)]
    steps = []
    print_step = md._print_step

    def record(time, iteration, masses, velocities, start, dof, energy, calculation, molecule):
        steps.append((molecule.bond_length, energy))
        print_step(time, iteration, masses, velocities, start, dof, energy, calculation, molecule)

    monkeypatch.setattr(md, "_print_step", record)
    energies, _ = _run("MD : C O 1.13 : HF 6-31G : NUM 4 NOTRAJ")
    assert len(steps) == len(expected) == len(energies)
    for (bond, energy), (bond_ref, energy_ref) in zip(steps, expected):
        assert abs(bond - bond_ref) <= 1e-8
        assert abs(energy - energy_ref) <= 1e-8


def test_force_and_optfreq_match_tuna_tpu():
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     print(run("FORCE : C O 1.13 : HF STO-3G")); \
    #     print(run("OPTFREQ : H H 0.74 : HF STO-3G"))'
    # and the "Gradient" rows of their convergence tables
    result, printed = _run("FORCE : C O 1.13 : HF STO-3G")
    assert result is None
    assert re.findall(r"Gradient\s+(-?\d+\.\d+)", printed) == ["-0.04833873"]
    (hessian, reduced_mass, frequency, zpe), printed = _run("OPTFREQ : H H 0.74 : HF STO-3G")
    assert re.findall(r"Gradient\s+(-?\d+\.\d+)", printed) == [
        "0.02767960", "-0.03668038", "0.00276337", "0.00025192", "-0.00000197", "0.00000000"]
    assert abs(frequency - 5481.715496129465) <= 0.01
    assert abs(zpe - 0.01248826678074945) <= 1e-8
    assert abs(hessian - 0.5730329034922488) <= 1e-8
    assert reduced_mass == 918.5762933780251


def test_md_writes_tuna_tpus_trajectory(tmp_path, monkeypatch):
    # tuna-trajectory.xyz and the energies of
    #   run("MD : H H 0.74 : HF STO-3G : NUM 3")  (JAX CPU backend)
    monkeypatch.chdir(tmp_path)
    energies, _ = _run("MD : H H 0.74 : HF STO-3G : NUM 3")
    expected = [-1.116759307480125, -1.1167664190278217, -1.1167874975451246]
    assert max(abs(e - r) for e, r in zip(energies, expected)) <= 1e-8
    assert (tmp_path / "tuna-trajectory.xyz").read_text() == (
        "2\nEnergy: -1.1167664190\n"
        "H        0.00000000     0.00000000     0.00006813\n"
        "H        0.00000000     0.00000000     0.73993187\n"
        "2\nEnergy: -1.1167874975\n"
        "H        0.00000000     0.00000000     0.00027192\n"
        "H        0.00000000     0.00000000     0.73972808\n")


@pytest.mark.parametrize("line", [
    "ANHARM : C O 1.13 : HF STO-3G",
    "SCAN : C O 1.13 : HF STO-3G : STEP 0.1 NUM 2 DIPOLE",
    "IP : C O 1.13 : HF STO-3G",
    "BDE : C O 1.13 : HF STO-3G",
    "FREQ : C O 1.13 : HF STO-3G : DIPOLE",
])
def test_unported_calculations_raise(line):
    with pytest.raises(TunaError, match="not yet ported"):
        _run(line)


def test_single_atom_optimisation_raises():
    with pytest.raises(TunaError, match="single atom"):
        _run("OPT : HE : HF STO-3G")


def test_uhf_and_correlated_gradients_are_not_analytic():
    """Correlated and VV10 gradients take finite differences, as in
    tuna_tpu; UHF, which tuna_tpu differentiates analytically, is analytic
    here too."""
    for line in ("OPT : H H 0.74 : UHF STO-3G", "OPT : H H 0.74 : CCSD STO-3G",
                 "OPT : H H 0.74 : B3LYP STO-3G : NL"):
        calc_type, method, basis, symbols, coordinates, params = parse_input(line)
        calculation = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                             suppress_output=True)
        molecule = Molecule(symbols, coordinates, calculation)
        molecule.process_basis_functions(calculation, molecule.spherical_transformation.shape[0])
        if calculation.reference == "UHF":
            assert gradients.analytic_gradient_available(calculation, molecule), line
        else:
            assert not gradients.analytic_gradient_available(calculation, molecule), line

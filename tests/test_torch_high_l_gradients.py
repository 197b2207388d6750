"""The analytic gradient's kernels at g and h shells (lmax 4 and 5) in the
port against tuna_tpu.

K8a, K8b and K8bu take lmax up to 5 on the card (ops/integrals.py::
KERNEL_MAX_LMAX); their CUDA kernels run only there (tests/test_torch_gpu.py,
chip_smoke.py phase 26).  Here the plain versions, which the wrappers take for
CPU tensors, meet tuna_tpu on the same primitive data: reduced diatomic plans
that keep the first g shell of H/cc-pV5Z or the first h shell of H/cc-pV6Z
on atom 0 and the first s shell on atom 1 (ops/integrals.py::shell_subset),
so that the tangents are not zero.  Tolerances: 1e-12 absolute for the
tangents (the same Hermite recursions in float64, the raised and lowered
powers against forward-mode differentiation of them, summed in another
order); 1e-10 Ha/bohr for the whole gradient, as in
tests/test_torch_gradients.py.

tuna_tpu is differentiated in forward mode (jax.jvp, the substitute for
jax.grad that tests/chip_smoke_references.py uses and that
tests/test_torch_uhf_gradients.py holds to jax.grad at 1e-12 Ha/bohr): at
lmax 4 the reverse-mode compile of its ERI sweep alone took 146 s on a
loaded 8-core host, and jax.jit(jax.grad) of its whole total_energy
600 s, where the forward derivative of each kernel compiles in 20-40 s.
Each reduced plan is tuna_tpu's plan cache's (drivers/common.py::
get_integral_plan), so the whole gradient function reuses the compiled
tangents of its one-electron integrals and its ERI at lmax 4.  At lmax 5
tuna_tpu's one-electron integrals run eagerly (jax.disable_jit): their
tangent took 11-16 s that way, where compiling it took 47-89 s.
"""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.cli import parse_input as jax_parse_input, process_method as jax_process
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.drivers import common as jax_common
from tuna_tpu.drivers import gradients as jax_gradients
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.ops import boys as jax_boys
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import parse_input, process_method
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.drivers import gradients
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import boys
from tuna_tpu_torch.ops.integrals import IntegralPlan, shell_subset
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
BOND = 0.74   # angstrom
# (basis, the shells kept as (atom, l)), lmax
REDUCED = [(("CC-PV5Z", ((0, 4), (1, 0))), 4), (("CC-PV6Z", ((0, 5), (1, 0))), 5)]


def _jvp(f, R):
    """tuna_tpu's derivative of f at R, forward mode."""
    return jax.jvp(f, (R,), (1.0,))[1]




def _jax_coords(R):
    return jnp.stack([jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]) * R])


def _torch_coords(R):
    return torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, R]], dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _plans(basis, keep):
    """(tuna_tpu's plan, the port's plan on its arrays, R, charges, mass
    fraction) of H2 with the shells `keep`."""
    R = jax_constants.angstrom_to_bohr(BOND)
    molecule = JaxMolecule(["H", "H"], np.array([[0.0, 0.0, 0.0], [0.0, 0.0, R]]),
                           JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis, ["H", "H"],
                                     suppress_output=True))
    molecule.cartesian_basis_functions = shell_subset(molecule.cartesian_basis_functions, keep)
    jax_plan = jax_common.get_integral_plan(molecule)
    plan = IntegralPlan.from_arrays(*[np.asarray(getattr(jax_plan, name))
                                      for name in PLAN_FIELDS], n_atoms=molecule.n_atoms)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    return jax_plan, plan, R, molecule.charges.astype(float), float(masses[1] / masses.sum())


def _densities(N, seed):
    """Seeded density-like P, P_a, P_b (symmetric, positive semidefinite)."""
    rng = np.random.default_rng(seed)
    C, C_a, C_b = (rng.standard_normal((N, k)) / np.sqrt(N) for k in (3, 3, 2))
    return C @ C.T, C_a @ C_a.T, C_b @ C_b.T


def test_boys_order_21_matches_tuna_tpu():
    """The derivative quartets of an h-shell basis need Boys order
    4 lmax + 1 = 21: its table builds, and the function matches tuna_tpu's
    and the host series."""
    T = np.concatenate([np.linspace(0.0, 30.0, 301) + 0.013, [30.0, 31.5, 45.0, 80.0]])
    ours = boys.boys_table(21, torch.as_tensor(T)).numpy()
    theirs = np.asarray(jax_boys.boys_table(21, jnp.asarray(T)))
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-14)
    small = T < 30.0
    series = boys._host_boys_top(21, T[small])
    np.testing.assert_allclose(ours[small, 21], series, rtol=1e-13, atol=0)
    assert boys.taylor_table(21, "cpu").shape == (301, 10)


@pytest.mark.parametrize("system,lmax", REDUCED)
def test_one_electron_tangent_matches_jvp(system, lmax):
    """K8a's plain version against the forward derivative of tuna_tpu's
    plan.one_electron in the bond length (atom 1 and the multipole origin
    moving), S, T, V, D and Q; at lmax 5 eagerly (the module docstring)."""
    jax_plan, plan, R, charges, fraction = _plans(*system)
    assert plan.lmax == lmax
    with jax.disable_jit() if lmax == 5 else contextlib.nullcontext():
        expected = _jvp(lambda r: jax_plan.one_electron(_jax_coords(r), jnp.asarray(charges),
                                                        fraction * r), R)
    _kernels.reset_launch_counts()
    got = plan.one_electron_deriv(_torch_coords(R), torch.as_tensor(charges), fraction * R,
                                  fraction)
    assert _kernels.launches["one_electron_deriv"] == 0
    assert max(float(np.max(np.abs(np.asarray(e)))) for e in expected) > 1e-3
    for name, e, g in zip("STVDQ", expected, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("system,lmax", REDUCED)
def test_eri_energy_tangents_match_jvp(system, lmax):
    """K8b's and K8bu's plain versions at a seeded P (and P_a, P_b) against
    the forward derivative of tuna_tpu's E_2 through plan.eri, contracted
    as its total_energy contracts the ERI (restricted and unrestricted)."""
    jax_plan, plan, R, _, _ = _plans(*system)
    P, P_a, P_b = _densities(plan.n_basis, 5)
    hfx = 0.3

    def energies(r):
        ERI = jax_plan.eri(_jax_coords(r))
        J = jnp.einsum("ijkl,kl->ij", ERI, P)
        K = jnp.einsum("ilkj,kl->ij", ERI, P)
        J_t = jnp.einsum("ijkl,kl->ij", ERI, P_a + P_b)
        K_a = jnp.einsum("ilkj,kl->ij", ERI, P_a)
        K_b = jnp.einsum("ilkj,kl->ij", ERI, P_b)
        return (0.5 * jnp.sum(P * J) - 0.25 * hfx * jnp.sum(P * K),
                0.5 * jnp.sum((P_a + P_b) * J_t)
                - 0.5 * hfx * (jnp.sum(P_a * K_a) + jnp.sum(P_b * K_b)))

    _kernels.reset_launch_counts()
    coords = _torch_coords(R)
    tangent = plan._eri_tangent_plain(coords)
    got = plan.eri_deriv_energy(coords, torch.as_tensor(P), hfx)
    got_u = plan.eri_deriv_energy_unrestricted(coords, torch.as_tensor(P_a),
                                               torch.as_tensor(P_b), hfx)
    assert _kernels.launches["eri_deriv_energy"] == 0
    assert _kernels.launches["eri_deriv_energy_unrestricted"] == 0
    assert float(got) == float(plan._eri_deriv_energy_plain(coords, torch.as_tensor(P), hfx,
                                                            tangent=tangent))
    expected, expected_u = _jvp(energies, R)
    assert abs(float(expected)) > 1e-3 and abs(float(expected_u)) > 1e-3
    assert abs(float(got) - float(expected)) <= 1e-12
    assert abs(float(got_u) - float(expected_u)) <= 1e-12


def _gradient_inputs(module_parse, module_config, module_process, module_molecule, line, keep):
    """A package's calculation and molecule for `line`, its basis cut to the
    shells `keep`."""
    calc_type, method, basis, symbols, coordinates, params = module_parse(line)
    calculation = module_config(calc_type, module_process(method), 0.0, params, basis, symbols,
                                suppress_output=True)
    molecule = module_molecule(symbols, coordinates, calculation)
    molecule.cartesian_basis_functions = shell_subset(molecule.cartesian_basis_functions, keep)
    return calculation, molecule, float(coordinates[1, 2])


@pytest.mark.parametrize("method", ["HF", "UHF"])
def test_gradient_function_at_g_shells_matches(method, monkeypatch):
    """The whole gradient function of each package (_build_gradient_fn) on
    H2 with the g shell of cc-pV5Z on atom 0 and an s shell on atom 1, at
    the same seeded Cartesian P_a, P_b and W (CARTHARM: the reduced basis
    has no spherical transform), restricted and unrestricted: 1e-10
    Ha/bohr.  Both read the plan of molecule.cartesian_basis_functions.
    tuna_tpu's is built with jax.grad in forward mode and its total_energy
    run eagerly around the jitted integrals (see the module docstring)."""
    line = f"SPE : H H {BOND} : {method} CC-PV5Z : CARTHARM"
    keep = REDUCED[0][0][1]
    jax_calculation, jax_molecule, R = _gradient_inputs(
        jax_parse_input, JaxConfig, jax_process, JaxMolecule, line, keep)
    calculation, molecule, _ = _gradient_inputs(parse_input, Config, process_method, Molecule,
                                                line, keep)
    assert calculation.cartesian_harmonics and jax_calculation.cartesian_harmonics
    assert gradients.analytic_gradient_available(calculation, molecule)
    N = len(molecule.cartesian_basis_functions)
    P, P_a, P_b = _densities(N, 7)
    W = -_densities(N, 8)[0]
    if method == "HF":
        P_a = P_b = P / 2
    monkeypatch.setattr(jax_gradients, "jax", types.SimpleNamespace(
        jit=lambda f: f, grad=lambda f, argnums=0: lambda R, *args: _jvp(lambda r: f(r, *args),
                                                                          R)))
    assert jax_common.get_integral_plan(jax_molecule) is _plans(*REDUCED[0][0])[0]
    expected = float(jax_gradients._build_gradient_fn(jax_molecule, jax_calculation)(
        R, jnp.asarray(P_a), jnp.asarray(P_b), jnp.asarray(W)))
    gradient_fn = gradients._build_gradient_fn(molecule, calculation, torch.device("cpu"))
    got = gradient_fn(R, torch.tensor(P_a), torch.tensor(P_b), torch.tensor(W))
    assert abs(got - expected) <= 1e-10, (got, expected)


def _shell_quartets_by_sort(plan):
    """shell_quartets as first built: the live quartets of the whole work
    list, oriented, then one lexsort over all of them."""
    quartets, _ = plan.work_list()
    first = plan.pair_start[:-1]
    atom = np.where(plan.atom1[first] == plan.atom2[first], plan.atom1[first], -1)
    A, B = quartets[:, 0].astype(np.int64), quartets[:, 1].astype(np.int64)
    live = ~((atom[A] >= 0) & (atom[A] == atom[B]))
    A, B = A[live], B[live]
    shell_pair, _ = plan.shell_pairs()
    L = (plan.l1[first].sum(axis=1) + plan.l2[first].sum(axis=1)).astype(np.int64)
    swap = (L[A] == L[B]) & (shell_pair[B] > shell_pair[A])
    A, B = np.where(swap, B, A), np.where(swap, A, B)
    sa, sb = shell_pair[A], shell_pair[B]
    order = np.lexsort((B, A, sb, sa, L[B], L[A]))
    A, B, sa, sb = A[order], B[order], sa[order], sb[order]
    begin = np.flatnonzero(np.r_[len(A) > 0, (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])])
    end = np.r_[begin[1:], len(A)][:len(begin)].astype(np.int64)
    components = np.ascontiguousarray(np.stack([A, B], axis=1), dtype=np.int32)
    table = np.stack([L[A[begin]], L[B[begin]], sa[begin], sb[begin], begin, end], axis=1)
    return components, table.astype(np.int32).reshape(-1, 6)


@pytest.mark.parametrize("symbols,bond,basis,keep", [
    (("H", "H"), 0.74, "STO-3G", None),
    (("C", "O"), 1.13, "6-31G", None),
    (("H", "F"), 0.95, "6-31G**", None),
    (("O", "H"), 0.97, "CC-PVTZ", None),
    (("C", "C"), 1.24, "ANO-PVTZ", None),
    (("H", "H"), BOND, "CC-PV5Z", ((0, 4), (1, 0))),
    (("H", "H"), BOND, "CC-PV6Z", ((0, 5), (1, 0))),
    (("N", "N"), 1.1, "CC-PV5Z", ((0, 0), (0, 4), (0, 5), (1, 3), (1, 5))),
])
def test_shell_quartets_match_the_whole_list_sort(symbols, bond, basis, keep):
    """IntegralPlan.shell_quartets, built shell quartet by shell quartet,
    gives bit for bit the arrays of one lexsort over every live quartet of
    the work list (the builder it replaces)."""
    symbols = list(symbols)
    coordinates = np.array([[0.0, 0.0, 0.0],
                            [0.0, 0.0, jax_constants.angstrom_to_bohr(bond)]])[:len(symbols)]
    molecule = Molecule(symbols, coordinates, Config("SPE", lookup_method("HF"), 0.0, [], basis,
                                                     symbols, suppress_output=True))
    functions = molecule.cartesian_basis_functions
    plan = IntegralPlan(shell_subset(functions, keep) if keep else functions, molecule.n_atoms)
    got = plan.shell_quartets()
    expected = _shell_quartets_by_sort(plan)
    assert len(expected[0]) > 0
    for g, e in zip(got, expected):
        assert g.dtype == e.dtype and g.shape == e.shape
        np.testing.assert_array_equal(g, e)

"""The port's unrestricted Kohn-Sham (tuna_tpu_torch.dft, on the CPU) against
tuna_tpu's on the JAX CPU backend.

Both packages get the same numpy-seeded inputs.  Tolerances:

  * spin-resolved correlation functionals and unrestricted_derivatives:
    1e-12 relative (the tolerance of test_functional_matches_tuna_tpu),
    relative to the value plus the size of the terms that make it up (see
    _term_scale); the port's side on one torch thread;
  * the unrestricted XC closure (V_XC of each spin, the grid energies and
    densities): 1e-11 absolute, as the restricted closure's test;
  * single points at TIGHTSCF: 1e-10 Ha with equal SCF iteration counts.
    OH (a doublet with one beta hole in its pi shell) is the exception:
    the eigensolver picks the hole's orientation in the degenerate pi pair
    (LAPACK's choice in tuna_tpu, torch's here), and the Lebedev grid is
    not symmetric under rotation about the bond, so the XC energy depends
    on that orientation (test_open_pi_shell_xc_energy_depends_on_orientation
    measures it) and the two runs follow other paths (14 and 48 SCF
    iterations, 9e-11 Ha apart).  OH is held in energy only, to 5e-10 Ha:
    a few times the orientation's effect, where a converged energy's
    rounding alone could move it past 1e-10.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.cli import run as jax_run
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.dft import grid as jax_grid
from tuna_tpu.dft import make_xc_closure as jax_make_xc_closure
from tuna_tpu.dft import xc as jax_xc
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.dft import grid, make_xc_closure, xc
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread, as tests/test_torch_dft.py's fixture of
    that name gives the functionals."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# Spin-resolved correlation functionals
# --------------------------------------------------------------------------

def _spin_inputs(n=10_000, seed=3):
    """Seeded (rho_a, rho_b, sigma_aa, sigma_bb, sigma_ab) with rho_a != rho_b
    over 12 decades, |sigma_ab| <= sqrt(sigma_aa sigma_bb) as for real
    gradients."""
    rng = np.random.default_rng(seed)
    na, nb, saa, sbb = (10.0 ** rng.uniform(-10, 2, n) for _ in range(4))
    sab = rng.uniform(-1.0, 1.0, n) * np.sqrt(saa * sbb)
    return na, nb, saa, sbb, sab


def _term_scale(na, nb, saa, sbb, sab, derivatives):
    """The size of the terms that make up each output at each point: the
    local part, |eps| of spin-unpolarised VWN5 at rho_a + rho_b, plus the
    gradient part sum_x |df/dsigma_x| |sigma_x| / rho; that times rho /
    |sigma_x| for df/dsigma_x.  Where the reduced gradient is large the two
    parts cancel (PBE and PW91: eps_LDA + H -> 0), and what is left is
    rounding of terms of this size."""
    density = na + nb
    local = np.abs(np.asarray(jax_xc._vwn_eps(jnp.asarray(density), *jax_xc._VWN5_PARA)))
    sigmas = (saa, sbb, sab)
    gradient = sum(np.abs(np.asarray(d)) * np.abs(s) / density
                   for d, s in zip(derivatives[2:5], sigmas) if d is not None)
    term = local + gradient
    # the scales of df/dna, df/dnb (and eps), df/dsaa, df/dsbb, df/dsab
    return [term, term] + [term * density / np.abs(s) for s in sigmas]


# (name, method name): every key of the port's registry that reads no tau,
# 3P under each of the method names that select its four variants (the
# meta-GGAs and B97, whose opposite-spin part needs a looser bound where
# one spin is nearly empty: tests/test_torch_meta_gga.py)
FUNCTIONALS = (
    [(name, "") for name, fn in xc.UNRESTRICTED_CORRELATION_FUNCTIONALS.items()
     if name not in ("3P", "B97") and not fn.needs_tau]
    + [("3P", method) for method in ("B3LYP", "B3LYP/G", "B3P86", "B3PW91")]
)


@pytest.mark.parametrize("name,method", FUNCTIONALS)
def test_unrestricted_functional_matches_tuna_tpu(name, method, one_torch_thread):
    inputs = _spin_inputs()
    got = xc.unrestricted_derivatives(
        xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name], *map(torch.as_tensor, inputs), None,
        None, xc.XCParams(method_name=method))
    expected = jax_xc.unrestricted_derivatives(
        jax_xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name], *map(jnp.asarray, inputs), None,
        None, jax_xc.XCParams(method_name=method))
    # order: df/dna, df/dnb, df/dsaa, df/dsbb, df/dsab, df/dta, df/dtb, eps
    assert got[5] is got[6] is expected[5] is expected[6] is None
    scales = _term_scale(*inputs, expected)
    for index in (7, 0, 1, 2, 3, 4):
        g, e = got[index], expected[index]
        assert (g is None) == (e is None), index
        if g is None:
            continue
        e = np.asarray(e)
        assert np.all(np.isfinite(e)) and np.all(np.isfinite(g.numpy()))
        scale = scales[0] if index == 7 else scales[index]
        assert np.max(np.abs(g.numpy() - e) / (np.abs(e) + scale)) <= 1e-12, index


def test_unrestricted_registry_has_the_restricted_keys():
    """The spin-resolved registry holds the port's restricted correlation
    functionals, each under tuna_tpu's key and with its sigma and tau flags,
    and every key of tuna_tpu's registry."""
    assert set(xc.UNRESTRICTED_CORRELATION_FUNCTIONALS) == set(xc.CORRELATION_FUNCTIONALS)
    assert set(xc.UNRESTRICTED_CORRELATION_FUNCTIONALS) == set(
        jax_xc.UNRESTRICTED_CORRELATION_FUNCTIONALS)
    for name, fn in xc.UNRESTRICTED_CORRELATION_FUNCTIONALS.items():
        reference = jax_xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name]
        assert fn.needs_sigma == reference.needs_sigma, name
        assert fn.needs_tau == reference.needs_tau, name


def test_unrestricted_derivatives_work_under_no_grad():
    inputs = [torch.as_tensor(x) for x in _spin_inputs(100)]
    with torch.no_grad():
        out = xc.unrestricted_derivatives(xc.UNRESTRICTED_CORRELATION_FUNCTIONALS["LYP"],
                                          *inputs, None, None, xc.XCParams())
    assert all(out[i].shape == (100,) for i in (0, 1, 2, 3, 4, 7))


# --------------------------------------------------------------------------
# The unrestricted XC closure
# --------------------------------------------------------------------------

def _spin_densities(molecule, seed):
    """Seeded alpha and beta densities with the molecule's electron counts:
    C C^T with C = S^-1/2 Q, Q orthonormal columns (spherical basis)."""
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64)
    U = molecule.spherical_transformation
    S = U @ plan.one_electron(coords, charges, 0.0)[0].numpy() @ U.T
    w, V = np.linalg.eigh(S)
    X = V @ np.diag(w ** -0.5) @ V.T
    Q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((S.shape[0],) * 2))
    C_a, C_b = X @ Q[:, :molecule.n_alpha], X @ Q[:, :molecule.n_beta]
    return C_a @ C_a.T, C_b @ C_b.T


@pytest.mark.parametrize("method", ["SVWN", "B3LYP", "PBE"])
def test_unrestricted_xc_closure_matches_tuna_tpu(method):
    symbols = ["O", "H"]
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, jax_constants.angstrom_to_bohr(0.97)]])
    jax_cfg = JaxConfig("SPE", jax_lookup_method(method), 0.0, [], "6-31G", symbols,
                        suppress_output=True)
    cfg = Config("SPE", lookup_method(method), 0.0, [], "6-31G", symbols, suppress_output=True)
    jax_mol, mol = JaxMolecule(symbols, coords, jax_cfg), Molecule(symbols, coords, cfg)
    n = mol.n_cartesian_basis
    for m, c in ((jax_mol, jax_cfg), (mol, cfg)):
        m.process_basis_functions(c, n)
    assert cfg.reference == jax_cfg.reference == "UHF"
    P_a, P_b = _spin_densities(mol, 5)

    jax_grid_container = jax_grid.set_up_integration_grid(jax_mol, P_a, P_b, jax_cfg, True)
    grid_container = grid.set_up_integration_grid(mol, P_a, P_b, cfg, True, "cpu")
    expected = jax_make_xc_closure(jax_cfg, jax_grid_container)(
        jnp.asarray(P_a), jnp.asarray(P_b), jax_cfg.HFX_prop, jax_cfg.DFX_prop,
        jax_cfg.DFC_prop)
    _kernels.reset_launch_counts()
    got = make_xc_closure(cfg, grid_container)(torch.as_tensor(P_a), torch.as_tensor(P_b),
                                               cfg.DFX_prop, cfg.DFC_prop)
    assert all(count == 0 for count in _kernels.launches.values())
    assert not torch.allclose(got[0], got[1])   # the spins' V_XC differ
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-11)


# --------------------------------------------------------------------------
# Single points
# --------------------------------------------------------------------------

def _jax_energy_and_iterations(line):
    """tuna_tpu's total energy and SCF iteration count (from its printout)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, _, energy, _ = jax_run(line)
    counts = re.findall(r"converged in (\d+) cycles", printed.getvalue())
    assert len(counts) == 1
    return energy, int(counts[0])


def _port(line):
    _kernels.reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        scf, molecule, energy, P = run(line, device="cpu")
    assert all(count == 0 for count in _kernels.launches.values())
    assert molecule.calculation.reference == "UHF"
    assert "UKS Spin Contamination" in printed.getvalue()
    n = molecule.n_basis
    assert P.shape == (n, n) and scf.alpha_density is not None
    return scf, energy


@pytest.mark.parametrize("line", [
    "SPE : O O 1.21 : B3LYP STO-3G : ML 3 TIGHTSCF",   # triplet O2
    "SPE : LI : UB3LYP 6-31G : ML 2 TIGHTSCF",          # tuna_tpu's tests/test_dft.py:99
    "SPE : O O 1.21 : SVWN STO-3G : ML 3 TIGHTSCF",    # LDA
])
def test_uks_energy_matches_tuna_tpu(line):
    jax_energy, jax_iterations = _jax_energy_and_iterations(line)
    scf, energy = _port(line)
    assert abs(energy - jax_energy) <= 1e-10
    assert len(scf.iteration_seconds) == jax_iterations


@pytest.mark.parametrize("line,energy_ref,iterations_ref", [
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     print(repr(run("SPE : N H 1.04 : PBE 6-31G : ML 3 TIGHTSCF")[2]))'
    # ("Self-consistent field converged in 14 cycles!" in its printout)
    ("SPE : N H 1.04 : PBE 6-31G : ML 3 TIGHTSCF", -55.133497969744134, 14),
    # the same command for OH: energy only (see the module docstring)
    ("SPE : O H 0.97 : PBE 6-31G : TIGHTSCF", -75.62126436168478, None),
])
def test_uks_gga_energy_matches_tuna_tpu(line, energy_ref, iterations_ref):
    scf, energy = _port(line)
    assert abs(energy - energy_ref) <= (1e-10 if iterations_ref is not None else 5e-10)
    if iterations_ref is not None:
        assert len(scf.iteration_seconds) == iterations_ref


def test_open_pi_shell_xc_energy_depends_on_orientation():
    """The converged UKS densities of OH PBE/6-31G rotated about the bond:
    the XC energy on the grid changes with the angle (by ~5e-11 Ha, the
    scale of the OH line's gap to tuna_tpu) and is the same at 0 and 90
    degrees (the grid maps x to y)."""
    scf, molecule, _, _ = run("SPE : O H 0.97 : PBE 6-31G : TIGHTSCF", suppress_output=True,
                              device="cpu")
    calculation = molecule.calculation
    P_a, P_b = scf.P_alpha.numpy(), scf.P_beta.numpy()
    closure = make_xc_closure(
        calculation, grid.set_up_integration_grid(molecule, P_a, P_b, calculation, True, "cpu"))
    lmn = [tuple(bf.lmn) for bf in molecule.cartesian_basis_functions]
    assert molecule.spherical_transformation.shape[0] == len(lmn)   # s and p only
    energies = []
    for degrees in (0, 15, 30, 45, 60, 90):
        c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
        R = np.eye(len(lmn))
        for i, powers in enumerate(lmn):
            if powers == (1, 0, 0):   # the (p_x, p_y) pair of a p shell
                assert lmn[i + 1] == (0, 1, 0)
                R[i:i + 2, i:i + 2] = [[c, -s], [s, c]]
        out = closure(torch.as_tensor(R @ P_a @ R.T), torch.as_tensor(R @ P_b @ R.T),
                      calculation.DFX_prop, calculation.DFC_prop)
        energies.append(float(out[2] + out[3]))
    spread = np.abs(np.array(energies) - energies[0])
    assert 1e-11 < np.max(spread) < 1e-9, spread
    assert spread[-1] < 1e-13


def test_empty_spin_fails_as_in_tuna_tpu():
    """A spin with no electrons (triplet H2): rho_b sits on its floor, zeta
    is 1, and the spin interpolation of VWN and PW92 differentiates
    cbrt(1 - zeta) at 0.  tuna_tpu's jax.grad gives NaN there and its SCF
    does not converge; the port keeps the expression, gives NaN at the same
    points (LYP, which has no zeta, stays finite in both) and stops with
    the same error."""
    na = np.array([1e-3, 0.3, 1e-20])
    nb = np.full(3, xc.DENSITY_FLOOR)
    saa, sbb, sab = np.array([1e-4, 1e-2, 1e-40]), np.full(3, xc.SIGMA_FLOOR), np.zeros(3)
    for name, method in (("VWN5", ""), ("PW", ""), ("3P", "B3LYP"), ("LYP", "")):
        got = xc.unrestricted_derivatives(
            xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name],
            *map(torch.as_tensor, (na, nb, saa, sbb, sab)), None, None,
            xc.XCParams(method_name=method))
        expected = jax_xc.unrestricted_derivatives(
            jax_xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name],
            *map(jnp.asarray, (na, nb, saa, sbb, sab)), None, None,
            jax_xc.XCParams(method_name=method))
        for index in (0, 1):
            np.testing.assert_array_equal(np.isnan(got[index].numpy()),
                                          np.isnan(np.asarray(expected[index])), err_msg=name)
        assert np.isnan(got[0].numpy()[0]) == (name != "LYP"), name
    with pytest.raises(TunaError, match="not converged"):
        run("SPE : H H 0.74 : B3LYP STO-3G : ML 3", suppress_output=True, device="cpu")


# --------------------------------------------------------------------------
# Open-shell atoms
# --------------------------------------------------------------------------
#
# Constants from tuna_tpu on the JAX CPU backend, printed by
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(repr(run(LINE)[2]))'
# ("Self-consistent field converged in N cycles!" in its printout).  An
# atom starts from the core-Hamiltonian guess, whose 2p eigenvectors form a
# degenerate block: LAPACK picks a basis of it, the polished eigh keeps
# that pick, and the builds of LAPACK under jaxlib and torch pick
# differently, so the two packages occupy differently oriented p orbitals
# from the first iteration (carbon: guess alpha densities 0.86 apart,
# first SCF energies 3.8e-7 Ha apart, from the Lebedev grid's anisotropy).
# Where the p shell is full or half full (the LDA oxygen, UHF carbon) the
# runs still agree; B and F reach tuna_tpu's energy by other SCF paths;
# oxygen and carbon under GGAs do not converge in one package or either.
# The runs are on one torch thread: oxygen PBE converged in 82 cycles on
# two.

@pytest.mark.parametrize("line,energy_ref,iterations_ref", [
    ("SPE : O : SVWN 6-31G : ML 3 TIGHTSCF", -74.484843649288, 12),
    ("SPE : C : UHF 6-31G : ML 3 TIGHTSCF", -37.67783701064292, 10),
])
def test_atom_matches_tuna_tpu(line, energy_ref, iterations_ref, one_torch_thread):
    scf, _, energy, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == iterations_ref


@pytest.mark.parametrize("line,energy_ref", [
    ("SPE : B : B3LYP 6-31G : ML 2 TIGHTSCF", -24.63510531179403),   # 45 cycles there
    ("SPE : F : B3LYP 6-31G : ML 2 TIGHTSCF", -99.67970877759895),   # 42 cycles there
])
def test_gga_atom_energy_matches_tuna_tpu(line, energy_ref, one_torch_thread):
    _, _, energy, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_ref) <= 1e-8


def test_oxygen_pbe_does_not_converge_as_in_tuna_tpu(one_torch_thread):
    # tuna_tpu: "Self-consistent field not converged in 100 iterations!"
    with pytest.raises(TunaError, match="not converged"):
        run("SPE : O : PBE 6-31G : ML 3 TIGHTSCF", suppress_output=True, device="cpu")


@pytest.mark.xfail(strict=True, raises=TunaError,
                   reason="the port's SCF wanders among orientations of the p hole and does "
                          "not converge in 100 cycles, where tuna_tpu converges in 9")
@pytest.mark.parametrize("line,energy_ref,iterations_ref", [
    ("SPE : C : B3LYP 6-31G : ML 3 TIGHTSCF", -37.822278292425096, 9),
    ("SPE : C : PBE 6-31G : ML 3 TIGHTSCF", -37.78009638319809, 9),
])
def test_carbon_gga_matches_tuna_tpu(line, energy_ref, iterations_ref, one_torch_thread):
    scf, _, energy, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == iterations_ref

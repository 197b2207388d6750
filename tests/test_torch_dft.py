"""The port's restricted Kohn-Sham DFT and VV10 (tuna_tpu_torch.dft, on the
CPU) against tuna_tpu's on the JAX CPU backend.

Both packages get the same numpy-seeded inputs.  Tolerances:

  * functionals: energy density and derivatives 1e-12 relative (the same
    expressions in float64, torch's elementwise functions and autograd in
    place of XLA's and jax.grad), relative to the value plus the size of
    its terms (see _term_scale); the cube root (x^(1/3) in the port)
    1e-14 relative against jnp.cbrt.  The port's side is evaluated on one
    torch thread (see one_torch_thread);
  * grid points and weights: equal (the same NumPy code);
  * AO values and gradients (plain K7a): 1e-12 absolute;
  * XC matrix and energies: 1e-11 absolute (grid sums of 1e4-1e5 terms in
    another order);
  * VV10 pair sum (plain K6): 1e-12 relative;
  * end to end: 1e-9 Ha, with the same number of SCF iterations.
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
from tuna_tpu.dft import vv10 as jax_vv10
from tuna_tpu.dft import xc as jax_xc
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.dft import grid, make_xc_closure, vv10, xc
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)


def _molecules(symbols, bond, basis, method="HF", params=()):
    symbols = list(symbols)
    coords = np.array([[0.0, 0.0, 0.0],
                       [0.0, 0.0, jax_constants.angstrom_to_bohr(bond)]])[:len(symbols)]
    jax_cfg = JaxConfig("SPE", jax_lookup_method(method), 0.0, list(params), basis, symbols,
                        suppress_output=True)
    cfg = Config("SPE", lookup_method(method), 0.0, list(params), basis, symbols,
                 suppress_output=True)
    return (JaxMolecule(symbols, coords, jax_cfg), jax_cfg,
            Molecule(symbols, coords, cfg), cfg)


# --------------------------------------------------------------------------
# Functionals
# --------------------------------------------------------------------------

def _density_sigma_pairs(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    return 10.0 ** rng.uniform(-10, 2, n), 10.0 ** rng.uniform(-10, 2, n)


def _term_scale(registry, density, sigma, df_ds):
    """The size of the terms that make up (eps, df/drho, df/dsigma) at each
    point: the local part, |eps| of Slater exchange or VWN5 correlation,
    plus the gradient part |df/dsigma| sigma / rho, and that times
    rho / sigma for df/dsigma.  At large reduced gradients the two parts
    cancel (PBE correlation: eps_LDA + H -> 0), and what is left is
    rounding of terms of this size."""
    if registry == "x":
        local = 0.75 * (3 / np.pi) ** (1 / 3) * np.cbrt(density)
    else:
        local = np.abs(np.asarray(jax_xc._vwn_eps(jnp.asarray(density), *jax_xc._VWN5_PARA)))
    term = local + (np.abs(np.asarray(df_ds)) * sigma / density if df_ds is not None else 0.0)
    return term, term, term * density / sigma


# (registry, name, method name, exchange name): every ported entry that
# reads no tau, with 3P under each of the method names that select its four
# variants (the meta-GGAs: tests/test_torch_meta_gga.py).
FUNCTIONALS = (
    [("x", name, "", name) for name, fn in xc.EXCHANGE_FUNCTIONALS.items() if not fn.needs_tau]
    + [("c", name, "", None) for name, fn in xc.CORRELATION_FUNCTIONALS.items()
       if name != "3P" and not fn.needs_tau]
    + [("c", "3P", method, None) for method in ("B3LYP", "B3LYP/G", "B3P86", "B3PW91")]
)


@pytest.fixture
def one_torch_thread():
    """Run the test on one torch intra-op thread.

    torch splits the elementwise ops it hands to MKL's vector math (sqrt,
    exp, log: grain 2048) over its intra-op threads.  With two threads, the
    first B88 evaluation of a process (a worker whose first file was this
    one) sometimes gave points 5001-9999 of 10,000, the second thread's
    half, off by up to 3.6e-11 relative, while a second evaluation in the
    same process was exact; torch.sqrt(sigma) is the one op of B88 split
    over threads at this size.  On one thread every point comes from the
    same call path."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("registry,name,method,x_name", FUNCTIONALS)
def test_functional_matches_tuna_tpu(registry, name, method, x_name, one_torch_thread):
    density, sigma = _density_sigma_pairs()
    table, jax_table = ((xc.EXCHANGE_FUNCTIONALS, jax_xc.EXCHANGE_FUNCTIONALS)
                        if registry == "x" else
                        (xc.CORRELATION_FUNCTIONALS, jax_xc.CORRELATION_FUNCTIONALS))
    params = xc.XCParams(method_name=method, x_name=x_name)
    jax_params = jax_xc.XCParams(method_name=method, x_name=x_name)
    df_dn, df_ds, df_dt, eps = xc.restricted_derivatives(
        table[name], torch.as_tensor(density), torch.as_tensor(sigma), None, params)
    expected = jax_xc.restricted_derivatives(jax_table[name], jnp.asarray(density),
                                             jnp.asarray(sigma), None, jax_params)
    assert df_dt is None and expected[2] is None
    assert (df_ds is None) == (expected[1] is None)
    scale_eps, scale_dn, scale_ds = _term_scale(registry, density, sigma, expected[1])
    for got, e, scale in ((eps, expected[3], scale_eps), (df_dn, expected[0], scale_dn),
                          (df_ds, expected[1], scale_ds)):
        if got is None:
            continue
        e = np.asarray(e)
        assert np.all(np.isfinite(e)) and np.all(np.isfinite(got.numpy()))
        error = np.abs(got.numpy() - e) / (np.abs(e) + scale)
        assert np.max(error) <= 1e-12


@pytest.mark.parametrize("name", ["B", "PBE"])
def test_first_functional_call_is_reproducible(name, one_torch_thread):
    """The first evaluation of a sqrt-using functional in the process,
    under one_torch_thread, is bitwise equal to a repeated one.  This
    checks the state the comparison now runs in; it does not reproduce the
    two-thread fault (see one_torch_thread), which showed only in some
    fresh processes on a loaded machine, and which nothing here tests."""
    assert torch.get_num_threads() == 1
    density, sigma = (torch.as_tensor(x) for x in _density_sigma_pairs())
    functional = xc.EXCHANGE_FUNCTIONALS[name]
    first = xc.restricted_derivatives(functional, density, sigma, None, xc.XCParams())
    again = xc.restricted_derivatives(functional, density.clone(), sigma.clone(), None,
                                      xc.XCParams())
    for a, b in zip(first, again):
        if a is not None:
            assert torch.equal(a, b)


def test_restricted_derivatives_work_under_no_grad():
    density, sigma = _density_sigma_pairs(100)
    with torch.no_grad():
        df_dn, df_ds, _, _ = xc.restricted_derivatives(
            xc.EXCHANGE_FUNCTIONALS["B"], torch.as_tensor(density), torch.as_tensor(sigma),
            None, xc.XCParams())
    assert df_dn.shape == (100,) and df_ds.shape == (100,)


def test_cube_root_matches_jnp_cbrt():
    x = 10.0 ** np.random.default_rng(1).uniform(-23, 3, 10_000)
    np.testing.assert_allclose(xc._cbrt(torch.as_tensor(x)).numpy(), np.asarray(jnp.cbrt(x)),
                               rtol=1e-14, atol=0)


# --------------------------------------------------------------------------
# Grid, AO values (plain K7a), density (plain K7b)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("symbols,bond", [(("N", "N"), 1.1), (("LI", "H"), 1.6)])
def test_grid_equals_tuna_tpu(symbols, bond):
    jax_mol, jax_cfg, mol, cfg = _molecules(symbols, bond, "STO-3G", "B3LYP")
    parameters = grid.grid_parameters(mol, cfg)
    assert parameters == jax_grid.grid_parameters(jax_mol, jax_cfg)
    points, weights = grid.build_molecular_grid(*parameters, mol.bond_length, mol.atoms)
    jax_points, jax_weights = jax_grid.build_molecular_grid(
        *parameters, jax_mol.bond_length, jax_mol.atoms)
    np.testing.assert_array_equal(points, jax_points)
    np.testing.assert_array_equal(weights, jax_weights)


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
def test_ao_values_and_gradients_match_tuna_tpu(basis):
    jax_mol, jax_cfg, mol, cfg = _molecules(("N", "N"), 1.1, basis, "B3LYP", ["LOOSEGRID"])
    points, _ = grid.build_molecular_grid(*grid.grid_parameters(mol, cfg), mol.bond_length,
                                          mol.atoms)
    U = mol.spherical_transformation
    _kernels.reset_launch_counts()
    bfs, grads = grid.basis_on_grid(mol.cartesian_basis_functions, torch.as_tensor(points),
                                    U, with_gradients=True)
    assert _kernels.launches["ao_on_grid"] == 0   # a CPU tensor takes the plain version
    assert max(sum(bf.lmn) for bf in mol.cartesian_basis_functions) == (2 if "*" in basis else 3)
    expected = jax_grid.construct_basis_functions_on_grid(
        jax_mol.cartesian_basis_functions, points, U)
    np.testing.assert_allclose(bfs.numpy(), expected, rtol=0, atol=1e-12)
    expected = jax_grid.construct_basis_function_gradients_on_grid(
        jax_mol.cartesian_basis_functions, points, U)
    assert np.all(np.isfinite(expected))
    np.testing.assert_allclose(grads.numpy(), expected, rtol=0, atol=1e-12)


def test_density_on_grid_matches_tuna_tpu():
    _, _, mol, cfg = _molecules(("N", "N"), 1.1, "6-31G", "B3LYP", ["LOOSEGRID"])
    points, _ = grid.build_molecular_grid(*grid.grid_parameters(mol, cfg), mol.bond_length,
                                          mol.atoms)
    bfs, grads = grid.basis_on_grid(mol.cartesian_basis_functions, torch.as_tensor(points),
                                    mol.spherical_transformation, with_gradients=True)
    rng = np.random.default_rng(2)
    n = bfs.shape[0]
    P = rng.standard_normal((n, n))
    density, gradient = grid.density_on_grid(torch.as_tensor(P), bfs, grads)
    b, g = jnp.asarray(bfs.numpy()), jnp.asarray(grads.numpy())
    np.testing.assert_allclose(
        density.numpy(), np.asarray(jax_grid.construct_density_on_grid(P, b, False)),
        rtol=0, atol=1e-12)
    expected = 2 * jnp.einsum("ij,ikl,ajkl->akl", jnp.asarray(P), b, g)
    np.testing.assert_allclose(gradient.numpy(), np.asarray(expected), rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# XC closure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["LDA", "B3LYP", "PBE"])
def test_xc_closure_matches_tuna_tpu(method):
    jax_mol, jax_cfg, mol, cfg = _molecules(("H", "H"), 0.74, "6-31G", method)
    n = mol.n_cartesian_basis
    for m, c in ((jax_mol, jax_cfg), (mol, cfg)):
        m.process_basis_functions(c, n)
    rng = np.random.default_rng(0)
    P0 = rng.standard_normal((n, n))
    P0 = P0 @ P0.T / n + np.eye(n) * 0.5
    P0 *= 2.0 / np.trace(P0)
    half = P0 / 2

    jax_grid_container = jax_grid.set_up_integration_grid(jax_mol, half, half, jax_cfg, True)
    grid_container = grid.set_up_integration_grid(mol, half, half, cfg, True, "cpu")
    jax_out = jax_make_xc_closure(jax_cfg, jax_grid_container)(
        jnp.asarray(half), jnp.asarray(half), jax_cfg.HFX_prop, jax_cfg.DFX_prop,
        jax_cfg.DFC_prop)
    P_half = torch.as_tensor(half)
    out = make_xc_closure(cfg, grid_container)(P_half, P_half, cfg.DFX_prop, cfg.DFC_prop)
    for got, expected in zip(out, jax_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-11)


# --------------------------------------------------------------------------
# VV10 (plain K6)
# --------------------------------------------------------------------------

def test_vv10_pair_sum_matches_tuna_tpu():
    M = 3072   # a multiple of tuna_tpu's 512-row chunk
    rng = np.random.default_rng(4)
    pts = rng.uniform(-4.0, 4.0, (M, 3))
    density = 10.0 ** rng.uniform(-6, 1, M)
    sigma = density ** (8 / 3) * rng.uniform(0.0, 4.0, M)
    w = rng.uniform(0.0, 0.05, M)
    b, C = 4.8, 0.0093
    _kernels.reset_launch_counts()
    got = float(vv10.vv10_energy(*(torch.as_tensor(v) for v in (density, w, sigma, pts)), b, C))
    assert _kernels.launches["vv10_energy"] == 0
    expected = float(jax_vv10._vv10_kernel(jnp.asarray(density), jnp.asarray(w),
                                           jnp.asarray(sigma), jnp.asarray(pts), b, C, M))
    assert np.isfinite(expected) and expected != 0.0
    assert abs(got - expected) <= 1e-12 * abs(expected)


def _vv10_by_tile_pairs(pts, omega, kappa, weighted_density, beta, tile):
    """K6's decomposition in plain torch: the tile pairs J >= I only, an
    off-diagonal pair counted twice, a diagonal tile summed whole (i = j
    included) with beta w_i added once."""
    M = len(weighted_density)
    n_tiles = -(-M // tile)
    energy = torch.zeros((), dtype=torch.float64)
    for I in range(n_tiles):
        i = slice(I * tile, (I + 1) * tile)
        for J in range(I, n_tiles):
            j = slice(J * tile, (J + 1) * tile)
            d2 = torch.sum((pts[i, None, :] - pts[None, j, :]) ** 2, dim=-1)
            g_i = d2 * omega[i, None] + kappa[i, None]
            g_j = d2 * omega[None, j] + kappa[None, j]
            inner = (1.0 / (g_i * g_j * (g_i + g_j))) @ weighted_density[j]
            energy += weighted_density[i] @ (beta - 0.75 * inner if I == J else -1.5 * inner)
    return energy


@pytest.mark.parametrize("M, tile", [(1, vv10.VV10_TILE), (1300, vv10.VV10_TILE), (1300, 97),
                                     (1024, vv10.VV10_TILE)])
def test_vv10_tile_pairs_match_tuna_tpu(M, tile):
    """The triangular tiling of K6 at M = 1, at M not a multiple of the
    tile, and at a multiple, against tuna_tpu's kernel on its zero-weight
    padding to a multiple of 512 points."""
    rng = np.random.default_rng(M + tile)
    pts = rng.uniform(-4.0, 4.0, (M, 3))
    density = 10.0 ** rng.uniform(-6, 1, M)
    sigma = density ** (8 / 3) * rng.uniform(0.0, 4.0, M)
    w = rng.uniform(0.0, 0.05, M)
    b, C = 4.8, 0.0093
    got = float(_vv10_by_tile_pairs(
        torch.as_tensor(pts), *vv10._vv10_point_terms(
            *(torch.as_tensor(v) for v in (density, w, sigma)), b, C), tile))
    n = -(-M // 512) * 512
    pad = lambda values, fill: np.concatenate([values, np.full((n - M,) + values.shape[1:], fill)])
    expected = float(jax_vv10._vv10_kernel(
        jnp.asarray(pad(density, 1.0)), jnp.asarray(pad(w, 0.0)), jnp.asarray(pad(sigma, 0.0)),
        jnp.asarray(pad(pts, 0.0)), b, C, n))
    assert np.isfinite(expected) and expected != 0.0
    assert abs(got - expected) <= 1e-12 * abs(expected)


# --------------------------------------------------------------------------
# End to end
# --------------------------------------------------------------------------

def _jax_energy_and_iterations(line):
    """tuna_tpu's total energy and SCF iteration count (from its printout)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, _, energy, _ = jax_run(line)
    counts = re.findall(r"converged in (\d+) cycles", printed.getvalue())
    assert len(counts) == 1
    return energy, int(counts[0])


def _check_against_tuna_tpu(line):
    jax_energy, jax_iterations = _jax_energy_and_iterations(line)
    _kernels.reset_launch_counts()
    scf, molecule, energy, P = run(line, suppress_output=True, device="cpu")
    assert abs(energy - jax_energy) <= 1e-9
    assert len(scf.iteration_seconds) == jax_iterations
    assert all(count == 0 for count in _kernels.launches.values())
    n = molecule.n_basis
    assert P.shape == (n, n) and scf.density is not None
    return scf


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : B3LYP 6-31G : TIGHTSCF",
    "SPE : H H 0.74 : BLYP STO-3G : NL LOOSEGRID TIGHTSCF",
    "SPE : LI H 1.6 : PBE0 STO-3G : TIGHTSCF",
])
def test_dft_energy_matches_tuna_tpu(line):
    scf = _check_against_tuna_tpu(line)
    if "NL" in line:
        assert scf.dispersion_energy > 0.0


@pytest.mark.slow
def test_n2_b3lyp_631gss_matches_tuna_tpu():
    _check_against_tuna_tpu("SPE : N N 1.1 : B3LYP 6-31G** : LOOSEGRID TIGHTSCF")


@pytest.mark.parametrize("line", [
    # relaxed densities of double hybrids: unrestricted, meta-GGA, restricted
    "SPE : O O 1.21 : B2PLYP STO-3G : ML 3 RELAXED",
    "SPE : H H 0.74 : R2SCAN0-DH STO-3G : RELAXED",
    "SPE : H H 0.74 : B2PLYP STO-3G : RELAXED",
])
def test_unported_dft_raises(line):
    with pytest.raises(TunaError, match="not yet ported"):
        run(line, suppress_output=True, device="cpu")

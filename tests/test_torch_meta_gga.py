"""The port's meta-GGAs and B97 (tuna_tpu_torch.dft, on the CPU) against
tuna_tpu's on the JAX CPU backend: the functionals, the kinetic energy
density tau on the grid (plain K7bt), the XC closure and single points.

Both packages get the same numpy-seeded inputs.  Tolerances:

  * functionals: energy density and df/drho, df/dsigma, df/dtau 1e-12
    relative to the value plus the size of the terms that make it up (see
    _term_scales; df/drho_s of the spin-resolved B97 family at 1e-5 where
    one spin is under 1e-3 of the other, see NEARLY_EMPTY_RATIO), on
    grid-like inputs (reduced gradients up to 5, alpha
    over [0, 4] with points within 1e-12 of SCAN's switch at alpha = 1 and
    of the regularised switch at 2.5, zero gradients, and points with
    everything at the floor); the port's side on one torch thread;
  * tau on the grid (plain K7bt) against tuna_tpu's einsum: 1e-13 relative
    to the largest entry;
  * the XC closure: 1e-11 absolute, as the GGA closures' tests;
  * single points at TIGHTSCF (the first line at tuna_tpu's default
    convergence): 1e-10 Ha with equal SCF iteration counts;
  * the restricted batch against the serial SCAN: 1e-9 Ha (the batch starts
    from the core guess, the serial walk from the STO-3G guess).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.dft import grid as jax_grid
from tuna_tpu.dft import make_xc_closure as jax_make_xc_closure
from tuna_tpu.dft import xc as jax_xc
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels, parallel
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.dft import grid, make_xc_closure, xc
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread, as tests/test_torch_dft.py's fixture of
    that name gives the functionals."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# Functionals
# --------------------------------------------------------------------------

N_FLOOR = 20   # points with the density, sigma and tau at their floors


def _alpha(rng, n):
    """The iso-orbital indicator: uniform over [0, 4], with points on and
    within 1e-12 to 1e-3 of the switches at 1 (SCAN) and 2.5 (rSCAN,
    r2SCAN) and a few far past them."""
    special = [0.0, 1e-8, 0.5, 1.0, 2.5, 20.0]
    special += [c + sign * d for c in (1.0, 2.5) for d in (1e-12, 1e-9, 1e-6, 1e-3)
                for sign in (-1, 1)]
    alpha = np.concatenate([rng.uniform(0.0, 4.0, n - len(special)), special])
    rng.shuffle(alpha)
    return alpha


def _spin_channel(rng, n, spin_factor):
    """(rho_s, sigma_ss, tau_s) of one density (spin_factor 1: total
    closed-shell; 2: one spin) with reduced gradients up to 5 (a hundred
    exactly 0) and tau = tau_W + alpha tau_unif."""
    rho = 10.0 ** rng.uniform(-8, 2, n)
    s = np.concatenate([10.0 ** rng.uniform(-3, np.log10(5.0), n - 100), np.zeros(100)])
    rng.shuffle(s)
    k_F = np.cbrt(3 * np.pi**2 * spin_factor * rho)
    sigma = np.maximum((2 * k_F * rho * s) ** 2, xc.SIGMA_FLOOR)
    tau_unif = 0.3 * np.cbrt(3 * np.pi**2 * spin_factor) ** 2 * rho ** (5 / 3)
    tau = sigma / (8 * rho) + _alpha(rng, n) * tau_unif
    rho[:N_FLOOR], sigma[:N_FLOOR], tau[:N_FLOOR] = (xc.DENSITY_FLOOR, xc.SIGMA_FLOOR,
                                                     xc.DENSITY_FLOOR)
    return rho, sigma, tau


def _restricted_inputs(n=10_000, seed=7):
    return _spin_channel(np.random.default_rng(seed), n, 1)


def _unrestricted_inputs(n=10_000, seed=8):
    """(rho_a, rho_b, sigma_aa, sigma_bb, sigma_ab, tau_a, tau_b), both
    spins at the floor at the same points, |sigma_ab| <= sqrt(sigma_aa
    sigma_bb).  (A spin alone at the floor beside a real one gives zeta = 1,
    where PW92's spin interpolation has a NaN derivative in both packages:
    tests/test_torch_uks.py::test_empty_spin_fails_as_in_tuna_tpu.)"""
    rng = np.random.default_rng(seed)
    na, saa, ta = _spin_channel(rng, n, 2)
    nb, sbb, tb = _spin_channel(rng, n, 2)
    sab = rng.uniform(-1.0, 1.0, n) * np.sqrt(saa * sbb)
    return na, nb, saa, sbb, sab, ta, tb


def _local_scale(registry, density):
    """|eps| of the local part at this density: Slater exchange, or
    spin-unpolarised VWN5 correlation."""
    if registry == "x":
        return 0.75 * (3 / np.pi) ** (1 / 3) * np.cbrt(density)
    return np.abs(np.asarray(jax_xc._vwn_eps(jnp.asarray(density), *jax_xc._VWN5_PARA)))


def _term_scales(registry, density, gradient_pairs, tau_pairs):
    """The size of the terms that make up each output at each point: the
    local part plus sum |df/dsigma_x| |sigma_x| / rho plus sum |df/dtau_s|
    tau_s / rho, for eps and the density derivatives; that times rho /
    |sigma_x| for df/dsigma_x and rho / tau_s for df/dtau_s.  Where a
    gradient or a kinetic part cancels the local one (large reduced
    gradients in PBE-based correlation, the saturated u = x / (1 + x) of B97
    at the floor) what is left is rounding of terms of this size."""
    term = _local_scale(registry, density)
    for d, value in gradient_pairs + tau_pairs:
        term = term + np.abs(np.asarray(d)) * np.abs(value) / density
    return (term, [term * density / np.abs(value) for _, value in gradient_pairs],
            [term * density / np.abs(value) for _, value in tau_pairs])


# Spin ratios below which the spin-resolved B97 family's df/drho_s is held
# at NEARLY_EMPTY_TOLERANCE: its opposite-spin part f_ab = eps_LSDA rho -
# eps_a rho_a - eps_b rho_b (tuna_tpu's dft/xc.py:875-887, :888-945) is a
# small difference of O(1) terms there, and d g_ab / d rho_s is steep
# (~1e8 at rho_a / rho_b ~ 1e-10, through s2_a = sigma_aa / rho_a^(8/3)).
# At one such point eps_LSDA differs by one ulp between XLA's and torch's
# elementwise functions, f_ab by 5e-7 of itself, and df/drho_a by 3e-7: no
# float64 evaluation but a bitwise copy does better.  The error grows as the
# ratio falls: 1e-9 of the derivative at ratios of 1e-6 to 1e-3, 1e-6 below.
NEARLY_EMPTY_RATIO = 1e-3
NEARLY_EMPTY_TOLERANCE = 1e-5


def _assert_close(got, expected, scale, label, tolerance=1e-12):
    """|port - tuna_tpu| within `tolerance` of the value plus its terms'
    size (an array: a tolerance a point)."""
    expected = np.asarray(expected)
    got = got.numpy()
    assert np.all(np.isfinite(expected)), label
    assert np.all(np.isfinite(got)), label
    assert np.all(np.abs(got - expected) <= tolerance * (np.abs(expected) + scale)), label


META_NAMES = ("TPSS", "REVTPSS", "SCAN", "RSCAN", "R2SCAN", "B97", "B97M")
# (kind, name, method name): exchange, restricted and spin-resolved
# correlation, B97 under both of its parameterisations
META_FUNCTIONALS = [
    (kind, name, method)
    for kind in ("x", "c", "uc")
    for name in META_NAMES
    for method in (("B97", "B97-D") if name == "B97" else ("",))
]


@pytest.mark.parametrize("kind,name,method", META_FUNCTIONALS)
def test_meta_gga_functional_matches_tuna_tpu(kind, name, method, one_torch_thread):
    tolerances = {}
    if kind == "uc":
        fn = xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name]
        reference = jax_xc.UNRESTRICTED_CORRELATION_FUNCTIONALS[name]
        inputs = _unrestricted_inputs()
        params, jax_params = xc.XCParams(method_name=method), jax_xc.XCParams(method_name=method)
        got = xc.unrestricted_derivatives(fn, *map(torch.as_tensor, inputs), params)
        expected = jax_xc.unrestricted_derivatives(reference, *map(jnp.asarray, inputs),
                                                   jax_params)
        na, nb, saa, sbb, sab, ta, tb = inputs
        density = na + nb
        # order: df/dna, df/dnb, df/dsaa, df/dsbb, df/dsab, df/dta, df/dtb, eps
        gradient_pairs = ([(expected[i], v) for i, v in zip((2, 3, 4), (saa, sbb, sab))]
                          if fn.needs_sigma else [])
        tau_pairs = [(expected[i], v) for i, v in zip((5, 6), (ta, tb))] if fn.needs_tau else []
        term, sigma_scales, tau_scales = _term_scales("c", density, gradient_pairs, tau_pairs)
        checks = [(7, term), (0, term), (1, term)]
        checks += list(zip((2, 3, 4), sigma_scales)) + list(zip((5, 6), tau_scales))
        if name in ("B97", "B97M"):
            nearly_empty = np.minimum(na, nb) < NEARLY_EMPTY_RATIO * np.maximum(na, nb)
            assert 0.05 < np.mean(nearly_empty) < 0.5
            tolerances = {i: np.where(nearly_empty, NEARLY_EMPTY_TOLERANCE, 1e-12)
                          for i in (0, 1)}
    else:
        registry = (xc.EXCHANGE_FUNCTIONALS if kind == "x" else xc.CORRELATION_FUNCTIONALS)
        jax_registry = (jax_xc.EXCHANGE_FUNCTIONALS if kind == "x"
                        else jax_xc.CORRELATION_FUNCTIONALS)
        fn, reference = registry[name], jax_registry[name]
        x_name = name if kind == "x" else None
        density, sigma, tau = _restricted_inputs()
        got = xc.restricted_derivatives(fn, *map(torch.as_tensor, (density, sigma, tau)),
                                        xc.XCParams(method_name=method, x_name=x_name))
        expected = jax_xc.restricted_derivatives(
            reference, *map(jnp.asarray, (density, sigma, tau)),
            jax_xc.XCParams(method_name=method, x_name=x_name))
        # order: df/dn, df/ds, df/dt, eps
        term, sigma_scales, tau_scales = _term_scales(
            kind, density, [(expected[1], sigma)], [(expected[2], tau)] if fn.needs_tau else [])
        checks = [(3, term), (0, term), (1, sigma_scales[0])]
        checks += [(2, tau_scales[0])] if fn.needs_tau else []
    assert fn.needs_sigma == reference.needs_sigma and fn.needs_tau == reference.needs_tau
    assert fn.needs_tau == (name != "B97")
    for index, g in enumerate(got):
        assert (g is None) == (expected[index] is None), index
    for index, scale in checks:
        _assert_close(got[index], expected[index], scale, f"{kind} {name} {method}: {index}",
                      tolerances.get(index, 1e-12))


def test_registries_hold_every_tuna_tpu_functional():
    for port, reference in ((xc.EXCHANGE_FUNCTIONALS, jax_xc.EXCHANGE_FUNCTIONALS),
                            (xc.CORRELATION_FUNCTIONALS, jax_xc.CORRELATION_FUNCTIONALS)):
        assert set(port) == set(reference)
        for name, fn in port.items():
            assert fn.needs_sigma == reference[name].needs_sigma, name
            assert fn.needs_tau == reference[name].needs_tau, name


def test_scan_switch_has_no_nan_in_its_derivative():
    """At alpha = 1 exactly, and within rounding of it, SCAN's switching
    function and its derivative stay finite (the double where), as in
    tuna_tpu, and the derivative there is tuna_tpu's."""
    alpha = torch.tensor([1.0 - 1e-15, 1.0, 1.0 + 1e-15, 0.0, 2.5], dtype=torch.float64,
                         requires_grad=True)
    value = xc._interp_scan(alpha, 0.667, 0.8, 1.24)
    (derivative,) = torch.autograd.grad(value.sum(), alpha)
    assert bool(torch.all(torch.isfinite(value))) and bool(torch.all(torch.isfinite(derivative)))
    import jax
    expected = jax.grad(lambda a: jnp.sum(jax_xc._interp_scan(a, 0.667, 0.8, 1.24)))(
        jnp.asarray(alpha.detach().numpy()))
    np.testing.assert_allclose(derivative.numpy(), np.asarray(expected), rtol=1e-14, atol=0)


def test_r2scan_lsda_derivative_matches_forward_mode():
    """d eps_LSDA / d r_s, which r2SCAN's correlation differentiates by hand
    where tuna_tpu takes jax.jvp, agrees with the forward-mode derivative."""
    import jax
    rng = np.random.default_rng(9)
    r_s = 10.0 ** rng.uniform(-3, 4, 1000)
    zeta = rng.uniform(-1.0, 1.0, 1000)
    got = xc._pw92_eps_spin_drs(torch.as_tensor(r_s), torch.as_tensor(zeta)).numpy()
    _, expected = jax.jvp(lambda r: jax_xc._pw92_eps_spin_rs(r, jnp.asarray(zeta)),
                          (jnp.asarray(r_s),), (jnp.ones(1000),))
    np.testing.assert_allclose(got, np.asarray(expected), rtol=1e-13, atol=0)


# --------------------------------------------------------------------------
# tau on the grid (plain K7bt) and the XC closure
# --------------------------------------------------------------------------

def _molecules(symbols, bond, basis, method, params=()):
    symbols = list(symbols)
    coords = np.array([[0.0, 0.0, 0.0],
                       [0.0, 0.0, jax_constants.angstrom_to_bohr(bond)]])
    jax_cfg = JaxConfig("SPE", jax_lookup_method(method), 0.0, list(params), basis, symbols,
                        suppress_output=True)
    cfg = Config("SPE", lookup_method(method), 0.0, list(params), basis, symbols,
                 suppress_output=True)
    jax_mol, mol = JaxMolecule(symbols, coords, jax_cfg), Molecule(symbols, coords, cfg)
    n = mol.n_cartesian_basis
    for m, c in ((jax_mol, jax_cfg), (mol, cfg)):
        m.process_basis_functions(c, n)
    return jax_mol, jax_cfg, mol, cfg


def _densities(molecule, seed):
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


def test_tau_on_the_grid_matches_tuna_tpu_einsum():
    """tau, rho and grad rho from the plain K7bt against tuna_tpu's einsums
    (dft/__init__.py:46-49) on N2/6-31G** with a seeded density."""
    jax_mol, jax_cfg, mol, cfg = _molecules(("N", "N"), 1.1, "6-31G**", "TPSS")
    P, _ = _densities(mol, 3)
    P = P + P   # a closed-shell total density
    bfs, _, grads, _ = grid.set_up_integration_grid(mol, P / 2, P / 2, cfg, True, "cpu")
    _kernels.reset_launch_counts()
    density, gradient, tau = grid.density_on_grid(torch.as_tensor(P), bfs, grads, with_tau=True)
    assert _kernels.launches["density_tau_on_grid"] == 0   # a CPU tensor takes the plain twin
    jax_bfs, jax_grads = jnp.asarray(bfs.numpy()), jnp.asarray(grads.numpy())
    P_j = jnp.asarray(P)
    expected = (jnp.einsum("ij,ikl,jkl->kl", P_j, jax_bfs, jax_bfs, optimize=True),
                2 * jnp.einsum("ij,ikl,ajkl->akl", P_j, jax_bfs, jax_grads, optimize=True),
                0.5 * jnp.einsum("ij,aikl,ajkl->kl", P_j, jax_grads, jax_grads, optimize=True))
    for got, e in zip((density, gradient, tau), expected):
        e = np.asarray(e)
        assert np.max(np.abs(got.numpy() - e)) <= 1e-13 * np.max(np.abs(e))
    plain_rho, plain_gradient = grid.density_on_grid(torch.as_tensor(P), bfs, grads)
    assert torch.equal(plain_rho, density) and torch.equal(plain_gradient, gradient)


# density_layout's output sets: K7b without and with gradients, K7bt
DENSITY_SETS = [grid.DENSITY_RHO, grid.DENSITY_GRADIENTS, grid.DENSITY_TAU]
DENSITY_SET_IDS = ["rho", "gradients", "tau"]


@pytest.mark.parametrize("n, points, whole, buffers, outputs", [
    (9, 32, True, 1, grid.DENSITY_TAU), (60, 32, True, 1, grid.DENSITY_TAU),
    (97, 32, True, 1, grid.DENSITY_TAU), (203, 16, False, 1, grid.DENSITY_TAU),
    (302, 8, False, 1, grid.DENSITY_TAU), (60, 32, True, 2, grid.DENSITY_GRADIENTS),
    (97, 32, True, 1, grid.DENSITY_GRADIENTS), (302, 8, False, 1, grid.DENSITY_GRADIENTS),
    (60, 32, True, 1, grid.DENSITY_RHO), (302, 32, False, 1, grid.DENSITY_RHO)])
def test_tau_kernel_layout_fits_shared_memory(n, points, whole, buffers, outputs):
    """The tile of K7b and K7bt (dft/grid.py::density_layout): with
    gradients or tau 32 points with P^T whole up to 97 AOs (N2/cc-pVTZ has
    60), then fewer points with P^T 16 rows at a time (n = 302, the most
    the first K7b took, fits with 8); without gradients one column, so 32
    points through n = 302; K7b with gradients two column buffers where
    they fit (at n = 60, not at 97), K7bt and K7b without gradients one;
    within an H100 block's shared memory, where
    every tile before it in the host's order is not."""
    layout = grid.density_layout(n, outputs)
    assert layout == (points, whole, buffers,
                      grid.density_bytes(n, outputs, points, whole, buffers))
    assert layout[3] <= _kernels.SHARED_MEMORY_A_BLOCK
    assert layout == grid.density_layouts(n, outputs)[0]
    buffers_first = (2, 1) if outputs == grid.DENSITY_GRADIENTS else (1, 2)
    order = [(t, w, b) for w in (True, False) for t in (32, 16, 8) for b in buffers_first]
    for t, w, b in order[:order.index(layout[:3])]:
        assert grid.density_bytes(n, outputs, t, w, b) > _kernels.SHARED_MEMORY_A_BLOCK


@pytest.mark.parametrize("outputs", DENSITY_SETS, ids=DENSITY_SET_IDS)
@pytest.mark.parametrize("n", [1, 9, 60, 97, 203, 302])
def test_density_layout_covers_the_first_kernels_bases(n, outputs):
    """Every n the first K7b took (up to 302 AOs) has a tile in each output
    set, and every tile listed fits a block."""
    layouts = grid.density_layouts(n, outputs)
    assert layouts and all(shared <= _kernels.SHARED_MEMORY_A_BLOCK
                           and shared == grid.density_bytes(n, outputs, t, w, b)
                           for t, w, b, shared in layouts)


@pytest.mark.parametrize("n, outputs", [(449, grid.DENSITY_GRADIENTS), (449, grid.DENSITY_TAU),
                                        (1033, grid.DENSITY_RHO)])
def test_density_layout_raises_past_the_card(n, outputs):
    """Past an H100 block's shared memory the layout raises in words (no
    other kernel or plain version takes the shape on the card): from 449
    AOs with gradients or tau, from 1033 without."""
    assert not grid.density_layouts(n, outputs)
    assert grid.density_layouts(n - 1, outputs)
    with pytest.raises(ValueError, match=f"{n} AOs do not fit one block's shared memory"):
        grid.density_layout(n, outputs)


def _k7bt_emulated(P, bfs, grads, outputs=grid.DENSITY_TAU):
    """The arithmetic of K7b and K7bt in NumPy on their zero-padded tiles:
    for each 16 AO rows i, Y_a = P^T[i, :kp] B_a[:kp] (kp = n rounded up to
    8, the MMA's depth) for B = (phi) without gradients, (phi) with them,
    (phi, d phi) with tau, then rho, grad rho and tau summed over i from Y_a
    against B's entries at the same (i, point).  Returns the output set's
    (rho, grad rho or None[, tau])."""
    n = P.shape[0]
    mp, kp = -(-n // 16) * 16, -(-n // 8) * 8
    Pt = np.zeros((mp, kp))
    Pt[:n, :n] = P.T
    columns = 1 if outputs == grid.DENSITY_RHO else 4
    products = 4 if outputs == grid.DENSITY_TAU else 1
    B = np.zeros((columns, mp, bfs.shape[1]))
    B[0, :n] = bfs
    if columns == 4:
        B[1:, :n] = grads
    sums = np.zeros((5, bfs.shape[1]))
    for i0 in range(0, mp, 16):
        Y = [Pt[i0:i0 + 16] @ B[a, :kp] for a in range(products)]
        rows = B[:, i0:i0 + 16]
        sums[:columns] += np.einsum("aik,ik->ak", rows, Y[0])
        if products == 4:
            sums[4] += sum(np.einsum("ik,ik->k", rows[a], Y[a]) for a in (1, 2, 3))
    if outputs == grid.DENSITY_RHO:
        return sums[0], None
    if outputs == grid.DENSITY_GRADIENTS:
        return sums[0], 2 * sums[1:4]
    return sums[0], 2 * sums[1:4], 0.5 * sums[4]


@pytest.mark.parametrize("outputs", DENSITY_SETS, ids=DENSITY_SET_IDS)
def test_k7bt_emulated_tiles_match_tuna_tpu(outputs):
    """The tiling of K7b and K7bt (n padded to 16 AO rows and the products'
    depth to 8, the sums over i a tile of rows at a time), emulated in NumPy
    for each output set on N2/6-31G** with a seeded non-symmetric P, against
    tuna_tpu's einsums: 1e-13 of each output's largest |entry|; the rho and
    grad rho of every set the same numbers."""
    jax_mol, jax_cfg, mol, cfg = _molecules(("N", "N"), 1.1, "6-31G**", "TPSS")
    P, _ = _densities(mol, 3)
    bfs, _, grads, _ = grid.set_up_integration_grid(mol, P, P, cfg, True, "cpu")
    P = 2 * P + 0.1 * np.random.default_rng(4).standard_normal(P.shape) / P.shape[0]
    bfs, grads = bfs.reshape(bfs.shape[0], -1).numpy(), grads.reshape(3, bfs.shape[0], -1).numpy()
    assert bfs.shape[0] % 16 != 0   # the padding is exercised
    P_j, jax_bfs, jax_grads = jnp.asarray(P), jnp.asarray(bfs), jnp.asarray(grads)
    expected = (jnp.einsum("ij,ik,jk->k", P_j, jax_bfs, jax_bfs, optimize=True),
                2 * jnp.einsum("ij,ik,ajk->ak", P_j, jax_bfs, jax_grads, optimize=True),
                0.5 * jnp.einsum("ij,aik,ajk->k", P_j, jax_grads, jax_grads, optimize=True))
    got = _k7bt_emulated(P, bfs, grads, outputs)
    assert len(got) == (3 if outputs == grid.DENSITY_TAU else 2)
    assert (got[1] is None) == (outputs == grid.DENSITY_RHO)
    for g, e in zip(got, expected):
        if g is not None:
            e = np.asarray(e)
            assert np.max(np.abs(g - e)) <= 1e-13 * np.max(np.abs(e))
    tau_set = _k7bt_emulated(P, bfs, grads)
    assert np.array_equal(got[0], tau_set[0])
    if got[1] is not None:
        assert np.array_equal(got[1], tau_set[1])


@pytest.mark.parametrize("method,symbols,bond", [
    ("R2SCAN", ("N", "N"), 1.1),     # restricted
    ("TPSS", ("O", "H"), 0.97),      # unrestricted, exchange at 2 tau_s
    ("B97M-V", ("O", "H"), 0.97),    # B97M's clean(tau_s) in its correlation
])
def test_meta_gga_xc_closure_matches_tuna_tpu(method, symbols, bond):
    jax_mol, jax_cfg, mol, cfg = _molecules(symbols, bond, "6-31G", method, ["LOOSEGRID"])
    assert cfg.reference == jax_cfg.reference
    P_a, P_b = _densities(mol, 5)
    if cfg.reference == "RHF":
        P_b = P_a
    jax_grid_container = jax_grid.set_up_integration_grid(jax_mol, P_a, P_b, jax_cfg, True)
    grid_container = grid.set_up_integration_grid(mol, P_a, P_b, cfg, True, "cpu")
    expected = jax_make_xc_closure(jax_cfg, jax_grid_container)(
        jnp.asarray(P_a), jnp.asarray(P_b), jax_cfg.HFX_prop, jax_cfg.DFX_prop,
        jax_cfg.DFC_prop)
    got = make_xc_closure(cfg, grid_container)(torch.as_tensor(P_a), torch.as_tensor(P_b),
                                               cfg.DFX_prop, cfg.DFC_prop)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0, atol=1e-11)


# --------------------------------------------------------------------------
# Single points
# --------------------------------------------------------------------------

# Total energy and SCF iteration count of each line from tuna_tpu on the JAX
# CPU backend (each took 30-60 s there, mostly in compilation), printed by
#   env JAX_PLATFORMS=cpu python -c 'import io, re, contextlib; \
#       from tuna_tpu.cli import run; buf = io.StringIO(); \
#       out = contextlib.redirect_stdout(buf).__enter__() and None; \
#       out = run(LINE); print(repr(out[2]), re.findall(r"converged in (\d+) cycles", \
#       buf.getvalue()))'
META_GGA_LINES = [
    # restricted
    ("SPE : H H 0.74 : TPSS STO-3G", -1.1667714669759985, 3),
    ("SPE : N N 1.1 : R2SCAN 6-31G : TIGHTSCF", -109.41124553060018, 10),
    ("SPE : H H 0.74 : REVTPSS STO-3G : TIGHTSCF", -1.1677006968505665, 3),
    ("SPE : H H 0.74 : SCAN STO-3G : TIGHTSCF", -1.1574652378324575, 3),
    ("SPE : H H 0.74 : RSCAN STO-3G : TIGHTSCF", -1.1574652378324575, 3),
    ("SPE : H H 0.74 : TPSSH STO-3G : TIGHTSCF", -1.1660375340723732, 3),
    ("SPE : H H 0.74 : R2SCANH STO-3G : TIGHTSCF", -1.1569988382511105, 3),
    ("SPE : H H 0.74 : B97 STO-3G : TIGHTSCF", -1.1618436541290182, 3),
    ("SPE : H F 0.92 : B97-D STO-3G : TIGHTSCF", -98.90152153263958, 10),
    ("SPE : H H 0.74 : B97M-V STO-3G : LOOSEGRID TIGHTSCF", -1.1570696935715954, 3),
    # unrestricted
    ("SPE : O O 1.21 : TPSS 6-31G : ML 3 TIGHTSCF", -150.293701096132, 13),
    ("SPE : LI H 1.6 : UTPSS STO-3G : CH 1 ML 2 TIGHTSCF", -7.667007648616918, 8),
    ("SPE : O O 1.21 : REVTPSS STO-3G : ML 3 TIGHTSCF", -148.27188426625776, 8),
    ("SPE : O O 1.21 : SCAN STO-3G : ML 3 TIGHTSCF", -148.25889017784112, 8),
    ("SPE : O O 1.21 : RSCAN STO-3G : ML 3 TIGHTSCF", -148.28802984831714, 8),
    ("SPE : O O 1.21 : R2SCAN STO-3G : ML 3 TIGHTSCF", -148.24503774615562, 8),
    ("SPE : O O 1.21 : B97-D STO-3G : ML 3 TIGHTSCF", -148.24199431962518, 7),
    ("SPE : O O 1.21 : B97M-V STO-3G : ML 3 LOOSEGRID TIGHTSCF", -148.29000072001037, 8),
]


@pytest.mark.parametrize("line,energy_ref,iterations_ref", META_GGA_LINES,
                         ids=[line for line, _, _ in META_GGA_LINES])
def test_meta_gga_energy_matches_tuna_tpu(line, energy_ref, iterations_ref):
    _kernels.reset_launch_counts()
    scf, molecule, energy, P = run(line, suppress_output=True, device="cpu")
    assert all(count == 0 for count in _kernels.launches.values())
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == iterations_ref
    if "B97M-V" in line:
        assert scf.dispersion_energy > 0.0
    n = molecule.n_basis
    assert P.shape == (n, n) and bool(torch.all(torch.isfinite(P)))


def test_restricted_meta_gga_batch_matches_serial_scan(monkeypatch):
    """A restricted TPSS scan (tuna_tpu's tests/test_parallel.py:55 batches
    it) takes the batch with two devices and matches the serial SCAN."""
    line = "SCAN : H H 0.64 : TPSS STO-3G : NUM 4 STEP 0.1 TIGHTSCF"
    calc_type, method, basis, symbols, coordinates, params = parse_input(line)
    cfg = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                 suppress_output=True)
    assert parallel.mean_field_batchable(cfg, symbols)
    serial_bonds, serial, _ = run(line, suppress_output=True, device="cpu")
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = []
    original = parallel.scan_points_parallel

    def counted(*args, **kwargs):
        calls.append(args[2])
        return original(*args, **kwargs)

    monkeypatch.setattr(parallel, "scan_points_parallel", counted)
    bonds, batched, _ = run(line, suppress_output=True, device="cpu")
    assert len(calls) == 1 and len(calls[0]) == 4
    assert np.max(np.abs(np.array(bonds) - np.array(serial_bonds))) <= 1e-12
    assert np.max(np.abs(np.array(batched) - np.array(serial))) <= 1e-9

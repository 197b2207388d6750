"""The port's analytic meta-GGA and B97 gradients (RKS and UKS, on the CPU)
against tuna_tpu.

* The plain twins of K8ct and K8cut (dft.grid.density_deriv_on_grid and
  ..._spin with tau): rho, grad rho and their tangents bitwise those of the
  plain K8c, each spin of K8cut bitwise K8ct's, tau the plain K7bt's at the
  same geometry to 1e-14 relative, and tau' a central difference of tau
  over R to 1e-5 relative (the difference's own truncation where tau is
  steep, near the nuclei).
* The gate: meta-GGAs and B97 take the analytic gradient, as in tuna_tpu
  (B97M-V too, see test_meta_gga_gradient_gate_follows_tuna_tpu); NL and
  the meta-GGA double hybrids do not.
* The full gradient given tuna_tpu's own converged Pa, Pb and W, against
  its jax.grad (calculate_analytic_gradient): 1e-10 Ha/bohr.
* Optimisations end to end against tuna_tpu's numbers: bond length 1e-6
  angstrom, energy 1e-8 Ha and the iteration count.
* The forward-mode substitute for tuna_tpu's jax.grad, which gave
  chip_smoke.py its cc-pVTZ meta-GGA OPT constants, against jax.grad on a
  UKS meta-GGA: 1e-12 Ha/bohr.
"""

import contextlib
import functools
import io

import numpy as np
import pytest
import torch

from tuna_tpu.cli import parse_input as jax_parse_input, process_method as jax_process
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.drivers import energy as jax_energy
from tuna_tpu.drivers import gradients as jax_gradients

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import grid
from tuna_tpu_torch.drivers import gradients
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


def _molecule(line):
    calc_type, method, basis, symbols, coordinates, params = parse_input(line)
    calculation = Config(calc_type, process_method(method), 0.0, params, basis, symbols,
                         suppress_output=True)
    molecule = Molecule(symbols, coordinates, calculation)
    molecule.process_basis_functions(calculation, molecule.spherical_transformation.shape[0])
    return calculation, molecule, coordinates


# --------------------------------------------------------------------------
# tau on the moving grid (plain K8ct and K8cut)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moving_grid():
    """OH/6-31G on the loose grid, atom 1's half of the points moving, and
    two seeded density-like Cartesian matrices."""
    calculation, molecule, coordinates = _molecule("SPE : O H 0.97 : TPSS 6-31G : LOOSEGRID")
    points_np, _ = grid.build_molecular_grid(*grid.grid_parameters(molecule, calculation),
                                             molecule.bond_length, molecule.atoms)
    G = points_np.shape[1] * points_np.shape[2]
    points = torch.as_tensor(points_np.reshape(3, G))
    basis = grid.GridBasis(molecule.cartesian_basis_functions)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32)
    rng = np.random.default_rng(12)
    C = [rng.standard_normal((basis.n_ao, k)) / np.sqrt(basis.n_ao) for k in (5, 4)]
    P_stack = torch.stack([torch.as_tensor(c @ c.T) for c in C])
    return basis, moves, points, G, P_stack


def test_tau_deriv_plain_keeps_k8c_and_gives_tau(moving_grid):
    basis, moves, points, G, P_stack = moving_grid
    origin = torch.as_tensor(basis.origin)
    P = P_stack[0]
    _kernels.reset_launch_counts()
    got = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2, P, True,
                                     with_tau=True)
    assert _kernels.launches["density_tau_deriv_on_grid"] == 0   # the plain twin on the CPU
    without = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2, P, True)
    assert len(got) == 6
    assert all(torch.equal(a, b) for a, b in zip(got[:4], without))
    values, gradients_ao = grid.ao_on_grid(basis, points, True)
    _, _, tau = grid.density_on_grid(P, values, gradients_ao, with_tau=True)
    assert torch.max(torch.abs(got[4] - tau)) <= 1e-14 * torch.max(torch.abs(tau))


def test_tau_tangent_is_the_derivative_of_tau(moving_grid):
    """tau' against a central difference of tau when atom 1, its AOs and
    its half of the grid move by +-h along z."""
    basis, moves, points, G, P_stack = moving_grid
    P = P_stack[1]
    origin = torch.as_tensor(basis.origin)
    shift = torch.zeros_like(origin)
    shift[:, 2] = moves.to(torch.float64)
    point_shift = torch.zeros_like(points)
    point_shift[2, G // 2:] = 1.0
    h = 1e-5
    taus = [grid.density_deriv_on_grid(basis, origin + s * h * shift, moves,
                                       points + s * h * point_shift, G // 2, P, True,
                                       with_tau=True)[4] for s in (1, -1)]
    d_tau = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2, P, True,
                                       with_tau=True)[5]
    central = (taus[0] - taus[1]) / (2 * h)
    assert torch.max(torch.abs(d_tau)) > 0
    assert torch.max(torch.abs(d_tau - central)) <= 1e-5 * torch.max(torch.abs(d_tau))


def test_spin_tau_deriv_plain_is_k8ct_plain_per_spin(moving_grid):
    basis, moves, points, G, P_stack = moving_grid
    origin = torch.as_tensor(basis.origin)
    got = grid.density_deriv_on_grid_spin(basis, origin, moves, points, G // 2, P_stack, True,
                                          with_tau=True)
    assert len(got) == 6
    for s in range(2):
        single = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2,
                                            P_stack[s], True, with_tau=True)
        for g, one in zip(got, single):
            assert g.shape[0] == 2 and torch.equal(g[s], one)


def test_tau_needs_the_gradients(moving_grid):
    basis, moves, points, G, P_stack = moving_grid
    with pytest.raises(ValueError, match="with_gradients"):
        grid.density_deriv_on_grid(basis, torch.as_tensor(basis.origin), moves, points,
                                   G // 2, P_stack[0], False, with_tau=True)


@pytest.mark.parametrize("n, spins, points, whole", [
    (9, 1, 32, True), (9, 2, 16, True), (70, 1, 32, True), (70, 2, 16, True),
    (140, 1, 16, False), (140, 2, 16, False), (203, 1, 8, False), (203, 2, 8, False)])
def test_tau_deriv_kernel_layout_fits_shared_memory(n, spins, points, whole):
    """K8ct's (spins = 1) and K8cut's (2) tile (dft/grid.py::
    density_deriv_layout with tau): at most 32 / spins points (256 threads
    a block); at cc-pVTZ's 70 Cartesian AOs 32 points with P whole for one
    density, 16 for two; from cc-pVQZ's 140, P 16 rows at a time; within an
    H100 block's shared memory, where the next larger tile is not."""
    layout = grid.density_deriv_layout(n, spins)
    assert layout == (points, whole, grid.density_deriv_bytes(n, spins, points, whole))
    assert layout[2] <= _kernels.SHARED_MEMORY_A_BLOCK
    if points < 32 // spins:
        assert grid.density_deriv_bytes(n, spins, 2 * points, whole) > \
            _kernels.SHARED_MEMORY_A_BLOCK
    if not whole:
        assert grid.density_deriv_bytes(n, spins, 8, True) > _kernels.SHARED_MEMORY_A_BLOCK


@pytest.mark.parametrize("n, spins", [(252, 2), (288, 1)])
def test_tau_deriv_kernel_layout_raises_past_the_card(n, spins):
    with pytest.raises(ValueError, match=f"{n} AOs with {spins} density matrices do not fit"):
        grid.density_deriv_layout(n, spins)


# (with_gradients, with_tau) of the moving-grid kernel: K8c and K8cu
# without gradients (the LDA branch), with them, and K8ct and K8cut
OUTPUT_SETS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("outputs", OUTPUT_SETS, ids=["rho", "gradients", "tau"])
@pytest.mark.parametrize("spins", [1, 2])
@pytest.mark.parametrize("n", [9, 70, 140, 190])
def test_deriv_kernel_layout_covers_every_card_basis(n, spins, outputs):
    """The moving-grid kernel's tile (dft/grid.py::density_deriv_layout)
    for each output set (tau reads the seven columns of the gradients, so
    shares their tile), up to 190 Cartesian AOs (T-AUG-CC-PVTZ's 95 an
    atom, the largest with lmax <= 3, on a diatomic): it fits an H100
    block's shared memory, and every tile before it in the host's order (32
    / spins, 16, 8 points with P whole, then with 16 rows) does not."""
    with_gradients, _ = outputs
    points, whole, shared = grid.density_deriv_layout(n, spins, with_gradients)
    assert shared == grid.density_deriv_bytes(n, spins, points, whole, with_gradients)
    assert shared <= _kernels.SHARED_MEMORY_A_BLOCK and points * spins <= 32
    order = [(t, w) for w in (True, False) for t in (32, 16, 8) if t * spins <= 32]
    for t, w in order[:order.index((points, whole))]:
        assert grid.density_deriv_bytes(n, spins, t, w, with_gradients) > \
            _kernels.SHARED_MEMORY_A_BLOCK
    if not with_gradients:   # two columns: the same or a larger tile than seven
        assert points >= grid.density_deriv_layout(n, spins)[0]


@pytest.mark.parametrize("outputs", OUTPUT_SETS, ids=["rho", "gradients", "tau"])
@pytest.mark.parametrize("n, spins", [(252, 2), (288, 1), (508, 2), (708, 1)])
def test_deriv_kernel_layout_raises_past_the_card(n, spins, outputs):
    """Past an H100 block's shared memory the layout raises in words (no
    other kernel or plain version takes the shape on the card): 252 AOs for
    two densities and 288 for one with seven columns, 508 and 708 with
    two."""
    with_gradients, _ = outputs
    if with_gradients or n > 300:
        with pytest.raises(ValueError,
                           match=f"{n} AOs with {spins} density matrices do not fit"):
            grid.density_deriv_layout(n, spins, with_gradients)
    else:
        assert grid.density_deriv_layout(n, spins, False)[2] <= _kernels.SHARED_MEMORY_A_BLOCK


def _k8ct_columns(basis, origin, ao_moves, points, point_moves):
    """The seven columns K8ct forms for its tile, in NumPy: phi, grad phi
    and the moving z column of the Hessian, (s_k - s_mu) d(grad phi)/dz."""
    columns = np.zeros((7, basis.n_ao, points.shape[1]))
    for mu in range(basis.n_ao):
        X, Y, Z = points - origin[mu][:, None]
        lo, hi = basis.prim_start[mu], basis.prim_start[mu + 1]
        a, c = basis.exps[lo:hi, None], basis.coefs[lo:hi, None]
        e = c * np.exp(-a * (X * X + Y * Y + Z * Z))
        s0, s1, s2 = e.sum(0), (a * e).sum(0), (a * a * e).sum(0)
        l, m, n = basis.lmn[mu]
        px, py, pz = X ** l, Y ** m, Z ** n
        poly = px * py * pz
        dx = l * X ** max(l - 1, 0) * py * pz
        dy = m * px * Y ** max(m - 1, 0) * pz
        dz = n * px * py * Z ** max(n - 1, 0)
        dxz = l * n * X ** max(l - 1, 0) * py * Z ** max(n - 1, 0)
        dyz = m * n * px * Y ** max(m - 1, 0) * Z ** max(n - 1, 0)
        dzz = n * (n - 1) * px * py * Z ** max(n - 2, 0)
        moves = point_moves - ao_moves[mu]
        columns[:, mu] = [s0 * poly, dx * s0 - 2 * X * poly * s1, dy * s0 - 2 * Y * poly * s1,
                          dz * s0 - 2 * Z * poly * s1,
                          moves * (dxz * s0 - 2 * Z * dx * s1 - 2 * X * dz * s1
                                   + 4 * X * Z * poly * s2),
                          moves * (dyz * s0 - 2 * Z * dy * s1 - 2 * Y * dz * s1
                                   + 4 * Y * Z * poly * s2),
                          moves * (dzz * s0 - 4 * Z * dz * s1 - 2 * poly * s1
                                   + 4 * Z * Z * poly * s2)]
    return columns


def _k8ct_emulated(basis, origin, ao_moves, points, first_moving, P, tile,
                   with_gradients=True, with_tau=True):
    """The moving-grid kernel's arithmetic in NumPy on its tiles
    (csrc/dft_grid.cu moving_grid_kernel): a tile's columns with rows past n
    zero (seven with gradients, else phi and d_z phi), phi' formed from the
    d_z phi column, and for each 16 AO rows i the products {Y, Y'} (Y alone
    without gradients) and, with tau, {Y_x, Y_y, Y_z} = P[i, :kp] B[:kp] (kp
    = n rounded up to 8, the MMA's depth), then each warp's epilogue against
    the columns at the same (i, point), summed over i.  Returns the
    outputs of density_deriv_on_grid for those flags."""
    n, G = basis.n_ao, points.shape[1]
    mp, kp = -(-n // 16) * 16, -(-n // 8) * 8
    P_padded = np.zeros((mp, kp))
    P_padded[:n, :n] = P
    moves_ao = np.zeros(mp)
    moves_ao[:n] = ao_moves
    kept = [0, 1, 2, 3, 4, 5, 6] if with_gradients else [0, 3]   # the columns a tile holds
    dz = kept.index(3)
    sums = np.zeros((10, G))
    for k0 in range(0, G, tile):
        k = np.arange(k0, min(k0 + tile, G))
        point_moves = (k >= first_moving).astype(np.float64)
        columns = np.zeros((len(kept), mp, len(k)))
        columns[:, :n] = _k8ct_columns(basis, origin, ao_moves, points[:, k], point_moves)[kept]
        moving_phi = (point_moves[None, :] - moves_ao[:, None]) * columns[dz]
        for i0 in range(0, mp, 16):
            c, f = columns[:, i0:i0 + 16], moving_phi[i0:i0 + 16]
            Y = P_padded[i0:i0 + 16] @ columns[0, :kp]
            sums[0, k] += np.sum(c[0] * Y, axis=0)
            sums[1, k] += np.sum(f * Y, axis=0)
            if not with_gradients:
                continue
            Ym = P_padded[i0:i0 + 16] @ moving_phi[:kp]
            sums[2:5, k] += np.sum(c[1:4] * Y, axis=1)
            sums[5:8, k] += np.sum(c[1:4] * Ym + c[4:7] * Y, axis=1)
            if with_tau:
                Yc = [P_padded[i0:i0 + 16] @ B[:kp] for B in columns[1:4]]
                sums[8, k] += sum(np.sum(c[1 + a] * Yc[a], axis=0) for a in range(3))
                sums[9, k] += sum(np.sum(c[4 + a] * Yc[a], axis=0) for a in range(3))
    if not with_gradients:
        return sums[0], None, 2 * sums[1], None
    outputs = (sums[0], 2 * sums[2:5], 2 * sums[1], 2 * sums[5:8])
    return outputs + (0.5 * sums[8], sums[9]) if with_tau else outputs


def test_k8ct_emulated_tiles_match_the_plain_version(moving_grid):
    """K8ct's tiling (seven columns, phi' from the d_z phi column, the AO
    rows padded to 16 and the depth to 8, the two kinds of warp's
    epilogues), emulated in NumPy on OH/6-31G's loose grid, against the
    plain version at a first_moving inside a tile: 1e-13 of each output's
    largest |entry|."""
    basis, moves, points, G, P_stack = moving_grid
    assert basis.n_ao % 8 != 0   # the padding is exercised
    tile = grid.density_deriv_layout(basis.n_ao, 1)[0]
    first_moving = G // 2 + tile // 2 - G // 2 % tile   # mid-tile
    expected = grid.density_deriv_on_grid(basis, torch.as_tensor(basis.origin), moves, points,
                                          first_moving, P_stack[1], True, with_tau=True)
    got = _k8ct_emulated(basis, basis.origin, moves.numpy(), points.numpy(), first_moving,
                         P_stack[1].numpy(), tile)
    for g, e in zip(got, expected):
        e = e.numpy()
        assert g.shape == e.shape
        assert np.max(np.abs(g - e)) <= 1e-13 * np.max(np.abs(e))


@pytest.mark.parametrize("with_gradients", [True, False])
def test_k8c_emulated_tiles_match_the_plain_version(moving_grid, with_gradients):
    """K8c's tiling on the same template without tau (the {Y, Y'} warp's
    epilogue alone; without gradients two columns and Y alone), emulated in
    NumPy on OH/6-31G's loose grid at the host's tile for that output set,
    against the plain version at a first_moving inside a tile: 1e-13 of
    each output's largest |entry|."""
    basis, moves, points, G, P_stack = moving_grid
    tile = grid.density_deriv_layout(basis.n_ao, 1, with_gradients)[0]
    first_moving = G // 2 + tile // 2 - G // 2 % tile   # mid-tile
    expected = grid.density_deriv_on_grid(basis, torch.as_tensor(basis.origin), moves, points,
                                          first_moving, P_stack[0], with_gradients)
    got = _k8ct_emulated(basis, basis.origin, moves.numpy(), points.numpy(), first_moving,
                         P_stack[0].numpy(), tile, with_gradients, with_tau=False)
    assert len(got) == len(expected) == 4
    for g, e in zip(got, expected):
        if e is None:
            assert g is None
            continue
        e = e.numpy()
        assert g.shape == e.shape
        assert np.max(np.abs(g - e)) <= 1e-13 * np.max(np.abs(e))


# --------------------------------------------------------------------------
# The gradient
# --------------------------------------------------------------------------

@pytest.mark.parametrize("line,analytic", [
    ("OPT : H H 0.74 : TPSS STO-3G", True),
    ("OPT : O O 1.21 : R2SCAN STO-3G : ML 3", True),
    ("OPT : H H 0.74 : B97-D STO-3G", True),
    ("OPT : H H 0.74 : TPSSH STO-3G", True),
    # B97M-V adds VV10 after the SCF, and tuna_tpu's gate reads only the NL
    # keyword (drivers/gradients.py:49), so its gradient is analytic and
    # leaves VV10's geometry derivative out: the port follows
    ("OPT : H H 0.74 : B97M-V STO-3G", True),
    ("OPT : H H 0.74 : TPSS STO-3G : NL", False),    # VV10: finite differences
    ("OPT : H H 0.74 : R2SCAN0-DH STO-3G", False),   # a double hybrid
])
def test_meta_gga_gradient_gate_follows_tuna_tpu(line, analytic):
    calculation, molecule, _ = _molecule(line)
    assert gradients.analytic_gradient_available(calculation, molecule) == analytic
    jax_line = jax_parse_input(line)
    jax_calculation = JaxConfig(jax_line[0], jax_process(jax_line[1]), 0.0, jax_line[5],
                                jax_line[2], jax_line[3], suppress_output=True)
    assert jax_gradients.analytic_gradient_available(jax_calculation) == analytic


@functools.lru_cache(maxsize=None)
def _tuna_tpu_gradient(line):
    """tuna_tpu's analytic gradient (jax.grad) at its converged SCF of
    `line`: (Pa, Pb, W, dE/dR)."""
    calc_type, method, basis, symbols, coordinates, params = jax_parse_input(line)
    calculation = JaxConfig(calc_type, jax_process(method), 0.0, params, basis, symbols,
                            suppress_output=True)
    SCF_output, molecule, _, _ = jax_energy.evaluate_molecular_energy(
        calculation, symbols, coordinates, silent=True)
    gradient = jax_gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                         coordinates)
    W = jax_gradients._energy_weighted_density(SCF_output, molecule,
                                               calculation.reference == "RHF")
    return (np.asarray(SCF_output.P_alpha), np.asarray(SCF_output.P_beta), np.asarray(W),
            gradient)


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : TPSS 6-31G",                 # RKS, meta-GGA
    "SPE : LI H 1.6 : R2SCAN STO-3G",              # RKS, r2SCAN's hand-differentiated delta_y
    "SPE : H F 0.92 : B97-D STO-3G",               # RKS, B97 with D2
    "SPE : O O 1.21 : TPSS STO-3G : ML 3",         # UKS, exchange at 2 tau_s
    "SPE : O H 0.97 : R2SCANH STO-3G",             # UKS, hybrid meta-GGA
])
def test_meta_gga_gradient_at_tuna_tpu_density_matches(line, one_torch_thread):
    P_a, P_b, W, expected = _tuna_tpu_gradient(line)
    calculation, molecule, coordinates = _molecule(line)
    assert gradients.analytic_gradient_available(calculation, molecule)
    gradient_fn = gradients._build_gradient_fn(molecule, calculation, torch.device("cpu"))
    _kernels.reset_launch_counts()
    got = gradient_fn(float(coordinates[1, 2]), torch.tensor(P_a), torch.tensor(P_b),
                      torch.tensor(W))
    assert all(count == 0 for count in _kernels.launches.values())
    assert abs(got - expected) <= 1e-10, (got, expected)


@pytest.mark.parametrize("line,bond_ref,energy_ref,iterations_ref", [
    # env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
    #     m, E = run(LINE); print(repr(m.bond_length), repr(E))'
    # ("Optimisation converged in N iterations!" in its printout)
    ("OPT : H H 0.74 : TPSS 6-31G : TIGHTSCF", 1.398720954009968, -1.1755184466420752, 3),
    ("OPT : O O 1.21 : R2SCAN STO-3G : ML 3 TIGHTSCF", 2.4303666909557426,
     -148.25522823124618, 5),
])
def test_meta_gga_optimisation_matches_tuna_tpu(line, bond_ref, energy_ref, iterations_ref):
    _kernels.reset_launch_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        molecule, energy_opt = run(line, device="cpu")
    printed = printed.getvalue()
    assert all(count == 0 for count in _kernels.launches.values())
    assert abs(molecule.bond_length - bond_ref) <= angstrom_to_bohr(1e-6)
    assert abs(energy_opt - energy_ref) <= 1e-8
    assert f"Optimisation converged in {iterations_ref} iterations!" in printed
    assert "Calculating analytic gradient" in printed


def test_jvp_substitute_matches_jax_grad_for_a_meta_gga(monkeypatch):
    """chip_smoke.py's cc-pVTZ meta-GGA OPT constants come from tuna_tpu
    with jax.grad(total_energy) replaced by its forward-mode derivative
    (jax.grad needs > 30 GB of host memory there): on a UKS meta-GGA line
    the substitute's gradient equals jax.grad's to 1e-12 Ha/bohr."""
    import types

    import jax

    line = "SPE : O O 1.21 : TPSS STO-3G : ML 3"
    _, _, _, expected = _tuna_tpu_gradient(line)
    calc_type, method, basis, symbols, coordinates, params = jax_parse_input(line)
    calculation = JaxConfig(calc_type, jax_process(method), 0.0, params, basis, symbols,
                            suppress_output=True)
    SCF_output, molecule, _, _ = jax_energy.evaluate_molecular_energy(
        calculation, symbols, coordinates, silent=True)

    def forward_grad(f, argnums=0):
        return lambda R, *args: jax.jvp(lambda r: f(r, *args), (R,), (1.0,))[1]

    monkeypatch.setattr(jax_gradients, "jax", types.SimpleNamespace(jit=jax.jit,
                                                                   grad=forward_grad))
    monkeypatch.setattr(jax_gradients, "_GRAD_CACHE", {})
    got = jax_gradients.calculate_analytic_gradient(molecule, calculation, SCF_output,
                                                    coordinates)
    assert abs(got - expected) <= 1e-12, (got, expected)

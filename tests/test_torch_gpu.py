"""The CUDA kernels of tuna_tpu_torch against their plain PyTorch versions,
on the card.

Every test here needs a CUDA GPU and skips without one.  This file imports
neither jax nor tuna_tpu, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(tests/conftest.py configures JAX).  Tolerances: 1e-12 absolute for the
integrals, the AO values and the density on the grid, and 1e-12 relative
for the (T) and VV10 energies -- the same float64 math, the kernels
unscaled and summed in another order (K6b: each element of the batch);
1e-12 of the largest |entry| for the
direct Fock build's J and K, whose atomics sum in no fixed order, for
the packed MO half-transform, and for the density's tangent on the moving
grid (its gradient reaches 10^4 at the nuclei).
"""

import numpy as np
import pytest
import torch

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr, bohr_to_angstrom
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import integrals, motransform
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.post import cc
from tuna_tpu_torch.system import Molecule

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels of tuna_tpu_torch/csrc run only there")
    return torch.device("cuda", 0)


def _n2(basis, method="HF"):
    calculation = Config("SPE", lookup_method(method), 0.0, [], basis, ["N", "N"],
                         suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(1.1)]])
    return Molecule(["N", "N"], coords, calculation)


def _n2_plan(basis):
    molecule = _n2(basis)
    return molecule, IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)


def _density(N, seed):
    C = np.random.default_rng(seed).standard_normal((N, 7)) / np.sqrt(N)
    return C @ C.T


def _n2_grid(basis, device):
    """N2's medium grid (3, G), weights (G,) and GridBasis on `device`."""
    molecule = _n2(basis, "B3LYP")
    points, weights = grid.build_molecular_grid(
        *grid.grid_parameters(molecule, molecule.calculation), molecule.bond_length,
        molecule.atoms)
    G = points.shape[1] * points.shape[2]
    return (molecule, torch.as_tensor(points.reshape(3, G), device=device),
            torch.as_tensor(weights.reshape(G), device=device),
            grid.GridBasis(molecule.cartesian_basis_functions))


def _diatomic(symbols, basis, bond_angstrom=1.1):
    """A molecule of one or two atoms (the second on the z axis) under HF."""
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, list(symbols),
                         suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(bond_angstrom)]])
    return Molecule(list(symbols), coords[:len(symbols)], calculation)


@pytest.mark.parametrize("symbols, basis", [
    (("N", "N"), "STO-3G"), (("N", "N"), "6-311G"), (("N", "N"), "6-31G**"),
    (("N", "N"), "CC-PVTZ"), (("C", "O"), "6-31G**"), (("C", "O"), "CC-PVTZ"),
    (("O", "H"), "6-31G**"), (("O", "H"), "CC-PVTZ"), (("C",), "6-31G")])
def test_integral_kernels_match_plain(cuda, symbols, basis):
    """K3 (on its lane schedule) and K1 against their plain versions, 1e-12
    absolute, on N2 at four bases, CO and OH at 6-31G** and cc-pVTZ and one
    atom; each bitwise over two calls."""
    molecule = _diatomic(symbols, basis)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=cuda)
    _kernels.reset_launch_counts()
    got = plan.one_electron(coords, charges, molecule.centre_of_mass)
    packed = plan.eri_pair_packed(coords)
    assert _kernels.launches["one_electron"] == 1
    assert _kernels.launches["eri_packed"] == 1
    for g, e in zip(got, plan._one_electron_plain(coords, charges, molecule.centre_of_mass)):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-12)
    torch.testing.assert_close(packed, plan._eri_packed_plain(coords), rtol=0, atol=1e-12)
    again = plan.one_electron(coords, charges, molecule.centre_of_mass)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(packed, plan.eri_pair_packed(coords))


def _triples_args(no, nv, device, seed):
    rng = np.random.default_rng(seed)

    def tensor(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape), device=device)

    return (tensor(no, no, nv, nv, scale=0.1), tensor(no, nv, nv, nv, scale=0.1),
            tensor(no, no, nv, no, scale=0.1), tensor(no, nv, scale=0.01),
            tensor(no, no, nv, nv, scale=0.05),
            torch.as_tensor(np.sort(rng.uniform(-15.0, -0.5, no)), device=device),
            torch.as_tensor(np.sort(rng.uniform(0.3, 5.0, nv)), device=device))


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
def test_triples_kernel_matches_plain(cuda, v_scale):
    args = _triples_args(7, 19, cuda, 3)
    got = float(cc.ccsd_t_energy(*args, v_scale))
    expected = float(cc._ccsd_t_energy_plain(*args, v_scale))
    assert abs(got - expected) <= 1e-12 * abs(expected)


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
@pytest.mark.parametrize("no, nv", [(1, 5), (2, 7), (3, 8), (7, 19), (7, 53), (2, 70),
                                    (2, 130)])
def test_triples_kernel_batches_and_repeats(cuda, no, nv, v_scale, monkeypatch):
    """K2 at the default workspace cap and at a cap of one ordering's R,
    which cuts every multiset of three or six orderings over ranges of a,
    against its plain version (v = 70 and 130 take two and three 64-wide
    tiles of a and c); two calls bitwise equal; one counted launch a call;
    no allocation of o^3 v^3 doubles."""
    args = _triples_args(no, nv, cuda, 10 * no + nv)
    expected = float(cc._ccsd_t_energy_plain(*args, v_scale))
    scale = abs(expected)
    if no == 1:   # W is symmetric in ijk, Ww = 0: the terms' size before cancelling
        e = (3.0 * args[5][0] - args[6][:, None, None] - args[6][:, None] - args[6]).reciprocal()
        V, W, _ = cc._restricted_T_tensors(*args[:5], None)
        scale = 4.0 * float(W.abs().max() * torch.sum(torch.abs((W + v_scale * V)[0, 0, 0] * e)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _kernels.reset_launch_counts()
    first = cc.ccsd_t_energy(*args, v_scale)
    again = cc.ccsd_t_energy(*args, v_scale)
    assert _kernels.launches["ccsd_t_energy"] == 2
    if 8 * no ** 3 * nv ** 3 > cc.TRIPLES_WORKSPACE_BYTES:   # more than one batch
        assert torch.cuda.max_memory_allocated() - before < 8 * no ** 3 * nv ** 3
    assert torch.equal(first, again)
    assert abs(float(first) - expected) <= 1e-12 * scale
    monkeypatch.setattr(cc, "TRIPLES_WORKSPACE_BYTES", 8 * nv ** 3)
    batches, _, _ = cc.triples_plan(no, nv, cc.TRIPLES_WORKSPACE_BYTES)
    assert len(np.unique(batches[:, 2])) == no * (no + 1) * (no + 2) // 6
    assert (no == 1) == np.all(batches[:, 5] - batches[:, 4] == nv)
    cut = cc.ccsd_t_energy(*args, v_scale)
    assert torch.equal(cut, cc.ccsd_t_energy(*args, v_scale))
    assert abs(float(cut) - expected) <= 1e-12 * scale


def _u_triples_args(no, nv, device, seed):
    """Seeded spin-orbital (T) inputs <oo||vv>, <vo||vv>, <ov||oo>, t1, t2,
    eps_o, eps_v, antisymmetric in each index pair as the real ones are
    (K2u reads X[c, (a, b)] for -X[c, b, a])."""
    rng = np.random.default_rng(seed)

    def pairs(x):
        x = x - x.swapaxes(0, 1) if x.shape[0] == x.shape[1] else x
        return x - x.swapaxes(2, 3)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return (tensor(0.1 * pairs(rng.standard_normal((no, no, nv, nv)))),
            tensor(0.1 * pairs(rng.standard_normal((nv, no, nv, nv)))),
            tensor(0.1 * pairs(rng.standard_normal((no, nv, no, no)))),
            tensor(0.01 * rng.standard_normal((no, nv))),
            tensor(0.05 * pairs(rng.standard_normal((no, no, nv, nv)))),
            tensor(np.sort(rng.uniform(-15.0, -0.5, no))),
            tensor(np.sort(rng.uniform(0.3, 5.0, nv))))


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
@pytest.mark.parametrize("no, nv", [(2, 5), (3, 1), (5, 2), (3, 3), (4, 7), (6, 11),
                                    (5, 70), (16, 36)])
def test_uccsd_t_kernel_matches_plain(cuda, no, nv, v_scale, monkeypatch):
    """K2u against its plain version: zero without a unique occupied or
    virtual triple (no launch); odd v; v = 70, two 64-wide tiles of a and
    38 of pairs; config A's shape (o = 16, v = 36); at the default
    workspace cap and at one of three triples, which cuts the triples into
    batches; two calls bitwise equal, one counted launch a call."""
    args = _u_triples_args(no, nv, cuda, 100 * no + nv)
    expected = float(cc._uccsd_t_energy_plain(*args, v_scale))
    _kernels.reset_launch_counts()
    first = cc.uccsd_t_energy(*args, v_scale)
    again = cc.uccsd_t_energy(*args, v_scale)
    if no < 3 or nv < 3:
        assert expected == 0.0 and float(first) == 0.0
        assert _kernels.launches["uccsd_t_energy"] == 0
        return
    assert _kernels.launches["uccsd_t_energy"] == 2
    assert torch.equal(first, again)
    assert abs(float(first) - expected) <= 1e-12 * abs(expected)
    monkeypatch.setattr(cc, "U_TRIPLES_WORKSPACE_BYTES", 3 * 8 * nv * nv * (nv - 1) // 2)
    assert len(cc.u_triples_plan(no, nv, cc.U_TRIPLES_WORKSPACE_BYTES)) == -(
        -(no * (no - 1) * (no - 2) // 6) // 3)
    cut = cc.uccsd_t_energy(*args, v_scale)
    assert torch.equal(cut, cc.uccsd_t_energy(*args, v_scale))
    assert abs(float(cut) - expected) <= 1e-12 * abs(expected)


@pytest.mark.parametrize("no, nv, v_scale", [(3, 13, 1.0), (4, 17, 2.0), (3, 64, 1.0),
                                             (3, 65, 2.0), (4, 129, 1.0)])
def test_uccsd_t_kernel_tile_edges(cuda, no, nv, v_scale):
    """K2u's stage-A tiles (64 a by 128 pairs, depth 16 a step) at their
    edges: a depth 3 (v + o) that is a multiple of 16 (v = 13) and one that
    is not; v = 64, one tile of a, and 65, two; C(v, 2) = 2016, 2080 and
    8256, never a multiple of 128; two calls bitwise equal."""
    args = _u_triples_args(no, nv, cuda, 7 * no + nv)
    expected = float(cc._uccsd_t_energy_plain(*args, v_scale))
    first = cc.uccsd_t_energy(*args, v_scale)
    assert torch.equal(first, cc.uccsd_t_energy(*args, v_scale))
    assert abs(float(first) - expected) <= 1e-12 * abs(expected)


def test_uccsd_t_kernel_checks_its_inputs(cuda):
    args = list(_u_triples_args(4, 5, cuda, 1))
    args[1] = args[1].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cc.uccsd_t_energy(*args)
    args[1] = args[1].contiguous().float()
    with pytest.raises(ValueError, match="dtype"):
        cc.uccsd_t_energy(*args)


def test_unrestricted_ccsd_t_runs_through_k2u(cuda):
    """A UHF CCSD(T) line on the card: K2u launched once, the energy the
    CPU path's to 1e-10 Ha."""
    from tuna_tpu_torch.cli import run

    line = "SPE : O O 1.21 : CCSD(T) 6-31G : ML 3 TIGHTSCF"
    _kernels.reset_launch_counts()
    _, _, energy, _ = run(line, suppress_output=True, device="cuda")
    assert _kernels.launches["uccsd_t_energy"] == 1
    assert _kernels.launches["ccsd_t_energy"] == 0
    _, _, energy_cpu, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_cpu) <= 1e-10


def test_kernel_wrappers_check_their_inputs(cuda):
    molecule, plan = _n2_plan("STO-3G")
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        plan.eri_pair_packed(coords)
    t1 = torch.zeros((3, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        cc.ccsd_t_energy(t1, t1, t1, t1, t1, t1[:, 0], t1[0], 1.0)


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
def test_grid_kernels_match_plain(cuda, basis):
    """K7a and K7b on N2's medium grid against their plain versions (1e-12
    absolute); K7b's rho with and without gradients, and its grad rho, bit
    for bit K7bt's."""
    molecule, points, _, basis_data = _n2_grid(basis, cuda)
    _kernels.reset_launch_counts()
    values, grads = grid.ao_on_grid(basis_data, points, True)
    assert _kernels.launches["ao_on_grid"] == 1
    values_p, grads_p = grid._ao_on_grid_plain(basis_data, points, True)
    torch.testing.assert_close(values, values_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(grads, grads_p, rtol=0, atol=1e-12)

    U = torch.as_tensor(molecule.spherical_transformation, device=cuda)
    bfs, bf_grads = U @ values, torch.matmul(U, grads)
    n = bfs.shape[0]
    A = np.random.default_rng(5).standard_normal((n, n))
    P = torch.as_tensor((A + A.T) / (2 * n), device=cuda)
    density, gradient = grid.density_on_grid(P, bfs, bf_grads)
    rho_only, none = grid.density_on_grid(P, bfs)
    assert _kernels.launches["density_on_grid"] == 2 and none is None
    density_p, gradient_p = grid._density_on_grid_plain(P, bfs, bf_grads)
    torch.testing.assert_close(density, density_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(rho_only, density_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(gradient, gradient_p, rtol=0, atol=1e-12)
    tau_set = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    assert torch.equal(rho_only, density) and torch.equal(tau_set[0], density)
    assert torch.equal(tau_set[1], gradient)
    # a non-symmetric P: the gradient is 2 sum_ij P_ij phi_i grad phi_j
    P = torch.as_tensor(A / n, device=cuda)
    density, gradient = grid.density_on_grid(P, bfs, bf_grads)
    density_p, gradient_p = grid._density_on_grid_plain(P, bfs, bf_grads)
    torch.testing.assert_close(density, density_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(gradient, gradient_p, rtol=0, atol=1e-12)


def _density_layout_cases():
    """(n, outputs, layout) for K7b's two output sets at n = 9, N2/cc-pVTZ's
    60, 97 (past the default 48 KB of shared memory), 203 (P^T in 16 rows
    with gradients) and 302 (the most the first K7b took), every tile that
    fits (dft/grid.py::density_layouts), the host's first marked."""
    cases = []
    for n in (9, 60, 97, 203, 302):
        for outputs, name in ((grid.DENSITY_RHO, "rho"), (grid.DENSITY_GRADIENTS, "gradients")):
            for layout in grid.density_layouts(n, outputs):
                points, whole, buffers, _ = layout
                first = "-first" if layout == grid.density_layout(n, outputs) else ""
                tile = f"{points}-{'whole' if whole else 'rows'}-{buffers}"
                cases.append(pytest.param(n, outputs, layout[:3], id=f"{n}-{name}-{tile}{first}"))
    return cases


@pytest.mark.parametrize("G", [1, 63, 65, 3001])
@pytest.mark.parametrize("n, outputs, layout", _density_layout_cases())
def test_density_kernel_wide_basis(cuda, n, outputs, layout, G):
    """K7b at every tile that fits, without and with gradients, at point
    counts that fill no tile, on a non-symmetric P: 1e-12 absolute from the
    plain version, bitwise over two calls, and bit for bit K7bt's rho and
    grad rho (the host's tile): a point's sums do not depend on the tile,
    the staging of P^T or the buffers."""
    rng = np.random.default_rng(1000 * n + G)
    bfs = torch.as_tensor(rng.standard_normal((n, G)) / n, device=cuda)
    bf_grads = torch.as_tensor(rng.standard_normal((3, n, G)) / n, device=cuda)
    P = torch.as_tensor(rng.standard_normal((n, n)), device=cuda)
    grads = bf_grads if outputs == grid.DENSITY_GRADIENTS else None
    _kernels.reset_launch_counts()
    got = grid._density_kernel(P, bfs, grads, False, layout)
    again = grid._density_kernel(P, bfs, grads, False, layout)
    assert _kernels.launches["density_on_grid"] == 2
    expected = grid._density_on_grid_plain(P, bfs, grads)
    torch.testing.assert_close(got[0], expected[0], rtol=0, atol=1e-12)
    assert torch.equal(got[0], again[0])
    tau_set = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    assert torch.equal(got[0], tau_set[0])
    if grads is None:
        assert got[1] is None
    else:
        torch.testing.assert_close(got[1], expected[1], rtol=0, atol=1e-12)
        assert torch.equal(got[1], again[1]) and torch.equal(got[1], tau_set[1])


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
def test_tau_kernel_matches_plain(cuda, basis):
    """K7bt on N2's medium grid: rho, grad rho and tau against the plain
    version (1e-12 absolute; tau 1e-12 of its largest |entry|), rho and
    grad rho bit for bit K7b's (one template, the same code for them),
    bitwise over two calls."""
    molecule, points, _, basis_data = _n2_grid(basis, cuda)
    values, grads = grid.ao_on_grid(basis_data, points, True)
    U = torch.as_tensor(molecule.spherical_transformation, device=cuda)
    bfs, bf_grads = (U @ values).contiguous(), torch.matmul(U, grads).contiguous()
    P = torch.as_tensor(_density(bfs.shape[0], 14), device=cuda)
    _kernels.reset_launch_counts()
    got = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    assert _kernels.launches["density_tau_on_grid"] == 1
    assert _kernels.launches["density_on_grid"] == 0
    again = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    expected = grid._density_on_grid_plain(P, bfs, bf_grads, with_tau=True)
    torch.testing.assert_close(got[0], expected[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(got[1], expected[1], rtol=0, atol=1e-12)
    assert _relative(got[2], expected[2]) <= 1e-12
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    rho, gradient = grid.density_on_grid(P, bfs, bf_grads)
    assert torch.equal(got[0], rho) and torch.equal(got[1], gradient)


@pytest.mark.parametrize("n", [97, 203])
def test_tau_kernel_wide_basis(cuda, n):
    rng = np.random.default_rng(n + 1)
    G = 3001
    bfs = torch.as_tensor(rng.standard_normal((n, G)) / n, device=cuda)
    bf_grads = torch.as_tensor(rng.standard_normal((3, n, G)) / n, device=cuda)
    P = torch.as_tensor(_density(n, n), device=cuda)
    got = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    expected = grid._density_on_grid_plain(P, bfs, bf_grads, with_tau=True)
    for g, e in zip(got, expected):
        assert _relative(g, e) <= 1e-12


@pytest.mark.parametrize("n", [9, 60, 97, 203])
@pytest.mark.parametrize("G", [1, 63, 65])
def test_tau_kernel_ragged_tiles(cuda, n, G):
    """Point counts that fill no tile (the tile is 32 points at n <= 97, 16
    at n = 203, whose P^T is staged 16 rows at a time): each output 1e-12
    of its largest |entry| from the plain version, bitwise over two calls,
    rho and grad rho bit for bit K7b's; a non-symmetric P, as the plain
    version takes any."""
    rng = np.random.default_rng(1000 * n + G)
    bfs = torch.as_tensor(rng.standard_normal((n, G)) / n, device=cuda)
    bf_grads = torch.as_tensor(rng.standard_normal((3, n, G)) / n, device=cuda)
    P = torch.as_tensor(rng.standard_normal((n, n)) / n, device=cuda)
    got = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    expected = grid._density_on_grid_plain(P, bfs, bf_grads, with_tau=True)
    for g, e in zip(got, expected):
        assert g.shape == e.shape and _relative(g, e) <= 1e-12
    again = grid.density_on_grid(P, bfs, bf_grads, with_tau=True)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    rho, gradient = grid.density_on_grid(P, bfs, bf_grads)
    assert torch.equal(got[0], rho) and torch.equal(got[1], gradient)


def test_vv10_kernel_matches_plain(cuda):
    molecule, points, weights, basis_data = _n2_grid("6-31G", cuda)
    values, grads = grid.ao_on_grid(basis_data, points, True)
    n = values.shape[0]
    A = np.random.default_rng(6).standard_normal((n, n))
    P = torch.as_tensor(A @ A.T / n, device=cuda)
    density, gradient = grid.density_on_grid(P, values, grads)
    mask = density > 1e-10
    active = (density[mask], weights[mask], torch.sum(gradient * gradient, dim=0)[mask],
              points.T[mask].contiguous())
    _kernels.reset_launch_counts()
    got = float(vv10.vv10_energy(*active, 4.8, 0.0093))
    assert _kernels.launches["vv10_energy"] == 1
    expected = float(vv10._vv10_pair_sum_plain(
        active[3], *vv10._vv10_point_terms(*active[:3], 4.8, 0.0093)))
    assert np.isfinite(expected) and abs(got - expected) <= 1e-12 * abs(expected)


@pytest.mark.parametrize("M", [1, 127, 129, 4097])
def test_vv10_kernel_tiles_and_repeats(cuda, M):
    """K6 on one tile (M = 1, 127, 129) and on 9 tiles whose last holds one
    point (M = 4097): the plain version's energy, two calls bitwise equal."""
    rng = np.random.default_rng(M)
    density = 10.0 ** rng.uniform(-6, 1, M)
    active = [torch.as_tensor(x, device=cuda) for x in (
        density, rng.uniform(0.0, 0.05, M), density ** (8 / 3) * rng.uniform(0.0, 4.0, M),
        rng.uniform(-4.0, 4.0, (M, 3)))]
    _kernels.reset_launch_counts()
    first = vv10.vv10_energy(*active, 4.8, 0.0093)
    again = vv10.vv10_energy(*active, 4.8, 0.0093)
    assert _kernels.launches["vv10_energy"] == 2
    expected = float(vv10._vv10_pair_sum_plain(
        active[3], *vv10._vv10_point_terms(*active[:3], 4.8, 0.0093)))
    assert torch.equal(first, again)
    assert np.isfinite(expected) and abs(float(first) - expected) <= 1e-12 * abs(expected)


def _vv10_batch_inputs(counts, device, seed=5):
    rng = np.random.default_rng(seed)
    M = sum(counts)
    density = 10.0 ** rng.uniform(-6, 1, M)
    return [torch.as_tensor(x, device=device) for x in (
        density, rng.uniform(0.0, 0.05, M), density ** (8 / 3) * rng.uniform(0.0, 4.0, M),
        rng.uniform(-4.0, 4.0, (M, 3)))]


@pytest.mark.parametrize("counts", [[0, 1, 512, 513, 2000], [300], [0, 0], [4097, 0, 129]])
def test_vv10_batch_kernel_matches_plain(cuda, counts):
    """K6b over a ragged batch (empty elements, one point, one full tile,
    one tile and one point, several tiles): each element within 1e-12
    relative of the plain version, 0 for an empty one, two calls bitwise
    equal, one launch a call."""
    active = _vv10_batch_inputs(counts, cuda)
    _kernels.reset_launch_counts()
    first = vv10.vv10_energy_batch(counts, *active, 4.8, 0.0093)
    again = vv10.vv10_energy_batch(counts, *active, 4.8, 0.0093)
    assert _kernels.launches["vv10_energy_batch"] == 2
    assert torch.equal(first, again)
    expected = vv10.vv10_energy_batch(counts, *(x.cpu() for x in active), 4.8, 0.0093)
    for got, want, m in zip(first.cpu().tolist(), expected.tolist(), counts):
        if m == 0:
            assert got == 0.0
        else:
            assert np.isfinite(want) and abs(got - want) <= 1e-12 * abs(want)


def test_vv10_batch_kernel_checks_its_inputs(cuda):
    active = _vv10_batch_inputs([10, 20], cuda)
    with pytest.raises(ValueError, match="counts"):
        vv10.vv10_energy_batch([10, 19], *active, 4.8, 0.0093)
    with pytest.raises(ValueError, match="dtype"):
        vv10.vv10_energy_batch([10, 20], *active[:3], active[3].float(), 4.8, 0.0093)


def test_batched_scan_runs_through_k6b(cuda):
    """parallel.scan_points_parallel on one card: one K6b launch for the
    batch, energies within 1e-9 Ha of the serial single points."""
    from tuna_tpu_torch import parallel
    from tuna_tpu_torch.cli import run

    calculation = Config("SCAN", lookup_method("B3LYP"), 0.0, ["NL", "TIGHTSCF"], "6-31G",
                         ["H", "F"], suppress_output=True)
    bonds = [angstrom_to_bohr(r) for r in (0.85, 0.92, 1.0)]
    _kernels.reset_launch_counts()
    energies, converged, dipoles = parallel.scan_points_parallel(
        calculation, ["H", "F"], bonds, devices=[cuda])
    assert _kernels.launches["vv10_energy_batch"] == 1
    assert converged.all() and np.all(np.isfinite(dipoles))
    for R, E in zip(bonds, energies):
        line = f"SPE : H F {bohr_to_angstrom(R):.12f} : B3LYP 6-31G : NL TIGHTSCF"
        assert abs(E - run(line, suppress_output=True, device="cuda")[2]) <= 1e-9


@pytest.mark.parametrize("line, bonds, kernel", [
    ("CCSD(T) 6-31G : TIGHTSCF", ("N N", 1.0, 1.05, 1.1), "ccsd_t_energy"),
    ("CCSD(T) 6-31G : ML 3 TIGHTSCF", ("O O", 1.11, 1.16, 1.21), "uccsd_t_energy"),
], ids=["CCSD(T)", "UCCSD(T)"])
def test_batched_coupled_cluster_runs_through_k2_and_k2u(cuda, line, bonds, kernel):
    """A batched CCSD(T) scan (K2) and UCCSD(T) scan (K2u) as two shards on
    the card: one launch of the (T) kernel a point, each point within 1e-8
    Ha of the same single point run serially on the card (another guess)."""
    from tuna_tpu_torch import parallel
    from tuna_tpu_torch.cli import parse_input, process_method, run

    pair, *angstroms = bonds
    symbols = pair.split()
    _, method, basis, _, _, params = parse_input(f"SPE : {pair} 1.0 : {line}")
    calculation = Config("SPE", process_method(method), 0.0, params, basis, symbols,
                         suppress_output=True)
    R = [angstrom_to_bohr(r) for r in angstroms]
    _kernels.reset_launch_counts()
    energies, converged, _ = parallel.scan_points_parallel(calculation, symbols, R,
                                                           devices=[cuda, cuda])
    assert _kernels.launches[kernel] == len(R) and converged.all()
    for r, E in zip(angstroms, energies):
        serial = run(f"SPE : {pair} {r} : {line}", suppress_output=True, device="cuda")[2]
        assert abs(E - serial) <= 1e-8


def test_field_batch_runs_through_k6b_once(cuda):
    """parallel.field_energies_parallel with VV10 as two shards on the card:
    one K6b launch for the whole batch (one shared grid), each field point
    within 1e-8 Ha of the same field's single point run serially."""
    from tuna_tpu_torch import parallel
    from tuna_tpu_torch.cli import run

    calculation = Config("SPE", lookup_method("B3LYP"), 0.0, ["NL", "TIGHTSCF"], "6-31G",
                         ["H", "F"], suppress_output=True)
    coordinates = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(0.92)]])
    fields = [np.array([0.0, 0.0, 2e-3]), np.array([0.0, 0.0, -1e-3]),
              np.array([1e-3, 0.0, 0.0])]
    _kernels.reset_launch_counts()
    energies, converged = parallel.field_energies_parallel(
        calculation, ["H", "F"], coordinates, fields, devices=[cuda, cuda])
    assert _kernels.launches["vv10_energy_batch"] == 1 and converged.all()
    for (ex, _, ez), E in zip(fields, energies):
        line = f"SPE : H F 0.92 : B3LYP 6-31G : NL TIGHTSCF EX {ex} EZ {ez}"
        assert abs(E - run(line, suppress_output=True, device="cuda")[2]) <= 1e-8


def test_wrong_dtype_on_the_card_raises(cuda):
    """A CUDA tensor of the wrong dtype raises; it does not fall back to the
    plain version."""
    _, points, weights, basis_data = _n2_grid("STO-3G", cuda)
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        grid.ao_on_grid(basis_data, points.float(), False)
    values, _ = grid.ao_on_grid(basis_data, points, False)
    with pytest.raises(ValueError, match="dtype"):
        grid.density_on_grid(torch.eye(values.shape[0], device=cuda, dtype=torch.float32),
                             values)
    x = weights[:64]
    with pytest.raises(ValueError, match="dtype"):
        vv10.vv10_energy(x.float() + 1, x, x, points.T[:64].contiguous().float(), 4.8, 0.0093)
    assert _kernels.launches == {**{k: 0 for k in _kernels.launches}, "ao_on_grid": 1}


def _relative(got, expected):
    return float(torch.max(torch.abs(got - expected)) / torch.max(torch.abs(expected)))


@pytest.mark.parametrize("basis", ["6-311G", "6-31G**", "CC-PVTZ"])
def test_fock_direct_kernel_matches_plain(cuda, basis):
    molecule, plan = _n2_plan(basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    N = plan.n_basis
    C = np.random.default_rng(9).standard_normal((N, 7)) / np.sqrt(N)
    P = torch.as_tensor(C @ C.T, device=cuda)
    _kernels.reset_launch_counts()
    J, K = plan.fock_direct(coords, P)
    J2, K2 = plan.fock_direct(coords, P)
    assert _kernels.launches["fock_direct"] == 2
    J_p, K_p = plan._fock_direct_plain(coords, P)
    assert _relative(J, J_p) <= 1e-12 and _relative(K, K_p) <= 1e-12
    # the atomics sum in another order on each call
    assert _relative(J2, J) <= 1e-12 and _relative(K2, K) <= 1e-12
    # a symmetric P that is not a density: the seeded P + P.T of tuna_tpu's test
    A = np.random.RandomState(3).randn(N, N)
    P = torch.as_tensor(A + A.T, device=cuda)
    for got, expected in zip(plan.fock_direct(coords, P), plan._fock_direct_plain(coords, P)):
        assert _relative(got, expected) <= 1e-12


def test_eri_kernel_is_bitwise_reproducible(cuda):
    """K1 at N2/cc-pVTZ, where the heavy part of the work list (a warp a
    quartet, a shuffle reduction) is used: no atomics, fixed order."""
    molecule, plan = _n2_plan("CC-PVTZ")
    _, classes = plan.work_list()
    assert np.sum(classes[:, 4] - classes[:, 3]) > 0
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    assert torch.equal(plan.eri_pair_packed(coords), plan.eri_pair_packed(coords))


def test_quartet_kernels_on_a_one_class_plan(cuda):
    """H2/STO-3G: s functions only, so one class (0, 0) and one kernel."""
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], "STO-3G", ["H", "H"],
                         suppress_output=True)
    molecule = Molecule(["H", "H"], np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.4]]), calculation)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    _, classes = plan.work_list()
    assert classes[:, :2].tolist() == [[0, 0]]
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    P = torch.as_tensor(_density(plan.n_basis, 2), device=cuda)
    _kernels.reset_launch_counts()
    packed = plan.eri_pair_packed(coords)
    J, K = plan.fock_direct(coords, P)
    assert _kernels.launches["eri_packed"] == 1 and _kernels.launches["fock_direct"] == 1
    torch.testing.assert_close(packed, plan._eri_packed_plain(coords), rtol=0, atol=1e-12)
    J_p, K_p = plan._fock_direct_plain(coords, P)
    assert _relative(J, J_p) <= 1e-12 and _relative(K, K_p) <= 1e-12


@pytest.mark.parametrize("threshold", [0, 10 ** 9])
def test_quartet_kernels_all_light_or_all_heavy(cuda, threshold, monkeypatch):
    """Threshold 0 sends every quartet of every class of N2/6-31G** (lmax
    2, classes up to (4, 4)) to the heavy kernels, 10^9 every one to the
    light kernels; both match the plain versions."""
    monkeypatch.setattr(integrals, "HEAVY_THRESHOLD", threshold)
    molecule, plan = _n2_plan("6-31G**")
    _, classes = plan.work_list()
    heavy = np.sum(classes[:, 4] - classes[:, 3])
    assert heavy == (np.sum(classes[:, 4] - classes[:, 2]) if threshold == 0 else 0)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    torch.testing.assert_close(plan.eri_pair_packed(coords), plan._eri_packed_plain(coords),
                               rtol=0, atol=1e-12)
    P = torch.as_tensor(_density(plan.n_basis, 4), device=cuda)
    for got, expected in zip(plan.fock_direct(coords, P), plan._fock_direct_plain(coords, P)):
        assert _relative(got, expected) <= 1e-12


def test_quartet_kernels_at_g_and_h_shells(cuda):
    """K1, K4 and K3 on reduced plans of N2 (one s, f and g shell on each
    atom of cc-pVQZ, with an h shell at cc-pV5Z: classes up to (8, 8) and
    (10, 10)): K1 and K3 1e-12 from their plain versions and bitwise over
    two calls, K4 1e-12 of the largest |entry| on a seeded density."""
    for basis, keep, lmax in (("CC-PVQZ", (0, 3, 4), 4), ("CC-PV5Z", (0, 3, 4, 5), 5)):
        molecule = _n2(basis)
        functions = integrals.shell_subset(molecule.cartesian_basis_functions,
                                           [(atom, l) for atom in (0, 1) for l in keep])
        plan = IntegralPlan(functions, molecule.n_atoms)
        assert plan.lmax == lmax
        coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
        charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=cuda)
        packed = plan.eri_pair_packed(coords)
        assert torch.equal(packed, plan.eri_pair_packed(coords))
        torch.testing.assert_close(packed, plan._eri_packed_plain(coords), rtol=0, atol=1e-12)
        got = plan.one_electron(coords, charges, molecule.centre_of_mass)
        again = plan.one_electron(coords, charges, molecule.centre_of_mass)
        for g, a, e in zip(got, again, plan._one_electron_plain(coords, charges,
                                                                molecule.centre_of_mass)):
            assert torch.equal(g, a)
            torch.testing.assert_close(g, e, rtol=0, atol=1e-12)
        P = torch.as_tensor(_density(plan.n_basis, 22), device=cuda)
        for g, e in zip(plan.fock_direct(coords, P), plan._fock_direct_plain(coords, P)):
            assert _relative(g, e) <= 1e-12


def _mo_inputs(basis, device, seed):
    molecule, plan = _n2_plan(basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    rng = np.random.default_rng(seed)
    n_mo = U.shape[0]
    Ws = [(U.T @ torch.as_tensor(rng.standard_normal((n_mo, n_mo)) / np.sqrt(n_mo),
                                 device=device)).contiguous() for _ in range(2)]
    return plan.eri_pair_packed(coords), plan.tensors(device)["pair_index"], Ws, n_mo


def _mo_kernel_calls(G_pair, pair_index, W_left, W_right, n_mo):
    """Each of the K5 calls held below: both phases with one W, the mixed
    transform, and the transposed read alone."""
    return (motransform.pair_packed_to_mo(G_pair, pair_index, W_left, n_mo),
            motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo),
            motransform.half_transform(G_pair, pair_index, W_right, transposed=True))


def _mo_plain_calls(G_pair, pair_index, W_left, W_right, n_mo):
    tri = motransform.mo_pair_indices(n_mo)

    def plain(W_l, W_r):
        H = motransform._chunked_half_transform(G_pair, pair_index, W_r, tri, 128)
        return motransform._chunked_half_transform(H.T, pair_index, W_l, tri, 128)

    return (plain(W_left, W_left), plain(W_left, W_right).T,
            motransform._chunked_half_transform(G_pair.T, pair_index, W_right, tri, 128))


@pytest.mark.parametrize("basis", ["6-311G", "6-31G**", "CC-PVTZ"])
def test_mo_transform_kernel_matches_plain(cuda, basis):
    """K5 at N2's shapes (6-311G: N = n_mo = 26; cc-pVTZ: N = 70, n_mo =
    60): both phases, the mixed transform and the transposed read, 1e-12
    of the largest |entry|, bitwise over two calls."""
    G_pair, pair_index, (W_left, W_right), n_mo = _mo_inputs(basis, cuda, 21)
    _kernels.reset_launch_counts()
    got = _mo_kernel_calls(G_pair, pair_index, W_left, W_right, n_mo)
    assert _kernels.launches["mo_half_transform"] == 5
    for g, e in zip(got, _mo_plain_calls(G_pair, pair_index, W_left, W_right, n_mo)):
        assert _relative(g, e) <= 1e-12
    again = _mo_kernel_calls(G_pair, pair_index, W_left, W_right, n_mo)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def _packed_inputs(N, n_mo, rows, device, seed):
    """A random packed matrix of `rows` rows over N AOs, its pair_index
    (the pairs in a random order, as a plan's shell-pair order is not
    np.tril_indices'), and two seeded W."""
    rng = np.random.default_rng(seed)
    tril = np.tril_indices(N)
    order = rng.permutation(len(tril[0]))
    pair_index = np.zeros((N, N), dtype=np.int64)
    pair_index[tril] = pair_index[tril[::-1]] = order
    M = torch.as_tensor(rng.random((rows, len(tril[0]))), device=device)
    Ws = [torch.as_tensor(rng.standard_normal((N, n_mo)) / np.sqrt(N), device=device)
          for _ in range(2)]
    return M, torch.as_tensor(pair_index, device=device), Ws


@pytest.mark.parametrize("N, n_mo", [(13, 11), (37, 29)])
def test_mo_transform_kernel_off_the_tile(cuda, N, n_mo):
    """Shapes that fill no MMA tile: rows, transposed and mixed against the
    plain version (1e-12 of the largest |entry|), bitwise over two calls,
    on a pair order that is not np.tril_indices'."""
    n_pairs = N * (N + 1) // 2
    M, pair_index, (W_left, W_right) = _packed_inputs(N, n_mo, n_pairs, cuda, N)
    G_pair = (M + M.T).contiguous()   # square and symmetric, as the ERI matrix is
    got = _mo_kernel_calls(G_pair, pair_index, W_left, W_right, n_mo)
    for g, e in zip(got, _mo_plain_calls(G_pair, pair_index, W_left, W_right, n_mo)):
        assert _relative(g, e) <= 1e-12
    again = _mo_kernel_calls(G_pair, pair_index, W_left, W_right, n_mo)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_mo_transform_kernel_at_the_cc_pv6z_shape(cuda):
    """N = 252 Cartesian AOs and n_mo = 182 (H2/cc-pV6Z): D_r and W^T D_r do
    not fit in shared memory, so the kernel runs in panels of D_r's rows:
    rows, transposed and with another W, bitwise over two calls."""
    N, n_mo, rows = 252, 182, 64
    assert not motransform.half_transform_layout(N, n_mo).staged
    tril = np.tril_indices(N)
    pair_index = np.zeros((N, N), dtype=np.int64)
    pair_index[tril] = pair_index[tril[::-1]] = np.arange(len(tril[0]))
    pair_index = torch.as_tensor(pair_index, device=cuda)
    rng = np.random.RandomState(17)
    M = torch.as_tensor(rng.rand(rows, len(tril[0])), device=cuda)
    W = torch.as_tensor(rng.randn(N, n_mo) / np.sqrt(N), device=cuda)
    W_other = torch.as_tensor(rng.randn(N, n_mo) / np.sqrt(N), device=cuda)
    tri = motransform.mo_pair_indices(n_mo)
    for weights in (W, W_other):
        expected = motransform._half_transform_plain(M, pair_index, weights, tri)
        got = motransform.half_transform(M, pair_index, weights)
        assert _relative(got, expected) <= 1e-12
        assert torch.equal(got, motransform.half_transform(M, pair_index, weights))
        transposed = motransform.half_transform(M.T.contiguous(), pair_index, weights,
                                                transposed=True)
        assert _relative(transposed, expected) <= 1e-12
        assert torch.equal(transposed, motransform.half_transform(
            M.T.contiguous(), pair_index, weights, transposed=True))


def _diatomic_plan(symbols, bond, basis):
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, list(symbols),
                         suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(bond)]])
    molecule = Molecule(list(symbols), coords, calculation)
    return molecule, IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)


@pytest.mark.parametrize("symbols, bond, basis", [
    (("H", "H"), 0.74, "STO-3G"), (("C", "O"), 1.13, "6-31G"), (("H", "F"), 0.95, "6-31G**"),
    (("N", "N"), 1.1, "CC-PVTZ"), (("C", "O"), 1.13, "CC-PVTZ")])
def test_gradient_integral_kernels_match_plain(cuda, symbols, bond, basis):
    """K8a and K8b (atom 1 moving) against their plain versions, f shells
    included (cc-pVTZ: Boys order 13); both bitwise over two calls (K8a's
    lanes sum in a fixed order, K8b's partials too)."""
    molecule, plan = _diatomic_plan(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=cuda)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    fraction = float(masses[1] / masses.sum())
    P = torch.as_tensor(_density(plan.n_basis, 8), device=cuda)
    _kernels.reset_launch_counts()
    got = plan.one_electron_deriv(coords, charges, fraction * molecule.bond_length, fraction)
    again = plan.one_electron_deriv(coords, charges, fraction * molecule.bond_length, fraction)
    first, second = plan.eri_deriv_energy(coords, P, 0.25), plan.eri_deriv_energy(coords, P, 0.25)
    assert _kernels.launches["one_electron_deriv"] == 2
    assert _kernels.launches["eri_deriv_energy"] == 2
    expected = plan._one_electron_deriv_plain(coords, charges, fraction * molecule.bond_length,
                                              fraction)
    for g, a, e in zip(got, again, expected):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-12)
        assert torch.equal(g, a)
    assert torch.equal(first, second)
    assert abs(float(first) - float(plan._eri_deriv_energy_plain(coords, P, 0.25))) <= 1e-12


@pytest.mark.parametrize("threshold", [1, 10 ** 9])
def test_eri_deriv_kernel_all_light_or_all_heavy(cuda, threshold, monkeypatch):
    """K8b at the two extremes of its schedule's split of work
    (IntegralPlan.deriv_schedule, SHELL_TASK_OPS): one component a task
    (the shared parts of every run of several components from the tables
    of deriv_tables), or every run with all its components in one task
    (every shared part formed in its task)."""
    monkeypatch.setattr(integrals, "SHELL_TASK_OPS", threshold)
    molecule, plan = _diatomic_plan(("H", "F"), 0.95, "6-31G**")
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    P = torch.as_tensor(_density(plan.n_basis, 9), device=cuda)
    got = float(plan.eri_deriv_energy(coords, P, 1.0))
    assert abs(got - float(plan._eri_deriv_energy_plain(coords, P, 1.0))) <= 1e-12


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
@pytest.mark.parametrize("with_gradients", [True, False])
def test_density_deriv_kernel_matches_plain(cuda, basis, with_gradients):
    """K8c on N2's medium grid, atom 1's half of the points moving: 1e-12 of
    each output's largest |entry| (the gradients reach 10^4 at the nuclei)."""
    molecule, points, _, basis_g = _n2_grid(basis, cuda)
    G = points.shape[1]
    origin = torch.as_tensor(basis_g.origin, device=cuda)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32, device=cuda)
    P = torch.as_tensor(_density(basis_g.n_ao, 6), device=cuda)
    _kernels.reset_launch_counts()
    got = grid.density_deriv_on_grid(basis_g, origin, moves, points, G // 2, P, with_gradients)
    assert _kernels.launches["density_deriv_on_grid"] == 1
    expected = grid._density_deriv_on_grid_plain(basis_g, origin, moves, points, G // 2, P,
                                                 with_gradients)
    for g, e in zip(got, expected):
        if e is None:
            assert g is None
        else:
            assert _relative(g, e) <= 1e-12


@pytest.mark.parametrize("symbols, bond, basis", [
    (("O", "H"), 0.97, "6-31G"), (("H", "F"), 0.95, "6-31G**"), (("O", "O"), 1.21, "CC-PVTZ")])
def test_unrestricted_eri_deriv_kernel_matches_plain(cuda, symbols, bond, basis):
    """K8bu against its plain version on two seeded spin densities Pa != Pb
    (1e-12 relative), bitwise over two calls, one launch a call; and at
    Pa = Pb = P/2 against K8b(P) (1e-14 relative: the same quartets, the
    exchange weight summed in another order)."""
    molecule, plan = _diatomic_plan(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    P_a = torch.as_tensor(_density(plan.n_basis, 10), device=cuda)
    P_b = torch.as_tensor(_density(plan.n_basis, 11), device=cuda)
    _kernels.reset_launch_counts()
    first = plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, 0.2)
    assert _kernels.launches["eri_deriv_energy_unrestricted"] == 1
    second = plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, 0.2)
    assert _kernels.launches["eri_deriv_energy_unrestricted"] == 2
    assert _kernels.launches["eri_deriv_energy"] == 0
    assert torch.equal(first, second)
    if plan.n_basis <= 30:   # the plain version expands the N^4 tangent
        expected = float(plan._eri_deriv_energy_unrestricted_plain(coords, P_a, P_b, 0.2))
        assert abs(float(first) - expected) <= 1e-12 * abs(expected)
    P = P_a + P_b
    restricted = float(plan.eri_deriv_energy(coords, P, 0.2))
    half = float(plan.eri_deriv_energy_unrestricted(coords, P / 2, P / 2, 0.2))
    assert abs(half - restricted) <= 1e-14 * abs(restricted)


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
@pytest.mark.parametrize("with_gradients", [True, False])
def test_spin_density_deriv_kernel_matches_plain(cuda, basis, with_gradients):
    """K8cu on N2's medium grid with two seeded densities in one launch:
    each output against the plain version spin by spin (1e-12 of its
    largest |entry|), bitwise over two calls, and each spin's outputs
    bitwise equal to K8c's on that density."""
    molecule, points, _, basis_g = _n2_grid(basis, cuda)
    G = points.shape[1]
    origin = torch.as_tensor(basis_g.origin, device=cuda)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32, device=cuda)
    P_stack = torch.stack([torch.as_tensor(_density(basis_g.n_ao, seed), device=cuda)
                           for seed in (12, 13)])
    _kernels.reset_launch_counts()
    got = grid.density_deriv_on_grid_spin(basis_g, origin, moves, points, G // 2, P_stack,
                                          with_gradients)
    assert _kernels.launches["density_deriv_on_grid_spin"] == 1
    again = grid.density_deriv_on_grid_spin(basis_g, origin, moves, points, G // 2, P_stack,
                                            with_gradients)
    for s in range(2):
        expected = grid._density_deriv_on_grid_plain(basis_g, origin, moves, points, G // 2,
                                                      P_stack[s], with_gradients)
        single = grid.density_deriv_on_grid(basis_g, origin, moves, points, G // 2,
                                            P_stack[s].contiguous(), with_gradients)
        for g, a, e, one in zip(got, again, expected, single):
            if e is None:
                assert g is None and a is None and one is None
            else:
                assert _relative(g[s], e) <= 1e-12
                assert torch.equal(g[s], a[s])
                assert torch.equal(g[s], one)


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
@pytest.mark.parametrize("n_spins", [1, 2])
def test_tau_density_deriv_kernels_match_plain(cuda, basis, n_spins):
    """K8ct (one density) and K8cut (two) on N2's medium grid: every output
    against the plain version (1e-12 of its largest |entry|), bitwise over
    two calls, rho, grad rho and their tangents bitwise K8c's (K8cu's: the
    same template, whose {Y, Y'} warp runs the same code with and without
    tau), and each spin of K8cut bitwise K8ct's."""
    molecule, points, _, basis_g = _n2_grid(basis, cuda)
    G = points.shape[1]
    origin = torch.as_tensor(basis_g.origin, device=cuda)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32, device=cuda)
    P_stack = torch.stack([torch.as_tensor(_density(basis_g.n_ao, seed), device=cuda)
                           for seed in (15, 16)])
    if n_spins == 1:
        call = grid.density_deriv_on_grid
        P, name, plain_name = P_stack[0].contiguous(), "density_tau_deriv_on_grid", \
            "density_deriv_on_grid"
    else:
        call = grid.density_deriv_on_grid_spin
        P, name, plain_name = P_stack, "density_tau_deriv_on_grid_spin", \
            "density_deriv_on_grid_spin"
    _kernels.reset_launch_counts()
    got = call(basis_g, origin, moves, points, G // 2, P, True, with_tau=True)
    assert _kernels.launches[name] == 1 and _kernels.launches[plain_name] == 0
    again = call(basis_g, origin, moves, points, G // 2, P, True, with_tau=True)
    without = call(basis_g, origin, moves, points, G // 2, P, True)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert all(torch.equal(g, w) for g, w in zip(got[:4], without))
    for s in range(n_spins):
        expected = grid._density_deriv_on_grid_plain(basis_g, origin, moves, points, G // 2,
                                                      P_stack[s], True, with_tau=True)
        for g, e in zip(got, expected):
            assert _relative(g[s] if n_spins == 2 else g, e) <= 1e-12
        if n_spins == 2:
            single = grid.density_deriv_on_grid(basis_g, origin, moves, points, G // 2,
                                                P_stack[s].contiguous(), True, with_tau=True)
            assert all(torch.equal(g[s], one) for g, one in zip(got, single))


def _seeded_basis(n, seed):
    """n Cartesian AOs (l + m + n <= 3, one to three primitives of
    exponents 0.2-8) on the centres (0, 0, 0) and (0, 0, 2.1), as a
    GridBasis, and their move flags (the second centre moves)."""
    rng = np.random.default_rng(seed)
    basis = object.__new__(grid.GridBasis)
    basis.n_ao = n
    moves = rng.integers(0, 2, n)
    basis.origin = np.stack([np.zeros(n), np.zeros(n), 2.1 * moves], axis=1)
    powers = [(l, m, k) for l in range(4) for m in range(4) for k in range(4) if l + m + k <= 3]
    basis.lmn = np.array([powers[i] for i in rng.integers(0, len(powers), n)], dtype=np.int32)
    counts = rng.integers(1, 4, n)
    basis.prim_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    basis.exps = rng.uniform(0.2, 8.0, counts.sum())
    basis.coefs = rng.uniform(0.5, 2.0, counts.sum())
    return basis, moves


# (with_gradients, with_tau): K8c and K8cu without gradients (the LDA
# branch, two columns), with them, and K8ct and K8cut
OUTPUT_SETS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("outputs", OUTPUT_SETS, ids=["rho", "gradients", "tau"])
@pytest.mark.parametrize("n", [9, 70, 97, 140, 203])
@pytest.mark.parametrize("G, first_moving", [(5, 0), (5, 5), (77, 37), (77, 0), (77, 77),
                                             (200, 100)])
def test_tau_deriv_kernels_tile_edges(cuda, n, G, first_moving, outputs):
    """The moving-grid kernel for one density (K8c, K8ct) and two (K8cu,
    K8cut) at each output set, on a seeded basis of n AOs at G seeded
    points, the points from first_moving on moving, at the host's layout
    (with seven columns: tiles of 32 points with P whole at n = 9 and 70 for
    one density, 16 for two; P 16 rows at a time from n = 97 for two and
    n = 140 for one; 8 points at n = 203) and at every other layout that
    fits: every output 1e-12 of its largest |entry| from the plain version,
    bitwise over two calls and between layouts, each spin of the
    two-density kernel bitwise the one-density kernel's, and without tau
    bitwise the first four outputs of the kernel with tau."""
    with_gradients, with_tau = outputs
    basis, moves = _seeded_basis(n, n)
    rng = np.random.default_rng(G + n)
    points = torch.as_tensor(rng.uniform([-3.0, -3.0, -3.0], [3.0, 3.0, 5.0], (G, 3)).T.copy(),
                             device=cuda)
    origin = torch.as_tensor(basis.origin, device=cuda)
    moves = torch.as_tensor(moves, dtype=torch.int32, device=cuda)
    P_stack = torch.stack([torch.as_tensor(_density(n, seed), device=cuda) for seed in (n, n + 1)])
    kernel = "density_tau_deriv_on_grid" if with_tau else "density_deriv_on_grid"
    singles = [grid.density_deriv_on_grid(basis, origin, moves, points, first_moving,
                                          P_stack[s].contiguous(), with_gradients, with_tau)
               for s in range(2)]
    _kernels.reset_launch_counts()
    both = grid.density_deriv_on_grid_spin(basis, origin, moves, points, first_moving, P_stack,
                                           with_gradients, with_tau)
    assert _kernels.launches[kernel + "_spin"] == 1
    assert sum(_kernels.launches.values()) == 1
    again = grid.density_deriv_on_grid_spin(basis, origin, moves, points, first_moving, P_stack,
                                            with_gradients, with_tau)
    assert all(b is a is None or torch.equal(b, a) for b, a in zip(both, again))
    for s in range(2):
        expected = grid._density_deriv_on_grid_plain(basis, origin, moves, points, first_moving,
                                                      P_stack[s], with_gradients, with_tau)
        single_again = grid.density_deriv_on_grid(basis, origin, moves, points, first_moving,
                                                  P_stack[s].contiguous(), with_gradients,
                                                  with_tau)
        for b, one, one_again, e in zip(both, singles[s], single_again, expected):
            if e is None:
                assert b is None and one is None and one_again is None
                continue
            assert one.shape == e.shape and _relative(one, e) <= 1e-12
            assert torch.equal(one, one_again) and torch.equal(b[s], one)
    if with_gradients and not with_tau:
        for s in range(2):
            tau = grid.density_deriv_on_grid(basis, origin, moves, points, first_moving,
                                             P_stack[s].contiguous(), True, True)
            assert all(torch.equal(a, b) for a, b in zip(singles[s], tau[:4]))
    for spins, P in ((1, P_stack[0].contiguous()), (2, P_stack)):
        name = kernel + ("_spin" if spins == 2 else "")
        default = singles[0] if spins == 1 else both
        for points_a_tile in (32, 16, 8):
            for whole in (True, False):
                shared = grid.density_deriv_bytes(n, spins, points_a_tile, whole, with_gradients)
                if points_a_tile * spins > 32 or shared > _kernels.SHARED_MEMORY_A_BLOCK:
                    continue
                got = grid._density_deriv_kernel(name, "tuna_" + name, basis, origin, moves,
                                                 points, first_moving, P, with_gradients,
                                                 with_tau, layout=(points_a_tile, whole))
                assert all(g is d is None or torch.equal(g, d) for g, d in zip(got, default))


@pytest.mark.parametrize("line,bond_ref,energy_ref,kernel", [
    # tests/test_torch_meta_gga_gradients.py holds these to tuna_tpu on the CPU
    ("OPT : H H 0.74 : TPSS 6-31G : TIGHTSCF", 1.398720954009968, -1.1755184466420752,
     "density_tau_deriv_on_grid"),
    ("OPT : O O 1.21 : R2SCAN STO-3G : ML 3 TIGHTSCF", 2.4303666909557426,
     -148.25522823124618, "density_tau_deriv_on_grid_spin"),
])
def test_meta_gga_optimisation_runs_through_the_tau_kernels(cuda, line, bond_ref, energy_ref,
                                                            kernel):
    """A meta-GGA OPT on the card: tuna_tpu's bond length and energy, K7bt
    on the SCF's densities, one K8ct (K8cut) launch a gradient and never
    K8c or K8cu."""
    from tuna_tpu_torch.cli import run
    _kernels.reset_launch_counts()
    molecule, energy = run(line, suppress_output=True, device="cuda")
    assert abs(molecule.bond_length - bond_ref) <= angstrom_to_bohr(1e-6)
    assert abs(energy - energy_ref) <= 1e-8
    launches = _kernels.launches
    assert launches[kernel] == launches["one_electron_deriv"] > 0
    assert launches["density_tau_on_grid"] > 0
    assert launches["density_deriv_on_grid"] == launches["density_deriv_on_grid_spin"] == 0


def test_unrestricted_optimisation_runs_through_the_gradient_kernels(cuda):
    """OPT of triplet O2 B3LYP/STO-3G on the card: tuna_tpu's bond length and
    energy (tests/test_torch_uhf_gradients.py), one K8a, K8bu and K8cu
    launch a gradient and none of K8b and K8c, five gradients."""
    from tuna_tpu_torch.cli import run
    _kernels.reset_launch_counts()
    molecule, energy = run("OPT : O O 1.21 : B3LYP STO-3G : ML 3", suppress_output=True,
                           device="cuda")
    assert abs(molecule.bond_length - 2.4291005059331745) <= angstrom_to_bohr(1e-6)
    assert abs(energy - -148.2204950126887) <= 1e-8
    for name in ("one_electron_deriv", "eri_deriv_energy_unrestricted",
                 "density_deriv_on_grid_spin"):
        assert _kernels.launches[name] == 5, name
    assert _kernels.launches["eri_deriv_energy"] == _kernels.launches["density_deriv_on_grid"] == 0


def test_optimisation_runs_through_the_gradient_kernels(cuda):
    """OPT H2 B3LYP/6-31G on the card: tuna_tpu's bond length and energy
    (tests/test_torch_gradients.py), one K8a, K8b and K8c launch a
    gradient, seven gradients."""
    from tuna_tpu_torch.cli import run
    _kernels.reset_launch_counts()
    molecule, energy = run("OPT : H H 1.0 : B3LYP 6-31G", suppress_output=True, device="cuda")
    assert abs(molecule.bond_length - 1.4042649853470401) <= angstrom_to_bohr(1e-6)
    assert abs(energy - -1.1687164812924133) <= 1e-8
    for name in ("one_electron_deriv", "eri_deriv_energy", "density_deriv_on_grid"):
        assert _kernels.launches[name] == 7, name


def test_force_and_optfreq_run_on_the_card(cuda):
    """FORCE and OPTFREQ through cli.run on the card, against tuna_tpu's
    numbers (tests/test_torch_gradients.py)."""
    from tuna_tpu_torch.cli import run
    _kernels.reset_launch_counts()
    assert run("FORCE : C O 1.13 : HF STO-3G", suppress_output=True, device="cuda") is None
    assert _kernels.launches["one_electron_deriv"] == 1
    _, _, frequency, zpe = run("OPTFREQ : H H 0.74 : HF STO-3G", suppress_output=True,
                               device="cuda")
    assert abs(frequency - 5481.715496129465) <= 0.01
    assert abs(zpe - 0.01248826678074945) <= 1e-8


def _quadruples_args(no, nv, device, seed):
    """Seeded (Q) inputs: the window's chemists' (pq|rs) (symmetric as real
    orbitals' are), pair-symmetric t2 and t3, orbital energies."""
    rng = np.random.default_rng(seed)
    n = no + nv
    c = rng.standard_normal((n, n, n, n))
    c = c + c.transpose(1, 0, 2, 3)
    c = c + c.transpose(0, 1, 3, 2)
    c = 0.05 * (c + c.transpose(2, 3, 0, 1))
    t2 = rng.standard_normal((no, no, nv, nv))
    t2 = 0.05 * (t2 + t2.transpose(1, 0, 3, 2))
    t3 = 0.02 * rng.standard_normal((no, no, no, nv, nv, nv))

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return (tensor(c), tensor(t2), tensor(t3),
            tensor(np.sort(rng.uniform(-15.0, -0.5, no))),
            tensor(np.sort(rng.uniform(0.3, 5.0, nv))))


def _quadruples_term_sizes(c, t2, t3, eps_o, eps_v):
    """The size of the (Q) terms before they cancel, for MP5 and MP6: the
    sum over the multisets and y of 1/2 |e| Gabs Zabs, with Gabs the sum of
    |Graw| over sigma and Zabs every product of Z taken as its absolute
    value (at v = 1, L = K and Z5 is 0; at o = 1, alpha = beta and Z6 is 0,
    so the energies are rounding alone)."""
    no, nv = t2.shape[0], t2.shape[2]
    B = cc._quadruples_blocks(c, no)
    _, slots, multisets = cc.quadruples_plan(no, nv, 2 ** 62)
    i, j, k, l = torch.as_tensor(slots.T.astype(np.int64), device=t2.device)
    G, alpha, beta = cc._quadruples_slot_blocks(B, t2, t3, i, j, k, l, 0)
    u, K, L = cc._u_of(t2)[k, l].abs(), B["K"][i, j].abs(), B["L"][i, j].abs()
    Z5 = (torch.einsum("sab,scd->sabcd", u, K) + 2.0 * torch.einsum("sbd,sac->sabcd", u, L)
          + torch.einsum("scd,sab->sabcd", u, L))
    at = lambda x, dims: x.abs().permute(0, *(1 + d for d in dims))
    Z6 = 2.0 * (2.0 * at(alpha, (0, 1, 2, 3)) + at(alpha, (2, 3, 0, 1)) + at(alpha, (1, 0, 2, 3))
                + 2.0 * at(beta, (2, 1, 3, 0)) + at(beta, (2, 0, 3, 1))
                + 2.0 * at(beta, (3, 1, 0, 2)) + at(beta, (3, 0, 1, 2)))
    inverse = [tuple(int(np.argsort(sigma)[n]) for n in range(4))
               for sigma in cc.QUADRUPLES_PERMUTATIONS]
    e_v = eps_v[:, None, None, None] + eps_v[:, None, None] + eps_v[:, None] + eps_v
    sizes = [0.0, 0.0]
    for row in multisets.tolist():
        g_abs = sum(G[row[4 + s]].abs().permute(dims) for s, dims in enumerate(inverse))
        firsts = [(row[4 + s], dims) for s, dims in enumerate(inverse) if row[28] >> s & 1]
        weighted = torch.abs(0.5 * g_abs / (eps_o[row[:4]].sum() - e_v))
        for n, Z in enumerate((Z5, Z6)):
            sizes[n] += float(torch.sum(weighted * sum(Z[slot].permute(dims)
                                                       for slot, dims in firsts)))
    return sizes


def _quadruples_caps(no, nv):
    """Workspace caps that cut the plan: room for 1 and 5 slots of the whole
    range of min(y) beside a carry (multisets cut over their slots), and
    for one slot of the range [0, 1) (the virtual quadruples cut over ranges
    of their smallest index too, where v > 1)."""
    whole = cc.quadruples_cut(no, nv, 0, nv)
    one_a = cc.quadruples_cut(no, nv, 0, 1)
    return [8 * (3 * whole[0] + whole[1]), 8 * (3 * whole[0] + 5 * whole[1]),
            8 * (3 * one_a[0] + one_a[1])]


@pytest.mark.parametrize("no, nv", [(2, 2), (2, 3), (3, 4), (4, 5), (5, 2), (7, 11), (1, 1),
                                    (1, 4), (4, 1), (3, 6)])
def test_ccsdt_q_kernel_matches_plain(cuda, no, nv, monkeypatch):
    """K9 against its plain version, E_MP5 and E_MP6 each to 1e-12
    relative (of the terms' size at o = 1 or v = 1): repeated occupied
    indices of every kind (o = 3 to 7); at the default workspace cap and at
    caps where the plan cuts multisets over their slots and the virtual
    quadruples over ranges of min(y); two calls bitwise equal, one counted
    launch a call."""
    args = _quadruples_args(no, nv, cuda, 10 * no + nv)
    expected = cc._ccsdt_q_energy_plain(*args)
    scales = [abs(x) for x in expected.tolist()]
    if no == 1 or nv == 1:
        scales = _quadruples_term_sizes(*args)
    _kernels.reset_launch_counts()
    first = cc.ccsdt_q_energy(*args)
    again = cc.ccsdt_q_energy(*args)
    assert _kernels.launches["ccsdt_q_energy"] == 2
    assert torch.equal(first, again)
    for got, want, scale in zip(first.tolist(), expected.tolist(), scales):
        assert abs(got - want) <= 1e-12 * scale
    for cap in _quadruples_caps(no, nv):
        monkeypatch.setattr(cc, "QUADRUPLES_WORKSPACE_BYTES", cap)
        cut = cc.ccsdt_q_energy(*args)
        assert torch.equal(cut, cc.ccsdt_q_energy(*args))
        for got, want, scale in zip(cut.tolist(), expected.tolist(), scales):
            assert abs(got - want) <= 1e-12 * scale


@pytest.mark.parametrize("no, nv", [(1, 19), (2, 17), (3, 9), (2, 33), (3, 16), (2, 8),
                                    (1, 3)])
def test_ccsdt_q_kernel_tile_edges(cuda, no, nv, monkeypatch):
    """K9's tiles at their edges: v not a multiple of 8 or 16 (9, 17, 19,
    33: two and three b tiles of 16, with 4 and 2 values of c a chunk), v
    a multiple (8, 16), v below one tile (3), o = 1 (alpha = beta, so E_MP6
    is rounding: held to the terms' size); at the default cap and at caps
    that cut multisets over their slots and the virtual quadruples over
    ranges of min(y), so that energy tiles stop at a1; two calls bitwise
    equal."""
    args = _quadruples_args(no, nv, cuda, 3 * no + nv)
    expected = cc._ccsdt_q_energy_plain(*args)
    scales = [abs(x) for x in expected.tolist()]
    if no == 1:
        scales = _quadruples_term_sizes(*args)
    for cap in [cc.QUADRUPLES_WORKSPACE_BYTES] + _quadruples_caps(no, nv):
        monkeypatch.setattr(cc, "QUADRUPLES_WORKSPACE_BYTES", cap)
        got = cc.ccsdt_q_energy(*args)
        assert torch.equal(got, cc.ccsdt_q_energy(*args))
        for value, want, scale in zip(got.tolist(), expected.tolist(), scales):
            assert abs(value - want) <= 1e-12 * scale


def test_ccsdt_q_kernel_checks_its_inputs(cuda, monkeypatch):
    """Non-contiguous and float32 inputs are refused, and so is a plan whose
    workspace or partials do not fit the buffers it is given."""
    args = list(_quadruples_args(3, 4, cuda, 1))
    args[2] = args[2].transpose(3, 4)
    with pytest.raises(ValueError, match="contiguous"):
        cc.ccsdt_q_energy(*args)
    args[2] = args[2].contiguous().float()
    with pytest.raises(ValueError, match="dtype"):
        cc.ccsdt_q_energy(*args)
    args[2] = args[2].double()
    cc._quadruples_tables_on(3, 4, cuda)
    key = (3, 4, str(cuda))
    entry = cc._quadruples_tables[key]
    for at in (4, 6):   # the workspace's doubles, the partials' doubles
        short = entry[:at] + (entry[at] - 1,) + entry[at + 1:]
        monkeypatch.setitem(cc._quadruples_tables, key, short)
        with pytest.raises(RuntimeError, match="CUDA error"):
            cc.ccsdt_q_energy(*args)


@pytest.mark.parametrize("line", ["SPE : LI H 1.6 : CCSDT(Q) STO-3G : TIGHTSCF",
                                  "SPE : LI H 1.6 : CCSDT(Q) STO-3G : ML 3 TIGHTSCF"])
def test_ccsdt_q_runs_through_k9(cuda, line):
    """A CCSDT(Q) line on the card, closed and open shell: K9 launched
    once, the energy the CPU path's to 1e-10 Ha."""
    from tuna_tpu_torch.cli import run

    _kernels.reset_launch_counts()
    _, _, energy, _ = run(line, suppress_output=True, device="cuda")
    assert _kernels.launches["ccsdt_q_energy"] == 1
    _, _, energy_cpu, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_cpu) <= 1e-10


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : MP2 6-31G",                       # BASELINE.json config 2
    "SPE : O H 0.97 : UMP2 6-31G : ML 2 TIGHTSCF",
    "SPE : O H 0.97 : UMP3 6-31G : ML 2 TIGHTSCF",
    "SPE : N N 1.1 : IMP2 6-31G : TIGHTSCF",
])
def test_perturbation_theory_on_the_card_matches_the_cpu(cuda, line):
    """MP2 (BASELINE.json config 2), UMP2, UMP3 and IMP2 on the card: the
    energy the CPU path's to 1e-10 Ha, the same SCF cycles and IMP2 steps,
    K1 and K3 launched."""
    from tuna_tpu_torch.cli import run

    _kernels.reset_launch_counts()
    card, _, energy, _ = run(line, suppress_output=True, device="cuda")
    assert _kernels.launches["eri_packed"] > 0 and _kernels.launches["one_electron"] > 0
    host, _, energy_cpu, _ = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_cpu) <= 1e-10
    assert len(card.iteration_seconds) == len(host.iteration_seconds)
    assert (len(card.correlation_iteration_seconds)
            == len(host.correlation_iteration_seconds) == (3 if "IMP2" in line else 0))


# The small lines of tests/test_torch_cc.py and tests/test_torch_properties.py
# (the rest of restricted CC/CI and the last calculation types).  Constants
# from tests/chip_smoke_references.py: tuna_tpu on the JAX CPU backend with
# one device, the line's total energy or result, the SCF cycles of every SCF
# and the CC iterations of every solve in the order they ran, and the
# finite-field properties' values.
SMALL_LINES = {
    "SPE : N N 1.1 : LCCD STO-3G : TIGHTSCF": {
        "energy": -107.65310260027428,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "SPE : N N 1.1 : CCD STO-3G : TIGHTSCF": {
        "energy": -107.64995995395651,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "SPE : N N 1.1 : CEPA(0) STO-3G : TIGHTSCF": {
        "energy": -107.65338555685418,
        "scf_cycles": [7, 7],
        "cc_iterations": [14],
    },
    "SPE : N N 1.1 : CID STO-3G : TIGHTSCF": {
        "energy": -107.64145282340243,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "SPE : N N 1.1 : QCISD STO-3G : TIGHTSCF": {
        "energy": -107.65025311279747,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "SPE : N N 1.1 : QCISD(T) STO-3G : TIGHTSCF": {
        "energy": -107.65195137238676,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "SPE : N N 1.1 : CC2 6-31G : TIGHTSCF FREEZECORE": {
        "energy": -108.89392438169018,
        "scf_cycles": [7, 12],
        "cc_iterations": [14],
    },
    "SPE : N N 1.1 : CC3 STO-3G : TIGHTSCF": {
        "energy": -107.65198634011772,
        "scf_cycles": [7, 7],
        "cc_iterations": [13],
    },
    "ANHARM : H H 0.74 : HF STO-3G": {
        "result": [-1.1050896749105505, -1.0809737991426698, -1.057636756345618,
            -1.0350152756858544, -1.01306556594401, -0.9917455716189727],
        "scf_cycles": [3, 2, 2, 2, 2, 2, 2, 3, 2, 3, 2, 3, 2, 2, 2, 2, 2, 2, 2, 3, 2, 2, 2,
            3, 2, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2, 3,
            2, 2, 2, 3, 2, 3, 2, 2, 2, 3, 2],
        "cc_iterations": [],
    },
    "SPE : H F 0.92 : HF STO-3G : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF": {
        "energy": -98.57110051608088,
        "scf_cycles": [9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 10,
            10, 10, 10, 10, 10, 10, 10, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 9, 10,
            10, 10, 10, 10, 10, 10, 10],
        "cc_iterations": [],
        "calculate_numerical_dipole_moment": -0.5057904033075911,
        "calculate_numerical_quadrupole_moment": -2.5074857519484572,
        "calculate_polarisability": 1.0566100109422727,
        "calculate_hyperpolarisability": [6.349622803953272, -0.01750777300912887],
    },
    "IP : H F 0.92 : HF STO-3G": {
        "result": 0.38100164698271044,
        "scf_cycles": [9, 2, 8, 8, 7, 7, 11, 2, 10, 10, 9, 8],
        "cc_iterations": [],
    },
    "EA : F : HF STO-3G": {
        "result": -0.37319028013550337,
        "scf_cycles": [2, 2],
        "cc_iterations": [],
    },
    "BDE : H F 0.92 : HF STO-3G": {
        "result": 0.08999138316293909,
        "scf_cycles": [9, 2, 8, 8, 7, 7, 1, 1, 10, 2],
        "cc_iterations": [],
    },
    "SPE : H H 0.74 : MP2 CC-PVDZ : EXTRAPOLATE TIGHTSCF": {
        "energy": -1.1692537285639262,
        "scf_cycles": [3, 7, 3, 9],
        "cc_iterations": [],
    },
}


def _counted_line(line, device):
    """`line` through cli.run on `device`: (total energy or result, the SCF
    cycles of every SCF, the CC iterations of every solve, the properties'
    values by function name)."""
    from tuna_tpu_torch.cli import run
    from tuna_tpu_torch.drivers import electric, energy

    counts, values = {"scf_cycles": [], "cc_iterations": []}, {}
    serial_scf, solve = energy.run_self_consistent_field, cc.solve_amplitudes
    properties = {name: getattr(electric, name) for name in _FIELD_STENCILS}

    def scf_counted(*args, **kwargs):
        SCF_output = serial_scf(*args, **kwargs)
        counts["scf_cycles"].append(len(SCF_output.iteration_seconds))
        return SCF_output

    def solve_counted(*args, **kwargs):
        result = solve(*args, **kwargs)
        counts["cc_iterations"].append(result[0])
        return result

    def recorded(name):
        def call(*args, **kwargs):
            values[name] = properties[name](*args, **kwargs)
            return values[name]
        return call

    energy.run_self_consistent_field, cc.solve_amplitudes = scf_counted, solve_counted
    for name in properties:
        setattr(electric, name, recorded(name))
    try:
        result = run(line, suppress_output=True, device=device)
    finally:
        energy.run_self_consistent_field, cc.solve_amplitudes = serial_scf, solve
        for name, function in properties.items():
            setattr(electric, name, function)
    value = result[2] if line.startswith("SPE") else result
    return np.asarray(value, dtype=np.float64), counts, values


# (step, sum of |coefficients| over the denominator, order) of each
# property's stencil: held to what 1e-10 Ha of energy allows through it
_FIELD_STENCILS = {
    "calculate_numerical_dipole_moment": (1e-5, 1.0, 1),
    "calculate_numerical_quadrupole_moment": (1e-5, 1.0, 1),
    "calculate_polarisability": (1e-3, 64 / 12, 2),
    "calculate_hyperpolarisability": (1.5e-3, 2 * (7 + 72 + 338 + 488) / 240, 3),
}


@pytest.mark.parametrize("line", sorted(SMALL_LINES))
def test_small_lines_on_the_card_match_tuna_tpu_and_the_cpu(cuda, line):
    """Each line on the card: its energy (ANHARM: its vibrational levels)
    within 1e-10 Ha of tuna_tpu's and of the CPU path's, the same SCF
    cycles and CC iterations, the properties within their stencils'
    limits; K1 and K3 launched, K2 on the (T) lines."""
    reference = SMALL_LINES[line]
    _kernels.reset_launch_counts()
    card, card_counts, card_values = _counted_line(line, "cuda")
    assert _kernels.launches["eri_packed"] > 0 and _kernels.launches["one_electron"] > 0
    assert (_kernels.launches["ccsd_t_energy"] > 0) == ("(T)" in line)
    host, host_counts, host_values = _counted_line(line, "cpu")
    expected = reference.get("energy", reference.get("result"))
    assert np.max(np.abs(card - expected)) <= 1e-10
    assert np.max(np.abs(card - host)) <= 1e-10
    assert card_counts == host_counts == {key: reference[key]
                                          for key in ("scf_cycles", "cc_iterations")}
    assert set(card_values) == {name for name in _FIELD_STENCILS if name in reference}
    for name, value in card_values.items():
        step, weight, order = _FIELD_STENCILS[name]
        limit = weight * 1e-10 / step ** order
        assert np.max(np.abs(np.subtract(value, reference[name]))) <= limit
        assert np.max(np.abs(np.subtract(value, host_values[name]))) <= limit


def test_extrapolation_from_triple_zeta_on_the_card(cuda):
    """EXTRAPOLATE from cc-pVTZ runs cc-pVQZ's g shells on the card: the
    extrapolated energy within 1e-10 Ha of tuna_tpu's and its SCF cycles
    (`tests/chip_smoke_references.py --phase 25`)."""
    _kernels.reset_launch_counts()
    energy, counts, _ = _counted_line("SPE : N N 1.1 : HF CC-PVTZ : EXTRAPOLATE TIGHTSCF",
                                      "cuda")
    assert abs(energy - -108.99288878978848) <= 1e-10
    assert counts == {"scf_cycles": [7, 14, 7, 14], "cc_iterations": []}
    assert _kernels.launches["eri_packed"] == 4 and _kernels.launches["one_electron"] == 4


def test_gradient_at_g_shells_refuses_on_the_card(cuda, monkeypatch):
    """FORCE at cc-pVQZ (g shells) runs on the card through K8a and K8b
    with no plain version (the name is kept from when the gradient kernels
    stopped at f shells and this line raised): tuna_tpu's energy (1e-10
    Ha) and its gradient (1e-8 Ha/bohr; `tests/chip_smoke_references.py
    --phase 26`)."""
    from tuna_tpu_torch.cli import run
    from tuna_tpu_torch.drivers import gradients

    def refused(*args, **kwargs):
        raise AssertionError("a plain version ran")

    for name in ("_one_electron_plain", "_eri_packed_plain", "_fock_direct_plain",
                 "_one_electron_deriv_plain", "_eri_deriv_energy_plain",
                 "_eri_deriv_energy_unrestricted_plain"):
        monkeypatch.setattr(IntegralPlan, name, refused)
    found = []
    analytic = gradients.calculate_analytic_gradient

    def recorded(molecule, calculation, SCF_output, coordinates):
        found.append((SCF_output.energy, analytic(molecule, calculation, SCF_output, coordinates)))
        return found[-1][1]

    monkeypatch.setattr(gradients, "calculate_analytic_gradient", recorded)
    _kernels.reset_launch_counts()
    assert run("FORCE : N N 1.1 : HF CC-PVQZ : TIGHTSCF", suppress_output=True,
               device="cuda") is None
    assert _kernels.launches["eri_packed"] > 0 and _kernels.launches["one_electron"] > 0
    assert _kernels.launches["one_electron_deriv"] == _kernels.launches["eri_deriv_energy"] == 1
    (energy, gradient), = found
    assert abs(float(energy) - -108.9906006517254) <= 1e-10
    assert abs(gradient - 0.11451397033788469) <= 1e-8


@pytest.mark.parametrize("symbols, basis, keep, lmax", [
    (("N", "N"), "CC-PVQZ", ((0, 0), (0, 3), (0, 4), (1, 0), (1, 3), (1, 4)), 4),
    (("N", "N"), "CC-PV5Z", ((0, 0), (0, 4), (0, 5), (1, 0), (1, 5)), 5),
    (("H", "H"), "CC-PV5Z", ((0, 4), (1, 0)), 4),
    (("H", "H"), "CC-PV6Z", ((0, 5), (1, 0)), 5)])
def test_gradient_kernels_at_g_and_h_shells(cuda, symbols, basis, keep, lmax):
    """K8a, K8b and K8bu (atom 1 moving) on reduced plans with g and h
    shells (derivative classes up to (8, 8) and (10, 10), Boys order up to
    21) against their plain versions, 1e-12 absolute, each bitwise over
    two calls; K8bu at Pa = Pb = P/2 within 1e-14 of K8b(P)."""
    molecule = _diatomic(symbols, basis, 0.74 if symbols[0] == "H" else 1.1)
    functions = integrals.shell_subset(molecule.cartesian_basis_functions, keep)
    plan = IntegralPlan(functions, molecule.n_atoms)
    assert plan.lmax == lmax
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=cuda)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    fraction = float(masses[1] / masses.sum())
    origin = fraction * molecule.bond_length
    P, P_a, P_b = (torch.as_tensor(_density(plan.n_basis, seed), device=cuda)
                   for seed in (23, 24, 25))
    _kernels.reset_launch_counts()
    got = plan.one_electron_deriv(coords, charges, origin, fraction)
    again = plan.one_electron_deriv(coords, charges, origin, fraction)
    first, second = plan.eri_deriv_energy(coords, P, 0.3), plan.eri_deriv_energy(coords, P, 0.3)
    spins = plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, 0.3)
    assert torch.equal(spins, plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, 0.3))
    assert _kernels.launches["one_electron_deriv"] == _kernels.launches["eri_deriv_energy"] == 2
    for g, a, e in zip(got, again, plan._one_electron_deriv_plain(coords, charges, origin,
                                                                   fraction)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, e, rtol=0, atol=1e-12)
    assert torch.equal(first, second)
    tangent = plan._eri_tangent_plain(coords)
    assert abs(float(first) - float(plan._eri_deriv_energy_plain(coords, P, 0.3,
                                                                 tangent=tangent))) <= 1e-12
    assert abs(float(spins) - float(plan._eri_deriv_energy_unrestricted_plain(
        coords, P_a, P_b, 0.3, tangent=tangent))) <= 1e-12
    half = plan.eri_deriv_energy_unrestricted(coords, P / 2, P / 2, 0.3)
    assert abs(float(half - first)) <= 1e-14 * abs(float(first))


# Excited states and stability at small sizes (the lines of
# tests/test_torch_excited.py).  Constants from `tests/chip_smoke_references.py
# --phase 24 LINE`: tuna_tpu on the JAX CPU backend, the line's total energy,
# the SCF cycles of every SCF, the first NSTATES excitation energies and
# oscillator strengths of its spectrum, its (D) correction and the lowest
# eigenvalue of each stability Hessian.
EXCITED_SMALL_LINES = {
    "SPE : H H 0.74 : CIS 6-31G : NSTATES 3 TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.7476366259822895,
        "excitation_energies": [0.3791186874672148, 0.5603391498541199, 0.8385643291349013],
        "oscillator_strengths": [0.0, 0.769990978948462, 0.0],
    },
    "SPE : H H 0.74 : TDHF 6-31G : TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.7668597461597058,
        "excitation_energies": [0.3598955672897985, 0.5519609956139673, 0.8314010339314486,
            1.051638108372343, 1.34952712639686, 1.6035634159484253],
        "oscillator_strengths": [0.0, 0.6509476140635941, 0.0, 3.663305057365302e-30, 0.0,
            0.06349598126371161],
    },
    "SPE : H H 0.74 : CIS[D] 6-31G : TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.7360251868272004,
        "excitation_energies": [0.3791186874672148, 0.5603391498541199, 0.8385643291349013,
            1.0573103451003139, 1.3582965869670307, 1.6124667190070752],
        "oscillator_strengths": [0.0, 0.769990978948462, 0.0, 4.499604741898307e-30, 0.0,
            0.10829325705276342],
        "doubles": [0.011611439155089089],
    },
    "SPE : H H 0.74 : SVWN 6-31G : TD TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.7306173346136848,
        "excitation_energies": [0.40202448899670434, 0.5323017957434572, 0.862376857863091,
            1.0454977631851667, 1.3516291569088867, 1.5715363682369974],
        "oscillator_strengths": [0.0, 0.6154002787457018, 0.0, 7.523961511482107e-31, 0.0,
            0.07326649975595008],
    },
    "SPE : H H 0.74 : SPW 6-31G : TD TDA TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.7254862638180487,
        "excitation_energies": [0.4069945961911007, 0.5437829875590333, 0.8658823028940368,
            1.0522402546764658, 1.3568487903934576, 1.5838360803670433],
        "oscillator_strengths": [0.0, 0.7408441355539519, 0.0, 3.827886756864682e-31, 0.0,
            0.1430354894520071],
    },
    "SPE : N H 1.04 : SVWN 6-31G : ML 3 TD TIGHTSCF": {
        "scf_cycles": [10, 14],
        "energy": -54.58076734216713,
        "excitation_energies": [0.14034903998844173, 0.14034903998844178, 0.3296287925657076,
            0.3296287925657078, 0.34830400842749304, 0.4415902968812691, 0.5596253797044869,
            0.5596253797044869, 0.7422071262447736, 0.8364920400581612],
        "oscillator_strengths": [0.00893128458258514, 0.008931284582585136, 0.00696729124336461,
            0.006967291243364612, 0.018641483132561695, 0.46242925611948477, 0.17693690964618908,
            0.1769369096461892, 0.020356157180129862, 0.03549413290589965],
    },
    "SPE : O H 0.97 : CIS(D) 6-31G : ML 2 TIGHTSCF": {
        "scf_cycles": [10, 15],
        "energy": -75.36224326359235,
        "excitation_energies": [0.0007471657040111409, 0.16513092056141032, 0.3301030906115344,
            0.3834466649011271, 0.42421421089276834, 0.45974811191843146, 0.5556064895601492,
            0.7971896220564804, 0.9647452787667936, 1.0500661182399718],
        "oscillator_strengths": [5.979341284724221e-38, 0.005153634114881202,
            0.001528379523402196, 0.008246743538387027, 0.009061458307192693,
            0.010508054172628237, 0.49096197726262036, 0.21594868419922222, 0.0019473847707744299,
            5.8250715742580014e-30],
        "doubles": [0.00017781676343830988],
    },
    "SPE : H H 2.5 : HF 6-31G : STAB TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -0.8568959618237292,
        "hessian_lowest": [0.05847189154540263, -0.32300740001513367],
    },
    "SPE : O H 0.97 : UHF 6-31G : ML 2 STAB TIGHTSCF": {
        "scf_cycles": [10, 15],
        "energy": -75.3631682460598,
        "hessian_lowest": [-9.273100569388011e-11],
    },
    "SPE : H H 0.74 : SVWN 6-31G : STAB TIGHTSCF": {
        "scf_cycles": [3, 6],
        "energy": -1.1326418236103892,
        "hessian_lowest": [0.4549675838276731, 0.35385024718626795],
    },
}


def _excited_line(line, device):
    """(total energy, SCF cycles, excitation energies and oscillator
    strengths of the printed spectrum, (D) corrections, stability
    eigenvalues) of one run of `line` on `device`."""
    from tuna_tpu_torch.cli import run
    from tuna_tpu_torch.drivers import energy
    from tuna_tpu_torch.post import excited, rpa

    record = {"cycles": [], "spectrum": [], "doubles": [], "lowest": []}
    watched = {(energy, "run_self_consistent_field"): ("cycles",
                                                       lambda a, r: len(r.iteration_seconds)),
               (excited, "print_absorption_spectrum"): (
                   "spectrum", lambda a, r: (a[1].cpu().numpy(), a[4].cpu().numpy())),
               (excited, "restricted_doubles_correction"): ("doubles", lambda a, r: float(r)),
               (excited, "unrestricted_doubles_correction"): ("doubles", lambda a, r: float(r)),
               (rpa, "orbital_hessian_lowest"): ("lowest", lambda a, r: float(r))}
    originals = {key: getattr(*key) for key in watched}

    def recorded(key):
        name, keep = watched[key]

        def call(*args, **kwargs):
            result = originals[key](*args, **kwargs)
            record[name].append(keep(args, result))
            return result
        return call

    for key in watched:
        setattr(*key, recorded(key))
    try:
        _, _, total, _ = run(line, suppress_output=True, device=device)
    finally:
        for key, original in originals.items():
            setattr(*key, original)
    return float(total), record


@pytest.mark.parametrize("line", sorted(EXCITED_SMALL_LINES))
def test_excited_lines_on_the_card_match_tuna_tpu_and_the_cpu(cuda, line):
    """Each excited-state or stability line on the card: its total energy,
    first NSTATES excitation energies, (D) correction and stability
    eigenvalues within 1e-10 of tuna_tpu's and of the CPU path's, its
    oscillator strengths within 1e-8, the same SCF cycles; K1 and K3
    launched, K7a and K7b on the TD-LDA lines."""
    reference = EXCITED_SMALL_LINES[line]
    _kernels.reset_launch_counts()
    card, card_record = _excited_line(line, "cuda")
    assert _kernels.launches["eri_packed"] > 0 and _kernels.launches["one_electron"] > 0
    grid_line = "SVWN" in line or "SPW" in line
    assert (_kernels.launches["density_on_grid"] > 0) == grid_line
    host, host_record = _excited_line(line, "cpu")
    for got in (card, host):
        assert abs(got - reference["energy"]) <= 1e-10
    assert card_record["cycles"] == host_record["cycles"] == reference["scf_cycles"]
    if "excitation_energies" in reference:
        n = len(reference["excitation_energies"])
        for energies, strengths in (card_record["spectrum"][0], host_record["spectrum"][0]):
            assert np.max(np.abs(energies[:n] - reference["excitation_energies"])) <= 1e-10
            assert np.max(np.abs(strengths[:n] - reference["oscillator_strengths"])) <= 1e-8
    for key, name in (("doubles", "doubles"), ("lowest", "hessian_lowest")):
        expected = reference.get(name, [])
        assert len(card_record[key]) == len(host_record[key]) == len(expected)
        if expected:
            assert np.max(np.abs(np.subtract(card_record[key], expected))) <= 1e-10
            assert np.max(np.abs(np.subtract(card_record[key], host_record[key]))) <= 1e-10


def test_checkpoints_on_the_card(cuda, tmp_path, monkeypatch):
    """CHKPT on the card writes the densities and CC amplitudes under the
    CPU path's keys; READCHK on the card reads it and a file the CPU path
    wrote and reaches the CPU path's energy from the same file (1e-10 Ha)
    in as many SCF cycles.  A single point restarts only its guess from the
    file (tuna_tpu's rule), so its SCF converges to TIGHTSCF's 1e-8 Ha of
    the written energy, not bit for bit."""
    from tuna_tpu_torch.cli import run

    monkeypatch.chdir(tmp_path)
    line = "SPE : LI H 1.6 : CCSD 6-31G : TIGHTSCF"
    _, _, written, _ = run(f"{line} CHKPT CARD", suppress_output=True, device="cuda")
    run(f"{line} CHKPT HOST", suppress_output=True, device="cpu")
    with np.load(tmp_path / "CARD.npz") as card, np.load(tmp_path / "HOST.npz") as host:
        assert sorted(card.files) == sorted(host.files) == [
            "cc/E_CC", "cc/t1", "cc/t2", "scf/P", "scf/P_alpha", "scf/P_beta", "scf/energy"]
        assert np.max(np.abs(card["scf/P"] - host["scf/P"])) <= 1e-8
    for source in ("CARD", "HOST"):
        scf, _, energy, _ = run(f"{line} READCHK {source}", suppress_output=True,
                                device="cuda")
        host_scf, _, host_energy, _ = run(f"{line} READCHK {source}", suppress_output=True,
                                          device="cpu")
        assert abs(energy - host_energy) <= 1e-10
        assert abs(energy - written) <= 1e-8
        assert len(scf.iteration_seconds) == len(host_scf.iteration_seconds)


def test_density_plot_on_the_card(cuda, tmp_path, monkeypatch):
    """DENSPLOT SAVEPLOT on the card: the plane's AOs through K7a and its
    density through K7b (rho alone), saved as a file."""
    pytest.importorskip("matplotlib")
    from tuna_tpu_torch.cli import run

    monkeypatch.chdir(tmp_path)
    _kernels.reset_launch_counts()
    run("SPE : H H 0.74 : HF 6-31G : DENSPLOT SAVEPLOT DENS.PNG", suppress_output=True,
        device="cuda")
    assert _kernels.launches["ao_on_grid"] == 1 and _kernels.launches["density_on_grid"] == 1
    saved = [p for p in tmp_path.iterdir() if p.name.upper() == "DENS.PNG"]
    assert len(saved) == 1 and saved[0].stat().st_size > 1000

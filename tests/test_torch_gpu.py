"""The CUDA kernels of tuna_tpu_torch against their plain PyTorch versions,
on the card.

Every test here needs a CUDA GPU and skips without one.  This file imports
neither jax nor tuna_tpu, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(tests/conftest.py configures JAX).  Tolerances: 1e-12 absolute for the
integrals, the AO values and the density on the grid, and 1e-12 relative
for the (T) and VV10 energies -- the same float64 math, the kernels
unscaled and summed in another order; 1e-12 of the largest |entry| for the
direct Fock build's J and K, whose atomics sum in no fixed order, and for
the packed MO half-transform.
"""

import numpy as np
import pytest
import torch

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
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


@pytest.mark.parametrize("basis", ["STO-3G", "6-311G", "6-31G**", "CC-PVTZ"])
def test_integral_kernels_match_plain(cuda, basis):
    molecule, plan = _n2_plan(basis)
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
    # a non-symmetric P: the gradient is 2 sum_ij P_ij phi_i grad phi_j
    P = torch.as_tensor(A / n, device=cuda)
    density, gradient = grid.density_on_grid(P, bfs, bf_grads)
    density_p, gradient_p = grid._density_on_grid_plain(P, bfs, bf_grads)
    torch.testing.assert_close(density, density_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(gradient, gradient_p, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [97, 203])
def test_density_kernel_wide_basis(cuda, n):
    """More AOs than the default 48 KB of shared memory holds columns for
    (n > 96), and n not a multiple of the kernel's 8 rows of Y."""
    rng = np.random.default_rng(n)
    G = 3001
    bfs = torch.as_tensor(rng.standard_normal((n, G)) / n, device=cuda)
    bf_grads = torch.as_tensor(rng.standard_normal((3, n, G)) / n, device=cuda)
    P = torch.as_tensor(rng.standard_normal((n, n)), device=cuda)
    density, gradient = grid.density_on_grid(P, bfs, bf_grads)
    density_p, gradient_p = grid._density_on_grid_plain(P, bfs, bf_grads)
    torch.testing.assert_close(density, density_p, rtol=0, atol=1e-12)
    torch.testing.assert_close(gradient, gradient_p, rtol=0, atol=1e-12)


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


def test_fock_direct_kernel_refuses_lmax_4(cuda):
    molecule, plan = _n2_plan("CC-PVQZ")
    assert plan.lmax == 4
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    P = torch.eye(plan.n_basis, dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="lmax"):
        plan.fock_direct(coords, P)


def _mo_inputs(basis, device, seed):
    molecule, plan = _n2_plan(basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    rng = np.random.default_rng(seed)
    n_mo = U.shape[0]
    Ws = [(U.T @ torch.as_tensor(rng.standard_normal((n_mo, n_mo)) / np.sqrt(n_mo),
                                 device=device)).contiguous() for _ in range(2)]
    return plan.eri_pair_packed(coords), plan.tensors(device)["pair_index"], Ws, n_mo


@pytest.mark.parametrize("basis", ["6-31G**", "CC-PVTZ"])
def test_mo_transform_kernel_matches_plain(cuda, basis):
    G_pair, pair_index, (W_left, W_right), n_mo = _mo_inputs(basis, cuda, 21)
    tri = motransform.mo_pair_indices(n_mo)

    def plain(W_l, W_r):
        H = motransform._chunked_half_transform(G_pair, pair_index, W_r, tri, 128)
        return motransform._chunked_half_transform(H.T, pair_index, W_l, tri, 128)

    _kernels.reset_launch_counts()
    got = motransform.pair_packed_to_mo(G_pair, pair_index, W_left, n_mo)
    mixed = motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo)
    assert _kernels.launches["mo_half_transform"] == 4
    assert _relative(got, plain(W_left, W_left)) <= 1e-12
    assert _relative(mixed, plain(W_left, W_right).T) <= 1e-12


def test_mo_transform_kernel_at_the_cc_pv6z_shape(cuda):
    """N = 252 Cartesian AOs and n_mo = 182 (H2/cc-pV6Z): D_r and W^T D_r do
    not fit in shared memory, so the kernel runs in panels of columns."""
    N, n_mo, rows = 252, 182, 64
    tril = np.tril_indices(N)
    pair_index = np.zeros((N, N), dtype=np.int64)
    pair_index[tril] = pair_index[tril[::-1]] = np.arange(len(tril[0]))
    pair_index = torch.as_tensor(pair_index, device=cuda)
    rng = np.random.RandomState(17)
    M = torch.as_tensor(rng.rand(rows, len(tril[0])), device=cuda)
    W = torch.as_tensor(rng.randn(N, n_mo) / np.sqrt(N), device=cuda)
    expected = motransform._half_transform_plain(M, pair_index, W,
                                                 motransform.mo_pair_indices(n_mo))
    assert _relative(motransform.half_transform(M, pair_index, W), expected) <= 1e-12
    transposed = motransform.half_transform(M.T.contiguous(), pair_index, W, transposed=True)
    assert _relative(transposed, expected) <= 1e-12

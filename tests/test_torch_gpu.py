"""The CUDA kernels of tuna_tpu_torch against their plain PyTorch versions,
on the card.

Every test here needs a CUDA GPU and skips without one.  This file imports
neither jax nor tuna_tpu, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(tests/conftest.py configures JAX).  Tolerances: 1e-12 absolute for the
integrals, the AO values and the density on the grid, and 1e-12 relative
for the (T) and VV10 energies -- the same float64 math, the kernels
unscaled and summed in another order; 1e-12 of the largest |entry| for the
direct Fock build's J and K, whose atomics sum in no fixed order, for
the packed MO half-transform, and for the density's tangent on the moving
grid (its gradient reaches 10^4 at the nuclei).
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
    included (cc-pVTZ: Boys order 13); K8b bitwise over two calls."""
    molecule, plan = _diatomic_plan(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=cuda)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=cuda)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    fraction = float(masses[1] / masses.sum())
    P = torch.as_tensor(_density(plan.n_basis, 8), device=cuda)
    _kernels.reset_launch_counts()
    got = plan.one_electron_deriv(coords, charges, fraction * molecule.bond_length, fraction)
    first, second = plan.eri_deriv_energy(coords, P, 0.25), plan.eri_deriv_energy(coords, P, 0.25)
    assert _kernels.launches["one_electron_deriv"] == 1
    assert _kernels.launches["eri_deriv_energy"] == 2
    expected = plan._one_electron_deriv_plain(coords, charges, fraction * molecule.bond_length,
                                              fraction)
    for g, e in zip(got, expected):
        torch.testing.assert_close(g, e, rtol=0, atol=1e-12)
    assert torch.equal(first, second)
    assert abs(float(first) - float(plan._eri_deriv_energy_plain(coords, P, 0.25))) <= 1e-12


@pytest.mark.parametrize("threshold", [0, 10 ** 9])
def test_eri_deriv_kernel_all_light_or_all_heavy(cuda, threshold, monkeypatch):
    monkeypatch.setattr(integrals, "HEAVY_THRESHOLD", threshold)
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

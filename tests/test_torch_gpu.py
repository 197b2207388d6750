"""The CUDA kernels of tuna_tpu_torch against their plain PyTorch versions,
on the card.

Every test here needs a CUDA GPU and skips without one.  This file imports
neither jax nor tuna_tpu, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(tests/conftest.py configures JAX).  Tolerances: 1e-12 absolute for the
integrals, the AO values and the density on the grid, and 1e-12 relative
for the (T) and VV10 energies -- the same float64 math, the kernels
unscaled and summed in another order.
"""

import numpy as np
import pytest
import torch

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
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


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
def test_triples_kernel_matches_plain(cuda, v_scale):
    no, nv = 7, 19
    rng = np.random.default_rng(3)

    def tensor(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape), device=cuda)

    args = (tensor(no, no, nv, nv, scale=0.1), tensor(no, nv, nv, nv, scale=0.1),
            tensor(no, no, nv, no, scale=0.1), tensor(no, nv, scale=0.01),
            tensor(no, no, nv, nv, scale=0.05),
            torch.as_tensor(np.sort(rng.uniform(-15.0, -0.5, no)), device=cuda),
            torch.as_tensor(np.sort(rng.uniform(0.3, 5.0, nv)), device=cuda))
    got = float(cc.ccsd_t_energy(*args, v_scale))
    expected = float(cc._ccsd_t_energy_plain(*args, v_scale))
    assert abs(got - expected) <= 1e-12 * abs(expected)


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

"""The CUDA kernels of tuna_tpu_torch against their plain PyTorch versions,
on the card.

Every test here needs a CUDA GPU and skips without one.  This file imports
neither jax nor tuna_tpu, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(tests/conftest.py configures JAX).  Tolerances: 1e-12 absolute for the
integrals and 1e-12 relative for the (T) energy -- the same float64 math,
the kernels unscaled and summed in another order.
"""

import numpy as np
import pytest
import torch

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
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


def _n2_plan(basis):
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, ["N", "N"],
                         suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(1.1)]])
    molecule = Molecule(["N", "N"], coords, calculation)
    return molecule, IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)


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

"""The port's restricted coupled cluster and (T) against tuna_tpu.

Residuals and (T) take identical seeded numpy inputs in both packages and
agree to 1e-12 relative (the same contractions in float64, summed in
another order).  End to end, total energies agree to 1e-9 Ha and the CC
iteration counts to within one: the DIIS loop is mirrored, f32 spread
extrapolation included, but the two eigensolvers may pick different bases
of degenerate orbitals.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.cli import run as jax_run
from tuna_tpu.post import cc as jax_cc
from tuna_tpu.post import transforms as jax_transforms

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.post import cc

torch.set_num_threads(2)

NO, NV = 3, 5


def _physicists_integrals(rng, n):
    """Random <pq|rs> with the 8-fold symmetry of real orbitals."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    chem = 0.05 * (chem + chem.transpose(2, 3, 0, 1))
    return chem.transpose(0, 2, 1, 3).copy()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = NO + NV
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, NO)),
                          np.sort(rng.uniform(0.2, 3.0, NV))])
    return {
        "g": _physicists_integrals(rng, n),
        "eps": eps,
        "t1": 0.02 * rng.standard_normal((NO, NV)),
        "t2": 0.05 * rng.standard_normal((NO, NO, NV, NV)),
    }


def _relative_error(got, expected):
    return np.max(np.abs(got - expected)) / np.max(np.abs(expected))


@pytest.mark.parametrize("method", ["CCSD", "CISD"])
def test_residual_matches_tuna_tpu(method):
    x = _inputs(11)
    o, v = slice(0, NO), slice(NO, None)
    eps = x["eps"]
    d1 = 1.0 / (eps[o, None] - eps[None, v])
    d2 = 1.0 / (eps[o, None, None, None] + eps[None, o, None, None]
                - eps[None, None, v, None] - eps[None, None, None, v])
    F_ov = np.zeros((NO, NV))

    jax_blocks = jax_cc._restricted_blocks(jnp.asarray(x["g"]), o, v)
    expected = jax_cc._RESTRICTED_UPDATES[method](
        jax_blocks, jnp.asarray(F_ov), jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(x["t1"]), jnp.asarray(x["t2"]), {})

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    blocks = cc._restricted_blocks(t(x["g"]), o, v)
    got = cc._RESTRICTED_UPDATES[method](blocks, t(F_ov), t(d1), t(d2), t(x["t1"]), t(x["t2"]))
    for g, e in zip(got, expected):
        assert _relative_error(g.numpy(), np.asarray(e)) <= 1e-12

    E = cc._restricted_energy(blocks, t(F_ov), got[0], got[1], True)[0]
    E_ref = jax_cc._restricted_energy(jax_blocks, jnp.asarray(F_ov), expected[0],
                                      expected[1], True)[0]
    assert abs(float(E) - float(E_ref)) <= 1e-12 * abs(float(E_ref))


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
def test_triples_energy_matches_tuna_tpu(v_scale):
    x = _inputs(5)
    o, v = slice(0, NO), slice(NO, None)
    g = x["g"]
    blocks = (g[o, o, v, v], g[o, v, v, v], g[o, o, v, o])
    e_ijkabc = jax_transforms.triples_epsilons(jnp.asarray(x["eps"]), o, v)
    V, W, W_weighted = jax_cc._restricted_T_tensors(
        *[jnp.asarray(b) for b in blocks], jnp.asarray(x["t1"]), jnp.asarray(x["t2"]),
        e_ijkabc)
    expected = (1.0 / 3.0) * float(jnp.einsum("ijkabc,ijkabc,ijkabc->", W + v_scale * V,
                                              W_weighted, e_ijkabc))

    _kernels.reset_launch_counts()
    got = cc.ccsd_t_energy(*[torch.as_tensor(np.ascontiguousarray(b)) for b in blocks],
                           torch.as_tensor(x["t1"]), torch.as_tensor(x["t2"]),
                           torch.as_tensor(x["eps"][o]), torch.as_tensor(x["eps"][v]),
                           v_scale)
    assert _kernels.launches["ccsd_t_energy"] == 0
    assert abs(float(got) - expected) <= 1e-12 * abs(expected)


@pytest.mark.parametrize("n_valid", [1, 3, 6])
def test_diis_coefficients_match_tuna_tpu(n_valid):
    """Same bordered DIIS system; tuna_tpu solves it with an f32 inverse and
    three f64 refinement steps, the port with an f64 LU, hence 1e-10."""
    M = 6
    rng = np.random.default_rng(n_valid)
    errors = rng.standard_normal((M, 40)) * np.logspace(-6, -1, M)[:, None]
    gram = errors @ errors.T
    ok_ref, expected = jax_cc._diis_coefficients_from_gram(jnp.asarray(gram), n_valid, M)
    ok, got = cc._diis_coefficients_from_gram(torch.as_tensor(gram), n_valid, M)
    assert bool(ok) and bool(ok_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-10)
    assert abs(float(got.sum()) - 1.0) <= 1e-14


def _cc_iterations(output):
    """Number of rows in the printed CC iteration table."""
    table = output.split("Step          Correlation E")[-1].split("Singles contribution")[0]
    return len(re.findall(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", table, re.M))


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : CCSD[T] STO-3G : TIGHTSCF",
    "SPE : H H 0.74 : CCSD[T] 6-31G : TIGHTSCF",   # two electrons: reduces to CISD
])
def test_cc_energy_matches_tuna_tpu(line, capsys):
    capsys.readouterr()
    _, _, jax_energy, _ = jax_run(line)
    jax_iterations = _cc_iterations(capsys.readouterr().out)
    scf, _, energy, P = run(line, device="cpu")
    iterations = _cc_iterations(capsys.readouterr().out)
    assert abs(energy - jax_energy) <= 1e-9
    assert jax_iterations > 0
    assert abs(iterations - jax_iterations) <= 1
    assert len(scf.correlation_iteration_seconds) == iterations
    assert bool(torch.all(torch.isfinite(P)))

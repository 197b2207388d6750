"""The port's restricted Hartree-Fock (tuna_tpu_torch, on the CPU) against
tuna_tpu on the JAX CPU backend, end to end through each package's
cli.run.  Same iteration semantics and tight convergence: total energies
and orbital energies agree to 1e-10 Ha."""

import numpy as np
import pytest
import torch

from tuna_tpu.cli import run as jax_run

from tuna_tpu_torch.cli import run
from tuna_tpu_torch.output import TunaError

torch.set_num_threads(2)


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : HF STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : HF 6-31G : TIGHTSCF",
])
def test_rhf_matches_tuna_tpu(line):
    jax_scf, _, jax_energy, _ = jax_run(line, suppress_output=True)
    scf, molecule, energy, P = run(line, suppress_output=True, device="cpu")
    assert abs(energy - jax_energy) <= 1e-10
    assert abs(scf.energy - jax_scf.energy) <= 1e-10
    np.testing.assert_allclose(scf.epsilons.numpy(), np.asarray(jax_scf.epsilons),
                               rtol=0, atol=1e-10)
    n = molecule.n_basis
    assert P.shape == (n, n) and P.device.type == "cpu"
    # Tr(PS) counts the electrons
    assert abs(float(torch.trace(P @ scf.S)) - molecule.n_electrons) <= 1e-10
    assert len(scf.iteration_seconds) >= 1


def test_cli_refuses_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TunaError, match="GPU"):
        run("SPE : H H 0.74 : HF STO-3G", suppress_output=True)


def test_unported_calculations_raise():
    with pytest.raises(TunaError, match="not yet ported"):
        run("ANHARM : H H 0.74 : HF STO-3G : VIBPLOT", suppress_output=True, device="cpu")
    with pytest.raises(TunaError, match="not yet ported"):
        run("SPE : O O 1.21 : R2SCAN0-DH STO-3G : ML 3 RELAXED", suppress_output=True,
            device="cpu")


@pytest.mark.parametrize("spread", [1.0, 1e-7])
def test_diis_solve_matches_tuna_tpu(spread):
    """The bordered DIIS system, well conditioned and nearly singular (error
    vectors that differ by `spread`): the same Gauss-Jordan arithmetic
    gives tuna_tpu's coefficients and its ok flag."""
    import jax.numpy as jnp

    from tuna_tpu.ops.linalg import solve_linear_small as jax_solve
    from tuna_tpu_torch.ops.linalg import solve_linear_small

    rng = np.random.default_rng(3)
    base = rng.standard_normal(40)
    errors = base + spread * rng.standard_normal((6, 40))
    n = errors.shape[0]
    B = errors @ errors.T
    A = np.zeros((n + 1, n + 1))
    A[:n, :n] = B / np.max(np.abs(B))
    A[:n, n] = A[n, :n] = -1.0
    b = np.zeros(n + 1)
    b[n] = -1.0
    x, ok = solve_linear_small(torch.as_tensor(A), torch.as_tensor(b))
    x_ref, ok_ref = jax_solve(jnp.asarray(A), jnp.asarray(b))
    assert ok == bool(ok_ref)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-12,
                               atol=1e-12 * float(np.max(np.abs(np.asarray(x_ref)))))

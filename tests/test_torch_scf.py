"""The port's restricted Hartree-Fock (tuna_tpu_torch, on the CPU) against
tuna_tpu on the JAX CPU backend, end to end through each package's
cli.run.  Same iteration semantics and tight convergence: total energies
and orbital energies agree to 1e-10 Ha."""

import numpy as np
import pytest
import torch

from tuna_tpu.cli import run as jax_run

from tuna_tpu_torch.cli import run
from ported_lines import RELAXED_DH, assert_line_matches_tuna_tpu
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


def test_unported_calculations_raise(monkeypatch, tmp_path):
    """Once refused as not ported: VIBPLOT runs as in tuna_tpu, and the
    relaxed density of a double hybrid is refused in tuna_tpu's words."""
    monkeypatch.chdir(tmp_path)
    assert_line_matches_tuna_tpu("ANHARM : H H 0.74 : HF STO-3G : VIBPLOT")
    assert_line_matches_tuna_tpu("SPE : O O 1.21 : R2SCAN0-DH STO-3G : ML 3 RELAXED",
                                 refusal=RELAXED_DH)


@pytest.mark.parametrize("spread", [1.0, 1e-7])
def test_diis_solve_matches_tuna_tpu(spread):
    """The bordered DIIS system, well conditioned and nearly singular (error
    vectors that differ by `spread`): the same Gauss-Jordan arithmetic
    gives tuna_tpu's coefficients and its ok flag.  tuna_tpu's SCF runs the
    solve compiled (jitted inside its while_loop), where XLA fuses each
    elimination update into one multiply-add; the reference is that
    compiled solve."""
    import jax
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
    x_ref, ok_ref = jax.jit(jax_solve)(jnp.asarray(A), jnp.asarray(b))
    assert ok == bool(ok_ref)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-12,
                               atol=1e-12 * float(np.max(np.abs(np.asarray(x_ref)))))


def test_fused_multiply_add_rounds_once():
    """The DIIS solve's emulated multiply-add against exact rational
    arithmetic: a b + c rounded once, also where a b and c cancel."""
    from fractions import Fraction

    from tuna_tpu_torch.ops.linalg import fused_multiply_add

    rng = np.random.default_rng(5)
    a, b, c = rng.standard_normal((3, 3000)) * np.exp(rng.uniform(-30, 30, (3, 3000)))
    c[::3] = -(a[::3] * b[::3]) * (1 + 1e-15 * rng.standard_normal(1000))
    got = fused_multiply_add(a, b, c)
    exact = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(exact))

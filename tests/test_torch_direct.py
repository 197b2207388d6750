"""The port's integral-direct SCF and transform-direct MO path (the DIRECT
keyword; tuna_tpu_torch, on the CPU) against tuna_tpu on the JAX CPU
backend.

Both packages integrate identical primitive data: the port's plan is built
from the JAX plan's arrays (IntegralPlan.from_arrays).  Tolerances:

  * plain direct Fock build: 1e-10 absolute on the seeded P + P.T of
    tuna_tpu's own test (its limit against the dense contractions,
    tests/test_fock_direct.py), and 1e-12 of the largest |entry| of J and
    of K for a density-like P = C C^T (the same quartet values, summed in
    another order);
  * packed MO transform: 1e-12 absolute (a gather and two contractions in
    float64);
  * end to end: 1e-10 Ha against tuna_tpu with the same SCF and CC
    iteration counts, and 1e-10 Ha against the port's stored-tensor path.
"""

import contextlib
import functools
import io
import re
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.cli import parse_input, process_method
from tuna_tpu.cli import run as jax_run
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.ops import motransform as jax_motransform
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.output import TunaError as JaxTunaError
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.ops import motransform
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.output import TunaError

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
FOCK_LINES = [
    "SPE : H H 0.74 : HF STO-3G",        # s only
    "SPE : N N 1.1 : HF 6-31G",          # s, p
    "SPE : H H 0.74 : HF CC-PVDZ",       # s, p on H
    "SPE : LI H 1.6 : HF 6-311G",        # mixed centres
    "SPE : H F 0.95 : HF 6-31G**",       # d shells on F
]


@functools.lru_cache(maxsize=None)
def _system(line, R_bohr=1.8):
    """(JAX molecule, JAX plan, port plan from the JAX plan's arrays, coords)
    at tuna_tpu's test geometry."""
    ct, ms, basis, symbols, _, params = parse_input(line)
    cfg = JaxConfig(ct, process_method(ms), time.time(), params, basis, symbols,
                    suppress_output=True)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, R_bohr]])
    molecule = JaxMolecule(list(symbols), coords, cfg)
    jax_plan = JaxPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    plan = IntegralPlan.from_arrays(
        *[np.asarray(getattr(jax_plan, name)) for name in PLAN_FIELDS],
        n_atoms=molecule.n_atoms)
    return molecule, jax_plan, plan, coords


def _densities(n):
    """tuna_tpu's seeded P + P.T, and a density-like C C^T."""
    P = np.random.RandomState(3).randn(n, n)
    C = np.random.default_rng(5).standard_normal((n, max(1, n // 3))) / np.sqrt(n)
    return {"seeded": P + P.T, "density-like": C @ C.T}


# --------------------------------------------------------------------------
# Plain direct Fock build (K4's plain version)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("line", FOCK_LINES)
def test_fock_direct_matches_tuna_tpu(line):
    _, jax_plan, plan, coords = _system(line)
    assert plan.lmax <= 2
    np.testing.assert_array_equal(plan.pid_i, np.asarray(jax_plan.pid_i))
    np.testing.assert_array_equal(plan.pid_j, np.asarray(jax_plan.pid_j))
    for kind, P in _densities(plan.n_basis).items():
        J_ref, K_ref = (np.asarray(x) for x in jax_plan.fock_direct(jnp.asarray(coords),
                                                                    jnp.asarray(P)))
        J, K = plan.fock_direct(torch.as_tensor(coords), torch.as_tensor(P))
        for got, expected in ((J.numpy(), J_ref), (K.numpy(), K_ref)):
            error = np.max(np.abs(got - expected))
            if kind == "seeded":
                assert error < 1e-10, line
            else:
                assert error <= 1e-12 * np.max(np.abs(expected)), line


def test_fock_direct_matches_stored_contractions():
    """J and K of the plain direct build are the stored tensor's einsums."""
    _, _, plan, coords = _system("SPE : N N 1.1 : HF 6-31G")
    coords = torch.as_tensor(coords)
    P = torch.as_tensor(_densities(plan.n_basis)["density-like"])
    ERI = plan.eri(coords)
    J, K = plan.fock_direct(coords, P)
    J_ref = torch.einsum("ijkl,kl->ij", ERI, P)
    K_ref = torch.einsum("ilkj,kl->ij", ERI, P)
    assert float(torch.max(torch.abs(J - J_ref))) <= 1e-12 * float(torch.max(torch.abs(J_ref)))
    assert float(torch.max(torch.abs(K - K_ref))) <= 1e-12 * float(torch.max(torch.abs(K_ref)))


def test_fock_closure_matches_tuna_tpu():
    """The spherical closure: U J_c U^T and U K_c U^T of the Cartesian
    density U^T P U (d shells: 6 Cartesian, 5 spherical functions)."""
    molecule, jax_plan, plan, coords = _system("SPE : H F 0.95 : HF 6-31G**")
    U = np.asarray(molecule.spherical_transformation)
    assert U.shape[0] < U.shape[1]
    C = np.random.default_rng(8).standard_normal((U.shape[0], 5))
    P = C @ C.T
    expected = jax_plan.fock_closure(U)(jnp.asarray(coords), jnp.asarray(P))
    got = plan.fock_closure(U)(torch.as_tensor(coords), torch.as_tensor(P))
    for g, e in zip(got, expected):
        e = np.asarray(e)
        assert g.shape == e.shape == (U.shape[0], U.shape[0])
        assert np.max(np.abs(g.numpy() - e)) <= 1e-12 * np.max(np.abs(e))


# --------------------------------------------------------------------------
# Plain packed MO transform (K5's plain version)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("line,n_mo", [
    ("SPE : H H 0.74 : HF 6-31G", None),
    ("SPE : N N 1.1 : HF 6-31G", None),
    ("SPE : H F 0.95 : HF 6-31G**", 17),    # fewer MOs than AOs, as W = U^T C
])
def test_pair_packed_to_mo_matches_tuna_tpu(line, n_mo):
    _, jax_plan, plan, coords = _system(line)
    N = plan.n_basis
    n_mo = n_mo or N
    W = np.random.RandomState(7).randn(N, n_mo) / np.sqrt(N)
    G_pair = np.array(jax_plan.eri_pair_packed(jnp.asarray(coords)))
    pidx = np.asarray(plan.pair_index)
    expected = jax_motransform.pair_packed_to_mo(jnp.asarray(G_pair), jnp.asarray(pidx),
                                                 jnp.asarray(W), n_mo)
    pair_index = torch.as_tensor(pidx, dtype=torch.int64)
    got = motransform.pair_packed_to_mo(torch.as_tensor(G_pair), pair_index,
                                        torch.as_tensor(W), n_mo)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        motransform.expand_mo_chemists(got, n_mo).numpy(),
        np.asarray(jax_motransform.expand_mo_chemists(expected, n_mo)), rtol=0, atol=1e-12)
    chunked = motransform.pair_packed_to_mo(torch.as_tensor(G_pair), pair_index,
                                            torch.as_tensor(W), n_mo, row_chunk=7)
    np.testing.assert_allclose(chunked.numpy(), got.numpy(), rtol=0, atol=1e-12)


def test_mixed_transform_matches_tuna_tpu():
    _, jax_plan, plan, coords = _system("SPE : N N 1.1 : HF STO-3G")
    N = plan.n_basis
    rng = np.random.RandomState(23)
    Wa, Wb = rng.randn(N, N) / np.sqrt(N), rng.randn(N, N) / np.sqrt(N)
    G_pair = np.array(jax_plan.eri_pair_packed(jnp.asarray(coords)))
    pidx = np.asarray(plan.pair_index)
    expected = jax_motransform.pair_packed_to_mo_mixed(
        jnp.asarray(G_pair), jnp.asarray(pidx), jnp.asarray(Wa), jnp.asarray(Wb), N)
    got = motransform.pair_packed_to_mo_mixed(
        torch.as_tensor(G_pair), torch.as_tensor(pidx, dtype=torch.int64),
        torch.as_tensor(Wa), torch.as_tensor(Wb), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-12)
    dense = np.einsum("ijkl,ir,js,kp,lq->rspq", np.asarray(jax_plan.eri(jnp.asarray(coords))),
                      Wa, Wa, Wb, Wb, optimize=True)
    np.testing.assert_allclose(motransform.expand_mo_chemists(got, N).numpy(), dense,
                               rtol=0, atol=1e-12)


def test_direct_kernels_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; a device with
    no kernel raises instead of falling back."""
    _, _, plan, coords = _system("SPE : H H 0.74 : HF STO-3G")
    coords = torch.as_tensor(coords)
    P = torch.eye(plan.n_basis, dtype=torch.float64)
    W = torch.eye(plan.n_basis, dtype=torch.float64)
    pair_index = torch.as_tensor(plan.pair_index, dtype=torch.int64)
    _kernels.reset_launch_counts()
    plan.fock_direct(coords, P)
    G = motransform.pair_packed_to_mo(plan.eri_pair_packed(coords), pair_index, W,
                                      plan.n_basis)
    assert G.shape == (3, 3)
    assert all(count == 0 for count in _kernels.launches.values())
    with pytest.raises(ValueError):
        plan.fock_direct(coords.to("meta"), P.to("meta"))
    with pytest.raises(ValueError):
        motransform.half_transform(G.to("meta"), pair_index.to("meta"), W.to("meta"))


# --------------------------------------------------------------------------
# End to end
# --------------------------------------------------------------------------

def _iterations(printout):
    """(SCF cycles, CC iterations) from a calculation's printout."""
    scf = re.findall(r"converged in (\d+) cycles", printout)
    table = printout.split("Step          Correlation E")[-1].split("Singles contribution")[0]
    cc = len(re.findall(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", table, re.M))
    return int(scf[-1]), cc if "Correlation E" in printout else 0


def _run_printed(runner, line, **kwargs):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        scf, _, energy, _ = runner(line, **kwargs)
    return scf, energy, _iterations(printed.getvalue()), printed.getvalue()


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : HF CC-PVDZ : DIRECT TIGHTSCF",
    "SPE : N N 1.1 : CCSD[T] 6-31G : DIRECT TIGHTSCF",
])
def test_direct_energy_matches_tuna_tpu(line):
    _, jax_energy, jax_iterations, _ = _run_printed(jax_run, line)
    _kernels.reset_launch_counts()
    scf, energy, iterations, printout = _run_printed(run, line, device="cpu")
    assert all(count == 0 for count in _kernels.launches.values())
    assert scf.integrals.ERI_AO is None
    assert "Two-electron integrals deferred (integral-direct SCF)." in printout
    assert abs(energy - jax_energy) <= 1e-10
    assert iterations == jax_iterations
    assert len(scf.iteration_seconds) == iterations[0]
    assert len(scf.correlation_iteration_seconds) == iterations[1]
    stored, stored_energy, stored_iterations, _ = _run_printed(
        run, line.replace("DIRECT ", ""), device="cpu")
    assert stored.integrals.ERI_AO is not None
    assert abs(energy - stored_energy) <= 1e-10
    assert stored_iterations == iterations


def test_direct_refusals_match_tuna_tpu():
    """DFT is refused with tuna_tpu's own text; unrestricted SCF, which
    tuna_tpu serves under DIRECT, is refused by the port's refusal of
    unrestricted SCF."""
    line = "SPE : N N 1.1 : B3LYP 6-31G : DIRECT"
    with pytest.raises(JaxTunaError) as expected:
        jax_run(line, suppress_output=True)
    with pytest.raises(TunaError) as got:
        run(line, suppress_output=True, device="cpu")
    assert str(got.value) == str(expected.value)
    assert '"DIRECT" (integral-direct) keyword supports' in str(got.value)
    with pytest.raises(TunaError, match="Unrestricted SCF is not yet ported"):
        run("SPE : H H 0.74 : UHF STO-3G : DIRECT", suppress_output=True, device="cpu")

"""The port's UHF SCF, spin-orbital transforms, unrestricted CC/CI and
spin-orbital (T) against tuna_tpu.

Residuals, transforms and (T) take identical seeded numpy inputs in both
packages and agree to 1e-12 relative (the same float64 contractions,
summed in another order).  End to end, at TIGHTSCF: SCF energies to
1e-10 Ha with equal SCF iteration counts, stored and DIRECT; total energies
to 1e-10 Ha with CC iteration counts within one (the DIIS loop is mirrored,
but the two eigensolvers may pick other bases of degenerate pi orbitals).
"""

import contextlib
import functools
import io
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
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.post import cc, transforms

torch.set_num_threads(2)

NO, NV = 4, 6


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _relative_error(got, expected):
    return np.max(np.abs(got - expected)) / np.max(np.abs(expected))


def _symmetric_chemists(rng, n, scale=0.05):
    """Random (pq|rs) with the 8-fold symmetry of real orbitals, exactly."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    return scale * (chem + chem.transpose(2, 3, 0, 1))


def _antisymmetrised(rng, n):
    """<pq||rs> from a random symmetric (pq|rs): exactly antisymmetric in
    (pq) and in (rs)."""
    physicists = _symmetric_chemists(rng, n).transpose(0, 2, 1, 3)
    return physicists - physicists.transpose(0, 1, 3, 2)


def _antisymmetric_pairs(x):
    """x antisymmetrised in its first and in its last two axes."""
    x = x - x.swapaxes(0, 1)
    return x - x.swapaxes(2, 3)


def _so_inputs(seed, no=NO, nv=NV):
    rng = np.random.default_rng(seed)
    n = no + nv
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, no)),
                          np.sort(rng.uniform(0.2, 3.0, nv))])
    F = np.diag(eps) + 0.01 * _symmetric_chemists(rng, n)[0, 0]
    return {
        "g": _antisymmetrised(rng, n), "eps": eps, "F": F,
        "t1": 0.02 * rng.standard_normal((no, nv)),
        "t2": 0.05 * _antisymmetric_pairs(rng.standard_normal((no, no, nv, nv))),
    }


# ---------------------------------------------------------------------------
# Spin-orbital transforms
# ---------------------------------------------------------------------------

def test_ao_to_so_physicists_matches_tuna_tpu():
    rng = np.random.default_rng(21)
    N = 4
    ERI = _symmetric_chemists(rng, N)
    C_a, C_b = rng.standard_normal((N, N)), rng.standard_normal((N, N))
    eps_combined = rng.uniform(-2.0, 2.0, 2 * N)

    C_ref = jax_transforms.spin_block_orbitals(C_a, C_b, eps_combined)
    block_ref = jax_transforms.spin_block_eri(jnp.asarray(ERI))
    expected = jax_transforms.antisymmetrise(
        jax_transforms.ao_to_so_physicists(block_ref, C_ref, C_ref))

    C = transforms.spin_block_orbitals(_t(C_a), _t(C_b), eps_combined)
    block = transforms.spin_block_eri(_t(ERI))
    assert np.array_equal(C.numpy(), np.asarray(C_ref))
    assert np.array_equal(block.numpy(), np.asarray(block_ref))
    got = transforms.antisymmetrise(transforms.ao_to_so_physicists(block, C, C))
    assert _relative_error(got.numpy(), np.asarray(expected)) <= 1e-12

    H = _symmetric_chemists(rng, N)[0, 0]
    H_so = transforms.transform_matrix_ao_to_so(transforms.spin_block_matrix(_t(H)), C)
    H_so_ref = jax_transforms.transform_matrix_ao_to_so(
        jax_transforms.spin_block_matrix(jnp.asarray(H)), C_ref)
    assert _relative_error(H_so.numpy(), np.asarray(H_so_ref)) <= 1e-12
    F = transforms.spin_orbital_fock(H_so, got, slice(0, 3))
    F_ref = jax_transforms.spin_orbital_fock(H_so_ref, expected, slice(0, 3))
    assert _relative_error(F.numpy(), np.asarray(F_ref)) <= 1e-12


def test_assemble_so_physicists_matches_tuna_tpu():
    rng = np.random.default_rng(22)
    n = 4
    blocks = [_symmetric_chemists(rng, n) for _ in range(3)]
    order = np.argsort(rng.uniform(-2.0, 2.0, 2 * n))
    is_alpha = order < n
    sp = np.where(is_alpha, order, order - n)
    expected = jax_transforms._assemble_so_physicists(
        *(jnp.asarray(b) for b in blocks), jnp.asarray(is_alpha), jnp.asarray(sp))
    got = transforms._assemble_so_physicists(*(_t(b) for b in blocks), is_alpha, sp)
    assert np.array_equal(got.numpy(), np.asarray(expected))


@functools.lru_cache(maxsize=None)
def _port_scf(line):
    return run(line, suppress_output=True, device="cpu")


def test_direct_so_integrals_match_stored():
    """transform_direct_so_physicists (packed pair matrix, alpha, beta and
    mixed blocks) against the spin-blocked stored tensor's transform, on
    converged O2 triplet UHF/6-31G orbitals."""
    SCF_output, molecule, _, _ = _port_scf("SPE : O O 1.21 : UHF 6-31G : ML 3 TIGHTSCF")
    C = transforms.spin_block_orbitals(SCF_output.molecular_orbitals_alpha,
                                       SCF_output.molecular_orbitals_beta,
                                       SCF_output.epsilons_combined)
    stored = transforms.ao_to_so_physicists(
        transforms.spin_block_eri(SCF_output.integrals.ERI_AO), C, C)
    direct = transforms.transform_direct_so_physicists(molecule, SCF_output,
                                                        molecule.calculation)
    assert direct.shape == (2 * molecule.n_basis,) * 4
    assert float(torch.max(torch.abs(direct - stored))) <= 1e-12


# ---------------------------------------------------------------------------
# Unrestricted residuals and (T)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["LCCD", "CCD", "LCCSD", "CID", "CISD", "QCISD", "CCSD"])
def test_unrestricted_residual_matches_tuna_tpu(method):
    x = _so_inputs(31)
    o, v = slice(0, NO), slice(NO, None)
    eps = x["eps"]
    d1 = 1.0 / (eps[o, None] - eps[None, v])
    d2 = 1.0 / (eps[o, None, None, None] + eps[None, o, None, None]
                - eps[None, None, v, None] - eps[None, None, None, v])

    jax_blocks = jax_cc._unrestricted_blocks(jnp.asarray(x["g"]), o, v)
    expected = jax_cc._UNRESTRICTED_UPDATES[method](
        jax_blocks, jnp.asarray(x["F"]), o, v, jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(x["t1"]), jnp.asarray(x["t2"]), {})

    blocks = cc._unrestricted_blocks(_t(x["g"]), o, v)
    got = cc._UNRESTRICTED_UPDATES[method](blocks, _t(x["F"]), o, v, _t(d1), _t(d2),
                                           _t(x["t1"]), _t(x["t2"]))
    for g, e in zip(got, expected):
        assert _relative_error(g.numpy(), np.asarray(e)) <= 1e-12

    F_ov = x["F"][o, v]
    E = cc._unrestricted_energy(blocks, _t(F_ov), got[0], got[1], True)[0]
    E_ref = jax_cc._unrestricted_energy(jax_blocks, jnp.asarray(F_ov), expected[0],
                                        expected[1], True)[0]
    assert abs(float(E) - float(E_ref)) <= 1e-12 * abs(float(E_ref))


def _uccsd_t_reference(x, o, v, v_scale):
    g = jnp.asarray(x["g"])
    e_ijkabc = jax_transforms.triples_epsilons(jnp.asarray(x["eps"]), o, v)
    E, t_c, t_d = jax_cc._unrestricted_T_tensors(
        g[o, o, v, v], g[v, o, v, v], g[o, v, o, o], jnp.asarray(x["t1"]),
        jnp.asarray(x["t2"]), e_ijkabc)
    if v_scale != 1.0:
        E = (1.0 / 36.0) * jnp.sum(t_c / e_ijkabc * (t_c + v_scale * t_d))
    return float(E)


def _uccsd_t_args(x, o, v):
    g = x["g"]
    return (_t(g[o, o, v, v]), _t(g[v, o, v, v]), _t(g[o, v, o, o]), _t(x["t1"]),
            _t(x["t2"]), _t(x["eps"][o]), _t(x["eps"][v]))


@pytest.mark.parametrize("no, nv", [(3, 3), (4, 6), (5, 7)])
@pytest.mark.parametrize("v_scale", [1.0, 2.0])
def test_uccsd_t_plain_matches_tuna_tpu(no, nv, v_scale):
    """K2u's plain version, a sum over i < j < k and a < b < c only, against
    tuna_tpu's sum over all o^3 v^3 ordered terms / 36."""
    x = _so_inputs(40 + no + nv, no, nv)
    o, v = slice(0, no), slice(no, None)
    expected = _uccsd_t_reference(x, o, v, v_scale)
    _kernels.reset_launch_counts()
    got = float(cc.uccsd_t_energy(*_uccsd_t_args(x, o, v), v_scale))
    assert _kernels.launches["uccsd_t_energy"] == 0
    assert abs(got - expected) <= 1e-12 * abs(expected)


def test_uccsd_t_plain_blocks_and_small_shapes(monkeypatch):
    """The plain version over one block and over blocks of one triple; zero
    without a unique occupied or virtual triple."""
    x = _so_inputs(50, 6, 5)
    o, v = slice(0, 6), slice(6, None)
    args = _uccsd_t_args(x, o, v)
    whole = float(cc._uccsd_t_energy_plain(*args))
    monkeypatch.setattr(cc, "U_TRIPLES_WORKSPACE_BYTES", 1)
    assert abs(float(cc._uccsd_t_energy_plain(*args)) - whole) <= 1e-13 * abs(whole)
    for no, nv in ((2, 5), (5, 2)):
        y = _so_inputs(51, no, nv)
        assert float(cc._uccsd_t_energy_plain(*_uccsd_t_args(
            y, slice(0, no), slice(no, None)))) == 0.0


@pytest.mark.parametrize("reference", ["UHF", "RHF"])
@pytest.mark.parametrize("n_print", [1, 12, 400])
def test_largest_amplitudes_print_matches_tuna_tpu(reference, n_print, capsys):
    """The amplitude printout on seeded antisymmetric amplitudes (each |t2|
    four times over, some below the 1e-6 print cut), for UHF with
    spin-mixed labels: the port makes each row only as it walks the sorted
    amplitudes, until it has n_print rows."""
    from types import SimpleNamespace

    rng = np.random.default_rng(61)
    no, nv = 6, 10
    t1 = 0.01 * rng.standard_normal((no, nv))
    t2 = 0.05 * _antisymmetric_pairs(rng.standard_normal((no, no, nv, nv)))
    t2[np.abs(t2) < 0.02] *= 1e-5
    labels = ([f"{k // 2 + 1}{'ab'[(k * 7) % 3 % 2]}" for k in range(no + nv)]
              if reference == "UHF" else None)
    calculation = SimpleNamespace(reference=reference, print_n_amplitudes=n_print,
                                  print_level=2)
    capsys.readouterr()
    jax_cc.print_largest_amplitudes(jnp.asarray(t1), jnp.asarray(t2), no, calculation, labels,
                                    False)
    expected = capsys.readouterr().out
    cc.print_largest_amplitudes(_t(t1), _t(t2), no, calculation, labels, False)
    assert capsys.readouterr().out == expected
    assert expected.count("->") > 0


@pytest.mark.parametrize("no, nv, cap", [(3, 4, 1), (6, 5, 8 * 5 * 10 * 4),
                                         (16, 36, cc.U_TRIPLES_WORKSPACE_BYTES),
                                         (16, 104, cc.U_TRIPLES_WORKSPACE_BYTES)])
def test_u_triples_plan_covers_every_triple_once(no, nv, cap):
    """The batches cover the unique triples in order, each within the cap
    (or one triple); the tables of triples, pairs and orbits."""
    batches = cc.u_triples_plan(no, nv, cap)
    n_triples = no * (no - 1) * (no - 2) // 6
    assert batches[0, 0] == 0 and batches[-1, 1] == n_triples
    assert np.array_equal(batches[1:, 0], batches[:-1, 1])
    slot_bytes = 8 * nv * nv * (nv - 1) // 2
    assert np.all(((batches[:, 1] - batches[:, 0]) * slot_bytes <= cap)
                  | (batches[:, 1] - batches[:, 0] == 1))
    triples = cc.unique_triples(no)
    assert [tuple(t) for t in triples.tolist()] == [
        (i, j, k) for i in range(no) for j in range(i + 1, no) for k in range(j + 1, no)]


# ---------------------------------------------------------------------------
# End to end against tuna_tpu
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tuna_tpu(line):
    """tuna_tpu's (SCF_output, total energy, SCF iterations, CC iterations)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        SCF_output, _, energy, _ = jax_run(line)
    text = out.getvalue()
    scf_cycles = int(re.findall(r"converged in (\d+) cycles", text)[-1])
    table = text.split("Step          Correlation E")[-1].split("Singles contribution")[0]
    cc_rows = re.findall(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", table, re.M)
    return SCF_output, energy, scf_cycles, len(cc_rows) if "Singles" in text else 0


@pytest.mark.parametrize("direct", [False, True], ids=["stored", "direct"])
@pytest.mark.parametrize("line", [
    "SPE : O O 1.21 : UHF 6-31G : ML 3 TIGHTSCF",
    "SPE : LI H 1.6 : UHF 6-31G : CH 1 ML 2 TIGHTSCF",
    "SPE : H H 2.0 : UHF 6-31G : TIGHTSCF",   # singlet UHF from the rotated guess
])
def test_uhf_scf_matches_tuna_tpu(line, direct):
    jax_scf, jax_energy, jax_cycles, _ = _tuna_tpu(line)
    scf, molecule, energy, P = _port_scf(line.replace("TIGHTSCF", "DIRECT TIGHTSCF")
                                         if direct else line)
    assert (scf.integrals.ERI_AO is None) == direct
    assert abs(energy - jax_energy) <= 1e-10
    assert len(scf.iteration_seconds) == jax_cycles
    spins = ("alpha", "beta")
    # A singlet's broken-symmetry solution has a mirror image with alpha and
    # beta swapped, of the same energy; the rotated guess mixes the HOMO and
    # LUMO, whose signs the two eigensolvers may pick differently.
    swapped = (molecule.n_alpha == molecule.n_beta and np.max(np.abs(
        scf.P_alpha.numpy() - np.asarray(jax_scf.P_beta))) < 1e-6)
    for spin, spin_ref in zip(spins, spins[::-1] if swapped else spins):
        np.testing.assert_allclose(getattr(scf, f"epsilons_{spin}").numpy(),
                                   np.asarray(getattr(jax_scf, f"epsilons_{spin_ref}")),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(getattr(scf, f"P_{spin}").numpy(),
                                   np.asarray(getattr(jax_scf, f"P_{spin_ref}")),
                                   rtol=0, atol=1e-8)
    np.testing.assert_allclose(scf.epsilons.numpy(), np.asarray(jax_scf.epsilons), rtol=0,
                               atol=1e-9)
    assert abs(float(torch.trace(P @ scf.S)) - molecule.n_electrons) <= 1e-10


@pytest.mark.parametrize("line", [
    "SPE : LI H 1.6 : UCCSD[T] STO-3G : CH 1 ML 2 TIGHTSCF",
    "SPE : O O 1.21 : CCSD(T) STO-3G : ML 3 TIGHTSCF",
    "SPE : LI H 1.6 : UCCSD 6-31G : CH 1 ML 2 DIRECT TIGHTSCF",
    "SPE : O O 1.21 : QCISD(T) STO-3G : ML 3 TIGHTSCF",
])
def test_unrestricted_cc_matches_tuna_tpu(line):
    jax_scf, jax_energy, jax_cycles, jax_cc_iterations = _tuna_tpu(line)
    scf, _, energy, P = run(line, suppress_output=True, device="cpu")
    assert abs(scf.energy - jax_scf.energy) <= 1e-10
    assert len(scf.iteration_seconds) == jax_cycles
    assert abs(energy - jax_energy) <= 1e-10
    assert jax_cc_iterations > 0
    assert abs(len(scf.correlation_iteration_seconds) - jax_cc_iterations) <= 1
    assert bool(torch.all(torch.isfinite(P)))


@pytest.mark.slow
def test_o2_triplet_ccsd_t_6311g_matches_tuna_tpu():
    """Config A of the UHF path, stored."""
    test_unrestricted_cc_matches_tuna_tpu("SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 TIGHTSCF")


# ---------------------------------------------------------------------------
# What stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("calculation", ["OPT", "FORCE", "FREQ", "OPTFREQ", "MD"])
def test_unrestricted_gradients_raise(calculation):
    """tuna_tpu differentiates UHF analytically; the port refuses rather
    than take finite differences."""
    extra = " : NUM 2 NOTRAJ" if calculation == "MD" else ""
    with pytest.raises(TunaError, match="Unrestricted analytic gradients are not yet ported"):
        run(f"{calculation} : H H 0.74 : UHF STO-3G{extra}", suppress_output=True,
            device="cpu")


@pytest.mark.parametrize("line", [
    "SPE : O O 1.21 : B3LYP STO-3G : ML 3",        # unrestricted Kohn-Sham
    "SPE : O O 1.21 : UHF STO-3G : ML 3 NATORBS",
    "SPE : O O 1.21 : CCSD STO-3G : ML 3 NATORBS",
])
def test_unported_unrestricted_options_raise(line):
    with pytest.raises(TunaError, match="not yet ported"):
        run(line, suppress_output=True, device="cpu")

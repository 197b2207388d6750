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

from ported_lines import RELAXED_DH, assert_line_matches_tuna_tpu
from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.constants import angstrom_to_bohr
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


def _stage_a_emulated(args, i, j, k):
    """K2u's stage A for the triple i < j < k in NumPy, on the layouts its
    wrapper hands over: X[a, pair] = sum over the depth 3 (v + o) of the
    left operand [t2[p, q, a, :] | <m a || p q> at [p][q][a][m]], signed
    per ordering and part as the kernel signs its A fragments, times the
    right operand read through u_triples_pair_offsets."""
    g_vovv, g_ovoo, t2 = args[1].numpy(), args[2], args[4].numpy()
    no, nv = t2.shape[0], t2.shape[2]
    ovoo_t = cc.u_triples_ovoo_transposed(g_ovoo).numpy()
    offsets = cc.u_triples_pair_offsets(nv)
    assert ovoo_t.shape == (no, no, nv, no) and ovoo_t.flags["C_CONTIGUOUS"]
    left, right = [], []
    for s, (r, p, q) in enumerate(((i, j, k), (j, i, k), (k, j, i))):
        sign = 1.0 if s == 0 else -1.0
        left.append(np.concatenate([sign * t2[p, q], -sign * ovoo_t[p, q]], axis=1))
        right.append(np.concatenate([g_vovv[:, r].reshape(nv, nv * nv)[:, offsets],
                                     t2[r].reshape(no, nv * nv)[:, offsets]], axis=0))
    return np.concatenate(left, axis=1) @ np.concatenate(right, axis=0)


@pytest.mark.parametrize("no, nv", [(3, 3), (4, 6), (5, 7)])
def test_u_triples_stage_a_layouts_match_tuna_tpu(no, nv):
    """K2u's host tables (the pair offsets, b v + c in the row-major order of
    pairs b < c, and <ov||oo> transposed to [p][q][a][m]) emulated with
    stage A in NumPy: A(conn) = X[a, bc] - X[b, ac] + X[c, ab], as stage B
    reads it, is tuna_tpu's connected triples at every i < j < k, a < b <
    c."""
    x = _so_inputs(70 + no + nv, no, nv)
    o, v = slice(0, no), slice(no, None)
    g = jnp.asarray(x["g"])
    e_ijkabc = jax_transforms.triples_epsilons(jnp.asarray(x["eps"]), o, v)
    _, t_c, _ = jax_cc._unrestricted_T_tensors(
        g[o, o, v, v], g[v, o, v, v], g[o, v, o, o], jnp.asarray(x["t1"]),
        jnp.asarray(x["t2"]), e_ijkabc)
    connected = np.asarray(t_c) / np.asarray(e_ijkabc)
    offsets = cc.u_triples_pair_offsets(nv)
    b, c = np.triu_indices(nv, 1)
    assert np.array_equal(offsets, b * nv + c) and offsets.dtype == np.int32
    pair = {(y, z): n for n, (y, z) in enumerate(zip(b.tolist(), c.tolist()))}
    args = _uccsd_t_args(x, o, v)
    for i, j, k in cc.unique_triples(no).tolist():
        X = _stage_a_emulated(args, i, j, k)
        for a, b_, c_ in cc.unique_triples(nv).tolist():
            got = X[a, pair[b_, c_]] - X[b_, pair[a, c_]] + X[c_, pair[a, b_]]
            expected = connected[i, j, k, a, b_, c_]
            assert abs(got - expected) <= 1e-12 * np.max(np.abs(connected))


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
    assert len(scf.correlation_iteration_seconds) == jax_cc_iterations
    assert bool(torch.all(torch.isfinite(P)))


@pytest.mark.slow
def test_o2_triplet_ccsd_t_6311g_matches_tuna_tpu():
    """Config A of the UHF path, stored."""
    test_unrestricted_cc_matches_tuna_tpu("SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 TIGHTSCF")


# ---------------------------------------------------------------------------
# What stays refused
# ---------------------------------------------------------------------------

def _run_printed(line):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = run(line, device="cpu")
    return result, printed.getvalue()


# tuna_tpu's numbers for each calculation type on the doublet OH, printed by
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(run("<CALC> : O H 0.97 : HF STO-3G"))'
# (OPT: molecule.bond_length in bohr and the energy; FREQ and OPTFREQ:
# force constant, reduced mass, frequency per cm, zero-point energy; MD
# with NUM 3 NOTRAJ: the step energies) and the "Gradient" rows of the
# convergence tables of its printout.
UHF_GRADIENT_REFERENCE = {
    "OPT": ((1.9160679137046703, -74.36488571400076),
            ["-0.05566024", "0.05838697", "0.00849177", "-0.00166076", "0.00003605"]),
    "FORCE": (None, ["-0.05566024"]),
    "FREQ": ((0.7546314606310833, 1728.2567084595278, 4586.1436735980615,
              0.010448004047488108), []),
    "OPTFREQ": ((0.5929258363634782, 1728.2567084595278, 4065.1857075299044,
                 0.009261174474444881),
                ["-0.05566024", "0.05838697", "0.00849177", "-0.00166076", "0.00003605",
                 "0.00000015"]),
    "MD": ((-74.36266922178697, -74.36268451191212, -74.36272992726789), []),
}


@pytest.mark.parametrize("calculation", ["OPT", "FORCE", "FREQ", "OPTFREQ", "MD"])
def test_unrestricted_gradients_raise(calculation):
    """The UHF gradient, which tuna_tpu takes analytically and the port once
    refused (the test keeps the name it had then; it now checks that each
    driver runs), through each driver on the doublet OH against tuna_tpu's
    numbers: bond length 1e-6 angstrom, energies 1e-8 Ha, frequency 0.01
    per cm, force constant and zero-point energy 1e-8, its printed
    gradients and the OPT iteration count."""
    extra = " : NUM 3 NOTRAJ" if calculation == "MD" else ""
    expected, gradients_printed = UHF_GRADIENT_REFERENCE[calculation]
    _kernels.reset_launch_counts()
    result, printed = _run_printed(f"{calculation} : O H 0.97 : HF STO-3G{extra}")
    assert all(count == 0 for count in _kernels.launches.values())
    assert re.findall(r"Gradient\s+(-?\d+\.\d+)", printed) == gradients_printed
    if calculation == "OPT":
        molecule, energy = result
        assert abs(molecule.bond_length - expected[0]) <= angstrom_to_bohr(1e-6)
        assert abs(energy - expected[1]) <= 1e-8
        assert "Optimisation converged in 5 iterations!" in printed
    elif calculation in ("FREQ", "OPTFREQ"):
        hessian, reduced_mass, frequency, zpe = result
        assert abs(hessian - expected[0]) <= 1e-8
        assert reduced_mass == expected[1]
        assert abs(frequency - expected[2]) <= 0.01
        assert abs(zpe - expected[3]) <= 1e-8
    elif calculation == "MD":
        assert len(result) == len(expected)
        assert max(abs(e - r) for e, r in zip(result, expected)) <= 1e-8
    else:
        assert result is None
    if calculation != "MD":
        assert "Calculating analytic gradient" in printed


@pytest.mark.parametrize("line", [
    # the relaxed density of an unrestricted meta-GGA double hybrid
    "SPE : O O 1.21 : R2SCAN0-DH STO-3G : ML 3 RELAXED",
    "SPE : O O 1.21 : UHF STO-3G : ML 3 STAB",
    "SPE : O O 1.21 : CCSD STO-3G : ML 3 TD",
])
def test_unported_unrestricted_options_raise(line):
    """Once refused as not ported: each line runs, or is refused, as in
    tuna_tpu."""
    assert_line_matches_tuna_tpu(line, refusal=RELAXED_DH if "RELAXED" in line else None)

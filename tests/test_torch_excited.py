"""The port's excited states, SCF stability and TD-DFT XC kernels against
tuna_tpu.

Units take identical seeded numpy inputs in both packages and agree to
1e-12 relative: the response builders of post/rpa.py (both channels, with
and without an XC kernel) and its solvers, the LDA kernels f_xc by nested
autodiff (jax's forward-over-reverse, torch's reverse-over-reverse), the
MO kernel matrices (the port's chunked over the grid), the CIS(D) pieces
and the relaxed MP2 density with a Kohn-Sham kernel.  End to end, the same
CLI line runs through tuna_tpu.cli.run and tuna_tpu_torch.cli.run(...,
device="cpu"): the state's total energy and every excitation energy within
1e-10 Ha, equal SCF cycles, oscillator strengths within 1e-8, the (D)
correction within 1e-10 Ha, the stability eigenvalues within 1e-10; and
every refusal in tuna_tpu's words.
"""

import contextlib
import io
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tuna_tpu.cli import run as jax_run
from tuna_tpu.dft import kernels as jax_kernels
from tuna_tpu.post import excited as jax_excited
from tuna_tpu.post import mp as jax_mp
from tuna_tpu.post import rpa as jax_rpa
from tuna_tpu.post import transforms as jax_transforms

from mp_lines import as_tensor, relative_error
from ported_lines import RELAXED_DH, assert_line_matches_tuna_tpu
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.containers import to_numpy
from tuna_tpu_torch.dft import kernels
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.post import excited, mp, rpa

torch.set_num_threads(2)

NO, NV = 3, 5
UNIT_TOLERANCE = 1e-12
ENERGY_TOLERANCE = 1e-10       # Ha
STRENGTH_TOLERANCE = 1e-8


def _symmetric_chemists(rng, n, scale=0.05):
    """Random (pq|rs) with the 8-fold symmetry of real orbitals, exactly."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    return scale * (chem + chem.transpose(2, 3, 0, 1))


def _epsilons(rng, no=NO, nv=NV):
    return np.concatenate([np.sort(rng.uniform(-2.0, -0.3, no)),
                           np.sort(rng.uniform(0.2, 3.0, nv))])


def _kernel_block(rng, no=NO, nv=NV, scale=0.02):
    K = rng.standard_normal((no, nv, no, nv))
    return scale * (K + K.transpose(2, 3, 0, 1))


# ---------------------------------------------------------------------------
# Response builders and solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, channel, with_kernel", [
    (name, channel, with_kernel)
    for name in ("restricted_apb", "restricted_tda_matrix")
    for channel in ("singlet", "triplet")
    for with_kernel in (False, True)] + [("restricted_amb", None, False)])
def test_restricted_builders_match_tuna_tpu(name, channel, with_kernel):
    rng = np.random.default_rng(21)
    g, eps = _symmetric_chemists(rng, NO + NV), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    args = (o, v, 0.7)
    if channel is None:
        got = getattr(rpa, name)(as_tensor(g), as_tensor(eps), *args)
        expected = getattr(jax_rpa, name)(g, jnp.asarray(eps), *args)
    else:
        K = _kernel_block(rng) if with_kernel else None
        got = getattr(rpa, name)(as_tensor(g), as_tensor(eps), *args, channel,
                                 None if K is None else as_tensor(K))
        expected = getattr(jax_rpa, name)(g, jnp.asarray(eps), *args, channel, K)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


@pytest.mark.parametrize("name, with_kernel", [
    ("spin_orbital_apb", False), ("spin_orbital_apb", True),
    ("spin_orbital_tda_matrix", False), ("spin_orbital_tda_matrix", True),
    ("spin_orbital_amb", False)])
def test_spin_orbital_builders_match_tuna_tpu(name, with_kernel):
    rng = np.random.default_rng(22)
    n = NO + NV
    g = 0.05 * rng.standard_normal((n, n, n, n))
    g = g - 0.6 * g.transpose(0, 1, 3, 2)
    eps = _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    if name == "spin_orbital_amb":
        got = rpa.spin_orbital_amb(as_tensor(g), as_tensor(eps), o, v)
        expected = jax_rpa.spin_orbital_amb(g, jnp.asarray(eps), o, v)
        assert relative_error(got, expected) <= UNIT_TOLERANCE
        return
    K = _kernel_block(rng) if with_kernel else None
    got = getattr(rpa, name)(as_tensor(g), as_tensor(eps), o, v,
                             None if K is None else as_tensor(K))
    expected = getattr(jax_rpa, name)(g, jnp.asarray(eps), o, v, K)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


def _response_pair(rng, n=12):
    """A positive (A+B) and (A-B) with well separated eigenvalues."""
    def spd(shift):
        M = rng.standard_normal((n, n))
        return M @ M.T / n + np.diag(np.linspace(shift, shift + 2.0, n))
    return spd(0.5), spd(0.3)


def _same_columns(got, expected):
    """Eigenvectors up to each column's sign."""
    got, expected = np.asarray(to_numpy(got)), np.asarray(expected)
    signs = np.sign(np.sum(got * expected, axis=0))
    return np.max(np.abs(got * signs - expected)) / np.max(np.abs(expected))


def test_solvers_match_tuna_tpu():
    rng = np.random.default_rng(23)
    apb, amb = _response_pair(rng)
    w, V = rpa.tda_excitations(as_tensor(apb))
    jw, jV = jax_rpa.tda_excitations(jnp.asarray(apb))
    assert relative_error(w, jw) <= UNIT_TOLERANCE
    assert _same_columns(V, jV) <= UNIT_TOLERANCE

    w, V, amb_min, w2_min = rpa.rpa_excitations(as_tensor(apb), as_tensor(amb))
    jw, jV, jamb_min, jw2_min = jax_rpa.rpa_excitations(jnp.asarray(apb), jnp.asarray(amb))
    assert relative_error(w, jw) <= UNIT_TOLERANCE
    assert _same_columns(V, jV) <= UNIT_TOLERANCE
    assert relative_error(torch.stack([amb_min, w2_min]),
                          np.array([jamb_min, jw2_min])) <= UNIT_TOLERANCE

    for shift in (0.0, -0.7):   # stable, and unstable in (A-B)
        lowest = rpa.orbital_hessian_lowest(as_tensor(apb), as_tensor(amb + shift * np.eye(12)))
        expected = jax_rpa.orbital_hessian_lowest(jnp.asarray(apb),
                                                  jnp.asarray(amb + shift * np.eye(12)))
        assert abs(float(lowest) - float(expected)) <= UNIT_TOLERANCE * abs(float(expected))


# ---------------------------------------------------------------------------
# XC kernels
# ---------------------------------------------------------------------------

DENSITIES = np.logspace(-8, 2, 41)


@pytest.mark.parametrize("name", ["VWN3", "VWN5", "PW"])
def test_lda_kernels_match_tuna_tpu(name):
    n = DENSITIES
    spin_a = n * np.linspace(0.3, 0.7, n.size)
    spin_b = n - spin_a
    pairs = [
        (kernels.slater_exchange_kernel(as_tensor(n), 2 / 3),
         jax_kernels.slater_exchange_kernel(jnp.asarray(n), 2 / 3)),
        (kernels.correlation_density_kernel(name, as_tensor(n)),
         jax_kernels.correlation_density_kernel(name, jnp.asarray(n))),
        (kernels.correlation_spin_kernel(name, as_tensor(n)),
         jax_kernels.correlation_spin_kernel(name, jnp.asarray(n))),
    ]
    pairs += list(zip(kernels.unrestricted_correlation_kernel(name, as_tensor(spin_a),
                                                               as_tensor(spin_b)),
                      jax_kernels.unrestricted_correlation_kernel(name, jnp.asarray(spin_a),
                                                                  jnp.asarray(spin_b))))
    for got, expected in pairs:
        got, expected = got.numpy(), np.asarray(expected)
        assert np.all(np.abs(got - expected) <= UNIT_TOLERANCE * np.abs(expected))


def _kernel_calculation(c_name="VWN5", x_name="S"):
    functional = SimpleNamespace(x_name=x_name, c_name=c_name)
    return SimpleNamespace(functional=functional, X_alpha=2 / 3, DFX_prop=0.9, DFC_prop=0.8,
                           DFT_calculation=True)


def _grid_inputs(rng, n_basis=5, shape=(3, 40)):
    bfs = rng.standard_normal((n_basis, *shape)) * np.exp(-rng.uniform(0, 2, (1, *shape)))
    weights = rng.uniform(0.01, 0.2, shape)
    C = rng.standard_normal((n_basis, n_basis)) / np.sqrt(n_basis)
    return bfs, weights, C


@pytest.mark.parametrize("chunk_bytes", [None, 8 * 40], ids=["whole", "chunked"])
@pytest.mark.parametrize("c_name", ["VWN5", "PW"])
def test_restricted_kernel_matrices_match_tuna_tpu(c_name, chunk_bytes, monkeypatch):
    if chunk_bytes:
        monkeypatch.setattr(kernels, "ROW_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(24)
    bfs, weights, C = _grid_inputs(rng)
    P = C[:, :2] @ C[:, :2].T
    density = np.einsum("ij,ikl,jkl->kl", P, bfs, bfs)
    o, v = slice(0, 2), slice(2, None)
    calculation = _kernel_calculation(c_name)
    got = kernels.restricted_xc_kernel_matrices(o, v, as_tensor(density), as_tensor(bfs),
                                                as_tensor(C), calculation, as_tensor(weights),
                                                True)
    expected = jax_kernels.restricted_xc_kernel_matrices(o, v, density, bfs, C, calculation,
                                                         weights, True)
    for a, b in zip(got, expected):
        assert relative_error(a, b) <= UNIT_TOLERANCE


# The seeded spin densities reach zeta = 0.9996 (a beta density of 2e-7
# beside an alpha one of 8e-4), where the two packages' spin-resolved f_xc
# differ by up to 3e-13 relative (1 - zeta loses digits in both, and their
# evaluation orders differ); summed over the grid with cancellation that
# gives 2.6e-12 of the largest |K_XC|, measured.
SPIN_KERNEL_TOLERANCE = 5e-12


@pytest.mark.parametrize("chunk_bytes", [None, 8 * 400], ids=["whole", "chunked"])
def test_unrestricted_kernel_matrices_match_tuna_tpu(chunk_bytes, monkeypatch):
    if chunk_bytes:
        monkeypatch.setattr(kernels, "ROW_CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(25)
    n_basis = 4
    bfs, weights, _ = _grid_inputs(rng, n_basis)
    C_a = rng.standard_normal((n_basis, n_basis)) / 2
    C_b = rng.standard_normal((n_basis, n_basis)) / 2
    P_a, P_b = C_a[:, :2] @ C_a[:, :2].T, C_b[:, :1] @ C_b[:, :1].T
    eps = np.concatenate([np.sort(rng.uniform(-1, 1, n_basis)),
                          np.sort(rng.uniform(-1, 1, n_basis))])
    order = np.argsort(eps)
    C_sb = np.zeros((2 * n_basis, 2 * n_basis))
    C_sb[:n_basis, :n_basis], C_sb[n_basis:, n_basis:] = C_a, C_b
    C_sb = C_sb[:, order]
    labels = [(["a"] * n_basis + ["b"] * n_basis)[i] for i in order]
    o, v = slice(0, 3), slice(3, None)
    calculation = _kernel_calculation("VWN3")
    got_K, got_full = kernels.unrestricted_xc_kernel_matrices(
        o, v, as_tensor(P_a), as_tensor(P_b), as_tensor(bfs), as_tensor(C_sb), labels,
        calculation, as_tensor(weights), True, return_full_kernel=True)
    K, full = jax_kernels.unrestricted_xc_kernel_matrices(
        o, v, P_a, P_b, bfs, C_sb, labels, calculation, weights, True,
        return_full_kernel=True)
    assert relative_error(got_K, K) <= SPIN_KERNEL_TOLERANCE
    assert relative_error(got_full, full) <= SPIN_KERNEL_TOLERANCE
    got = kernels.unrestricted_xc_kernel_matrices(
        o, v, as_tensor(P_a), as_tensor(P_b), as_tensor(bfs), as_tensor(C_sb), labels,
        calculation, as_tensor(weights), True)
    expected = jax_kernels.unrestricted_xc_kernel_matrices(
        o, v, P_a, P_b, bfs, C_sb, labels, calculation, weights, True)
    assert relative_error(got, expected) <= SPIN_KERNEL_TOLERANCE


def test_non_lda_kernel_is_refused_in_tuna_tpu_words():
    calculation = _kernel_calculation("LYP", "B")
    with pytest.raises(TunaError) as got:
        kernels._check_td_functional(calculation)
    with pytest.raises(Exception) as expected:
        jax_kernels._check_td_functional(calculation)
    assert str(got.value) == str(expected.value)


# ---------------------------------------------------------------------------
# CIS(D) pieces and the Kohn-Sham relaxed density
# ---------------------------------------------------------------------------

def test_restricted_doubles_pieces_match_tuna_tpu():
    rng = np.random.default_rng(26)
    g, eps = _symmetric_chemists(rng, NO + NV), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    b = rng.standard_normal((NO, NV))
    e_ijab = np.asarray(jax_transforms.doubles_epsilons(jnp.asarray(eps), jnp.asarray(eps),
                                                        o, o, v, v))
    blocks = (g[v, v, v, o], g[v, o, v, v], g[o, o, v, o], g[o, v, o, v])
    got = excited._restricted_doubles_pieces(tuple(as_tensor(x) for x in blocks),
                                             as_tensor(b), as_tensor(e_ijab))
    expected = jax_excited._restricted_doubles_pieces(tuple(jnp.asarray(x) for x in blocks),
                                                      jnp.asarray(b), jnp.asarray(e_ijab))
    for a, e in zip(got, expected):
        assert relative_error(a, e) <= UNIT_TOLERANCE


def test_unrestricted_doubles_pieces_match_tuna_tpu():
    rng = np.random.default_rng(27)
    n = NO + NV
    g = 0.05 * rng.standard_normal((n, n, n, n))
    g = g - g.transpose(0, 1, 3, 2)
    eps = _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    b = rng.standard_normal((NO, NV))
    e_ijab = np.asarray(jax_transforms.doubles_epsilons(jnp.asarray(eps), jnp.asarray(eps),
                                                        o, o, v, v))
    blocks = (g[v, v, v, o], g[o, v, o, o], g[o, o, v, v])
    got = excited._unrestricted_doubles_pieces(*(as_tensor(x) for x in blocks), as_tensor(b),
                                               as_tensor(e_ijab))
    expected = jax_excited._unrestricted_doubles_pieces(
        *(jnp.asarray(x) for x in blocks), jnp.asarray(b), jnp.asarray(e_ijab))
    for a, e in zip(got, expected):
        assert relative_error(a, e) <= UNIT_TOLERANCE


def test_restricted_relaxed_density_with_kernel_matches_tuna_tpu():
    rng = np.random.default_rng(28)
    n = NO + NV
    g, eps = _symmetric_chemists(rng, n), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    w = 0.05 * rng.standard_normal((NO, NO, NV, NV))
    P = 0.01 * rng.standard_normal((n, n))
    P = P + P.T
    K = _kernel_block(rng)
    K_full = 0.02 * rng.standard_normal((NO, NV, n, n))
    K_full = K_full + K_full.transpose(0, 1, 3, 2)
    calculation = SimpleNamespace(HFX_prop=0.5)
    got = mp._restricted_relaxed_density(as_tensor(P), as_tensor(w), as_tensor(g),
                                         as_tensor(eps), o, v, NO, NV, calculation,
                                         as_tensor(K), as_tensor(K_full))
    expected = jax_mp._restricted_relaxed_density(P, w, g, eps, o, v, NO, NV, calculation,
                                                  K, K_full)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _patched(module, name, record, key, keep=lambda args, result: result):
    original = getattr(module, name)

    def recorded(*args, **kwargs):
        result = original(*args, **kwargs)
        record.setdefault(key, []).append(keep(args, result))
        return result

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, original)


def _host(x):
    return np.asarray(to_numpy(x), dtype=float)


def _line(runner, excited_module, rpa_module, line, **kwargs):
    """What the line returns and prints, with the absorption spectrum (every
    state's energy and oscillator strength), the (D) corrections and the
    stability Hessians' lowest eigenvalues that its run formed."""
    record: dict = {}
    printed = io.StringIO()
    spectrum = lambda args, result: (_host(args[1]), _host(args[4]))   # noqa: E731
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(excited_module, "print_absorption_spectrum", record,
                                     "spectrum", spectrum))
        for name in ("restricted_doubles_correction", "unrestricted_doubles_correction"):
            stack.enter_context(_patched(excited_module, name, record, "doubles"))
        stack.enter_context(_patched(rpa_module, "orbital_hessian_lowest", record, "lowest",
                                     lambda args, result: float(result)))
        stack.enter_context(contextlib.redirect_stdout(printed))
        result = runner(line, **kwargs)
    record["energy"] = float(result[2])
    record["cycles"] = re.findall(r"converged in (\d+) cycles", printed.getvalue())
    return record


EXCITED_LINES = [
    # tests/test_parity.py's three lines
    "SPE : H H 0.74 : CIS 6-31G : NSTATES 3 TIGHTSCF",
    "SPE : H H 0.74 : TDHF 6-31G : TIGHTSCF",
    "SPE : H H 0.74 : CIS[D] 6-31G : TIGHTSCF",
    "SPE : H H 0.74 : RPA 6-31G : TIGHTSCF",
    "SPE : H H 0.74 : CIS 6-31G : NOSINGLETS ROOT 2 TIGHTSCF",
    "SPE : H H 0.74 : HF 6-31G : TD TDA NOTRIPLETS TIGHTSCF",
    "SPE : H H 0.74 : SVWN 6-31G : TD TIGHTSCF",
    "SPE : H H 0.74 : SVWN 6-31G : TD TDA TIGHTSCF",
    "SPE : H H 0.74 : SPW 6-31G : TD TIGHTSCF",
    "SPE : H H 0.74 : SPW 6-31G : TD TDA ROOT 2 TIGHTSCF",
    "SPE : O H 0.97 : CIS(D) 6-31G : ML 2 TIGHTSCF",
    "SPE : O H 0.97 : UHF 6-31G : ML 2 TD TIGHTSCF",
    # UKS TD-LDA on triplet NH: tuna_tpu's SVWN of OH (ML 2) at 6-31G does
    # not converge in 100 cycles
    "SPE : N H 1.04 : SVWN 6-31G : ML 3 TD TIGHTSCF",
    "SPE : N H 1.04 : SVWN 6-31G : ML 3 TD TDA TIGHTSCF",
    # stability: stable, triplet-unstable (stretched), Kohn-Sham, UHF
    "SPE : H H 0.74 : HF 6-31G : STAB TIGHTSCF",
    "SPE : H H 2.5 : HF 6-31G : STAB TIGHTSCF",
    "SPE : H H 0.74 : SVWN 6-31G : STAB TIGHTSCF",
    "SPE : O H 0.97 : UHF 6-31G : ML 2 STAB TIGHTSCF",
    "SPE : N H 1.04 : SVWN 6-31G : ML 3 STAB TIGHTSCF",
]


@pytest.mark.parametrize("line", EXCITED_LINES)
def test_line_matches_tuna_tpu(line):
    expected = _line(jax_run, jax_excited, jax_rpa, line)
    got = _line(run, excited, rpa, line, device="cpu")
    assert abs(got["energy"] - expected["energy"]) <= ENERGY_TOLERANCE
    assert got["cycles"] == expected["cycles"]
    assert ("spectrum" in got) == ("spectrum" in expected)
    if "spectrum" in expected:
        (energies, strengths), = got["spectrum"]
        (jax_energies, jax_strengths), = expected["spectrum"]
        assert energies.shape == jax_energies.shape
        assert np.max(np.abs(energies - jax_energies)) <= ENERGY_TOLERANCE
        assert np.max(np.abs(strengths - jax_strengths)) <= STRENGTH_TOLERANCE
    assert len(got.get("doubles", [])) == len(expected.get("doubles", []))
    if "doubles" in expected:
        assert abs(got["doubles"][0] - float(expected["doubles"][0])) <= ENERGY_TOLERANCE
    assert len(got.get("lowest", [])) == len(expected.get("lowest", []))
    if "lowest" in expected:
        assert np.max(np.abs(np.subtract(got["lowest"], expected["lowest"]))) <= 1e-10


def test_triplet_instability_is_found():
    """H2 stretched to 2.5 angstrom: its RHF is unstable towards UHF (a
    negative triplet eigenvalue), at 0.74 angstrom it is stable."""
    stable = _line(run, excited, rpa, "SPE : H H 0.74 : HF 6-31G : STAB", device="cpu")
    stretched = _line(run, excited, rpa, "SPE : H H 2.5 : HF 6-31G : STAB", device="cpu")
    assert min(stable["lowest"]) > 0 and stretched["lowest"][1] < 0 < stretched["lowest"][0]


@pytest.mark.parametrize("line, refusal", [
    ("SPE : H H 0.74 : CIS 6-31G : NOSINGLETS NOTRIPLETS", None),
    ("SPE : H H 0.74 : B3LYP STO-3G : TD", None),
    ("SPE : H H 0.74 : MP2 6-31G : TD", None),
    ("SPE : H H 0.74 : CIS STO-3G : ROOT 5", None),
    ("SPE : H H 0.74 : B2PLYP STO-3G : RELAXED", RELAXED_DH),
])
def test_refusals_match_tuna_tpu(line, refusal):
    """Every error() of the excited-state driver and the Kohn-Sham relaxed
    density in tuna_tpu's words: no states to calculate, TD with a non-LDA
    functional, excited states after MP2, a root that does not exist, the
    relaxed density of a double hybrid."""
    expected, got = assert_line_matches_tuna_tpu(line, refusal=refusal)
    assert got["error"] is not None


def test_stability_returns_the_lowest_eigenvalues():
    """The port's stability analysis returns the eigenvalues it prints."""
    printed = io.StringIO()
    record: dict = {}
    with _patched(excited, "determine_self_consistent_field_stability", record, "lowest"), \
            contextlib.redirect_stdout(printed):
        run("SPE : H H 0.74 : HF 6-31G : STAB", device="cpu")
    singlet, triplet = record["lowest"][0]
    assert f"Lowest singlet eigenvalue:             {singlet:10.5f}" in printed.getvalue()
    assert f"Lowest triplet eigenvalue:             {triplet:10.5f}" in printed.getvalue()


@pytest.mark.parametrize("method", ["HF", "CCSD"])
def test_checkpoints_cross_between_packages(method, tmp_path, monkeypatch):
    """CHKPT writes the converged densities (and the CC amplitudes) under
    tuna_tpu's npz keys; READCHK in each package restarts from the file the
    other wrote, without the guess SCF, and takes as many SCF cycles as
    tuna_tpu does there.  The amplitudes are compared by their norms: the
    signs of degenerate virtual orbitals are the eigensolvers' choice."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    base = f"SPE : LI H 1.6 : {method} 6-31G : TIGHTSCF"
    jax_write = _line(jax_run, jax_excited, jax_rpa, f"{base} CHKPT JAX")
    write = _line(run, excited, rpa, f"{base} CHKPT PORT", device="cpu")
    assert abs(write["energy"] - jax_write["energy"]) <= ENERGY_TOLERANCE
    with np.load(tmp_path / "JAX.npz") as a, np.load(tmp_path / "PORT.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            if key.startswith("cc/t"):
                assert abs(np.linalg.norm(a[key]) - np.linalg.norm(b[key])) <= 1e-8, key
            else:
                assert np.max(np.abs(a[key] - b[key])) <= 1e-8, key
    jax_read = _line(jax_run, jax_excited, jax_rpa, f"{base} READCHK PORT")
    read = _line(run, excited, rpa, f"{base} READCHK JAX", device="cpu")
    assert abs(read["energy"] - jax_read["energy"]) <= ENERGY_TOLERANCE
    assert read["cycles"] == jax_read["cycles"] and len(read["cycles"]) == 1

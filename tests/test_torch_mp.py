"""The port's restricted Moller-Plesset perturbation theory against tuna_tpu.

Units (the linear algebra, the response matrices, the MP cores, the IMP2
residual, the relaxed density and the second-order triples) take
identical seeded numpy inputs in both packages and agree to 1e-12
relative: the same float64 contractions, summed in another order.  The
ones with contractions of three or more operands run with opt_einsum on
and off (the card's machine has no opt_einsum, where torch.einsum
contracts left to right).  End to end, the same CLI line runs through
tuna_tpu.cli.run and tuna_tpu_torch.cli.run(..., device="cpu"): total
energies and the MP2, MP3 and MP4 parts within 1e-10 Ha, equal SCF
cycles, natural occupancies within 1e-8.  tests/test_torch_mp_paths.py
holds the iterative, Laplace and relaxed MP2, DIRECT and OPT.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.ops import linalg as jax_linalg
from tuna_tpu.post import mp as jax_mp
from tuna_tpu.post import rpa as jax_rpa
from tuna_tpu.post import transforms as jax_transforms

from mp_lines import as_tensor, assert_lines_match, port_line, relative_error, tuna_tpu_line
from tuna_tpu_torch.ops import linalg
from tuna_tpu_torch.post import mp, rpa, transforms

torch.set_num_threads(2)

NO, NV = 3, 5
UNIT_TOLERANCE = 1e-12


def _symmetric_chemists(rng, n, scale=0.05):
    """Random (pq|rs) with the 8-fold symmetry of real orbitals, exactly."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    return scale * (chem + chem.transpose(2, 3, 0, 1))


def _epsilons(rng, no=NO, nv=NV):
    return np.concatenate([np.sort(rng.uniform(-2.0, -0.3, no)),
                           np.sort(rng.uniform(0.2, 3.0, nv))])


@pytest.fixture(params=[True, False], ids=["opt_einsum", "left_to_right"])
def opt_einsum(request, monkeypatch):
    monkeypatch.setattr(torch.backends.opt_einsum, "enabled", request.param)
    return request.param


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conditioning", ["regular", "singular"])
def test_solve_symmetric_matches_tuna_tpu(conditioning):
    rng = np.random.default_rng(4)
    M = rng.standard_normal((9, 9))
    A = M @ M.T + 0.5 * np.eye(9)
    if conditioning == "singular":
        A = M[:, :6] @ M[:, :6].T
    b = A @ rng.standard_normal(9)
    x, ok = linalg.solve_symmetric(as_tensor(A), as_tensor(b))
    x_ref, ok_ref = jax_linalg.solve_symmetric(jnp.asarray(A), jnp.asarray(b))
    assert bool(ok) == bool(ok_ref)
    assert relative_error(x, x_ref) <= UNIT_TOLERANCE


def test_expm_skew_matches_tuna_tpu():
    rng = np.random.default_rng(5)
    M = 0.3 * rng.standard_normal((10, 10))
    K = M - M.T
    U = linalg.expm_skew(as_tensor(K))
    assert relative_error(U, jax_linalg.expm_skew(jnp.asarray(K))) <= UNIT_TOLERANCE
    assert np.max(np.abs(U.numpy() @ U.numpy().T - np.eye(10))) <= 1e-13


def test_chemists_to_physicists_matches_tuna_tpu():
    g = _symmetric_chemists(np.random.default_rng(6), 6)
    got = transforms.chemists_to_physicists(as_tensor(g))
    assert np.array_equal(got.numpy(), np.asarray(jax_transforms.chemists_to_physicists(g)))


@pytest.mark.parametrize("hfx", [1.0, 0.6])
def test_restricted_apb_matches_tuna_tpu(hfx):
    rng = np.random.default_rng(7)
    g, eps = _symmetric_chemists(rng, NO + NV), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    got = rpa.restricted_apb(as_tensor(g), as_tensor(eps), o, v, hfx)
    expected = jax_rpa.restricted_apb(jnp.asarray(g), jnp.asarray(eps), o, v, hfx)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


def _spin_orbital_inputs(seed, no=NO, nv=NV):
    rng = np.random.default_rng(seed)
    physicists = _symmetric_chemists(rng, no + nv).transpose(0, 2, 1, 3)
    return rng, physicists, _epsilons(rng, no, nv)


@pytest.mark.parametrize("hfx", [1.0, 0.53])
def test_spin_orbital_apb_matches_tuna_tpu(hfx):
    _, ERI_SO, eps = _spin_orbital_inputs(8)
    g_scaled = ERI_SO - hfx * ERI_SO.transpose(0, 1, 3, 2)
    o, v = slice(0, NO), slice(NO, None)
    got = rpa.spin_orbital_apb(as_tensor(g_scaled), as_tensor(eps), o, v)
    expected = jax_rpa.spin_orbital_apb(jnp.asarray(g_scaled), jnp.asarray(eps), o, v)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


def test_zvector_solve_matches_tuna_tpu():
    rng = np.random.default_rng(9)
    g, eps = _symmetric_chemists(rng, NO + NV), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    apb = jax_rpa.restricted_apb(jnp.asarray(g), jnp.asarray(eps), o, v, 1.0)
    L = rng.standard_normal((NO, NV))
    got = rpa.zvector_solve(as_tensor(apb), as_tensor(L))
    assert got.shape == (NO, NV)
    assert relative_error(got, jax_rpa.zvector_solve(apb, jnp.asarray(L))) <= UNIT_TOLERANCE


def _restricted_amplitudes(seed):
    """Chemists' g, the orbital energies, the MP2 denominators and MP3's
    amplitudes from tuna_tpu's core."""
    rng = np.random.default_rng(seed)
    g, eps = _symmetric_chemists(rng, NO + NV), _epsilons(rng)
    o, v = slice(0, NO), slice(NO, None)
    e_ijab = np.asarray(jax_transforms.doubles_epsilons(jnp.asarray(eps), jnp.asarray(eps),
                                                        o, o, v, v))
    _, _, t_ijab, t_dash_ijab, L = jax_mp._restricted_mp3_core(jnp.asarray(g),
                                                               jnp.asarray(e_ijab), NO)
    return g, eps, e_ijab, t_ijab, t_dash_ijab, L


def test_restricted_mp2_core_matches_tuna_tpu():
    g, eps, e_ijab, *_ = _restricted_amplitudes(10)
    g_oovv = g.transpose(0, 2, 1, 3)[:NO, :NO, NO:, NO:]
    got = mp._restricted_mp2_core(as_tensor(g_oovv), as_tensor(e_ijab))
    expected = jax_mp._restricted_mp2_core(jnp.asarray(g_oovv), jnp.asarray(e_ijab), NO)
    for x, y in zip(got, expected):
        assert relative_error(x, y) <= UNIT_TOLERANCE


def test_restricted_mp3_core_matches_tuna_tpu():
    g, eps, e_ijab, *_ = _restricted_amplitudes(11)
    got = mp._restricted_mp3_core(as_tensor(g), as_tensor(e_ijab), slice(0, NO),
                                  slice(NO, None))
    expected = jax_mp._restricted_mp3_core(jnp.asarray(g), jnp.asarray(e_ijab), NO)
    for x, y in zip(got, expected):
        assert relative_error(x, y) <= UNIT_TOLERANCE


@pytest.mark.parametrize("with_singles, with_triples", [(False, False), (True, False),
                                                        (True, True)],
                         ids=["DQ", "SDQ", "SDTQ"])
def test_restricted_mp4_core_matches_tuna_tpu(with_singles, with_triples, opt_einsum):
    g, eps, e_ijab, t_ijab, t_dash_ijab, L = _restricted_amplitudes(12)
    got = mp._restricted_mp4_core(as_tensor(g), as_tensor(e_ijab), as_tensor(t_ijab),
                                  as_tensor(t_dash_ijab), as_tensor(L), as_tensor(eps),
                                  slice(0, NO), slice(NO, None), with_singles, with_triples)
    expected = jax_mp._restricted_mp4_core(jnp.asarray(g), jnp.asarray(e_ijab), t_ijab,
                                           t_dash_ijab, L, jnp.asarray(eps), NO,
                                           with_singles, with_triples)
    for x, y in zip(got, expected):
        y = float(y)
        assert abs(float(x) - y) <= UNIT_TOLERANCE * max(abs(y), 1e-300)
    assert (float(got[2]) != 0.0) == with_triples
    assert (float(got[0]) != 0.0) == with_singles


def test_second_order_triples_amplitudes_match_tuna_tpu(opt_einsum):
    g, eps, e_ijab, t_ijab, *_ = _restricted_amplitudes(13)
    o, v = slice(0, NO), slice(NO, None)
    e_ijkabc = np.asarray(jax_transforms.triples_epsilons(jnp.asarray(eps), o, v))
    got = mp.second_order_triples_amplitudes(as_tensor(e_ijkabc), as_tensor(t_ijab),
                                             as_tensor(g), o, v)
    expected = jax_mp.second_order_triples_amplitudes(jnp.asarray(e_ijkabc), t_ijab,
                                                      jnp.asarray(g), o, v)
    assert relative_error(got, expected) <= UNIT_TOLERANCE


def test_imp2_residual_matches_tuna_tpu_expressions(opt_einsum):
    """One IMP2 residual against tuna_tpu's four einsums (mp.py:680-683), as
    jax evaluates them."""
    rng = np.random.default_rng(14)
    g_oovv = 0.05 * rng.standard_normal((NO, NO, NV, NV))
    t = 0.05 * rng.standard_normal((NO, NO, NV, NV))
    Fvv, Foo, Svv = (rng.standard_normal((NV, NV)), rng.standard_normal((NO, NO)),
                     np.eye(NV) + 0.01 * rng.standard_normal((NV, NV)))
    J = [jnp.asarray(x) for x in (g_oovv, Fvv, Foo, Svv, t)]
    expected = J[0] + jnp.einsum("ap,ijpq,qb->ijab", J[1], J[4], J[3], optimize=True)
    expected += jnp.einsum("ap,ijpq,qb->ijab", J[3], J[4], J[1], optimize=True)
    expected += -jnp.einsum("ap,ik,kjpq,qb->ijab", J[3], J[2], J[4], J[3], optimize=True)
    expected += -jnp.einsum("ap,kj,ikpq,qb->ijab", J[3], J[2], J[4], J[3], optimize=True)
    got = mp._imp2_residual(*[as_tensor(x) for x in (g_oovv, Fvv, Foo, Svv, t)])
    assert relative_error(got, expected) <= UNIT_TOLERANCE


@pytest.mark.parametrize("n_frozen", [0, 1])
def test_restricted_relaxed_density_matches_tuna_tpu(n_frozen):
    rng = np.random.default_rng(15)
    n = NO + NV
    g, eps = _symmetric_chemists(rng, n), _epsilons(rng)
    o, v = slice(n_frozen, NO), slice(NO, None)
    w = 0.05 * rng.standard_normal((NO - n_frozen, NO - n_frozen, NV, NV))
    P = 0.01 * rng.standard_normal((n, n))
    P = P + P.T
    calculation = SimpleNamespace(HFX_prop=0.8)
    got = mp._restricted_relaxed_density(as_tensor(P), as_tensor(w), as_tensor(g),
                                         as_tensor(eps), o, v, NO, NV, calculation)
    expected = jax_mp._restricted_relaxed_density(P, w, g, eps, o, v, NO, NV, calculation,
                                                  None, None)
    assert np.max(np.abs(got.numpy() - np.asarray(expected))) <= 1e-12


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------

# One molecule and basis, N2 6-31G (BASELINE.json config 2), so that
# tuna_tpu compiles few SCF programs.
LINES = [
    "SPE : N N 1.1 : MP2 6-31G",                        # BASELINE.json config 2
    "SPE : N N 1.1 : SCS-MP2 6-31G : TIGHTSCF",
    "SPE : N N 1.1 : SCS-MP2 6-31G : SSS 0.4 OSS 1.1 TIGHTSCF",
    "SPE : N N 1.1 : MP3 6-31G : TIGHTSCF",
    "SPE : N N 1.1 : SCS-MP3 6-31G : MP3S 0.3 TIGHTSCF",
    "SPE : N N 1.1 : MP4[DQ] 6-31G : TIGHTSCF",
    "SPE : N N 1.1 : MP4[SDQ] 6-31G : TIGHTSCF",
    "SPE : N N 1.1 : MP4 6-31G : TIGHTSCF",
    "SPE : N N 1.1 : MP2 6-31G : NATORBS TIGHTSCF FREEZECORE",
]


@pytest.mark.parametrize("line", LINES)
def test_line_matches_tuna_tpu(line):
    assert_lines_match(line)


def test_mp4_triples_part_is_nonzero():
    """Full MP4 and MP4[SDQ] differ by the triples part, in both packages."""
    full, sdq = "SPE : N N 1.1 : MP4 6-31G : TIGHTSCF", "SPE : N N 1.1 : MP4[SDQ] 6-31G : TIGHTSCF"
    for record in (port_line, tuna_tpu_line):
        E_T = record(full)["parts"][2] - record(sdq)["parts"][2]
        assert abs(E_T) > 1e-4

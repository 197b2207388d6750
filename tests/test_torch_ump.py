"""The port's unrestricted Moller-Plesset perturbation theory, OMP2 and the
natural orbitals of unrestricted references against tuna_tpu.

Units take identical seeded numpy inputs in both packages and agree to
1e-12 relative; UMP3's five-operand contractions run with opt_einsum on
and off.  End to end, the same CLI line runs through tuna_tpu.cli.run and
tuna_tpu_torch.cli.run(..., device="cpu") at TIGHTSCF: total energies and
MP parts within 1e-10 Ha, equal SCF cycles and OMP2 steps, natural
occupancies within 1e-8.  Where tuna_tpu fails (its unrestricted relaxed
density writes into an immutable array, its restricted MP3 under
FREEZECORE takes the wrong orbitals), the port is held to an independent
route: the restricted relaxed density, tuna_tpu's UMP3 and the relaxed
density's defining property, Tr(P D_z) = dE/dF_z.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.cli import run as jax_run
from tuna_tpu.output import TunaError as JaxTunaError
from tuna_tpu.post import mp as jax_mp
from tuna_tpu.post import transforms as jax_transforms

from mp_lines import as_tensor, assert_lines_match, port_line, relative_error, tuna_tpu_line
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.post import mp

torch.set_num_threads(2)

NO, NV = 4, 6


def _antisymmetrised_inputs(seed, no=NO, nv=NV):
    """Physicists' <pq|rs> from a random (pq|rs) with the 8-fold symmetry,
    its antisymmetrised <pq||rs> and sorted orbital energies."""
    rng = np.random.default_rng(seed)
    n = no + nv
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    physicists = (0.05 * (chem + chem.transpose(2, 3, 0, 1))).transpose(0, 2, 1, 3)
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, no)),
                          np.sort(rng.uniform(0.2, 3.0, nv))])
    return rng, physicists, physicists - physicists.transpose(0, 1, 3, 2), eps


@pytest.fixture(params=[True, False], ids=["opt_einsum", "left_to_right"])
def opt_einsum(request, monkeypatch):
    monkeypatch.setattr(torch.backends.opt_einsum, "enabled", request.param)
    return request.param


@pytest.mark.parametrize("n_frozen", [0, 2])
def test_unrestricted_mp3_matches_tuna_tpu(n_frozen, opt_einsum):
    _, _, g, eps = _antisymmetrised_inputs(21)
    o, v = slice(n_frozen, NO), slice(NO, None)
    calculation = SimpleNamespace(method=SimpleNamespace(name="MP3"))
    got = mp.run_unrestricted_MP3(calculation, as_tensor(g), as_tensor(eps), 0.0, o, v,
                                  silent=True)
    expected = jax_mp.run_unrestricted_MP3(calculation, jnp.asarray(g), jnp.asarray(eps), 0.0,
                                           o, v, silent=True)
    assert abs(got - expected) <= 1e-12 * abs(expected)


@pytest.mark.parametrize("n_frozen", [0, 2])
def test_unrestricted_relaxed_density_matches_tuna_tpu(n_frozen):
    rng, ERI_SO, g, eps = _antisymmetrised_inputs(22)
    n = NO + NV
    o, v = slice(n_frozen, NO), slice(NO, None)
    e_ijab = np.asarray(jax_transforms.doubles_epsilons(jnp.asarray(eps), jnp.asarray(eps),
                                                        o, o, v, v))
    w = 0.7 * g[o, o, v, v] * e_ijab
    P = 0.01 * rng.standard_normal((n, n))
    P = P + P.T
    calculation = SimpleNamespace(HFX_prop=0.65)
    got = mp._unrestricted_relaxed_density(as_tensor(P), as_tensor(w), as_tensor(g),
                                           as_tensor(ERI_SO), as_tensor(eps), o, v, NO, NV,
                                           calculation)
    expected = jax_mp._unrestricted_relaxed_density(P, w, g, ERI_SO, eps, o, v, NO, NV,
                                                    calculation, None, None)
    assert relative_error(got, expected) <= 1e-12


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    "SPE : O H 0.97 : UMP2 6-31G : ML 2 TIGHTSCF",
    "SPE : O H 0.97 : SCS-MP2 6-31G : ML 2 TIGHTSCF",
    "SPE : O H 0.97 : UMP3 6-31G : ML 2 TIGHTSCF",
    "SPE : O H 0.97 : SCS-MP3 6-31G : ML 2 MP3S 0.3 TIGHTSCF",
    "SPE : O H 0.97 : UMP2 6-31G : ML 2 NATORBS TIGHTSCF",
    "SPE : O H 0.97 : UHF 6-31G : ML 2 NATORBS TIGHTSCF",
    "SPE : O H 0.97 : UCCSD STO-3G : ML 2 NATORBS TIGHTSCF",
    "SPE : O H 0.97 : OMP2 STO-3G : ML 2 TIGHTSCF",
])
def test_line_matches_tuna_tpu(line):
    expected, got = assert_lines_match(line, unrestricted=True)
    assert (got["steps"] > 0) == ("OMP2" in line or "CCSD" in line)


def test_restricted_and_unrestricted_mp2_agree_on_a_closed_shell():
    """As tests/test_mp.py does for tuna_tpu: the spatial-orbital and the
    spin-orbital code paths are independent, and on a closed shell they
    give one energy and, relaxed, one density."""
    restricted = port_line("SPE : LI H 1.6 : MP2 6-31G : RELAXED TIGHTSCF")
    unrestricted = port_line("SPE : LI H 1.6 : UMP2 6-31G : RELAXED NOROTATE TIGHTSCF")
    assert abs(restricted["energy"] - unrestricted["energy"]) <= 1e-9
    assert np.max(np.abs(restricted["P"] - unrestricted["P"])) <= 1e-9
    unrelaxed = port_line("SPE : LI H 1.6 : MP2 6-31G : TIGHTSCF")
    assert np.max(np.abs(restricted["P"] - unrelaxed["P"])) > 1e-4


def test_unrestricted_relaxed_density_is_the_field_derivative():
    """Tr(P D_z) of the relaxed UMP2 density against the central difference
    of the energy in an applied field (tests/test_mp_relaxed.py's check of
    tuna_tpu's restricted density)."""
    base = "SPE : O H 0.97 : UMP2 6-31G : ML 2 RELAXED TIGHTSCF"
    h = 2e-4
    E_plus = port_line(base + f" EZ {h}")["energy"]
    E_minus = port_line(base + f" EZ {-h}")["energy"]
    record = port_line(base)
    Dz = record["SCF_output"].integrals.D[2].numpy()
    assert abs(float(np.sum(record["P"] * Dz)) - (E_plus - E_minus) / (2 * h)) < 5e-6


def test_frozen_core_mp3_matches_tuna_tpu_unrestricted():
    """tuna_tpu's restricted MP3 fails under FREEZECORE; its spin-orbital MP3
    on the same closed shell is the reference for the port's restricted
    one, part by part."""
    got = port_line("SPE : N N 1.1 : MP3 6-31G : TIGHTSCF FREEZECORE")
    expected = tuna_tpu_line("SPE : N N 1.1 : UMP3 6-31G : NOROTATE TIGHTSCF FREEZECORE")
    assert abs(got["energy"] - expected["energy"]) <= 1e-10
    assert np.max(np.abs(np.subtract(got["parts"], expected["parts"]))) <= 1e-10
    with pytest.raises(ValueError):
        jax_run("SPE : N N 1.1 : MP3 STO-3G : TIGHTSCF FREEZECORE", suppress_output=True)


@pytest.mark.parametrize("line", [
    "SPE : O H 0.97 : UMP2 STO-3G : ML 2 STAB",
    "SPE : O H 0.97 : UMP2 STO-3G : ML 2 TD",
])
def test_unported_unrestricted_options_raise(line):
    with pytest.raises(TunaError, match="not yet ported"):
        run(line, suppress_output=True, device="cpu")


@pytest.mark.parametrize("line", [
    "SPE : O H 0.97 : UMP2 STO-3G : ML 2 DIRECT",
    "SPE : O H 0.97 : UMP3 STO-3G : ML 2 DIRECT",
    "SPE : O H 0.97 : IMP2 STO-3G : ML 2",
    "SPE : O H 0.97 : MP4 STO-3G : ML 2",
])
def test_unrestricted_refusals_match_tuna_tpu(line):
    with pytest.raises(JaxTunaError) as expected:
        jax_run(line, suppress_output=True)
    with pytest.raises(TunaError) as got:
        run(line, suppress_output=True, device="cpu")
    assert str(got.value) == str(expected.value)

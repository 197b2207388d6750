"""The port's iterative, Laplace and relaxed MP2, its DIRECT MPn and MP2
optimisation, and the refusals that stay, against tuna_tpu.

The same CLI line runs through tuna_tpu.cli.run and
tuna_tpu_torch.cli.run(..., device="cpu") at TIGHTSCF: total energies and
MP2 parts within 1e-10 Ha, equal SCF cycles and IMP2/OMP2 steps, relaxed
densities within 1e-10 elementwise, natural occupancies within 1e-8.
DIRECT MPn is held to the port's stored path (1e-10 Ha), the MP2
optimisation of H2 (finite-difference gradients in both packages) to
tuna_tpu's bond length within 1e-6 angstrom.
"""

import numpy as np
import pytest
import torch

from tuna_tpu.cli import run as jax_run
from tuna_tpu.output import TunaError as JaxTunaError

from mp_lines import assert_lines_match, port_line
from ported_lines import RELAXED_DH, assert_line_matches_tuna_tpu
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.constants import bohr_to_angstrom
from tuna_tpu_torch.output import TunaError

torch.set_num_threads(2)


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : IMP2 6-31G : TIGHTSCF",
    "SPE : LI H 1.6 : CCSD STO-3G : NATORBS TIGHTSCF",
    "SPE : LI H 1.6 : IMP2 STO-3G : ECONV 1e-12 TIGHTSCF",
    "SPE : LI H 1.6 : LMP2 STO-3G : MPGRID 20 TIGHTSCF",
    "SPE : LI H 1.6 : AO-MP2 STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : OMP2 STO-3G : ECONV 1e-10 TIGHTSCF",
])
def test_iterative_laplace_and_natural_orbital_lines_match_tuna_tpu(line):
    expected, got = assert_lines_match(line)
    assert (got["steps"] > 0) == any(name in line for name in ("IMP2", "OMP2", "CCSD"))
    assert len(got["SCF_output"].correlation_iteration_seconds) == got["steps"]


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : MP2 6-31G : RELAXED NATORBS TIGHTSCF",
    "SPE : N N 1.1 : SCS-MP2 6-31G : RELAXED TIGHTSCF FREEZECORE",
])
def test_relaxed_density_matches_tuna_tpu(line):
    assert_lines_match(line, density_tolerance=1e-10)


def test_direct_mpn_matches_stored():
    """MP2, MP3 and MP4 parts from the transform-direct integrals against the
    stored tensor's, in the port."""
    direct = port_line("SPE : N N 1.1 : MP4 6-31G : DIRECT TIGHTSCF")
    stored = port_line("SPE : N N 1.1 : MP4 6-31G : TIGHTSCF")
    assert direct["SCF_output"].integrals.ERI_AO is None
    assert abs(direct["energy"] - stored["energy"]) <= 1e-10
    assert np.max(np.abs(np.subtract(direct["parts"], stored["parts"]))) <= 1e-10
    assert direct["scf_cycles"] == stored["scf_cycles"]


def test_mp2_optimisation_matches_tuna_tpu():
    """OPT at MP2 takes finite-difference gradients in both packages."""
    line = "OPT : H H 0.74 : MP2 6-31G : TIGHTSCF"
    molecule, energy = run(line, suppress_output=True, device="cpu")
    jax_molecule, jax_energy = jax_run(line, suppress_output=True)
    assert bohr_to_angstrom(abs(molecule.bond_length - jax_molecule.bond_length)) <= 1e-6
    assert abs(energy - jax_energy) <= 1e-10


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : B2PLYP STO-3G : RELAXED",
    "SPE : H H 0.74 : MP2 STO-3G : STAB",
    "SPE : H H 0.74 : CIS STO-3G",
    "SPE : H H 0.74 : MP2 STO-3G : TD",
    "SPE : H H 0.74 : MP2 STO-3G : DENSPLOT",
])
def test_unported_options_raise(line, monkeypatch, tmp_path):
    """Options once refused as not ported: each line runs, or is refused,
    as in tuna_tpu."""
    monkeypatch.chdir(tmp_path)
    assert_line_matches_tuna_tpu(line, refusal=RELAXED_DH if "RELAXED" in line else None)


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : IMP2 STO-3G : DIRECT",
    "SPE : H H 0.74 : LMP2 STO-3G : DIRECT",
    "SPE : H H 0.74 : OMP2 STO-3G : DIRECT",
    "SPE : H H 0.74 : MP4[SDQ] STO-3G : DIRECT",
    "SPE : H H 0.74 : B2PLYP STO-3G : DIRECT",
])
def test_direct_refusals_match_tuna_tpu(line):
    with pytest.raises(JaxTunaError) as expected:
        jax_run(line, suppress_output=True)
    with pytest.raises(TunaError) as got:
        run(line, suppress_output=True, device="cpu")
    assert str(got.value) == str(expected.value)

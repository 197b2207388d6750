"""The port's double hybrids on restricted and unrestricted Kohn-Sham
references against tuna_tpu: the same CLI line through tuna_tpu.cli.run
and tuna_tpu_torch.cli.run(..., device="cpu") at TIGHTSCF, total energies
and MP2 parts within 1e-10 Ha, equal SCF cycles.  The XC part scales by
DFX and DFC, the MP2 part by MPC; DSD-BLYP scales its spin components.
The relaxed density and TD need the XC kernel, which tuna_tpu has only
for LDA functionals: it refuses both for a double hybrid, and so does the
port, in the same words.
"""

import pytest
import torch

from mp_lines import assert_lines_match
from ported_lines import RELAXED_DH, TD_DH, assert_line_matches_tuna_tpu

torch.set_num_threads(2)


@pytest.mark.parametrize("line", [
    "SPE : LI H 1.6 : B2PLYP 6-31G : TIGHTSCF",
    "SPE : LI H 1.6 : DSD-BLYP 6-31G : TIGHTSCF",
    "SPE : LI H 1.6 : B2PLYP 6-31G : ML 3 TIGHTSCF",
    "SPE : LI H 1.6 : DSD-BLYP 6-31G : ML 3 TIGHTSCF",
])
def test_double_hybrid_matches_tuna_tpu(line):
    expected, got = assert_lines_match(line)
    assert got["parts"][0] < 0.0


@pytest.mark.parametrize("line", [
    "SPE : H H 0.74 : B2PLYP STO-3G : RELAXED",
    "SPE : H H 0.74 : B2PLYP STO-3G : ML 3 RELAXED",
    "SPE : H H 0.74 : B2PLYP STO-3G : TD",
])
def test_unported_double_hybrid_options_raise(line):
    """The double hybrids lack the TD-DFT kernel: tuna_tpu refuses their
    relaxed density and TD (once refused here as not ported) in these
    words."""
    assert_line_matches_tuna_tpu(line, refusal=RELAXED_DH if "RELAXED" in line else TD_DH)

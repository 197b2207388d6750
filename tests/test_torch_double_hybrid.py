"""The port's double hybrids on restricted and unrestricted Kohn-Sham
references against tuna_tpu: the same CLI line through tuna_tpu.cli.run
and tuna_tpu_torch.cli.run(..., device="cpu") at TIGHTSCF, total energies
and MP2 parts within 1e-10 Ha, equal SCF cycles.  The XC part scales by
DFX and DFC, the MP2 part by MPC; DSD-BLYP scales its spin components.
The relaxed density of a Kohn-Sham reference needs the XC kernel, which
is not ported: it is refused in words before the SCF.
"""

import pytest
import torch

from mp_lines import assert_lines_match
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.output import TunaError

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
    with pytest.raises(TunaError, match="not yet ported"):
        run(line, suppress_output=True, device="cpu")

"""Prints the tuna_tpu numbers that phases 23 and 24 of chip_smoke.py hold
the port to, one JSON line a calculation line:

    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py [LINE ...]
    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py --phase 24 [LINE ...]

(no LINE: every line of the phase, 23 by default).  Each runs through tuna_tpu.cli.run on
the JAX CPU backend with one device, so scans and stencils walk serially as
the port does on one card, and reports what run returns, the SCF cycles of
every SCF in the order they ran (the STO-3G guess SCFs included), the CC
iterations of every coupled-cluster solve, and, where the line has them,
the values of the finite-field properties (the polarisability's parallel
and perpendicular second derivatives as well), the (T) energies, the
energies of the IP/EA states, the CBS parts, and the anharmonic levels,
zero-point energy, chi and number of scans; for the excited-state and
stability lines of phase 24, the first NSTATES excitation energies and
oscillator strengths of the printed spectrum, the (D) corrections and the
lowest eigenvalue of each stability Hessian.
tuna_tpu's analytic gradient (jax.grad) needs more than 30 GB of host
memory at cc-pVTZ; its forward-mode derivative (jax.jvp), which
tests/test_torch_uhf_gradients.py holds to jax.grad at 1e-12 Ha/bohr,
takes its place here.
"""

import json
import pathlib
import re
import sys
import types

import jax
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tuna_tpu import cli, scf  # noqa: E402
from tuna_tpu.drivers import common, electric, energy, freq, gradients  # noqa: E402
from tuna_tpu.post import cc, excited, rpa  # noqa: E402

LINES = (
    "SPE : N N 1.1 : CC3 CC-PVTZ : TIGHTSCF",
    "SPE : N N 1.1 : CC2 CC-PVTZ : TIGHTSCF",
    "SPE : N N 1.1 : QCISD(T) CC-PVTZ : TIGHTSCF",
    "SPE : N N 1.1 : LCCD 6-311G : TIGHTSCF",
    "SPE : N N 1.1 : CCD 6-311G : TIGHTSCF",
    "SPE : N N 1.1 : CEPA(0) 6-311G : TIGHTSCF",
    "SPE : N N 1.1 : CID 6-311G : TIGHTSCF",
    "ANHARM : C O 1.13 : HF CC-PVTZ",
    "SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF",
    "IP : C O 1.13 : CCSD(T) CC-PVTZ : VERTICAL",
    "EA : F : CCSD(T) CC-PVTZ",
    "BDE : H F 0.92 : MP2 CC-PVTZ : ZPE",
    "SPE : N N 1.1 : CCSD(T) CC-PVDZ : EXTRAPOLATE TIGHTSCF",
)
LINES_24 = (
    "SPE : N N 1.1 : TDHF CC-PVTZ : TIGHTSCF",
    "SPE : N N 1.1 : CIS(D) CC-PVTZ : TIGHTSCF",
    "SPE : N N 1.1 : SVWN CC-PVTZ : TD TIGHTSCF",
    "SPE : O O 1.21 : CIS(D) CC-PVTZ : ML 3 TIGHTSCF",
    "SPE : O O 1.21 : SVWN CC-PVTZ : ML 3 TD TIGHTSCF",
    "SPE : N N 1.1 : HF CC-PVTZ : STAB TIGHTSCF",
    "SPE : O O 1.21 : UHF CC-PVTZ : ML 3 STAB TIGHTSCF",
)
_CC_ROW = re.compile(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$")


def _wrap(module, name, record, key):
    """Replace module.name by a function that appends (args, result) of each
    call to record[key]."""
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        result = original(*args, **kwargs)
        record.setdefault(key, []).append((args, result))
        return result

    setattr(module, name, wrapped)


def _plain(value):
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "bond_length"):      # a molecule
        return {"bond_length": float(value.bond_length)}
    return value if isinstance(value, (int, float, str, type(None))) else repr(value)


RECORD: dict = {}
MESSAGES: list = []


def _install() -> None:
    """Record, for the lines run after it: every message the SCF and CC
    modules log (printed or not), and the calls of the functions whose
    results phase 23 reads; and give tuna_tpu's gradients jax.jvp."""
    def logging(original):
        def log(message, *args, **kwargs):
            MESSAGES.append(str(message))
            return original(message, *args, **kwargs)
        return log

    scf.log = logging(scf.log)
    cc.log = logging(cc.log)
    _wrap(electric, "second_derivative", RECORD, "second_derivatives")
    for name in ("calculate_numerical_dipole_moment", "calculate_numerical_quadrupole_moment",
                 "calculate_polarisability", "calculate_hyperpolarisability"):
        _wrap(electric, name, RECORD, name)
    _wrap(cc, "restricted_CCSD_T", RECORD, "restricted_T")
    _wrap(cc, "unrestricted_CCSD_T", RECORD, "unrestricted_T")
    _wrap(energy, "evaluate_molecular_energy", RECORD, "energies")
    _wrap(common, "extrapolate_energies", RECORD, "extrapolation")
    _wrap(freq, "solve_nuclear_schroedinger", RECORD, "schroedinger")
    _wrap(freq, "_process_anharmonic_output", RECORD, "anharmonic_output")
    _wrap(energy, "scan_coordinate", RECORD, "scans")
    _wrap(excited, "print_absorption_spectrum", RECORD, "spectrum")
    _wrap(excited, "restricted_doubles_correction", RECORD, "doubles")
    _wrap(excited, "unrestricted_doubles_correction", RECORD, "doubles")
    _wrap(rpa, "orbital_hessian_lowest", RECORD, "hessian_lowest")
    gradients.jax = types.SimpleNamespace(
        jit=jax.jit,
        grad=lambda f, argnums=0: (lambda R, *a: jax.jvp(lambda r: f(r, *a), (R,), (1.0,))[1]))


def reference(line: str) -> dict:
    RECORD.clear()
    MESSAGES.clear()
    record, messages = RECORD, MESSAGES
    result = cli.run(line, suppress_output=True)

    scf_cycles = [int(m.group(1)) for text in messages
                  for m in [re.search(r"converged in (\d+) cycles", text)] if m]
    cc_iterations, counting = [], False
    for text in messages:
        if "Step          Correlation E" in text:
            cc_iterations.append(0)
            counting = True
        elif counting and _CC_ROW.match(text):
            cc_iterations[-1] += 1
    out = {"line": line, "scf_cycles": scf_cycles, "cc_iterations": cc_iterations}
    if line.startswith("SPE"):
        out["energy"] = float(result[2])
    else:
        out["result"] = _plain(result)
    if "extrapolation" in record:
        args, parts = record["extrapolation"][0]
        out["extrapolation"] = {"inputs": _plain(args[1:5]), "parts": _plain(parts)}
    for key in ("calculate_numerical_dipole_moment", "calculate_numerical_quadrupole_moment",
                "calculate_polarisability", "calculate_hyperpolarisability"):
        if key in record:
            out[key] = _plain(record[key][0][1])
    if "calculate_polarisability" in record:
        # the parallel and perpendicular components: minus the two second
        # derivatives the polarisability takes, in that order
        out["polarisability_components"] = [-float(r) for _, r in record["second_derivatives"]]
    for key in ("restricted_T", "unrestricted_T"):
        if key in record:
            out[key] = [float(r) for _, r in record[key]]
    if line.split()[0] in ("IP", "EA"):
        out["state_energies"] = [float(r[2]) for _, r in record["energies"]]
    if "spectrum" in record:
        args, _ = record["spectrum"][0]
        energies, calculation, strengths = args[1], args[2], args[4]
        n = min(len(energies), calculation.n_states)
        out["excitation_energies"] = _plain(np.asarray(energies)[:n])
        out["oscillator_strengths"] = _plain(np.asarray(strengths)[:n])
    if "doubles" in record:
        out["doubles"] = [float(r) for _, r in record["doubles"]]
    if "hessian_lowest" in record:
        out["hessian_lowest"] = [float(r) for _, r in record["hessian_lowest"]]
    if line.startswith("ANHARM"):
        out["scans"] = len(record["scans"])
        levels, _, _, _, V = record["schroedinger"][-1][1]
        out["levels"] = _plain(levels)
        out["zero_point_energy"] = float(levels[0] - np.min(V))
        out["chi"] = float(record["anharmonic_output"][0][0][4])
    return out


def main() -> int:
    _install()
    arguments = sys.argv[1:]
    lines = LINES
    if arguments[:1] == ["--phase"]:
        lines = {"23": LINES, "24": LINES_24}[arguments[1]]
        arguments = arguments[2:]
    for line in arguments or lines:
        print(json.dumps(reference(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

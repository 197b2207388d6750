"""Prints the tuna_tpu numbers that phases 23, 24 and 25 of chip_smoke.py
hold the port to, one JSON line a calculation line:

    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py [LINE ...]
    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py --phase 24 [LINE ...]
    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py --phase 25 [LINE ...]
    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py --phase 26 [LINE ...]

    JAX_PLATFORMS=cpu python tests/chip_smoke_references.py --phase 27 [LINE ...]

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
lowest eigenvalue of each stability Hessian; for a single point, its SCF
energy as well.  Phase 25's lines are the g- and h-shell bases; its first
is CCSD where chip_smoke.py runs CCSD[T]: tuna_tpu's restricted (T) forms
o^3 v^3 arrays several times over, 2.9 GB each at o = 7, v = 103, too many
for a host of 62 GB, so the port's (T) there is held to K2's plain version
on the card.  Its last line, N2 HF/cc-pV5Z DIRECT, ran for more than two
hours on the JAX CPU backend without ending.  Phase 26's lines are the
analytic gradients at g and h shells: for each, the energy of every SCF, the
gradient of every geometry iteration (dE/dR, Ha/bohr) and the seconds the
line took; tuna_tpu's OPT line also its bond length and energy.
tuna_tpu's analytic gradient (jax.grad) needs more than 30 GB of host
memory at cc-pVTZ; its forward-mode derivative (jax.jvp), which
tests/test_torch_uhf_gradients.py holds to jax.grad at 1e-12 Ha/bohr,
takes its place here.  Phase 27's lines are the batches of
tuna_tpu/parallel.py on the conftest's 8 virtual CPU devices: each scan
through parallel.scan_points_parallel (the CCSD(T) lines one point a call,
on one device: tuna_tpu's (T) forms o^3 v^3 arrays several times over,
2.1 GB each at O2/cc-pVDZ, for every point of a batch at once), each field
line through cli.run, whose property stencils call
parallel.field_energies_parallel; for each, the energies of every point,
and every SCF and CC solve inside tuna_tpu's batches as (iterations,
electronic or correlation energy) pairs, read by jax.debug.callback from
the vmapped kernels (the order of a batch's callbacks is the devices', so
chip_smoke.py matches them to its points by energy).
"""

import json
import pathlib
import re
import sys
import time
import types

import os

import jax
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from tuna_tpu import cli, constants, scf  # noqa: E402
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
LINES_25 = (
    "SPE : N N 1.1 : CCSD CC-PVQZ : TIGHTSCF",
    "SPE : N N 1.1 : HF CC-PVTZ : EXTRAPOLATE TIGHTSCF",
    "SPE : N N 1.1 : B3LYP DEF2-QZVP : TIGHTSCF",
    "SPE : H F 0.917 : HF CC-PV5Z : TIGHTSCF",
    "SPE : N N 1.1 : HF CC-PV5Z : DIRECT TIGHTSCF",
)
LINES_26 = (
    "FORCE : N N 1.1 : HF CC-PVQZ : TIGHTSCF",
    "FORCE : O O 1.21 : UHF CC-PVQZ : ML 3 TIGHTSCF",
    "FORCE : N N 1.1 : B3LYP CC-PVQZ : TIGHTSCF",
    "FORCE : H F 0.917 : HF CC-PV5Z : TIGHTSCF",
    "OPT : N N 1.1 : HF CC-PVQZ : TIGHTSCF",
)
LINES_27 = (
    "SCAN : N N 1.0 : CCSD(T) CC-PVTZ : NUM 6 STEP 0.04 EXTREMESCF",
    "SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF",
    "SPE : N N 1.1 : B3LYP CC-PVTZ : NL POLAR EXTREMESCF",
    "SCAN : O O 1.16 : B3LYP CC-PVTZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF",
    "SCAN : O O 1.11 : CCSD(T) CC-PVDZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF",
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
    _wrap(gradients, "calculate_analytic_gradient", RECORD, "gradients")
    gradients.jax = types.SimpleNamespace(
        jit=jax.jit,
        grad=lambda f, argnums=0: (lambda R, *a: jax.jvp(lambda r: f(r, *a), (R,), (1.0,))[1]))


def reference(line: str) -> dict:
    RECORD.clear()
    MESSAGES.clear()
    record, messages = RECORD, MESSAGES
    start = time.perf_counter()
    result = cli.run(line, suppress_output=True)
    seconds = time.perf_counter() - start

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
        if hasattr(result[0], "energy"):
            out["scf_energy"] = float(result[0].energy)
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
    if line.split()[0] in ("FORCE", "OPT"):
        out["energies"] = [float(r[2]) for _, r in record["energies"]]
        out["gradients"] = [float(r) for _, r in record.get("gradients", [])]
        out["seconds"] = seconds
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


def _install_27() -> dict:
    """Record (iterations, energy) of every SCF and CC solve inside
    tuna_tpu's batches, and each field batch's fields and energies."""
    from tuna_tpu import parallel
    from tuna_tpu import scf as scf_module
    solves = {"scf": set(), "cc": set(), "field_batches": []}

    def counting(kernel, key, energy_at):
        def counted(*args):
            out = kernel(*args)
            jax.debug.callback(lambda n, E: solves[key].add((int(n), float(E))), out[0],
                               out[energy_at])
            return out
        return counted

    get_kernel, make_kernel = parallel.get_scf_kernel, scf_module.make_scf_kernel_fn
    build_solver = cc._build_cc_solver_fn
    parallel.get_scf_kernel = lambda *a, **k: counting(get_kernel(*a, **k), "scf", 2)
    scf_module.make_scf_kernel_fn = lambda *a, **k: counting(make_kernel(*a, **k), "scf", 2)
    cc._build_cc_solver_fn = lambda *a, **k: counting(build_solver(*a, **k), "cc", 3)
    field_batch = parallel.field_energies_parallel

    def recorded(calculation, symbols, coordinates, fields, gradients=None, mesh=None):
        energies, converged = field_batch(calculation, symbols, coordinates, fields, gradients,
                                          mesh)
        solves["field_batches"].append({"fields": _plain(fields),
                                        "gradients": _plain(gradients),
                                        "energies": _plain(energies),
                                        "converged": _plain(converged)})
        return energies, converged

    parallel.field_energies_parallel = recorded
    return solves


def reference_27(line: str, solves: dict) -> dict:
    from tuna_tpu import parallel
    from tuna_tpu.config import Config
    for value in solves.values():
        value.clear()
    start = time.perf_counter()
    out = {"line": line}
    if line.startswith("SCAN"):
        ct, method, basis, symbols, coordinates, params = cli.parse_input(line)
        calculation = Config(ct, cli.process_method(method), time.time(), params, basis,
                             symbols, suppress_output=True)
        bonds, bond = [], float(coordinates[1][2])
        for _ in range(calculation.number_of_steps):
            bonds.append(bond)
            bond = bond + constants.angstrom_to_bohr(calculation.step)
        groups = [[b] for b in bonds] if "CCSD(T)" in line else [bonds]
        mesh = parallel.device_mesh(1 if len(groups) > 1 else 8)
        energies, converged = [], []
        for group in groups:
            E, conv, _ = parallel.scan_points_parallel(calculation, symbols, np.array(group),
                                                       mesh)
            energies += _plain(E)
            converged += _plain(conv)
        out.update(bonds=bonds, energies=energies, converged=converged)
    else:
        RECORD.clear()
        cli.run(line, suppress_output=True)
        out["field_batches"] = list(solves["field_batches"])
        for key in ("calculate_numerical_dipole_moment", "calculate_numerical_quadrupole_moment",
                    "calculate_polarisability", "calculate_hyperpolarisability"):
            if key in RECORD:
                out[key] = _plain(RECORD[key][0][1])
    out["scf_solves"] = sorted(solves["scf"])
    out["cc_solves"] = sorted(solves["cc"])
    out["seconds"] = time.perf_counter() - start
    return out


def main() -> int:
    _install()
    arguments = sys.argv[1:]
    lines = LINES
    if arguments[:2] == ["--phase", "27"]:
        # the conftest's mesh; set before JAX's backend starts
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        if jax.device_count() != 8:
            raise RuntimeError(f"{jax.device_count()} JAX devices, phase 27 pins on 8")
        solves = _install_27()
        for line in arguments[2:] or LINES_27:
            print(json.dumps(reference_27(line, solves)), flush=True)
        return 0
    if arguments[:1] == ["--phase"]:
        lines = {"23": LINES, "24": LINES_24, "25": LINES_25, "26": LINES_26}[arguments[1]]
        arguments = arguments[2:]
    for line in arguments or lines:
        print(json.dumps(reference(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

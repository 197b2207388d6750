"""Command-line interface and calculation dispatcher.

Twin of tuna_tpu/cli.py with the same grammar and printed output:

    TUNA CALC : A [B R] : METHOD BASIS [: KEYWORDS...]

Single points (SPE), coordinate scans (SCAN), geometry optimisation (OPT,
FORCE), harmonic frequencies (FREQ, OPTFREQ) and molecular dynamics (MD)
are ported; the other calculation types raise.  The command line runs on the GPU and
refuses to run without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import __version__, constants
from .config import Config
from .methods import (BASIS_ALIASES, CALCULATION_TYPES,
                      ELECTRONIC_STRUCTURE_METHODS, lookup_method)
from .output import TunaError, error, finish_calculation, timer, warning
from .periodic import ATOMIC_PROPERTIES

MINIMUM_BOND_LENGTH_ANGSTROMS = 0.01


class ParamList(list):
    """Upper-cased keyword tokens, with the raw-cased originals attached so
    path-valued keywords survive the grammar's upper-casing."""

    def __init__(self, upper_tokens, raw_tokens=None):
        super().__init__(upper_tokens)
        self.raw = list(raw_tokens) if raw_tokens is not None else list(upper_tokens)


def parse_input(input_line: str):
    """Parse the colon-grammar input line."""
    atom_options = ATOMIC_PROPERTIES.keys()
    ghost_options = [f"X{key}" for key in ATOMIC_PROPERTIES.keys()]
    method_options = {m.name for m in ELECTRONIC_STRUCTURE_METHODS}

    raw_line = input_line.strip()
    input_line = input_line.upper().strip()

    try:
        raw_sections = raw_line.split(":")
        sections = input_line.split(":")
        calculation_type = sections[0].strip()
        geometry_section = sections[1].strip()
        method_string, basis = sections[2].strip().split()
        params = sections[3].strip().split() if len(sections) == 4 else []
        params_raw = raw_sections[3].strip().split() if len(sections) == 4 else []
    except (IndexError, ValueError):
        error("Input line formatted incorrectly! Read the manual for help.")

    if len(sections) > 4:
        # The reference silently drops ALL keywords when extra colon
        # sections appear (tuna.py:98, len == 4 check) -- a silent footgun
        # (e.g. ": TIGHTSCF : P" loses both keywords).  Matching parse
        # behaviour, plus a warning.
        warning("More than four colon sections in the input line -- all "
                "keywords ignored! Keywords share ONE section, e.g. "
                '": TIGHTSCF P".')

    atomic_symbols = [a.strip() for a in geometry_section.split(" ")[0:2] if a.strip()]

    try:
        coordinates_1D = [0] + [float(b.strip()) for b in geometry_section.split(" ")[2:] if b.strip()]
    except ValueError:
        error("Could not parse bond length!")

    if calculation_type not in CALCULATION_TYPES:
        error(f'Calculation type "{calculation_type}" is not supported.')

    if method_string not in method_options:
        base_method = method_string.split("U", 1)[-1]
        if base_method not in method_options or base_method == method_string:
            error(f'Electronic structure method "{method_string}" is not supported.')

    if basis not in BASIS_ALIASES:
        error(f'Basis set "{basis}" is not supported.')

    if not all(a in atom_options or a in ghost_options for a in atomic_symbols):
        error("One or more atom types not recognised! Check the manual for available atoms.")

    if len(atomic_symbols) != len(coordinates_1D):
        error("Two atoms requested without a bond length!")

    if len(coordinates_1D) == 2 and coordinates_1D[1] < MINIMUM_BOND_LENGTH_ANGSTROMS:
        error(f"Bond length ({coordinates_1D[1]} angstroms) is too small! Minimum "
              f"bond length is {MINIMUM_BOND_LENGTH_ANGSTROMS} angstroms.")

    coordinates = np.array([[0.0, 0.0, constants.angstrom_to_bohr(c)]
                            for c in coordinates_1D])
    return (calculation_type, method_string, basis, atomic_symbols, coordinates,
            ParamList(params, params_raw))


def process_method(method_string: str):
    method = lookup_method(method_string)
    if method == "restricted_only":
        error(f"The {method_string[1:]} method is only implemented for "
              "spin-restricted references!")
    if method is None:
        error(f'Electronic structure method "{method_string}" is not supported.')
    return method


def run_calculation(calculation_type, calculation, atomic_symbols, coordinates,
                    device="cuda"):
    from .drivers import energy as energ

    if calculation_type in ("SCAN", "OPT", "OPTFREQ", "FORCE", "FREQ", "ANHARM",
                            "MD", "BDE") and calculation.monatomic:
        error(f"{CALCULATION_TYPES.get(calculation_type)} requested for a single atom!")
    if calculation_type not in ("SPE", "SCAN", "OPT", "FORCE", "FREQ", "OPTFREQ", "MD"):
        error(f"{CALCULATION_TYPES.get(calculation_type)} calculations are not yet "
              "ported to tuna_tpu_torch!")

    if calculation_type == "SPE":
        timer("Energy evaluation", 0)
        result = energ.evaluate_molecular_energy(calculation, atomic_symbols, coordinates,
                                                 device=device)
        timer("Energy evaluation", 1)

    elif calculation_type == "SCAN":
        if calculation.step is None:
            error('Coordinate scan requested but no step size given by keyword "STEP"!')
        if calculation.number_of_steps is None:
            error('Coordinate scan requested but no number of steps given by keyword "NUM"!')
        result = energ.scan_coordinate(calculation, atomic_symbols, coordinates, device=device)

    elif calculation_type in ("OPT", "FORCE"):
        from .drivers import opt
        result = opt.optimise_geometry(calculation, atomic_symbols, coordinates,
                                       multiple_iterations=calculation_type != "FORCE",
                                       device=device)

    elif calculation_type == "FREQ":
        from .drivers import freq
        result = freq.calculate_harmonic_frequency(
            calculation, atomic_symbols=atomic_symbols, coordinates=coordinates, device=device)

    elif calculation_type == "OPTFREQ":
        from .drivers import freq, opt
        optimised_molecule, optimised_energy = opt.optimise_geometry(
            calculation, atomic_symbols, coordinates, device=device)
        result = freq.calculate_harmonic_frequency(
            calculation, molecule=optimised_molecule, energy=optimised_energy, device=device)

    elif calculation_type == "MD":
        from .drivers import md
        if not calculation.no_trajectory:
            calculation.trajectory = True
        result = md.run_molecular_dynamics_simulation(calculation, atomic_symbols,
                                                      coordinates, device=device)
    return result


def run(input_line: str, suppress_output: bool = False, device="cuda"):
    """Programmatic entry point: run one TUNA calculation from an input line
    with every tensor on `device` ("cuda" unless a caller chooses "cpu")."""
    start_time = time.perf_counter()
    (calculation_type, method_string, basis, atomic_symbols, coordinates,
     params) = parse_input(input_line)
    method = process_method(method_string)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        error("No CUDA GPU is visible: tuna_tpu_torch runs on a GPU.")

    if not suppress_output:
        print(f"{CALCULATION_TYPES.get(calculation_type)} calculation in "
              f"{BASIS_ALIASES.get(basis)} basis set requested.")
        print(f"Electronic structure method is {method.long_name}.\n")

    calculation = Config(calculation_type, method, start_time, params, basis,
                         atomic_symbols, suppress_output)

    contraction = "fully decontracted" if calculation.decontract else "partially contracted"
    if not suppress_output:
        print(f"Setting up calculation using {contraction} basis set.")
        print("\nDistances in angstroms and times in femtoseconds. "
              "Everything else in atomic units.")

    result = run_calculation(calculation_type, calculation, atomic_symbols, coordinates,
                             device)
    finish_calculation(calculation)
    return result


LOGO = r"""
      _______ _    _ _   _                     ___
     |__   __| |  | | \ | |   /\            __/__/__  _
 ~~~~~~ | |  | |  | |  \| |  /  \ ~~~~~~~~ / .      \/ ) ~~~~
 ~~~~~~ | |  | |  | | . ` | / /\ \ ~~~~~~ (     ))    ( ~~~~~
 ~~~~~~ | |  | |__| | |\  |/ ____ \ ~~~~~~ \___  ___/\_) ~~~~
        |_|   \____/|_| \_/_/    \_\          \\_\
"""


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-version", "--version"):
        sys.exit(f"TUNA {__version__}")

    print(LOGO)
    print(f"\nWelcome to version {__version__} of TUNA-TPU!\n")

    input_line = " ".join(argv)
    try:
        run(input_line)
    except KeyboardInterrupt:
        print("\nERROR: The TUNA calculation has been interrupted by the user. Goodbye!")
        sys.exit(1)
    except TunaError as tuna_error:
        print(tuna_error)
        sys.exit(1)


if __name__ == "__main__":
    main()

"""One CLI line through tuna_tpu and through tuna_tpu_torch on the CPU, with
what tests/test_torch_mp.py and tests/test_torch_ump.py compare: the total
energy, the SCF cycles and the IMP2/OMP2 steps of the printout, the MP2,
MP3 and MP4 parts, the density the run returns and the natural occupancies
handed to the property printout."""

import contextlib
import functools
import io
import re

import numpy as np
import torch

from tuna_tpu import props as jax_props
from tuna_tpu.cli import run as jax_run
from tuna_tpu.post import mp as jax_mp

from tuna_tpu_torch import props
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.containers import to_numpy
from tuna_tpu_torch.post import mp

_STEP_ROW = re.compile(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", re.M)


@contextlib.contextmanager
def _recording(mp_module, props_module, record):
    run_pt = mp_module.run_perturbation_theory_calculation
    properties = props_module.calculate_molecular_properties

    def recorded_pt(*args, **kwargs):
        out = run_pt(*args, **kwargs)
        record["parts"] = tuple(float(x) for x in out[:3])
        return out

    def recorded_properties(*args, **kwargs):
        occupancies = kwargs.get("natural_occupancies")
        record["natural_occupancies"] = None if occupancies is None else np.asarray(
            to_numpy(occupancies))
        return properties(*args, **kwargs)

    mp_module.run_perturbation_theory_calculation = recorded_pt
    props_module.calculate_molecular_properties = recorded_properties
    try:
        yield
    finally:
        mp_module.run_perturbation_theory_calculation = run_pt
        props_module.calculate_molecular_properties = properties


def _run(runner, mp_module, props_module, line, **kwargs):
    record = {"parts": None, "natural_occupancies": None}
    printed = io.StringIO()
    with _recording(mp_module, props_module, record), contextlib.redirect_stdout(printed):
        SCF_output, _, energy, P = runner(line, **kwargs)
    text = printed.getvalue()
    steps = text.split("Step          Correlation E")
    record.update(energy=float(energy), P=np.asarray(to_numpy(P)),
                  scf_cycles=int(re.findall(r"converged in (\d+) cycles", text)[-1]),
                  steps=len(_STEP_ROW.findall(steps[-1])) if len(steps) > 1 else 0,
                  SCF_output=SCF_output)
    return record


@functools.lru_cache(maxsize=None)
def tuna_tpu_line(line):
    return _run(jax_run, jax_mp, jax_props, line)


@functools.lru_cache(maxsize=None)
def port_line(line):
    return _run(run, mp, props, line, device="cpu")


@functools.lru_cache(maxsize=None)
def tuna_tpu_line_natural_occupancies(line):
    """tuna_tpu's run of `line` without NATORBS, with the natural occupancies
    of the density it returns from its own natural_orbitals_of_density: on
    an unrestricted reference tuna_tpu's NATORBS fails before any result
    (drivers/post_scf.py:62 passes `silent` to log() by position)."""
    from tuna_tpu.scf.guess import natural_orbitals_of_density

    record = dict(tuna_tpu_line(line.replace(" NATORBS", "")))
    SCF_output = record["SCF_output"]
    occupancies, _ = natural_orbitals_of_density(record["P"], SCF_output.X, SCF_output.S)
    record["natural_occupancies"] = np.asarray(occupancies)
    return record


def assert_lines_match(line, energy_tolerance=1e-10, density_tolerance=None,
                       occupancy_tolerance=1e-8, unrestricted=False):
    """The port's run of `line` against tuna_tpu's: total energy and MP parts
    within energy_tolerance (Ha), equal SCF cycles and steps, the densities
    elementwise within density_tolerance when given, the natural occupancies
    within occupancy_tolerance (on an `unrestricted` reference against
    tuna_tpu_line_natural_occupancies).  Returns both records."""
    expected = (tuna_tpu_line_natural_occupancies(line) if unrestricted and "NATORBS" in line
                else tuna_tpu_line(line))
    got = port_line(line)
    assert abs(got["energy"] - expected["energy"]) <= energy_tolerance
    assert (got["scf_cycles"], got["steps"]) == (expected["scf_cycles"], expected["steps"])
    assert (got["parts"] is None) == (expected["parts"] is None)
    if expected["parts"] is not None:
        assert np.max(np.abs(np.subtract(got["parts"], expected["parts"]))) <= energy_tolerance
    if density_tolerance is not None:
        assert np.max(np.abs(got["P"] - expected["P"])) <= density_tolerance
    assert (got["natural_occupancies"] is None) == (expected["natural_occupancies"] is None)
    if expected["natural_occupancies"] is not None:
        assert np.max(np.abs(got["natural_occupancies"]
                             - expected["natural_occupancies"])) <= occupancy_tolerance
    return expected, got


def as_tensor(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def relative_error(got, expected):
    got, expected = np.asarray(to_numpy(got)), np.asarray(expected)
    return np.max(np.abs(got - expected)) / max(np.max(np.abs(expected)), 1e-300)

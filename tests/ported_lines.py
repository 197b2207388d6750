"""One CLI line through tuna_tpu and through tuna_tpu_torch on the CPU, for
the tests of options that the port once refused: where tuna_tpu refuses
the line, the port raises the same text; where it runs, the numbers it
returns agree and every SCF took as many cycles."""

import contextlib
import functools
import io
import re

import jax
import numpy as np
import torch

from tuna_tpu.cli import run as jax_run
from tuna_tpu.output import TunaError as JaxTunaError

from tuna_tpu_torch.cli import run
from tuna_tpu_torch.output import TunaError

_CYCLES = re.compile(r"converged in (\d+) cycles")


def numbers(result):
    """The floats of what cli.run returns, flattened in order: for SPE the
    total energy; elsewhere every float, array or list in the result (a
    molecule contributes its bond length)."""
    if isinstance(result, tuple) and len(result) == 4 and hasattr(result[1], "atoms"):
        return [float(result[2])]
    if isinstance(result, (list, tuple)):
        return [x for item in result for x in numbers(item)]
    if isinstance(result, torch.Tensor):
        return result.detach().cpu().numpy().ravel().tolist()
    if isinstance(result, np.ndarray):
        return result.ravel().tolist()
    if isinstance(result, (float, int, np.floating)) and not isinstance(result, bool):
        return [float(result)]
    if hasattr(result, "bond_length"):
        return [float(result.bond_length)]
    return []


def _outcome(runner, error_type, line, **kwargs):
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            result = runner(line, **kwargs)
    except error_type as refused:
        return {"error": str(refused)}
    text = printed.getvalue()
    return {"error": None, "result": result, "numbers": numbers(result),
            "cycles": [int(n) for n in _CYCLES.findall(text)], "printed": text}


@functools.lru_cache(maxsize=None)
def tuna_tpu_outcome(line):
    """tuna_tpu's run on one JAX device: with the conftest's eight it
    batches scans and stencils, where the port on one device walks them."""
    device_count = jax.device_count
    jax.device_count = lambda: 1
    try:
        return _outcome(jax_run, JaxTunaError, line)
    finally:
        jax.device_count = device_count


def port_outcome(line):
    return _outcome(run, TunaError, line, device="cpu")


# tuna_tpu's refusals of the double hybrids' relaxed density and TD
# (tuna_tpu/post/mp.py:862 and :873, tuna_tpu/post/excited.py:602)
RELAXED_DH = "The relaxed density is not yet available for this exchange-correlation functional!"
TD_DH = "Time-dependent DFT is not yet available for this exchange-correlation functional!"


def assert_line_matches_tuna_tpu(line, tolerance=1e-10, refusal=None):
    """The port's run of `line` against tuna_tpu's: the same error text, or
    every returned number within tolerance (relative above 1) and equal
    SCF cycles.  With `refusal` (tuna_tpu's error text for the line, where
    its run before the refusal is long) the port alone runs and must raise
    it.  Returns both outcomes."""
    if refusal is not None:
        got = port_outcome(line)
        assert got["error"] == f"\nERROR: {refusal}"
        return None, got
    expected, got = tuna_tpu_outcome(line), port_outcome(line)
    assert got["error"] == expected["error"]
    if expected["error"] is None:
        assert len(got["numbers"]) == len(expected["numbers"]) > 0
        for a, b in zip(got["numbers"], expected["numbers"]):
            assert abs(a - b) <= tolerance * max(1.0, abs(b)), (a, b)
        assert got["cycles"] == expected["cycles"]
    return expected, got

"""On-disk checkpoint/restart for wavefunctions and amplitudes.

The reference has no persistent checkpointing -- only in-memory MOREAD
density chaining (tuna_opt.py:406-412).  Long coupled-cluster runs deserve
real restart files (SURVEY.md section 5); this module writes converged
densities and CC amplitudes to a compressed npz keyed by stage, and serves
them back as SCF guesses / CC starting amplitudes when shapes match.
"""

from __future__ import annotations

import numpy as np

from .output import log, warning


def _normalise(path: str) -> str:
    """np.savez appends .npz only for the lowercase suffix; the CLI
    upper-cases its input line, so normalise explicitly."""
    return path if path.lower().endswith(".npz") else path + ".npz"


def save_stage(calculation, stage: str, arrays: dict) -> None:
    """Merge `arrays` under `stage/` into the checkpoint file."""
    if not getattr(calculation, "checkpoint", False):
        return
    path = _normalise(calculation.checkpoint_path)
    existing = {}
    try:
        with np.load(path, allow_pickle=False) as handle:
            existing = {k: handle[k] for k in handle.files}
    except (FileNotFoundError, OSError, ValueError):
        pass
    for key, value in arrays.items():
        existing[f"{stage}/{key}"] = np.asarray(value)
    np.savez_compressed(path, **existing)
    log(f'  (Checkpoint stage "{stage}" written to "{path}")', calculation, 3)


def load_stage(calculation, stage: str) -> dict | None:
    """Arrays for `stage/` from the restart file, or None."""
    if not getattr(calculation, "read_checkpoint", False):
        return None
    path = _normalise(calculation.read_checkpoint_path)
    try:
        with np.load(path, allow_pickle=False) as handle:
            prefix = f"{stage}/"
            found = {k[len(prefix):]: handle[k] for k in handle.files
                     if k.startswith(prefix)}
    except (FileNotFoundError, OSError, ValueError):
        warning(f'Restart file "{path}" could not be read; ignoring READCHK.')
        return None
    return found or None

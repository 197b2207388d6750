"""Prints the raw convergence values of one SCF of a line, iteration by
iteration, in tuna_tpu (JAX on the CPU) or in the port (on the CPU):

    JAX_PLATFORMS=cpu python tests/scf_convergence_margins.py jax "LINE" INDEX
    python tests/scf_convergence_margins.py torch "LINE" INDEX

INDEX counts the line's SCFs in the order they ran, the STO-3G guess SCFs
included.  Each row is (energy without V_NN, delta E, RMS(dP), max(dP),
DIIS error), unrounded: what the convergence test compares with the
thresholds, where the printed table rounds to ten decimals.  One JSON line
a row.  The ANHARM line of chip_smoke.py takes about 25 minutes either way.
"""

import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _jax_rows(line):
    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    from tuna_tpu import cli, scf

    records = []
    get_kernel = scf.get_scf_kernel

    def recording_kernel(*args, **kwargs):
        kernel = get_kernel(*args, **kwargs)

        def run(*inputs):
            out = kernel(*inputs)
            records.append(np.asarray(out[5])[:int(out[0])].tolist())
            return out
        return run

    scf.get_scf_kernel = recording_kernel
    cli.run(line, suppress_output=True)
    return records


def _torch_rows(line):
    from tuna_tpu_torch import cli, scf

    records = []
    cycles = scf.run_scf_cycles

    def recording_cycles(*args, **kwargs):
        rows, args = [], list(args)
        on_iteration = args[15]

        def recorded(step, stats, seconds):
            rows.append(list(stats))
            return on_iteration(step, stats, seconds)

        args[15] = recorded
        out = cycles(*args, **kwargs)
        records.append(rows)
        return out

    scf.run_scf_cycles = recording_cycles
    cli.run(line, suppress_output=True, device="cpu")
    return records


def main() -> int:
    package, line, index = sys.argv[1], sys.argv[2], int(sys.argv[3])
    records = (_jax_rows if package == "jax" else _torch_rows)(line)
    for step, row in enumerate(records[index], 1):
        print(json.dumps({"package": package, "scf": index, "iteration": step,
                          "energy": row[0], "delta_E": row[1], "rms_dP": row[2],
                          "max_dP": row[3], "diis_error": row[4]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Times IntegralPlan.shell_quartets (K8b's and K8bu's shell quartets, built
shell quartet by shell quartet) against the one lexsort over every live
quartet of the work list that it replaced, on this host, with the peak
memory each allocates (tracemalloc) and whether the arrays are the same:

    JAX_PLATFORMS=cpu python tests/shell_quartets_host.py [old]

Molecules: HF/cc-pV5Z (196 Cartesian functions) and N2/cc-pV5Z (252).  The
old builder (`tests/test_torch_high_l_gradients.py::_shell_quartets_by_sort`)
runs only with `old`: at N2/cc-pV5Z it needs about 10 GB.  One JSON line a
molecule.
"""

import hashlib
import json
import pathlib
import sys
import time
import tracemalloc

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from tuna_tpu_torch.config import Config  # noqa: E402
from tuna_tpu_torch.constants import angstrom_to_bohr  # noqa: E402
from tuna_tpu_torch.methods import lookup_method  # noqa: E402
from tuna_tpu_torch.ops.integrals import IntegralPlan  # noqa: E402
from tuna_tpu_torch.system import Molecule  # noqa: E402


def measured(build):
    """(arrays, seconds, peak bytes allocated) of build()."""
    tracemalloc.start()
    start = time.perf_counter()
    arrays = build()
    seconds = time.perf_counter() - start
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return arrays, seconds, peak


def digest(arrays) -> str:
    h = hashlib.sha256()
    for array in arrays:
        h.update(array.tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    with_old = sys.argv[1:] == ["old"]
    for symbols, bond in ((["H", "F"], 0.917), (["N", "N"], 1.1)):
        calculation = Config("SPE", lookup_method("HF"), 0.0, [], "CC-PV5Z", symbols,
                             suppress_output=True)
        molecule = Molecule(symbols, np.array([[0.0, 0.0, 0.0],
                                               [0.0, 0.0, angstrom_to_bohr(bond)]]),
                            calculation)
        plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
        plan.shell_pairs()
        new, seconds, peak = measured(plan.shell_quartets)
        out = {"molecule": "".join(symbols) + "/cc-pV5Z", "functions": plan.n_basis,
               "components": len(new[0]), "shell_quartets": len(new[1]),
               "seconds": seconds, "peak_bytes": peak, "sha256": digest(new)}
        if with_old:
            from test_torch_high_l_gradients import _shell_quartets_by_sort
            _, work_list_s, work_list_peak = measured(plan.work_list)
            old, old_seconds, old_peak = measured(lambda: _shell_quartets_by_sort(plan))
            out.update(work_list_seconds=work_list_s, work_list_peak_bytes=work_list_peak,
                       old_seconds=old_seconds, old_peak_bytes=old_peak,
                       same_arrays=all(np.array_equal(a, b) and a.dtype == b.dtype
                                       for a, b in zip(new, old)))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port (tuna_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a phase that fails raises, and the script exits
non-zero without printing a result):

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; a visible CUDA device is required;
  2. build: compiles the CUDA kernels of tuna_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, on
     the same inputs at the main path's shapes (N2/6-311G and N2/STO-3G for
     the integrals, o = 7 and v = 19 for (T)), with both times;
  4. end to end: `SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF` through
     tuna_tpu_torch.cli.run on the card, held against tuna_tpu's energy on
     the JAX CPU backend, with every kernel's launch count from that run.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tuna_tpu_torch
from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.post import cc
from tuna_tpu_torch.system import Molecule

LINE = "SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF"
# Total energy of LINE from the reference package on the JAX CPU backend:
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(repr(run("SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF")[2]))'
E_REF = -109.17931351416613
E_TOLERANCE = 1e-8          # Ha, the BASELINE contract
INTEGRAL_TOLERANCE = 1e-12  # absolute, kernel against plain version
TRIPLES_TOLERANCE = 1e-12   # relative, kernel against plain version

KERNELS = {
    "eri_packed": ("tuna_tpu_torch/csrc/eri.cu", "tuna_tpu/ops/integrals.py:470"),
    "one_electron": ("tuna_tpu_torch/csrc/one_electron.cu", "tuna_tpu/ops/integrals.py:332"),
    "ccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t.cu", "tuna_tpu/post/cc.py:1741"),
}


class SmokeFailure(RuntimeError):
    pass


def require(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def median_ms(fn, repeats: int = 5) -> float:
    """Median device time of fn() over `repeats` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def diatomic(symbol: str, bond_angstrom: float, basis: str) -> Molecule:
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, [symbol, symbol],
                         suppress_output=True)
    coordinates = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(bond_angstrom)]])
    return Molecule([symbol, symbol], coordinates, calculation)


def check_integrals(basis: str, device, record: dict) -> str:
    molecule = diatomic("N", 1.1, basis)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=device)
    origin = molecule.centre_of_mass

    def kernel_1e():
        return plan.one_electron(coords, charges, origin)

    def plain_1e():
        return plan._one_electron_plain(coords, charges, origin)

    def kernel_eri():
        return plan.eri_pair_packed(coords)

    def plain_eri():
        return plan._eri_packed_plain(coords)

    err_1e = max(float(torch.max(torch.abs(k - p)))
                 for k, p in zip(kernel_1e(), plain_1e()))
    packed_kernel, packed_plain = kernel_eri(), plain_eri()
    require(bool(torch.all(torch.isfinite(packed_kernel))), f"{basis}: non-finite ERI")
    err_eri = float(torch.max(torch.abs(packed_kernel - packed_plain)))
    torch.cuda.synchronize()
    require(err_1e <= INTEGRAL_TOLERANCE,
            f"{basis}: one-electron kernel off its plain version by {err_1e:.3e}")
    require(err_eri <= INTEGRAL_TOLERANCE,
            f"{basis}: ERI kernel off its plain version by {err_eri:.3e}")
    times = {"one_electron": (median_ms(kernel_1e), median_ms(plain_1e)),
             "eri_packed": (median_ms(kernel_eri), median_ms(plain_eri))}
    for name, err in (("one_electron", err_1e), ("eri_packed", err_eri)):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if basis == "6-311G":
            entry["ms"], entry["plain_ms"] = times[name]
    return (f"kernels {basis}: lmax {plan.lmax}, {plan.n_pairs} AO pairs, "
            f"{plan.n_prim_pairs} primitive pairs; one_electron max|diff| {err_1e:.3e} "
            f"({times['one_electron'][0]:.4f} ms vs plain {times['one_electron'][1]:.4f} ms); "
            f"eri_packed max|diff| {err_eri:.3e} "
            f"({times['eri_packed'][0]:.4f} ms vs plain {times['eri_packed'][1]:.4f} ms)")


def check_triples(device, record: dict) -> str:
    no, nv = 7, 19
    rng = np.random.default_rng(7)

    def tensor(*shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape), dtype=torch.float64,
                               device=device)

    args = (tensor(no, no, nv, nv, scale=0.1), tensor(no, nv, nv, nv, scale=0.1),
            tensor(no, no, nv, no, scale=0.1), tensor(no, nv, scale=0.01),
            tensor(no, no, nv, nv, scale=0.05),
            torch.as_tensor(-np.sort(rng.uniform(0.5, 15.0, no))[::-1].copy(),
                            dtype=torch.float64, device=device),
            torch.as_tensor(np.sort(rng.uniform(0.3, 5.0, nv)), dtype=torch.float64,
                            device=device))

    def kernel():
        return cc.ccsd_t_energy(*args)

    def plain():
        return cc._ccsd_t_energy_plain(*args, 1.0)

    e_kernel, e_plain = float(kernel()), float(plain())
    err = abs(e_kernel - e_plain)
    require(np.isfinite(e_kernel), "(T) kernel returned a non-finite energy")
    require(err <= TRIPLES_TOLERANCE * abs(e_plain),
            f"(T) kernel off its plain version by {err:.3e} (relative {err / abs(e_plain):.3e})")
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    record["ccsd_t_energy"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return (f"kernels (T): o {no}, v {nv}; E {e_kernel:.15e}, |diff| {err:.3e} "
            f"(relative {err / abs(e_plain):.3e}); {ms:.4f} ms vs plain {plain_ms:.4f} ms")


def main() -> int:
    # --- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"tuna_tpu_torch {tuna_tpu_torch.__version__}")

    # --- 2. build -----------------------------------------------------------
    start = time.perf_counter()
    library = _kernels.build()
    _kernels.library()
    report = library.with_suffix(".log").read_text().splitlines()
    usage = [line.split("ptxas info    : ")[-1] for line in report if "Used" in line]
    print(f"build: {library.name} in {time.perf_counter() - start:.1f} s; "
          f"ptxas: {' | '.join(usage)}")

    # --- 3. kernels against their plain versions ----------------------------
    record: dict = {}
    for basis in ("6-311G", "STO-3G", "6-31G**", "CC-PVTZ"):
        print(check_integrals(basis, device, record))
    print(check_triples(device, record))

    # --- 4. end to end --------------------------------------------------------
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    SCF_output, molecule, energy, P = run(LINE, suppress_output=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(_kernels.launches)
    delta = energy - E_REF
    scf_seconds = SCF_output.iteration_seconds
    cc_seconds = SCF_output.correlation_iteration_seconds
    n = molecule.n_basis
    require(np.isfinite(energy), "non-finite total energy")
    require(tuple(P.shape) == (n, n) and bool(torch.all(torch.isfinite(P))),
            "CC density has the wrong shape or non-finite entries")
    require(tuple(SCF_output.molecular_orbitals.shape) == (n, n), "MO matrix shape")
    require(abs(delta) <= E_TOLERANCE,
            f"E_total {energy:.12f} is {delta:.3e} Ha from the reference {E_REF:.12f}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    print(f"end to end: {LINE}; E_total {energy!r}, E_total - E_ref {delta:.3e} Ha; "
          f"SCF {len(scf_seconds)} iterations, median {statistics.median(scf_seconds) * 1e3:.3f} "
          f"ms/iteration; CCSD {len(cc_seconds)} iterations, median "
          f"{statistics.median(cc_seconds) * 1e3:.3f} ms/iteration; wall {wall:.3f} s; "
          f"launches {launches}")

    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], **record[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

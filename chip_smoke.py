"""Smoke test of the PyTorch/CUDA port (tuna_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT [ROOT ...]

Phases, one line each (a phase that fails raises, and the script exits
non-zero without printing a result):

  1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
     scipy versions; a visible CUDA device is required;
  2. build: compiles the CUDA kernels of tuna_tpu_torch/csrc with nvcc, with
     the build time and the registers of each kernel (ptxas);
  3. kernels: K1-K3 against their plain PyTorch versions on the card, on the
     same inputs at the coupled-cluster path's shapes (N2/6-311G and
     N2/STO-3G for the integrals, o = 7 and v = 19 for (T)) and at 6-31G**
     and cc-pVTZ, with both times; K1 against a repeated call of itself
     (bitwise), and the quartet work list's classes, light/heavy split and
     kernels a call;
  4. coupled-cluster path: `SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF`
     through tuna_tpu_torch.cli.run on the card, held against tuna_tpu's
     energy on the JAX CPU backend, with the launch count of each kernel;
     then its profile (below);
  5. DFT path: `SPE : N N 1.1 : B3LYP CC-PVTZ : NL TIGHTSCF` the same way,
     with its SCF iteration count, and its profile;
  6. DFT kernels: K7a, K7b and K6 against their plain versions at the DFT
     path's shapes (N2/cc-pVTZ on the medium grid; K6 on the active points
     of the converged density of phase 5, bitwise over two calls);
  7. DIRECT kernels: K4 (the direct Fock build) against its plain version at
     N2/cc-pVTZ and N2/6-311G with a seeded density-like P, and against a
     repeated call of itself (its atomics sum in no fixed order), beside K1
     on the same plan (bitwise over two calls); K5 (the
     packed half-transform) against its plain version at the DIRECT path's
     shapes, both variants, and on 64 rows at the cc-pV6Z shape (N = 252,
     n_mo = 182), where it runs in panels; K2 again at o = 7, v = 53 (both
     K2 shapes: bitwise over two calls, peak device memory a call, stage A's
     products as one batched torch.matmul for library_ms);
  8. DIRECT path: `SPE : N N 1.1 : CCSD[T] CC-PVTZ : DIRECT TIGHTSCF`, the
     N^4 tensor never stored, held against tuna_tpu's energy and iteration
     counts and against the port's stored twin (the same line without
     DIRECT, run once), then its profile;
  9. gradient kernels: K8a (one-electron tangent) and K8b (two-electron
     energy tangent, bitwise over two calls) against their plain versions
     at N2/cc-pVTZ and CO/6-31G; K8c (the density's tangent on the moving
     grid) at the DFT path's grid with its converged density, in phase 6;
 10. gradient path: `OPT : N N 1.1 : B3LYP CC-PVTZ : TIGHTSCF` (optimised
     bond length, energy and iteration count) and `FREQ : C O 1.13 : HF
     CC-PVTZ : TIGHTSCF` (frequency and zero-point energy) against
     tuna_tpu's numbers, with a profile of the OPT line (wall per OPT
     iteration and the gradient's share of it);
 11. BASELINE.json configs 3 and 5: `OPT : H H 1.0 : B3LYP 6-31G`, `FREQ :
     C O 1.13 : HF 6-31G` and `MD : C O 1.13 : HF 6-31G : NUM 5 NOTRAJ`
     against tuna_tpu's numbers;
 12. spin-orbital (T) kernel: K2u against its plain version on seeded
     antisymmetric inputs at the UHF paths' shapes, (o, v) = (16, 36),
     (9, 79) and (16, 104), and with QCISD's disconnected scale 2 at (16,
     36): bitwise over two calls, peak device memory a call, stage A's
     products as batched torch.matmul for library_ms;
 13. UHF paths: `SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 TIGHTSCF` (triplet
     O2), stored and DIRECT; `SPE : O H 0.97 : CCSD(T) CC-PVTZ : ML 2
     TIGHTSCF` (OH radical, f shells); `SPE : O O 1.21 : CCSD(T) CC-PVTZ :
     ML 3 DIRECT TIGHTSCF` with its stored twin; `SPE : O O 1.21 :
     QCISD(T) 6-311G : ML 3 TIGHTSCF`; each against tuna_tpu's SCF and
     CC energies and iteration counts, its (T) against K2u's plain version
     on the path's own amplitudes and integrals, with its profile.

Each path's launch counts are read from zero: the counts are reset just
before the path runs and read just after, so launches made to compare a
kernel with its plain version do not count.  Each kernel's record carries
`bound_ms`, the least time the card could take for the same work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its float64 operations, counted from the kernel's loop body
at this run's inputs, or from what the function needs where the kernel
does more (K1, K4 and K8b: see eri_operations; K2: triples_ms; K6:
vv10_operations; the phase lines print both counts), over the H100 SXM
data sheet's float64 rates: 67
TFLOP/s for the matrix products that the tensor cores can take (K5's two
products, K7b's P^T phi, the contractions of (T)), 34 TFLOP/s for the
rest.  exp, sqrt and a division count as one operation each, so the bound
is a lower bound.

A path's profile, printed as one `profile` JSON line, comes from
WARM_RUNS more runs after the counted one (host clock, each ending in a
device sync: wall median and quartiles, the medians of SCF and CC ms per
iteration, and the medians of the port's phase timers) and one run under
torch.profiler (device busy time as the union of the kernel intervals, the
device idle share, kernel and cudaLaunchKernel counts, the device time
of the top kernels, the launches and device time of each kernel of csrc/,
and for K1 and K4 the union of their class kernels' intervals a call).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

--compare times the three restricted paths, WARM_RUNS warm runs each after a cold one
(warm wall median and quartiles, SCF and CC ms per iteration, iteration
counts), then, CUDA events, median of 10 after a warm-up: K1 and K4 alone at
N2/cc-pVTZ (K4 on a seeded density), K2 alone at o = 7, v = 53 and K6 alone
at M = 51,320 points, both on seeded inputs through cc.ccsd_t_energy and
vv10.vv10_energy, with their energies; with the tuna_tpu_torch of each ROOT
in turn (each in its own interpreter, building its own kernels), and prints
one JSON line for each: two checkouts, say a parent commit and this one,
compared on one card in one call (run them in the order A B B A).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tuna_tpu_torch
from tuna_tpu_torch import _kernels, output
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr, bohr_to_angstrom
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import motransform
from tuna_tpu_torch.ops.integrals import HEAVY_THRESHOLD, IntegralPlan, quartet_operations
from tuna_tpu_torch.post import cc
from tuna_tpu_torch.system import Molecule

LINE = "SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF"
# Total energy of LINE from the reference package on the JAX CPU backend:
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(repr(run("SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF")[2]))'
E_REF = -109.17931351416613
LINE_DFT = "SPE : N N 1.1 : B3LYP CC-PVTZ : NL TIGHTSCF"
# Total energy (VV10 included) and SCF iteration count of LINE_DFT from the
# reference package on the JAX CPU backend:
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(repr(run("SPE : N N 1.1 : B3LYP CC-PVTZ : NL TIGHTSCF")[2]))'
# ("Self-consistent field converged in 11 cycles!" in its printout).
E_REF_DFT = -109.43605607252006
SCF_ITERATIONS_DFT = 11
LINE_DIRECT = "SPE : N N 1.1 : CCSD[T] CC-PVTZ : DIRECT TIGHTSCF"
LINE_DIRECT_STORED = "SPE : N N 1.1 : CCSD[T] CC-PVTZ : TIGHTSCF"
# Total energy and SCF and CCSD iteration counts of LINE_DIRECT from the
# reference package on the JAX CPU backend (~4 min there):
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       print(repr(run("SPE : N N 1.1 : CCSD[T] CC-PVTZ : DIRECT TIGHTSCF")[2]))'
# ("Self-consistent field converged in 14 cycles!" and 13 rows in the
# coupled-cluster iteration table of its printout).
E_REF_DIRECT = -109.39989748904053
SCF_ITERATIONS_DIRECT = 14
CC_ITERATIONS_DIRECT = 13
# The gradient paths.  Constants from the reference package on the JAX CPU
# backend, printed by
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; print(run(LINE))'
# (OPT returns (molecule, energy): its molecule.bond_length in bohr; FREQ
# returns (hessian, reduced mass, frequency per cm, zero-point energy); MD the
# energy of every step; the OPT iteration count is the N of "Optimisation
# converged in N iterations!" in its printout).  For the two cc-pVTZ lines
# the reference's jax.grad(total_energy) needs more than 30 GB of host
# memory there, so tuna_tpu.drivers.gradients.jax was replaced by a module
# whose grad(f) returns R -> jax.jvp(f, (R,), (1.0,))[1]: the same derivative
# of the same function in forward mode (on OPT H2/6-31G the two agree to
# 4e-13 bohr and 1e-15 Ha).
LINE_OPT = "OPT : N N 1.1 : B3LYP CC-PVTZ : TIGHTSCF"
BOND_REF_OPT = 2.0627441514606106   # bohr
E_REF_OPT = -109.51624311107587
ITERATIONS_OPT = 5
LINE_FREQ = "FREQ : C O 1.13 : HF CC-PVTZ : TIGHTSCF"
FREQUENCY_REF_FREQ = 2223.0137561634197   # per cm
ZPE_REF_FREQ = 0.005064397972468039
# BASELINE.json configs 3 and 5 at their own sizes
LINE_OPT_H2 = "OPT : H H 1.0 : B3LYP 6-31G"
BOND_REF_OPT_H2 = 1.4042649853470401
E_REF_OPT_H2 = -1.1687164812924133
ITERATIONS_OPT_H2 = 7
LINE_FREQ_CO = "FREQ : C O 1.13 : HF 6-31G"
FREQUENCY_REF_FREQ_CO = 2291.503343670439
ZPE_REF_FREQ_CO = 0.00522042873347617
LINE_MD_CO = "MD : C O 1.13 : HF 6-31G : NUM 5 NOTRAJ"
E_REF_MD_CO = (-112.6672208310967, -112.66722083319698, -112.66722083926815,
               -112.66722084934422, -112.66722086338045)
# The UHF paths.  Constants from the reference package on the JAX CPU
# backend, printed by
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       out = run(LINE); print(repr(out[0].energy), repr(out[2]))'
# (the SCF and total energies; the iteration counts from "Self-consistent
# field converged in N cycles!" and the rows of the coupled-cluster
# iteration table of its printout).  For the two cc-pVTZ lines tuna_tpu's
# (T) forms o^3 v^3 arrays several times over (2.9 GB each at o = 9, v =
# 79; 37 GB at o = 16, v = 104), so the constants are those of the same
# line with CCSD in place of CCSD(T) (SCF and CCSD energies), and the
# port's (T) is held to K2u's plain version on the card.
LINE_UHF = "SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 TIGHTSCF"
E_SCF_REF_UHF = -149.59617783487772
E_REF_UHF = -149.88873114519333
ITERATIONS_UHF = (16, 15)                 # SCF, CCSD
LINE_UHF_DIRECT = "SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 DIRECT TIGHTSCF"
E_REF_UHF_DIRECT = -149.88873114519345
LINE_UHF_QCISD = "SPE : O O 1.21 : QCISD(T) 6-311G : ML 3 TIGHTSCF"
E_REF_UHF_QCISD = -149.8894356699433
ITERATIONS_UHF_QCISD = (16, 16)
LINE_UHF_OH = "SPE : O H 0.97 : CCSD(T) CC-PVTZ : ML 2 TIGHTSCF"
E_SCF_REF_UHF_OH = -75.41925053512463
E_CCSD_REF_UHF_OH = -75.64482066183278    # "SPE : O H 0.97 : CCSD CC-PVTZ : ML 2 TIGHTSCF"
ITERATIONS_UHF_OH = (18, 17)
LINE_UHF_TZ = "SPE : O O 1.21 : CCSD(T) CC-PVTZ : ML 3 DIRECT TIGHTSCF"
LINE_UHF_TZ_STORED = "SPE : O O 1.21 : CCSD(T) CC-PVTZ : ML 3 TIGHTSCF"
E_SCF_REF_UHF_TZ = -149.67472478511564
E_CCSD_REF_UHF_TZ = -150.135420506447     # "SPE : O O 1.21 : CCSD CC-PVTZ : ML 3 DIRECT TIGHTSCF"
ITERATIONS_UHF_TZ = (15, 15)
BOND_TOLERANCE = 1e-6       # angstrom
FREQUENCY_TOLERANCE = 0.01  # per cm
E_TOLERANCE = 1e-8          # Ha, the BASELINE contract
DIRECT_TOLERANCE = 1e-10    # Ha, DIRECT against the port's stored twin
UHF_TOLERANCE = 1e-10       # Ha, the UHF paths' energies against tuna_tpu's
INTEGRAL_TOLERANCE = 1e-12  # absolute, kernel against plain version
TRIPLES_TOLERANCE = 1e-12   # relative, kernel against plain version
GRID_TOLERANCE = 1e-12      # absolute, AO values and density on the grid
VV10_TOLERANCE = 1e-12      # relative, VV10 energy
FOCK_TOLERANCE = 1e-12      # relative to the largest |entry| of J and of K
TRANSFORM_TOLERANCE = 1e-12  # relative to the largest |entry| of the output
DERIV_GRID_TOLERANCE = 1e-12  # relative to the largest |entry| of each K8c output

WARM_RUNS = 9                  # warm runs of a path, for its profile and --compare

BYTES_PER_MS = 3.35e12 / 1e3   # H100 SXM device memory
FP64_PER_MS = 34e12 / 1e3      # float64 outside the tensor cores
FP64_MMA_PER_MS = 67e12 / 1e3  # float64 matrix products on the tensor cores (DMMA)

KERNELS = {
    "eri_packed": ("tuna_tpu_torch/csrc/eri.cu", "tuna_tpu/ops/integrals.py:470"),
    "one_electron": ("tuna_tpu_torch/csrc/one_electron.cu", "tuna_tpu/ops/integrals.py:332"),
    "ccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t.cu", "tuna_tpu/post/cc.py:1741"),
    "uccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t_u.cu", "tuna_tpu/post/cc.py:1783"),
    "ao_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu", "tuna_tpu/dft/grid.py:80"),
    "density_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu", "tuna_tpu/dft/grid.py:137"),
    "vv10_energy": ("tuna_tpu_torch/csrc/vv10.cu", "tuna_tpu/dft/vv10.py:26"),
    "fock_direct": ("tuna_tpu_torch/csrc/fock_direct.cu", "tuna_tpu/ops/integrals.py:754"),
    "mo_half_transform": ("tuna_tpu_torch/csrc/mo_transform.cu",
                          "tuna_tpu/ops/motransform.py:51"),
    "one_electron_deriv": ("tuna_tpu_torch/csrc/one_electron_deriv.cu",
                           "tuna_tpu/drivers/gradients.py:247"),
    "eri_deriv_energy": ("tuna_tpu_torch/csrc/eri_deriv.cu", "tuna_tpu/drivers/gradients.py:248"),
    "density_deriv_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu",
                              "tuna_tpu/drivers/gradients.py:123"),
}
CC_PATH_KERNELS = ("eri_packed", "one_electron", "ccsd_t_energy")
DFT_PATH_KERNELS = ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid",
                    "vv10_energy")
DIRECT_PATH_KERNELS = ("eri_packed", "one_electron", "fock_direct", "mo_half_transform",
                       "ccsd_t_energy")
# the KS gradient path (OPT B3LYP); the HF ones (FREQ, MD) launch the first four
GRADIENT_PATH_KERNELS = ("eri_packed", "one_electron", "one_electron_deriv",
                         "eri_deriv_energy", "ao_on_grid", "density_on_grid",
                         "density_deriv_on_grid")
HF_GRADIENT_PATH_KERNELS = GRADIENT_PATH_KERNELS[:4]
UHF_PATH_KERNELS = ("eri_packed", "one_electron", "uccsd_t_energy")
UHF_DIRECT_PATH_KERNELS = ("eri_packed", "one_electron", "fock_direct", "mo_half_transform",
                           "uccsd_t_energy")


class SmokeFailure(RuntimeError):
    pass


def require(condition: bool, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def medians_ms(fns, repeats: int) -> list[float]:
    """Median device time of each of fns over `repeats` rounds that call
    them in turn, after one warm-up call each."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(repeats):
        for fn, fn_times in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            fn_times.append(start.elapsed_time(end))
    return [statistics.median(fn_times) for fn_times in times]


def median_ms(fn, repeats: int = 5) -> float:
    """Median device time of fn() over `repeats` calls after one warm-up."""
    return medians_ms((fn,), repeats)[0]


def bound(n_bytes: float, ops_ms: float) -> dict:
    """bound_ms and bound_by from a byte count and an operation time."""
    bytes_ms = n_bytes / BYTES_PER_MS
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def diatomic(symbol: str, bond_angstrom: float, basis: str, partner: str | None = None) -> Molecule:
    symbols = [symbol, partner or symbol]
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, symbols,
                         suppress_output=True)
    coordinates = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(bond_angstrom)]])
    return Molecule(symbols, coordinates, calculation)


# ---------------------------------------------------------------------------
# Operation counts, from each kernel's loop body
# ---------------------------------------------------------------------------

def shell_pairs(plan: IntegralPlan) -> tuple[np.ndarray, np.ndarray]:
    """(shell-pair id of each AO pair, primitive pairs of each shell pair).
    The AOs of one atom with one total angular momentum and the same
    primitive exponents form a shell (a general contraction's shells
    merge), so the AO pairs of a shell pair have the same primitive pairs'
    p and P_z, whatever their Cartesian components."""
    n_prim = np.diff(plan.pair_start)
    shell_of, shells = np.empty(plan.n_basis, dtype=np.int64), {}
    for i in range(plan.n_basis):
        diagonal = plan.pair_index[i, i]
        s, n = plan.pair_start[diagonal], int(round(np.sqrt(n_prim[diagonal])))
        key = (int(plan.atom1[s]), int(plan.l1[s].sum()), plan.b[s:s + n].tobytes())
        shell_of[i] = shells.setdefault(key, len(shells))
    si, sj = shell_of[plan.pid_i], shell_of[plan.pid_j]
    _, first, ids = np.unique(np.maximum(si, sj) * len(shells) + np.minimum(si, sj),
                              return_index=True, return_inverse=True)
    return ids, n_prim[first].astype(np.float64)


def deriv_quartet_operations(l_bra: int, l_ket: int) -> tuple[int, int]:
    """(shared, own) float64 operations of one derivative primitive quartet
    of csrc/eri_deriv.cu: quartet_operations' with the Boys order and the
    R^n_00v recursion one order higher, plus the second z product of
    [d bra | ket] + [bra | d ket] (two operations a term)."""
    shared = quartet_operations(l_bra, l_ket + 1)[0]
    own = quartet_operations(l_bra, l_ket)[1] + 2 * (l_bra + 2) * (l_ket + 2)
    return shared, own


def eri_operations(plan: IntegralPlan, derivative: bool = False) -> tuple[float, float]:
    """(needed, kernel's) float64 operations of the packed ERI matrix over
    the unordered AO-pair quartets with matching x/y parities, each at its
    own class (L_bra, L_ket), from ops/integrals.py::quartet_operations;
    higher orders are exact zeros.  With `derivative`, those of K8b's
    derivative quartets (deriv_quartet_operations), without the quartets on
    one atom, which it skips.

    The kernel computes every part of quartet_operations for each primitive
    quartet of each AO-pair quartet.  The function needs the shared part
    (alpha and T, Boys, the R^n_00v recursion) only once a primitive
    quartet of a shell-pair quartet (shell_pairs), and the own part
    (Hermite products, x/y pairing, contraction) for each AO-pair quartet:
    that count is the bound's.  pair_rows_kernel, ~0.1% of either, is left
    out."""
    quartets, classes = plan.work_list()
    n_prim = np.diff(plan.pair_start).astype(np.float64)
    counts = n_prim[quartets[:, 0]] * n_prim[quartets[:, 1]]
    if derivative:
        first = plan.pair_start[:-1]
        atom = np.where(plan.atom1[first] == plan.atom2[first], plan.atom1[first], -1)
        bra_atom, ket_atom = atom[quartets[:, 0]], atom[quartets[:, 1]]
        counts = np.where((bra_atom >= 0) & (bra_atom == ket_atom), 0.0, counts)
    shell_pair, shell_prim = shell_pairs(plan)
    n_shell_pairs = len(shell_prim)
    needed = kernel = 0.0
    for la, lb, begin, _, end, _, _ in classes:
        shared, own = (deriv_quartet_operations if derivative else quartet_operations)(la, lb)
        primitive_quartets = counts[begin:end].sum()
        kernel += (shared + own) * primitive_quartets
        live = slice(begin, end) if not derivative else np.flatnonzero(counts[begin:end]) + begin
        bra, ket = shell_pair[quartets[live, 0]], shell_pair[quartets[live, 1]]
        shell_quartets = np.unique(np.maximum(bra, ket) * n_shell_pairs + np.minimum(bra, ket))
        needed += own * primitive_quartets + shared * np.sum(
            shell_prim[shell_quartets // n_shell_pairs] * shell_prim[shell_quartets % n_shell_pairs])
    return float(needed), float(kernel)


def fock_direct_operations(plan: IntegralPlan) -> tuple[float, float]:
    """csrc/fock_direct.cu: the quartet values as in eri_operations, plus per
    AO-pair quartet and orientation 3 operations for J and 2 for each K
    term, (1 + [i != j]) (1 + [k != l]) of them; both orientations of the
    unordered quartets sum to all ordered (P, Q) of one parity class."""
    first = plan.pair_start[:-1]
    parity = (2 * ((plan.l1[first, 0] + plan.l2[first, 0]) & 1)
              + ((plan.l1[first, 1] + plan.l2[first, 1]) & 1))
    w = 1.0 + (plan.pid_i != plan.pid_j)
    jk = sum(3.0 * np.sum(parity == cls) ** 2 + 2.0 * np.sum(w[parity == cls]) ** 2
             for cls in range(4))
    needed, kernel = eri_operations(plan)
    return needed + jk, kernel + jk


def work_list_summary(plan: IntegralPlan) -> str:
    """The work list's size, classes and light/heavy split, and the class
    kernels one K1 or K4 call launches."""
    quartets, classes = plan.work_list()
    light = int(np.sum(classes[:, 3] - classes[:, 2]))
    heavy = int(np.sum(classes[:, 4] - classes[:, 3]))
    kernels = int(np.sum(classes[:, 3] > classes[:, 2]) + np.sum(classes[:, 4] > classes[:, 3]))
    return (f"work list {len(quartets)} quartets in {len(classes)} classes, {light} light / "
            f"{heavy} heavy (threshold {HEAVY_THRESHOLD}); a call launches {kernels} "
            f"class kernels + pair rows (K4: + J unpack)")


def ptxas_report(log: str) -> dict:
    """Registers of each kernel, and its spill stores if any, from the
    build's ptxas report, keyed by source and kernel (the class kernels as
    quartet_light_kernel<L_bra,L_ket>)."""
    report, unit, kernel, spills = {}, "", "", 0
    for line in log.splitlines():
        if line.startswith("== "):
            unit = line[3:].removesuffix(".cu")
        elif "Compiling entry function" in line:
            mangled = line.split("'")[1]
            kernel = mangled
            scope = re.match(r"_ZN(\d+)", mangled)   # _ZN <namespace> <name> ...
            if scope:
                rest = mangled[scope.end() + int(scope.group(1)):]
                length = re.match(r"\d+", rest)
                kernel = rest[length.end():length.end() + int(length.group())]
                args = re.findall(r"Li(\d+)E", rest)
                kernel += f"<{','.join(args)}>" if args else ""
        elif "bytes spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "registers" in line and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            report[f"{unit}:{kernel}"] = f"{regs} ({spills} B spilled)" if spills else regs
            spills = 0
    return report


def half_transform_operations(n_rows: int, n: int, n_mo: int) -> float:
    """csrc/mo_transform.cu: per row, T = W^T D (n_mo n^2 FMAs) and the
    packed W^T-side product (n n_mo (n_mo + 1) / 2 FMAs), two operations
    an FMA."""
    return 2.0 * n_rows * (n_mo * n * n + n * n_mo * (n_mo + 1) / 2)


def one_electron_operations(plan: IntegralPlan) -> float:
    """csrc/one_electron.cu: per primitive pair, three Hermite rows raised
    up to j + 2 (5 operations an entry), the S, T, D, Q terms and sums, the
    x/y products for V, and per atom a Boys evaluation and a Hermite
    Coulomb table of order 2 lmax."""
    L = plan.lmax
    TL, LEN, NMAX = 2 * L + 1, 2 * L + 3, 2 * L
    raises = (plan.l1.sum(axis=1) + plan.l2.sum(axis=1) + 6).astype(np.float64)
    per_pair = 5 * LEN * raises + 3 * 8 + 15 * 3 + 40 + 3 * (TL // 2 + 1) ** 2
    boys = 23 + 4 * NMAX
    coulomb = 4 * (NMAX + 1) + 1 + 5 * NMAX * (NMAX + 1) // 2 + 2 * NMAX
    per_atom = boys + coulomb + 8
    return float(np.sum(per_pair) + plan.n_prim_pairs * plan.n_atoms * per_atom)


def triples_ms(no: int, nv: int) -> tuple[float, float]:
    """(needed, first kernel's) ms of the (T) energy's float64 operations.
    The function needs each raw element R_ijk[abc] once, nv + no
    multiply-adds (2 (nv + no) operations at the matrix-product rate), then
    per (ijk, abc) the sum W of six raw terms, its weighting, the
    disconnected term, the denominator and the accumulation (26).  The
    first (T) kernel recomputed the six raw terms for every W element:
    12 (nv + no)."""
    n = float(no ** 3 * nv ** 3)
    rest = n * 26 / FP64_PER_MS
    return (n * 2 * (no + nv) / FP64_MMA_PER_MS + rest,
            n * 12 * (no + nv) / FP64_MMA_PER_MS + rest)


def vv10_operations(M: int) -> tuple[float, float]:
    """(needed, first kernel's) float64 operations of the VV10 pair sum: 18 a
    pair over the symmetric half, M (M + 1) / 2 pairs, which the function
    needs since K_ij = K_ji; the first VV10 kernel visited all M^2 ordered
    pairs."""
    return 18.0 * M * (M + 1) / 2, 18.0 * M * M


def ao_on_grid_operations(basis: grid.GridBasis, n_points: int, with_gradients: bool) -> float:
    """csrc/dft_grid.cu ao_on_grid_kernel: per point and AO, the offset and
    r^2 (8), 5 per primitive, the monomials and the value, and with
    gradients three components of ~5 operations plus the monomial
    derivatives."""
    L = basis.lmn.sum(axis=1).astype(np.float64)
    n_prim = np.diff(basis.prim_start).astype(np.float64)
    per_ao = 8 + 5 * n_prim + L + 3
    if with_gradients:
        per_ao = per_ao + 15 + 2 * L
    return float(n_points * np.sum(per_ao))


def density_ms(n: int, n_points: int, with_gradients: bool) -> float:
    """csrc/dft_grid.cu density_on_grid_kernel: per point, Y = P^T phi (2
    n^2, a matrix product), rho (2 n) and with gradients three more dot
    products (6 n) and their doubling (3)."""
    rest = 2.0 * n + ((6.0 * n + 3) if with_gradients else 0.0)
    return n_points * (2.0 * n * n / FP64_MMA_PER_MS + rest / FP64_PER_MS)


def one_electron_deriv_operations(plan: IntegralPlan) -> float:
    """csrc/one_electron_deriv.cu: per primitive pair seven Hermite
    recursions (x and y at (i, j), z at (i, j) and its four neighbours) of
    2 lmax + 5 entries, 5 operations an entry and raise, raised i + j + 2
    (+1) times, the tangent terms, the x/y pairing, and per atom whose
    weight is not zero a Boys evaluation and a Hermite Coulomb table of
    order 2 lmax + 1."""
    L = plan.lmax
    LEN, NMAX = 2 * L + 5, 2 * L + 1
    l_xy = (plan.l1[:, :2] + plan.l2[:, :2]).sum(axis=1).astype(np.float64)
    l_z = (plan.l1[:, 2] + plan.l2[:, 2]).astype(np.float64)
    raises = l_xy + 4 + 5 * (l_z + 3)
    per_pair = 5 * LEN * raises + 100 + 3 * (L + 1) ** 2
    moving_a, moving_b = plan.atom1 == 1, plan.atom2 == 1
    atoms_with_weight = (moving_a | moving_b).astype(np.float64) + (~(moving_a & moving_b))
    per_atom = (23 + 4 * NMAX) + 4 * (NMAX + 1) + 1 + 5 * NMAX * (NMAX + 1) // 2 + 4 * NMAX + 8
    return float(np.sum(per_pair + atoms_with_weight * per_atom))


def density_deriv_ms(basis: grid.GridBasis, n_points: int, with_gradients: bool) -> float:
    """csrc/dft_grid.cu density_deriv_on_grid_kernel: per point, each AO's
    value and z derivative (~16 + 5 a primitive), Y = P phi and Y' = P phi'
    (4 n^2, matrix products), rho and rho' (4 n), and with gradients each
    AO's gradient and Hessian z column (~70 + 7 a primitive) and their
    products with Y and Y' (15 n)."""
    n = basis.n_ao
    n_prim = float(len(basis.exps))
    rest = 16.0 * n + 5 * n_prim + 4 * n
    if with_gradients:
        rest += 70.0 * n + 7 * n_prim + 15 * n
    return n_points * (4.0 * n * n / FP64_MMA_PER_MS + rest / FP64_PER_MS)


# ---------------------------------------------------------------------------
# Phase 3: K1-K3
# ---------------------------------------------------------------------------

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
    packed_kernel, packed_again, packed_plain = kernel_eri(), kernel_eri(), plain_eri()
    require(bool(torch.all(torch.isfinite(packed_kernel))), f"{basis}: non-finite ERI")
    err_eri = float(torch.max(torch.abs(packed_kernel - packed_plain)))
    torch.cuda.synchronize()
    require(err_1e <= INTEGRAL_TOLERANCE,
            f"{basis}: one-electron kernel off its plain version by {err_1e:.3e}")
    require(err_eri <= INTEGRAL_TOLERANCE,
            f"{basis}: ERI kernel off its plain version by {err_eri:.3e}")
    require(torch.equal(packed_kernel, packed_again), f"{basis}: two ERI kernel calls differ")
    times = {"one_electron": (median_ms(kernel_1e), median_ms(plain_1e)),
             "eri_packed": (median_ms(kernel_eri), median_ms(plain_eri))}
    for name, err in (("one_electron", err_1e), ("eri_packed", err_eri)):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    needed, algorithm = eri_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + 8 * plan.n_pairs ** 2,
                      needed / FP64_PER_MS)
    t = plan.tensors(device)
    N = plan.n_basis
    one_electron_bound = bound(
        tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"],
                     t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"], t["boys_one_electron"])
        + 8 * 9 * N * N, one_electron_operations(plan) / FP64_PER_MS)
    if basis == "6-311G":
        record["eri_packed"].update(
            ms=times["eri_packed"][0], plain_ms=times["eri_packed"][1], library_ms=None,
            **eri_bound)
        record["one_electron"].update(
            ms=times["one_electron"][0], plain_ms=times["one_electron"][1], library_ms=None,
            **one_electron_bound)
    return (f"kernels {basis}: lmax {plan.lmax}, {plan.n_pairs} AO pairs, "
            f"{plan.n_prim_pairs} primitive pairs, {work_list_summary(plan)}; one_electron "
            f"max|diff| {err_1e:.3e} ({times['one_electron'][0]:.4f} ms vs plain "
            f"{times['one_electron'][1]:.4f} ms, bound {one_electron_bound['bound_ms']:.5f} ms "
            f"by {one_electron_bound['bound_by']}); eri_packed max|diff| {err_eri:.3e}, two "
            f"calls bitwise equal ({times['eri_packed'][0]:.4f} ms vs plain "
            f"{times['eri_packed'][1]:.4f} ms, bound {eri_bound['bound_ms']:.5f} ms by "
            f"{eri_bound['bound_by']}; {needed:.4g} operations needed, "
            f"{algorithm:.4g} in the kernel's algorithm, {algorithm / FP64_PER_MS:.5f} ms)")


def eri_input_bytes(plan: IntegralPlan, coords) -> int:
    """Bytes of the inputs of the function K1 and K4 compute: the
    coordinates and the basis's primitive-pair arrays (not the kernels' own
    work list and Boys tables)."""
    t = plan.tensors(coords.device)
    return tensor_bytes(coords, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"],
                        t["atom2"], t["pair_start"])


def triples_args(no: int, nv: int, device) -> tuple:
    """Seeded (T) inputs at o = no, v = nv: <oo|vv>, <ov|vv>, <oo|vo>, t1,
    t2, eps_o, eps_v."""
    rng = np.random.default_rng(7)

    def tensor(*shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape), dtype=torch.float64,
                               device=device)

    return (tensor(no, no, nv, nv, scale=0.1), tensor(no, nv, nv, nv, scale=0.1),
            tensor(no, no, nv, no, scale=0.1), tensor(no, nv, scale=0.01),
            tensor(no, no, nv, nv, scale=0.05),
            torch.as_tensor(-np.sort(rng.uniform(0.5, 15.0, no))[::-1].copy(),
                            dtype=torch.float64, device=device),
            torch.as_tensor(np.sort(rng.uniform(0.3, 5.0, nv)), dtype=torch.float64,
                            device=device))


def stage_a_library_ms(args) -> float:
    """One batched torch.matmul computing K2's stage-A products, R_ijk[:, b, :]
    = [G_ib | -O_ij] . [T_kj^T ; T_kb] for every ordered (i, j, k) and b
    (the operands are built before the timing)."""
    g_oovv, g_ovvv, g_oovo, t1, t2 = args[:5]
    no, nv = t1.shape
    i, j, k = (torch.arange(no, device=t1.device)[:, None, None].expand(no, no, no).reshape(-1),
               torch.arange(no, device=t1.device)[None, :, None].expand(no, no, no).reshape(-1),
               torch.arange(no, device=t1.device)[None, None, :].expand(no, no, no).reshape(-1))
    A = torch.cat([g_ovvv[i], -g_oovo[i, j][:, None].expand(-1, nv, nv, no)], dim=3)
    B = torch.cat([t2[k, j].transpose(1, 2)[:, None].expand(-1, nv, nv, nv),
                   t2[:, k].permute(1, 2, 0, 3)], dim=2)
    A, B = A.reshape(-1, nv, nv + no).contiguous(), B.reshape(-1, nv + no, nv).contiguous()
    ms = median_ms(lambda: torch.matmul(A, B))
    del A, B
    return ms


def check_triples(no: int, nv: int, device, record: dict) -> str:
    """K2 against its plain version at o = no, v = nv, with its peak device
    memory a call; the record keeps the largest error over the shapes, the
    times of the first shape checked (the coupled-cluster path's, v = 19)
    and every shape's measurements under `shapes`."""
    args = triples_args(no, nv, device)

    def kernel():
        return cc.ccsd_t_energy(*args)

    def plain():
        return cc._ccsd_t_energy_plain(*args, 1.0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    e_kernel = float(kernel())
    peak_bytes = torch.cuda.max_memory_allocated() - before
    e_plain = float(plain())
    err = abs(e_kernel - e_plain)
    require(np.isfinite(e_kernel), "(T) kernel returned a non-finite energy")
    require(err <= TRIPLES_TOLERANCE * abs(e_plain),
            f"(T) kernel off its plain version by {err:.3e} (relative {err / abs(e_plain):.3e})")
    require(torch.equal(kernel(), kernel()), "two (T) kernel calls differ")
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    library_ms = stage_a_library_ms(args)
    needed, old_count = triples_ms(no, nv)
    triples_bound = bound(tensor_bytes(*args), needed)
    entry = record.setdefault("ccsd_t_energy", {"max_abs_err": 0.0, "shapes": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if "ms" not in entry:
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **triples_bound)
    entry["shapes"].append({"o": no, "v": nv, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "max_abs_err": err, **triples_bound,
                            "peak_bytes_a_call": peak_bytes})
    n_batches = len(cc.triples_plan(no, nv, cc.TRIPLES_WORKSPACE_BYTES)[0])
    return (f"kernels (T): o {no}, v {nv}; E {e_kernel:.15e}, |diff| {err:.3e} "
            f"(relative {err / abs(e_plain):.3e}), two calls bitwise equal; {ms:.4f} ms vs "
            f"plain {plain_ms:.4f} ms, stage A as one batched torch.matmul {library_ms:.4f} ms; "
            f"bound {triples_bound['bound_ms']:.5f} ms by {triples_bound['bound_by']} (raw once "
            f"an element; six raw terms an element, the first kernel's count: {old_count:.5f} ms); "
            f"{n_batches} batches, peak device memory a call {peak_bytes} bytes (one o^3 v^3 "
            f"tensor: {8 * no ** 3 * nv ** 3} bytes)")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the two paths end to end
# ---------------------------------------------------------------------------

def run_counted(line: str, kernels: tuple):
    """Run `line` on the card with the launch counts and phase timers read
    from zero; every kernel of `kernels` must have launched.  Returns (what
    run returns, wall seconds, launches)."""
    output.reset_timers()
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    result = run(line, suppress_output=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(_kernels.launches)
    for name in kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the path {line!r}")
    return result, wall, launches


def drive(line: str, kernels: tuple):
    """A single point through run_counted, its outputs checked."""
    (SCF_output, molecule, energy, P), wall, launches = run_counted(line, kernels)
    n = molecule.n_basis
    require(np.isfinite(energy), f"{line}: non-finite total energy")
    require(tuple(P.shape) == (n, n) and bool(torch.all(torch.isfinite(P))),
            f"{line}: density matrix has the wrong shape or non-finite entries")
    require(tuple(SCF_output.molecular_orbitals_alpha.shape) == (n, n),
            f"{line}: MO matrix shape")
    return SCF_output, molecule, energy, P, wall, launches


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end_so_far = 0.0, -np.inf
    for start, end in sorted(intervals):
        if start > end_so_far:
            total += end - start
            end_so_far = end
        elif end > end_so_far:
            total += end - end_so_far
            end_so_far = end
    return total


def profile_path(line: str) -> dict:
    """WARM_RUNS warm runs of `line`, then one under torch.profiler."""
    walls, scf_ms, cc_ms, phases = [], [], [], {}
    for _ in range(WARM_RUNS):
        SCF_output, _, _, _, wall, _ = drive(line, ())
        walls.append(wall)
        scf_ms.append(statistics.median(SCF_output.iteration_seconds) * 1e3)
        if SCF_output.correlation_iteration_seconds:
            cc_ms.append(statistics.median(SCF_output.correlation_iteration_seconds) * 1e3)
        for name, seconds in output.timer_table():
            phases.setdefault(name, []).append(seconds * 1e3)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return {
        "line": line,
        "warm_wall_s": {"median": statistics.median(walls), "q1": q1, "q3": q3},
        "scf_ms_per_iteration": statistics.median(scf_ms),
        "cc_ms_per_iteration": statistics.median(cc_ms) if cc_ms else None,
        "phase_host_ms": {name: statistics.median(v) for name, v in phases.items()},
        **profiled_run(line),
    }


# the class kernels of each quartet-engine wrapper, by kernel name
QUARTET_KERNELS = {"eri_packed": r"PackedOut", "fock_direct": r"FockOut",
                   "eri_deriv_energy": r"::deriv_(light|heavy)_kernel"}


def profiled_run(line: str) -> dict:
    """One run of `line` under torch.profiler: device busy time as the union
    of the kernel intervals, the idle share, kernel and cudaLaunchKernel
    counts, the top kernels, each csrc/ kernel's launches and device time,
    and for the quartet-engine wrappers the union of their class kernels'
    intervals a call."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, profiled_wall, profiled_launches = run_counted(line, ())
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    launch_calls = [e for e in events if e.name == "cudaLaunchKernel"]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    hand: dict = {}  # the kernels of csrc/, by function name (and K1/K4 output)
    for e in kernels:
        match = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", e.name)
        if match:
            output_of = re.search(r"(PackedOut|FockOut)", e.name)
            key = match.group(1) + (f"[{output_of.group(1)}]" if output_of else "")
            entry = hand.setdefault(key, {"launches": 0, "device_ms": 0.0})
            entry["launches"] += 1
            entry["device_ms"] += e.time_range.elapsed_us() / 1e3
    # the quartet engine's class kernels overlap on side streams: a wrapper
    # call's device time is the union of its kernels' intervals
    quartet_ms_a_launch = {
        name: _busy_us([(e.time_range.start, e.time_range.end) for e in kernels
                        if re.search(pattern, e.name)]) / 1e3 / profiled_launches[name]
        for name, pattern in QUARTET_KERNELS.items() if profiled_launches[name]}
    return {
        "profiled_wall_s": profiled_wall,
        "device_kernels": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / profiled_wall if kernels else "not measured",
        "cudaLaunchKernel_calls": len(launch_calls),
        "cudaLaunchKernel_host_ms": sum(e.cpu_time_total for e in launch_calls) / 1e3,
        "top_kernels_device_ms": {name[:90]: us / 1e3 for name, us in top_kernels},
        "hand_kernels": hand,
        "quartet_class_kernels_busy_ms_a_launch": quartet_ms_a_launch,
    }


# ---------------------------------------------------------------------------
# Phase 6: K7a, K7b, K6 at the DFT path's shapes
# ---------------------------------------------------------------------------

def check_dft_kernels(molecule, P_converged, device, record: dict) -> str:
    calculation = molecule.calculation
    points_np, weights_np = grid.build_molecular_grid(
        *grid.grid_parameters(molecule, calculation), molecule.bond_length, molecule.atoms)
    G = points_np.shape[1] * points_np.shape[2]
    points = torch.as_tensor(points_np.reshape(3, G), dtype=torch.float64, device=device)
    weights = torch.as_tensor(weights_np.reshape(G), dtype=torch.float64, device=device)
    basis = grid.GridBasis(molecule.cartesian_basis_functions)

    # K7a: Cartesian AO values and gradients
    def kernel_ao():
        return grid.ao_on_grid(basis, points, True)

    def plain_ao():
        return grid._ao_on_grid_plain(basis, points, True)

    (values, grads), (values_p, grads_p) = kernel_ao(), plain_ao()
    require(bool(torch.all(torch.isfinite(values)) and torch.all(torch.isfinite(grads))),
            "ao_on_grid: non-finite values")
    err_ao = max(float(torch.max(torch.abs(values - values_p))),
                 float(torch.max(torch.abs(grads - grads_p))))
    require(err_ao <= GRID_TOLERANCE, f"ao_on_grid off its plain version by {err_ao:.3e}")
    del values_p, grads_p
    record["ao_on_grid"] = {
        "max_abs_err": err_ao, "ms": median_ms(kernel_ao), "plain_ms": median_ms(plain_ao),
        "library_ms": None,
        **bound(tensor_bytes(points, values, grads)
                + tensor_bytes(*basis.tensors(device).values()),
                ao_on_grid_operations(basis, G, True) / FP64_PER_MS)}

    # K7b: density and gradient from a seeded symmetric P, spherical AOs
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    bfs = (U @ values).contiguous()
    bf_grads = torch.matmul(U, grads).contiguous()
    del values, grads
    n = bfs.shape[0]
    rng = np.random.default_rng(11)
    A = rng.standard_normal((n, n))
    P = torch.as_tensor((A + A.T) / (2 * n), dtype=torch.float64, device=device)

    def kernel_rho():
        return grid.density_on_grid(P, bfs, bf_grads)

    def plain_rho():
        return grid._density_on_grid_plain(P, bfs, bf_grads)

    def library_rho():
        return torch.einsum("ij,ik,jk->k", P, bfs, bfs)

    (rho, grad_rho), (rho_p, grad_rho_p) = kernel_rho(), plain_rho()
    err_rho = max(float(torch.max(torch.abs(rho - rho_p))),
                  float(torch.max(torch.abs(grad_rho - grad_rho_p))),
                  float(torch.max(torch.abs(library_rho() - rho))))
    require(err_rho <= GRID_TOLERANCE, f"density_on_grid off its plain version by {err_rho:.3e}")
    rho_only_ms = median_ms(lambda: grid.density_on_grid(P, bfs))
    record["density_on_grid"] = {
        "max_abs_err": err_rho, "ms": median_ms(kernel_rho), "plain_ms": median_ms(plain_rho),
        "library_ms": median_ms(library_rho),
        **bound(tensor_bytes(P, bfs, bf_grads, rho, grad_rho), density_ms(n, G, True))}

    # K6: the active points of the converged density of the DFT path
    density, gradient = grid.density_on_grid(P_converged, bfs, bf_grads)
    density = torch.clamp(density, min=1e-23)
    sigma = torch.sum(gradient * gradient, dim=0)
    mask = density > 1e-10
    active = (density[mask], weights[mask], sigma[mask], points.T[mask].contiguous())
    M = int(active[0].shape[0])
    functional = calculation.functional
    b, C = functional.VV10_b, functional.VV10_C

    def kernel_vv10():
        return vv10.vv10_energy(*active, b, C)

    def plain_vv10():
        return vv10._vv10_pair_sum_plain(active[3], *vv10._vv10_point_terms(*active[:3], b, C))

    e_kernel, e_plain = float(kernel_vv10()), float(plain_vv10())
    plain_ms = median_ms(plain_vv10, repeats=1)
    err_vv10 = abs(e_kernel - e_plain)
    require(np.isfinite(e_kernel) and err_vv10 <= VV10_TOLERANCE * abs(e_plain),
            f"vv10_energy off its plain version by {err_vv10:.3e} (E {e_kernel!r})")
    require(torch.equal(kernel_vv10(), kernel_vv10()), "two vv10_energy calls differ")
    needed, old_count = vv10_operations(M)
    vv10_bound = bound(6 * 8 * M, needed / FP64_PER_MS)
    record["vv10_energy"] = {
        "max_abs_err": err_vv10, "ms": median_ms(kernel_vv10), "plain_ms": plain_ms,
        "library_ms": None, **vv10_bound}
    return (f"DFT kernels: N2/{molecule.basis}, {n} spherical AOs ({basis.n_ao} Cartesian), {G} grid "
            f"points, {M} VV10 points; ao_on_grid max|diff| {err_ao:.3e} "
            f"({record['ao_on_grid']['ms']:.4f} ms vs plain {record['ao_on_grid']['plain_ms']:.4f} ms); "
            f"density_on_grid max|diff| {err_rho:.3e} ({record['density_on_grid']['ms']:.4f} ms, "
            f"rho only {rho_only_ms:.4f} ms, vs plain {record['density_on_grid']['plain_ms']:.4f} ms, "
            f"einsum (rho only) {record['density_on_grid']['library_ms']:.4f} ms); "
            f"vv10_energy E {e_kernel!r}, |diff| {err_vv10:.3e}, two calls bitwise equal "
            f"({record['vv10_energy']['ms']:.4f} ms vs plain {plain_ms:.4f} ms, one run; bound "
            f"{vv10_bound['bound_ms']:.5f} ms by {vv10_bound['bound_by']} over the M (M + 1) / 2 "
            f"pairs of the symmetric half, {old_count / FP64_PER_MS:.5f} ms over all M^2)")


# ---------------------------------------------------------------------------
# Phases 7 and 8: K4 and K5 at the DIRECT path's shapes, the DIRECT path
# ---------------------------------------------------------------------------

def _relative(a, b) -> float:
    """max |a - b| over the largest |b|."""
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def check_fock_direct(basis: str, device, record: dict) -> str:
    molecule = diatomic("N", 1.1, basis)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    N = plan.n_basis
    C = np.random.default_rng(13).standard_normal((N, 7)) / np.sqrt(N)
    P = torch.as_tensor(C @ C.T, dtype=torch.float64, device=device)  # density-like

    def kernel():
        return plan.fock_direct(coords, P)

    def plain():
        return plan._fock_direct_plain(coords, P)

    def kernel_eri():
        return plan.eri_pair_packed(coords)

    (J, K), (J2, K2), (J_p, K_p) = kernel(), kernel(), plain()
    require(bool(torch.all(torch.isfinite(J)) and torch.all(torch.isfinite(K))),
            f"{basis}: non-finite J or K")
    err = max(_relative(J, J_p), _relative(K, K_p))
    repeat = max(_relative(J2, J), _relative(K2, K))
    torch.cuda.synchronize()
    require(err <= FOCK_TOLERANCE, f"{basis}: fock_direct off its plain version by {err:.3e}")
    require(repeat <= FOCK_TOLERANCE, f"{basis}: two fock_direct calls differ by {repeat:.3e}")
    require(torch.equal(kernel_eri(), kernel_eri()), f"{basis}: two ERI kernel calls differ")
    # K4 against K1 on one plan: 21 rounds that call them in turn
    ms, eri_ms = medians_ms((kernel, kernel_eri), repeats=21)
    plain_ms = median_ms(plain, repeats=1)
    t = plan.tensors(device)
    needed, algorithm = fock_direct_operations(plan)
    fock_bound = bound(eri_input_bytes(plan, coords)
                       + tensor_bytes(P, t["pid_i"], t["pid_j"], J, K), needed / FP64_PER_MS)
    entry = record.setdefault("fock_direct", {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               float(torch.max(torch.abs(J - J_p))),
                               float(torch.max(torch.abs(K - K_p))))
    if basis == "CC-PVTZ":
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, **fock_bound)
    return (f"kernels DIRECT {basis}: {work_list_summary(plan)}; fock_direct relative "
            f"max|diff| {err:.3e}, repeated call {repeat:.3e} ({ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms, bound {fock_bound['bound_ms']:.5f} ms by "
            f"{fock_bound['bound_by']}; the kernel's algorithm {algorithm / FP64_PER_MS:.5f} "
            f"ms); eri_packed on the same plan {eri_ms:.4f} ms, two "
            f"calls bitwise equal; fock_direct / eri_packed {ms / eri_ms:.3f}")


def check_mo_transform(device, record: dict) -> str:
    molecule = diatomic("N", 1.1, "CC-PVTZ")
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    G_pair = plan.eri_pair_packed(coords)
    pair_index = plan.tensors(device)["pair_index"]
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    n_mo = U.shape[0]
    rng = np.random.default_rng(17)

    def coefficients():   # W = U^T C for a seeded C
        C = torch.as_tensor(rng.standard_normal((n_mo, n_mo)) / np.sqrt(n_mo),
                            dtype=torch.float64, device=device)
        return (U.T @ C).contiguous()

    W, W_left, W_right = coefficients(), coefficients(), coefficients()
    tri = motransform.mo_pair_indices(n_mo)

    def plain(G, W_l, W_r):
        H = motransform._chunked_half_transform(G, pair_index, W_r, tri, 128)
        return motransform._chunked_half_transform(H.T, pair_index, W_l, tri, 128)

    def kernel():
        return motransform.pair_packed_to_mo(G_pair, pair_index, W, n_mo)

    def plain_same():
        return plain(G_pair, W, W)

    got, expected = kernel(), plain_same()
    mixed = motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo)
    mixed_expected = plain(G_pair, W_left, W_right).T
    require(bool(torch.all(torch.isfinite(got))), "mo_half_transform: non-finite output")
    err = max(_relative(got, expected), _relative(mixed, mixed_expected))

    # the cc-pV6Z shape: 64 rows of a random packed symmetric matrix, read
    # as rows and, transposed, as columns
    N6, n_mo6, rows6 = 252, 182, 64
    tril = np.tril_indices(N6)
    pidx6 = np.zeros((N6, N6), dtype=np.int64)
    pidx6[tril] = pidx6[tril[::-1]] = np.arange(len(tril[0]))
    pidx6 = torch.as_tensor(pidx6, device=device)
    M6 = torch.as_tensor(rng.random((rows6, len(tril[0]))), device=device)
    W6 = torch.as_tensor(rng.standard_normal((N6, n_mo6)) / np.sqrt(N6), device=device)
    expected6 = motransform._half_transform_plain(M6, pidx6, W6, motransform.mo_pair_indices(n_mo6))
    err6 = max(_relative(motransform.half_transform(M6, pidx6, W6), expected6),
               _relative(motransform.half_transform(M6.T.contiguous(), pidx6, W6,
                                                    transposed=True), expected6))
    torch.cuda.synchronize()
    require(err <= TRANSFORM_TOLERANCE,
            f"mo_half_transform off its plain version by {err:.3e} (relative)")
    require(err6 <= TRANSFORM_TOLERANCE,
            f"mo_half_transform at the cc-pV6Z shape off its plain version by {err6:.3e}")
    ms, plain_ms = median_ms(kernel), median_ms(plain_same)
    n_mo_pairs = n_mo * (n_mo + 1) // 2
    N = plan.n_basis
    H_bytes = 8 * plan.n_pairs * n_mo_pairs
    record["mo_half_transform"] = {
        "max_abs_err": max(float(torch.max(torch.abs(got - expected))),
                           float(torch.max(torch.abs(mixed - mixed_expected)))),
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        # two launches: G -> H, then H (read transposed) -> G_mo
        **bound(tensor_bytes(G_pair, got) + 2 * H_bytes + 2 * tensor_bytes(W, pair_index),
                (half_transform_operations(plan.n_pairs, N, n_mo)
                 + half_transform_operations(n_mo_pairs, N, n_mo)) / FP64_MMA_PER_MS)}
    return (f"kernels DIRECT: mo_half_transform N2/cc-pVTZ ({plan.n_pairs} AO pairs -> "
            f"{n_mo_pairs} MO pairs, both phases) relative max|diff| {err:.3e} (mixed "
            f"included), cc-pV6Z shape ({rows6} rows, N {N6}, n_mo {n_mo6}) {err6:.3e}; "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")


def check_direct_path() -> dict:
    """Phase 8: the DIRECT path against tuna_tpu and against the port's
    stored twin, then its profile; returns the DIRECT run's launches."""
    SCF_output, molecule, energy, P, wall, launches = drive(LINE_DIRECT, DIRECT_PATH_KERNELS)
    require(SCF_output.integrals.ERI_AO is None, f"{LINE_DIRECT}: the ERI tensor was stored")
    delta = energy - E_REF_DIRECT
    scf_seconds = SCF_output.iteration_seconds
    cc_seconds = SCF_output.correlation_iteration_seconds
    require(abs(delta) <= E_TOLERANCE,
            f"E_total {energy:.12f} is {delta:.3e} Ha from the reference {E_REF_DIRECT:.12f}")
    require((len(scf_seconds), len(cc_seconds)) == (SCF_ITERATIONS_DIRECT, CC_ITERATIONS_DIRECT),
            f"{len(scf_seconds)} SCF and {len(cc_seconds)} CCSD iterations, the reference "
            f"takes {SCF_ITERATIONS_DIRECT} and {CC_ITERATIONS_DIRECT}")
    print(f"end to end: {LINE_DIRECT}; E_total {energy!r}, E_total - E_ref {delta:.3e} Ha; "
          f"SCF {len(scf_seconds)} iterations, median "
          f"{statistics.median(scf_seconds) * 1e3:.3f} ms/iteration; CCSD {len(cc_seconds)} "
          f"iterations, median {statistics.median(cc_seconds) * 1e3:.3f} ms/iteration; "
          f"wall {wall:.3f} s; launches {launches}")
    stored, _, stored_energy, _, stored_wall, _ = drive(LINE_DIRECT_STORED, CC_PATH_KERNELS)
    require(stored.integrals.ERI_AO is not None, f"{LINE_DIRECT_STORED}: no stored tensor")
    require(abs(energy - stored_energy) <= DIRECT_TOLERANCE,
            f"DIRECT and stored differ by {energy - stored_energy:.3e} Ha")
    require((len(stored.iteration_seconds), len(stored.correlation_iteration_seconds))
            == (len(scf_seconds), len(cc_seconds)), "DIRECT and stored iteration counts differ")
    print(f"stored twin: {LINE_DIRECT_STORED}; E_total {stored_energy!r}, E_DIRECT - E_stored "
          f"{energy - stored_energy:.3e} Ha; SCF {len(stored.iteration_seconds)} iterations, "
          f"median {statistics.median(stored.iteration_seconds) * 1e3:.3f} ms/iteration; "
          f"CCSD median {statistics.median(stored.correlation_iteration_seconds) * 1e3:.3f} "
          f"ms/iteration; wall {stored_wall:.3f} s")
    print("profile: " + json.dumps(profile_path(LINE_DIRECT)))
    return launches


# ---------------------------------------------------------------------------
# K8a-K8c, the gradient paths, BASELINE configs 3 and 5
# ---------------------------------------------------------------------------

def check_gradient_integrals(symbol: str, partner: str, bond_angstrom: float, basis: str,
                             device, record: dict) -> str:
    """K8a and K8b against their plain versions on one molecule (atom 1
    moving, the origin at the centre of mass), K8b on a seeded density-like
    P and against a repeated call of itself (bitwise)."""
    molecule = diatomic(symbol, bond_angstrom, basis, partner)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=device)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    fraction = float(masses[1] / masses.sum())
    origin = fraction * molecule.bond_length
    N = plan.n_basis
    C = np.random.default_rng(13).standard_normal((N, 7)) / np.sqrt(N)
    P = torch.as_tensor(C @ C.T, dtype=torch.float64, device=device)
    hfx = 0.2

    def kernel_1e():
        return plan.one_electron_deriv(coords, charges, origin, fraction)

    def plain_1e():
        return plan._one_electron_deriv_plain(coords, charges, origin, fraction)

    def kernel_2e():
        return plan.eri_deriv_energy(coords, P, hfx)

    def plain_2e():
        return plan._eri_deriv_energy_plain(coords, P, hfx)

    err_1e = max(float(torch.max(torch.abs(k - p))) for k, p in zip(kernel_1e(), plain_1e()))
    e_kernel, e_again, e_plain = kernel_2e(), kernel_2e(), plain_2e()
    torch.cuda.synchronize()
    err_2e = abs(float(e_kernel - e_plain))
    require(bool(torch.isfinite(e_kernel)), f"{basis}: non-finite two-electron tangent")
    require(err_1e <= INTEGRAL_TOLERANCE,
            f"{basis}: one_electron_deriv off its plain version by {err_1e:.3e}")
    require(err_2e <= INTEGRAL_TOLERANCE,
            f"{basis}: eri_deriv_energy off its plain version by {err_2e:.3e}")
    require(torch.equal(e_kernel, e_again), f"{basis}: two eri_deriv_energy calls differ")
    ms_1e, ms_1e_plain = median_ms(kernel_1e), median_ms(plain_1e)
    ms_2e, ms_2e_plain = median_ms(kernel_2e), median_ms(plain_2e, repeats=1)
    t = plan.tensors(device)
    one_electron_bound = bound(
        tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"],
                     t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"],
                     t["boys_one_electron_deriv"]) + 8 * 9 * N * N,
        one_electron_deriv_operations(plan) / FP64_PER_MS)
    needed, algorithm = eri_operations(plan, derivative=True)
    eri_bound = bound(eri_input_bytes(plan, coords) + tensor_bytes(P, t["pid_i"], t["pid_j"]) + 8,
                      needed / FP64_PER_MS)
    for name, err in (("one_electron_deriv", err_1e), ("eri_deriv_energy", err_2e)):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if basis == "CC-PVTZ" and partner is None:
        record["one_electron_deriv"].update(ms=ms_1e, plain_ms=ms_1e_plain, library_ms=None,
                                            **one_electron_bound)
        record["eri_deriv_energy"].update(ms=ms_2e, plain_ms=ms_2e_plain, library_ms=None,
                                          **eri_bound)
    return (f"gradient kernels {symbol}{partner or symbol}/{basis}: one_electron_deriv "
            f"max|diff| {err_1e:.3e} ({ms_1e:.4f} ms vs plain {ms_1e_plain:.4f} ms, bound "
            f"{one_electron_bound['bound_ms']:.5f} ms by {one_electron_bound['bound_by']}); "
            f"eri_deriv_energy dE/dR {float(e_kernel)!r}, |diff| {err_2e:.3e}, two calls bitwise "
            f"equal ({ms_2e:.4f} ms vs plain {ms_2e_plain:.4f} ms, one run; bound "
            f"{eri_bound['bound_ms']:.5f} ms by {eri_bound['bound_by']}; {needed:.4g} "
            f"operations needed, {algorithm:.4g} in the kernel's algorithm, "
            f"{algorithm / FP64_PER_MS:.5f} ms)")


def check_density_deriv(molecule, P_converged, device, record: dict) -> str:
    """K8c against its plain version on the DFT path's grid (N2/cc-pVTZ,
    medium grid), atom 1's half of the points moving, with the converged
    density of that path in the Cartesian basis."""
    points_np, _ = grid.build_molecular_grid(
        *grid.grid_parameters(molecule, molecule.calculation), molecule.bond_length,
        molecule.atoms)
    G = points_np.shape[1] * points_np.shape[2]
    points = torch.as_tensor(points_np.reshape(3, G), dtype=torch.float64, device=device)
    basis = grid.GridBasis(molecule.cartesian_basis_functions)
    origin = torch.as_tensor(basis.origin, dtype=torch.float64, device=device)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32, device=device)
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    P = (U.T @ P_converged @ U).contiguous()

    def kernel():
        return grid.density_deriv_on_grid(basis, origin, moves, points, G // 2, P, True)

    def plain():
        return grid._density_deriv_on_grid_plain(basis, origin, moves, points, G // 2, P, True)

    got, expected = kernel(), plain()
    require(all(bool(torch.all(torch.isfinite(x))) for x in got),
            "density_deriv_on_grid: non-finite output")
    relative = max(_relative(a, b) for a, b in zip(got, expected))
    absolute = max(float(torch.max(torch.abs(a - b))) for a, b in zip(got, expected))
    require(relative <= DERIV_GRID_TOLERANCE,
            f"density_deriv_on_grid off its plain version by {relative:.3e} (relative)")
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    deriv_bound = bound(tensor_bytes(points, origin, moves, P, *got)
                        + tensor_bytes(*basis.tensors(device).values()),
                        density_deriv_ms(basis, G, True))
    record["density_deriv_on_grid"] = {"max_abs_err": absolute, "ms": ms, "plain_ms": plain_ms,
                                       "library_ms": None, **deriv_bound}
    names = ("rho", "grad rho", "rho'", "grad rho'")
    scales = ", ".join(f"{name} {float(torch.max(torch.abs(x))):.4g}"
                       for name, x in zip(names, expected))
    return (f"gradient kernels: density_deriv_on_grid {'-'.join(molecule.atomic_symbols)}/"
            f"{molecule.basis}, {basis.n_ao} Cartesian "
            f"AOs, {G} points ({G // 2} moving), converged P; relative max|diff| {relative:.3e}, "
            f"absolute {absolute:.3e} (largest |entry|: {scales}); {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms, bound {deriv_bound['bound_ms']:.5f} ms by "
            f"{deriv_bound['bound_by']}")


def profile_gradient_path(line: str) -> dict:
    """WARM_RUNS warm runs of an OPT line (the wall per OPT iteration and
    the gradient's share of it, from the port's phase timers; one analytic
    gradient, so one K8a launch, an iteration), then one under
    torch.profiler."""
    walls, per_iteration, gradient_ms, shares, phases = [], [], [], [], {}
    for _ in range(WARM_RUNS):
        _, wall, launches = run_counted(line, ())
        iterations = launches["one_electron_deriv"]
        table = dict(output.timer_table())
        walls.append(wall)
        per_iteration.append(wall / iterations * 1e3)
        gradient_ms.append(table["Gradient"] / iterations * 1e3)
        shares.append(table["Gradient"] / wall)
        for name, seconds in table.items():
            phases.setdefault(name, []).append(seconds * 1e3)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return {
        "line": line,
        "iterations": iterations,
        "warm_wall_s": {"median": statistics.median(walls), "q1": q1, "q3": q3},
        "wall_ms_per_opt_iteration": statistics.median(per_iteration),
        "gradient_ms_per_opt_iteration": statistics.median(gradient_ms),
        "gradient_share_of_wall": statistics.median(shares),
        "phase_host_ms": {name: statistics.median(v) for name, v in phases.items()},
        **profiled_run(line),
    }


def check_optimisation(line: str, kernels: tuple, bond_ref: float, energy_ref: float,
                       iterations_ref: int) -> dict:
    (molecule, energy), wall, launches = run_counted(line, kernels)
    iterations = launches["one_electron_deriv"]   # one analytic gradient an iteration
    delta_bond = bohr_to_angstrom(molecule.bond_length - bond_ref)
    delta = energy - energy_ref
    require(abs(delta_bond) <= BOND_TOLERANCE,
            f"{line}: bond length {delta_bond:.3e} angstrom from the reference")
    require(abs(delta) <= E_TOLERANCE, f"{line}: energy {delta:.3e} Ha from the reference")
    require(iterations == iterations_ref,
            f"{line}: {iterations} iterations, the reference takes {iterations_ref}")
    gradient_s = dict(output.timer_table())["Gradient"]
    print(f"end to end: {line}; bond {bohr_to_angstrom(molecule.bond_length)!r} angstrom "
          f"({delta_bond:.3e} from the reference), E {energy!r} ({delta:.3e} Ha), {iterations} "
          f"iterations as the reference; wall {wall:.3f} s, gradients {gradient_s:.3f} s; "
          f"launches {launches}")
    return launches


def check_frequency(line: str, frequency_ref: float, zpe_ref: float) -> dict:
    result, wall, launches = run_counted(line, HF_GRADIENT_PATH_KERNELS)
    hessian, _, frequency, zpe = (float(x) for x in result)
    require(abs(frequency - frequency_ref) <= FREQUENCY_TOLERANCE,
            f"{line}: frequency {frequency - frequency_ref:.3e} per cm from the reference")
    require(abs(zpe - zpe_ref) <= E_TOLERANCE,
            f"{line}: zero-point energy {zpe - zpe_ref:.3e} Ha from the reference")
    print(f"end to end: {line}; force constant {hessian!r}, frequency {frequency!r} per cm "
          f"({frequency - frequency_ref:.3e} from the reference), ZPE {zpe!r} "
          f"({zpe - zpe_ref:.3e} Ha); wall {wall:.3f} s; launches {launches}")
    return launches


def check_gradient_paths() -> dict:
    """The gradient path at full width (OPT N2 B3LYP/cc-pVTZ with its
    profile, FREQ CO HF/cc-pVTZ) and BASELINE configs 3 and 5 (OPT H2
    B3LYP/6-31G, FREQ and MD of CO HF/6-31G), each against tuna_tpu's
    numbers; returns the launches summed over these runs."""
    runs = [check_optimisation(LINE_OPT, GRADIENT_PATH_KERNELS, BOND_REF_OPT, E_REF_OPT,
                               ITERATIONS_OPT)]
    print("profile: " + json.dumps(profile_gradient_path(LINE_OPT)))
    runs.append(check_frequency(LINE_FREQ, FREQUENCY_REF_FREQ, ZPE_REF_FREQ))
    runs.append(check_optimisation(LINE_OPT_H2, GRADIENT_PATH_KERNELS, BOND_REF_OPT_H2,
                                   E_REF_OPT_H2, ITERATIONS_OPT_H2))
    runs.append(check_frequency(LINE_FREQ_CO, FREQUENCY_REF_FREQ_CO, ZPE_REF_FREQ_CO))
    energies, wall, launches = run_counted(LINE_MD_CO, HF_GRADIENT_PATH_KERNELS)
    deltas = [e - ref for e, ref in zip(energies, E_REF_MD_CO)]
    require(len(energies) == len(E_REF_MD_CO) and max(map(abs, deltas)) <= E_TOLERANCE,
            f"{LINE_MD_CO}: step energies off the reference by {deltas}")
    print(f"end to end: {LINE_MD_CO}; {len(energies)} steps, largest |E - E_ref| "
          f"{max(map(abs, deltas)):.3e} Ha; wall {wall:.3f} s; launches {launches}")
    runs.append(launches)
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phases 12 and 13: K2u, the UHF paths
# ---------------------------------------------------------------------------

def u_triples_ms(no: int, nv: int) -> float:
    """ms of the spin-orbital (T) energy's float64 operations as K2u counts
    them over the unique i < j < k, a < b < c: stage A's X_ijk[a, (b < c)],
    3 (v + o) multiply-adds an element (2 C(o,3) v C(v,2) 3 (v + o)
    operations at the matrix-product rate), then per (triple, orbit) the
    connected term from three X values, the nine disconnected products, the
    denominator and the accumulation (30)."""
    triples = no * (no - 1) * (no - 2) / 6
    stage_a = 2.0 * triples * nv * nv * (nv - 1) / 2 * 3 * (nv + no)
    stage_b = 30.0 * triples * nv * (nv - 1) * (nv - 2) / 6
    return stage_a / FP64_MMA_PER_MS + stage_b / FP64_PER_MS


def u_triples_args(no: int, nv: int, device) -> tuple:
    """Seeded spin-orbital (T) inputs at o = no, v = nv: <oo||vv>, <vo||vv>,
    <ov||oo>, t1, t2, eps_o, eps_v, antisymmetric in each index pair as the
    path's are."""
    rng = np.random.default_rng(17)

    def pairs(x):
        x = x - x.swapaxes(0, 1) if x.shape[0] == x.shape[1] else x
        return x - x.swapaxes(2, 3)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=device)

    return (tensor(0.1 * pairs(rng.standard_normal((no, no, nv, nv)))),
            tensor(0.1 * pairs(rng.standard_normal((nv, no, nv, nv)))),
            tensor(0.1 * pairs(rng.standard_normal((no, nv, no, no)))),
            tensor(0.01 * rng.standard_normal((no, nv))),
            tensor(0.05 * pairs(rng.standard_normal((no, no, nv, nv)))),
            tensor(np.sort(rng.uniform(-15.0, -0.5, no))),
            tensor(np.sort(rng.uniform(0.3, 5.0, nv))))


def u_stage_a_library_ms(args) -> float:
    """Batched torch.matmul computing K2u's stage-A products, X_ijk[a, (b <
    c)] = [A_ijk | -A_jik | -A_kji] . [B_i ; B_j ; B_k] for every unique
    triple (one product per batch of the kernel's plan; the operands are
    built before the timing)."""
    g_oovv, g_vovv, g_ovoo, t1, t2 = args[:5]
    no, nv = t1.shape
    device = t1.device
    triples = torch.as_tensor(cc.unique_triples(no), dtype=torch.long, device=device)
    b, c = (torch.as_tensor(x, device=device) for x in np.triu_indices(nv, 1))
    left, right = [], []
    for (r, p, q), sign in cc._U_ORDERINGS:
        r, p, q = triples[:, r], triples[:, p], triples[:, q]
        left.append(sign * torch.cat([t2[p, q], -g_ovoo[:, :, p, q].permute(2, 1, 0)], dim=2))
        right.append(torch.cat([g_vovv[:, r][:, :, b, c].transpose(0, 1), t2[r][:, :, b, c]],
                               dim=1))
    A, B = torch.cat(left, dim=2), torch.cat(right, dim=1)
    del left, right
    batches = cc.u_triples_plan(no, nv, cc.U_TRIPLES_WORKSPACE_BYTES).tolist()
    ms = sum(medians_ms([lambda begin=begin, end=end: torch.matmul(A[begin:end], B[begin:end])
                         for begin, end in batches], 5))
    del A, B
    return ms


def check_u_triples(no: int, nv: int, device, record: dict, v_scale: float = 1.0) -> str:
    """K2u against its plain version at o = no, v = nv, bitwise over two
    calls, with its peak device memory a call (its device time a launch is
    in the UHF paths' profiles); the record keeps the largest error over
    the shapes, the times of the first shape checked (config A's, o = 16,
    v = 36) and every shape's measurements under `shapes`."""
    args = u_triples_args(no, nv, device)

    def kernel():
        return cc.uccsd_t_energy(*args, v_scale)

    def plain():
        return cc._uccsd_t_energy_plain(*args, v_scale)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    e_kernel = float(kernel())
    peak_bytes = torch.cuda.max_memory_allocated() - before
    e_plain = float(plain())
    err = abs(e_kernel - e_plain)
    require(np.isfinite(e_kernel), "spin-orbital (T) kernel returned a non-finite energy")
    require(err <= TRIPLES_TOLERANCE * abs(e_plain),
            f"spin-orbital (T) kernel off its plain version by {err:.3e} "
            f"(relative {err / abs(e_plain):.3e})")
    require(torch.equal(kernel(), kernel()), "two spin-orbital (T) kernel calls differ")
    ms, plain_ms = medians_ms((kernel, plain), 5)
    library_ms = u_stage_a_library_ms(args)
    u_bound = bound(tensor_bytes(*args), u_triples_ms(no, nv))
    entry = record.setdefault("uccsd_t_energy", {"max_abs_err": 0.0, "shapes": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if "ms" not in entry:
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **u_bound)
    entry["shapes"].append({"o": no, "v": nv, "v_scale": v_scale, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "max_abs_err": err, **u_bound,
                            "peak_bytes_a_call": peak_bytes})
    n_batches = len(cc.u_triples_plan(no, nv, cc.U_TRIPLES_WORKSPACE_BYTES))
    return (f"kernels spin-orbital (T): o {no}, v {nv}, v_scale {v_scale}; E {e_kernel:.15e}, "
            f"|diff| {err:.3e} (relative {err / abs(e_plain):.3e}), two calls bitwise equal; "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, stage A as batched torch.matmul "
            f"{library_ms:.4f} ms; bound {u_bound['bound_ms']:.5f} ms by "
            f"{u_bound['bound_by']}; {n_batches} batches, peak device memory a call "
            f"{peak_bytes} bytes (one o^3 v^3 tensor: {8 * no ** 3 * nv ** 3} bytes)")


class TriplesRecorder:
    """Wraps post.cc.uccsd_t_energy while a path runs, keeping the inputs
    and the energy of each call, so that the path's (T) can be held to
    K2u's plain version on the same tensors."""

    def __enter__(self):
        self.calls, self.original = [], cc.uccsd_t_energy

        def recording(*args):
            energy = self.original(*args)
            self.calls.append((args, energy))
            return energy

        cc.uccsd_t_energy = recording
        return self

    def __exit__(self, *exc):
        cc.uccsd_t_energy = self.original


def check_uhf_path(line: str, kernels: tuple, iterations_ref: tuple, E_scf_ref: float,
                   E_ref: float | None = None, E_ccsd_ref: float | None = None) -> tuple:
    """A UHF CC(T) line on the card against tuna_tpu's SCF energy and
    iteration counts and its total (or, where tuna_tpu's (T) does not fit
    the host, CCSD) energy, to UHF_TOLERANCE; the path's (T) against K2u's
    plain version on the path's own inputs.  Returns (energy, SCF output,
    launches)."""
    with TriplesRecorder() as recorder:
        SCF_output, _, energy, _, wall, launches = drive(line, kernels)
    require(len(recorder.calls) == 1, f"{line}: {len(recorder.calls)} (T) calls")
    args, E_T = recorder.calls[0]
    E_T = float(E_T)
    E_T_plain = float(cc._uccsd_t_energy_plain(*args))
    err_T = abs(E_T - E_T_plain)
    require(err_T <= TRIPLES_TOLERANCE * abs(E_T_plain),
            f"{line}: (T) {E_T!r} off its plain version by {err_T:.3e}")
    iterations = (len(SCF_output.iteration_seconds),
                  len(SCF_output.correlation_iteration_seconds))
    require(iterations[0] == iterations_ref[0] and abs(iterations[1] - iterations_ref[1]) <= 1,
            f"{line}: {iterations} SCF and CC iterations, the reference takes {iterations_ref}")
    deltas = {"E_SCF": SCF_output.energy - E_scf_ref}
    if E_ref is not None:
        deltas["E_total"] = energy - E_ref
    if E_ccsd_ref is not None:
        deltas["E_total - E_(T)"] = energy - E_T - E_ccsd_ref
    for name, delta in deltas.items():
        require(abs(delta) <= UHF_TOLERANCE, f"{line}: {name} {delta:.3e} Ha from the reference")
    print(f"end to end: {line}; E_total {energy!r}, E_(T) {E_T!r} (plain version "
          f"{E_T_plain!r}, relative {err_T / abs(E_T_plain):.3e}); from the reference: "
          + ", ".join(f"{name} {delta:.3e} Ha" for name, delta in deltas.items())
          + f"; SCF {iterations[0]} iterations, median "
          f"{statistics.median(SCF_output.iteration_seconds) * 1e3:.3f} ms/iteration; CC "
          f"{iterations[1]} iterations, median "
          f"{statistics.median(SCF_output.correlation_iteration_seconds) * 1e3:.3f} "
          f"ms/iteration; wall {wall:.3f} s; launches {launches}")
    return energy, SCF_output, launches


def check_uhf_twin(line: str, energy: float, SCF_output) -> None:
    """The stored twin of a DIRECT UHF line (or the DIRECT twin of a stored
    one): the same energy to DIRECT_TOLERANCE and the same iteration
    counts."""
    twin, _, twin_energy, _, wall, _ = drive(line, ())
    require((twin.integrals.ERI_AO is None) != (SCF_output.integrals.ERI_AO is None),
            f"{line}: not the other storage of its twin")
    require(abs(energy - twin_energy) <= DIRECT_TOLERANCE,
            f"{line}: DIRECT and stored differ by {energy - twin_energy:.3e} Ha")
    require((len(twin.iteration_seconds), len(twin.correlation_iteration_seconds))
            == (len(SCF_output.iteration_seconds),
                len(SCF_output.correlation_iteration_seconds)),
            f"{line}: DIRECT and stored iteration counts differ")
    print(f"twin: {line}; E_total {twin_energy!r}, difference {energy - twin_energy:.3e} Ha; "
          f"wall {wall:.3f} s")


def check_uhf_paths() -> dict:
    """Phase 13: the UHF paths with their profiles; returns the launches
    summed over the counted runs."""
    runs = []
    energy, scf, launches = check_uhf_path(LINE_UHF, UHF_PATH_KERNELS, ITERATIONS_UHF,
                                           E_SCF_REF_UHF, E_ref=E_REF_UHF)
    runs.append(launches)
    print("profile: " + json.dumps(profile_path(LINE_UHF)))
    direct_energy, direct_scf, launches = check_uhf_path(
        LINE_UHF_DIRECT, UHF_DIRECT_PATH_KERNELS, ITERATIONS_UHF, E_SCF_REF_UHF,
        E_ref=E_REF_UHF_DIRECT)
    require(direct_scf.integrals.ERI_AO is None, f"{LINE_UHF_DIRECT}: the ERI tensor was stored")
    require(abs(direct_energy - energy) <= DIRECT_TOLERANCE,
            f"{LINE_UHF_DIRECT}: DIRECT and stored differ by {direct_energy - energy:.3e} Ha")
    runs.append(launches)
    print("profile: " + json.dumps(profile_path(LINE_UHF_DIRECT)))
    _, _, launches = check_uhf_path(LINE_UHF_QCISD, UHF_PATH_KERNELS, ITERATIONS_UHF_QCISD,
                                    E_SCF_REF_UHF, E_ref=E_REF_UHF_QCISD)
    runs.append(launches)
    print("profile: " + json.dumps(profile_path(LINE_UHF_QCISD)))
    _, _, launches = check_uhf_path(LINE_UHF_OH, UHF_PATH_KERNELS, ITERATIONS_UHF_OH,
                                    E_SCF_REF_UHF_OH, E_ccsd_ref=E_CCSD_REF_UHF_OH)
    runs.append(launches)
    print("profile: " + json.dumps(profile_path(LINE_UHF_OH)))
    energy, scf, launches = check_uhf_path(LINE_UHF_TZ, UHF_DIRECT_PATH_KERNELS,
                                           ITERATIONS_UHF_TZ, E_SCF_REF_UHF_TZ,
                                           E_ccsd_ref=E_CCSD_REF_UHF_TZ)
    require(scf.integrals.ERI_AO is None, f"{LINE_UHF_TZ}: the ERI tensor was stored")
    runs.append(launches)
    check_uhf_twin(LINE_UHF_TZ_STORED, energy, scf)
    print("profile: " + json.dumps(profile_path(LINE_UHF_TZ)))
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# --compare: the coupled-cluster path's warm walls from another checkout
# ---------------------------------------------------------------------------

# Run in a fresh interpreter per package root; it needs nothing of the root
# but tuna_tpu_torch.cli.run, Output.{,correlation_}iteration_seconds,
# IntegralPlan.eri_pair_packed and .fock_direct, post.cc.ccsd_t_energy and
# dft.vv10.vv10_energy, which every checkout with the DIRECT path has.
_WALLS = """
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import tuna_tpu_torch
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops.integrals import IntegralPlan
from tuna_tpu_torch.post import cc
from tuna_tpu_torch.system import Molecule
runs, lines = int(sys.argv[2]), sys.argv[3:]


def warm(line):
    walls, scf_ms, cc_ms = [], [], []
    for i in range(runs + 1):
        start = time.perf_counter()
        out, _, energy, _ = run(line, suppress_output=True, device="cuda")
        torch.cuda.synchronize()
        if i:  # run 0 is cold
            walls.append(time.perf_counter() - start)
            scf_ms.append(1e3 * statistics.median(out.iteration_seconds))
            if out.correlation_iteration_seconds:
                cc_ms.append(1e3 * statistics.median(out.correlation_iteration_seconds))
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return {"energy": energy, "warm_wall_s": {"median": statistics.median(walls), "q1": q1,
                                              "q3": q3},
            "scf_ms_per_iteration": statistics.median(scf_ms),
            "cc_ms_per_iteration": statistics.median(cc_ms) if cc_ms else None,
            "iterations": [len(out.iteration_seconds), len(out.correlation_iteration_seconds)]}


def median_ms(fn):   # CUDA events, median of 10 after a warm-up
    fn()
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


paths = {line: warm(line) for line in lines}
# K1 and K4 alone at N2/cc-pVTZ (K4 on a seeded density-like P)
cfg = Config("SPE", lookup_method("HF"), 0.0, [], "CC-PVTZ", ["N", "N"], suppress_output=True)
mol = Molecule(["N", "N"], np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(1.1)]]), cfg)
plan = IntegralPlan(mol.cartesian_basis_functions, mol.n_atoms)
coords = torch.as_tensor(mol.coordinates, dtype=torch.float64, device="cuda")
C = np.random.default_rng(13).standard_normal((plan.n_basis, 7)) / np.sqrt(plan.n_basis)
P = torch.as_tensor(C @ C.T, dtype=torch.float64, device="cuda")   # density-like
# K2 alone at o = 7, v = 53 and K6 alone at M = 51,320, seeded
rng = np.random.default_rng(19)
no, nv, M = 7, 53, 51320
gpu = lambda x: torch.as_tensor(x, dtype=torch.float64, device="cuda")
triples = [gpu(s * rng.standard_normal(shape)) for s, shape in (
    (0.1, (no, no, nv, nv)), (0.1, (no, nv, nv, nv)), (0.1, (no, no, nv, no)), (0.01, (no, nv)),
    (0.05, (no, no, nv, nv)))]
triples += [gpu(np.sort(rng.uniform(-15.0, -0.5, no))), gpu(np.sort(rng.uniform(0.3, 5.0, nv)))]
density = 10.0 ** rng.uniform(-6, 1, M)
points = [gpu(density), gpu(rng.uniform(0.0, 0.05, M)),
          gpu(density ** (8 / 3) * rng.uniform(0.0, 4.0, M)), gpu(rng.uniform(-8.0, 8.0, (M, 3)))]
print(json.dumps({"root": sys.argv[1], "package": tuna_tpu_torch.__file__,
                  "paths": paths,
                  "eri_packed_cc_pvtz_ms": median_ms(lambda: plan.eri_pair_packed(coords)),
                  "fock_direct_cc_pvtz_ms": median_ms(lambda: plan.fock_direct(coords, P)),
                  "ccsd_t_energy_o7_v53_ms": median_ms(lambda: cc.ccsd_t_energy(*triples)),
                  "ccsd_t_energy_o7_v53": float(cc.ccsd_t_energy(*triples)),
                  "vv10_energy_m51320_ms": median_ms(lambda: vv10.vv10_energy(*points, 6.0,
                                                                             0.01)),
                  "vv10_energy_m51320": float(vv10.vv10_energy(*points, 6.0, 0.01))}))
"""


def compare(roots) -> int:
    for root in roots:
        result = subprocess.run([sys.executable, "-c", _WALLS, str(pathlib.Path(root).resolve()),
                                 str(WARM_RUNS), LINE, LINE_DFT, LINE_DIRECT], cwd=root,
                                capture_output=True, text=True, timeout=600)
        if result.returncode != 0:
            print(result.stderr[-4000:], file=sys.stderr)
            return result.returncode
        print("compare: " + result.stdout.strip().splitlines()[-1])
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare", nargs="+", metavar="ROOT")
    args = parser.parse_args()
    # --- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import scipy
    import scipy.integrate

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if args.compare:
        return compare(args.compare)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"scipy {scipy.__version__} (lebedev_rule: "
          f"{hasattr(scipy.integrate, 'lebedev_rule')}), "
          f"tuna_tpu_torch {tuna_tpu_torch.__version__}")

    # --- 2. build -----------------------------------------------------------
    start = time.perf_counter()
    library = _kernels.build()
    _kernels.library()
    registers = ptxas_report(library.with_suffix(".log").read_text())
    print(f"build: {library.name} in {time.perf_counter() - start:.1f} s; {len(registers)} "
          f"kernels; registers (ptxas): {json.dumps(registers)}")

    # --- 3. K1-K3 against their plain versions -------------------------------
    record: dict = {}
    for basis in ("6-311G", "STO-3G", "6-31G**", "CC-PVTZ"):
        print(check_integrals(basis, device, record))
    print(check_triples(7, 19, device, record))

    # --- 4. coupled-cluster path ---------------------------------------------
    SCF_output, molecule, energy, P, wall, launches = drive(LINE, CC_PATH_KERNELS)
    delta = energy - E_REF
    scf_seconds = SCF_output.iteration_seconds
    cc_seconds = SCF_output.correlation_iteration_seconds
    require(abs(delta) <= E_TOLERANCE,
            f"E_total {energy:.12f} is {delta:.3e} Ha from the reference {E_REF:.12f}")
    print(f"end to end: {LINE}; E_total {energy!r}, E_total - E_ref {delta:.3e} Ha; "
          f"SCF {len(scf_seconds)} iterations, median {statistics.median(scf_seconds) * 1e3:.3f} "
          f"ms/iteration; CCSD {len(cc_seconds)} iterations, median "
          f"{statistics.median(cc_seconds) * 1e3:.3f} ms/iteration; wall {wall:.3f} s; "
          f"launches {launches}")
    cc_launches = launches
    print("profile: " + json.dumps(profile_path(LINE)))

    # --- 5. DFT path ----------------------------------------------------------
    SCF_output, molecule, energy, P, wall, launches = drive(LINE_DFT, DFT_PATH_KERNELS)
    delta = energy - E_REF_DFT
    scf_seconds = SCF_output.iteration_seconds
    require(abs(delta) <= E_TOLERANCE,
            f"E_total {energy:.12f} is {delta:.3e} Ha from the reference {E_REF_DFT:.12f}")
    require(len(scf_seconds) == SCF_ITERATIONS_DFT,
            f"{len(scf_seconds)} SCF iterations, the reference takes {SCF_ITERATIONS_DFT}")
    extent, n_radial, order = grid.grid_parameters(molecule, molecule.calculation)
    print(f"end to end: {LINE_DFT}; E_total {energy!r}, E_total - E_ref {delta:.3e} Ha; "
          f"grid {2 * n_radial} x {SCF_output.density.numel() // (2 * n_radial)} = "
          f"{SCF_output.density.numel()} points (Lebedev order {order}); "
          f"E_VV10 {SCF_output.dispersion_energy!r}; SCF {len(scf_seconds)} iterations, "
          f"median {statistics.median(scf_seconds) * 1e3:.3f} ms/iteration; "
          f"wall {wall:.3f} s; launches {launches}")
    # each kernel's launches over the paths' runs
    path_launches = {name: cc_launches[name] + launches[name] for name in KERNELS}
    print("profile: " + json.dumps(profile_path(LINE_DFT)))

    # --- 6. DFT kernels against their plain versions --------------------------
    print(check_dft_kernels(molecule, P, device, record))
    print(check_density_deriv(molecule, P, device, record))

    # --- 7. DIRECT kernels against their plain versions -----------------------
    for basis in ("CC-PVTZ", "6-311G"):
        print(check_fock_direct(basis, device, record))
    print(check_mo_transform(device, record))
    print(check_triples(7, 53, device, record))   # K2 at the DIRECT path's shape

    # --- 8. DIRECT path ---------------------------------------------------------
    launches = check_direct_path()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 9. gradient kernels against their plain versions ---------------------
    for symbol, partner, bond_angstrom, basis in (("N", None, 1.1, "CC-PVTZ"),
                                                  ("C", "O", 1.13, "6-31G")):
        print(check_gradient_integrals(symbol, partner, bond_angstrom, basis, device, record))

    # --- 10 and 11. gradient paths, BASELINE configs 3 and 5 --------------------
    launches = check_gradient_paths()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 12. the spin-orbital (T) kernel against its plain version -----------
    for no, nv, v_scale in ((16, 36, 1.0), (16, 36, 2.0), (9, 79, 1.0), (16, 104, 1.0)):
        print(check_u_triples(no, nv, device, record, v_scale))

    # --- 13. UHF paths ---------------------------------------------------------
    launches = check_uhf_paths()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], **record[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

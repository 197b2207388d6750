"""Smoke test of the PyTorch/CUDA port (tuna_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT [ROOT ...]

Phases, one line each (a phase that fails raises, and the script exits
non-zero without printing a result):

  1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
     scipy versions; a visible CUDA device is required;
  2. build: compiles the CUDA kernels of tuna_tpu_torch/csrc with nvcc;
  3. kernels: K1-K3 against their plain PyTorch versions on the card, on the
     same inputs at the coupled-cluster path's shapes (N2/6-311G and
     N2/STO-3G for the integrals, o = 7 and v = 19 for (T)), with both times;
  4. coupled-cluster path: `SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF`
     through tuna_tpu_torch.cli.run on the card, held against tuna_tpu's
     energy on the JAX CPU backend, with the launch count of each kernel;
     then its profile (below);
  5. DFT path: `SPE : N N 1.1 : B3LYP CC-PVTZ : NL TIGHTSCF` the same way,
     with its SCF iteration count, and its profile;
  6. DFT kernels: K7a, K7b and K6 against their plain versions at the DFT
     path's shapes (N2/cc-pVTZ on the medium grid; K6 on the active points
     of the converged density of phase 5).

Each path's launch counts are read from zero: the counts are reset just
before the path runs and read just after, so launches made to compare a
kernel with its plain version do not count.  Each kernel's record carries
`bound_ms`, the least time the card could take for the same work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its float64 operations, counted from the kernel's loop body
at this run's inputs, over 34 TFLOP/s (the H100 SXM data sheet's float64
rate outside the tensor cores).  exp, sqrt and a division count as one
operation each, so the bound is a lower bound.

A path's profile, printed as one `profile` JSON line, comes from
WARM_RUNS more runs after the counted one (host clock, each ending in a
device sync: wall median and quartiles, the medians of SCF and CC ms per
iteration, and the medians of the port's phase timers) and one run under
torch.profiler (device busy time as the union of the kernel intervals, the
device idle share, kernel and cudaLaunchKernel counts, the device time
of the top kernels, and the launches and device time of each kernel of
csrc/).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

--compare times the coupled-cluster path alone, WARM_RUNS warm runs after a
cold one, with the tuna_tpu_torch of each ROOT in turn (each in its own
interpreter, building its own kernels), and prints one JSON line for each:
two checkouts, say a parent commit and this one, compared on one card in
one call (run them in the order A B B A).
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
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops.integrals import IntegralPlan
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
E_TOLERANCE = 1e-8          # Ha, the BASELINE contract
INTEGRAL_TOLERANCE = 1e-12  # absolute, kernel against plain version
TRIPLES_TOLERANCE = 1e-12   # relative, kernel against plain version
GRID_TOLERANCE = 1e-12      # absolute, AO values and density on the grid
VV10_TOLERANCE = 1e-12      # relative, VV10 energy

WARM_RUNS = 9                  # warm runs of a path, for its profile and --compare

BYTES_PER_MS = 3.35e12 / 1e3   # H100 SXM device memory
FP64_PER_MS = 34e12 / 1e3      # float64 outside the tensor cores

KERNELS = {
    "eri_packed": ("tuna_tpu_torch/csrc/eri.cu", "tuna_tpu/ops/integrals.py:470"),
    "one_electron": ("tuna_tpu_torch/csrc/one_electron.cu", "tuna_tpu/ops/integrals.py:332"),
    "ccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t.cu", "tuna_tpu/post/cc.py:1741"),
    "ao_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu", "tuna_tpu/dft/grid.py:80"),
    "density_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu", "tuna_tpu/dft/grid.py:137"),
    "vv10_energy": ("tuna_tpu_torch/csrc/vv10.cu", "tuna_tpu/dft/vv10.py:26"),
}
CC_PATH_KERNELS = ("eri_packed", "one_electron", "ccsd_t_energy")
DFT_PATH_KERNELS = ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid",
                    "vv10_energy")


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


def bound(n_bytes: float, ops_ms: float) -> dict:
    """bound_ms and bound_by from a byte count and an operation time."""
    bytes_ms = n_bytes / BYTES_PER_MS
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def diatomic(symbol: str, bond_angstrom: float, basis: str) -> Molecule:
    calculation = Config("SPE", lookup_method("HF"), 0.0, [], basis, [symbol, symbol],
                         suppress_output=True)
    coordinates = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(bond_angstrom)]])
    return Molecule([symbol, symbol], coordinates, calculation)


# ---------------------------------------------------------------------------
# Operation counts, from each kernel's loop body
# ---------------------------------------------------------------------------

def eri_operations(plan: IntegralPlan) -> float:
    """csrc/eri.cu: the primitive quartets of every unordered AO-pair
    quartet with matching x/y parities, times the work of one: the Hermite
    products, axy, alpha and T, the Boys evaluation, the Hermite Coulomb
    table and the prefactor (pair_rows_kernel, ~0.1% of it, is left out)."""
    L = plan.lmax
    TL, MX, NMAX = 2 * L + 1, 2 * L, 4 * L
    hermite = 2 * TL * TL + 4 * ((TL * TL + 1) // 2)
    axy = 3 * (MX + 1) ** 2
    boys = 23 + 4 * NMAX
    coulomb = 4 * (NMAX + 1) + 1 + 5 * NMAX * (NMAX + 1) // 2 + 2 * NMAX
    per_quartet = hermite + axy + 6 + boys + coulomb + 8
    start = plan.pair_start
    n_prim = np.diff(start).astype(np.float64)
    first = start[:-1]
    parity = (2 * ((plan.l1[first, 0] + plan.l2[first, 0]) & 1)
              + ((plan.l1[first, 1] + plan.l2[first, 1]) & 1))
    quartets = 0.0
    for cls in range(4):
        n = n_prim[parity == cls]
        quartets += (n.sum() ** 2 + (n * n).sum()) / 2   # unordered, P >= Q
    return quartets * per_quartet


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


def triples_operations(no: int, nv: int) -> float:
    """csrc/ccsd_t.cu: per (ijk, abc), six raw terms of nv + no
    multiply-adds and the weighting, disconnected term, denominator and
    accumulation."""
    return float(no ** 3 * nv ** 3 * (12 * (no + nv) + 26))


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


def density_operations(n: int, n_points: int, with_gradients: bool) -> float:
    """csrc/dft_grid.cu density_on_grid_kernel: per point, Y = P^T phi (2
    n^2), rho (2 n) and with gradients three more dot products (6 n) and
    their doubling (3)."""
    per_point = 2.0 * n * n + 2.0 * n + ((6.0 * n + 3) if with_gradients else 0.0)
    return n_points * per_point


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
        t = plan.tensors(device)
        inputs = [coords, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"], t["atom2"],
                  t["pair_start"]]
        N = plan.n_basis
        record["eri_packed"].update(
            ms=times["eri_packed"][0], plain_ms=times["eri_packed"][1], library_ms=None,
            **bound(tensor_bytes(*inputs, t["boys_eri"]) + 8 * plan.n_pairs ** 2,
                    eri_operations(plan) / FP64_PER_MS))
        record["one_electron"].update(
            ms=times["one_electron"][0], plain_ms=times["one_electron"][1], library_ms=None,
            **bound(tensor_bytes(*inputs, charges, t["ao_i"], t["ao_j"],
                                 t["boys_one_electron"]) + 8 * 9 * N * N,
                    one_electron_operations(plan) / FP64_PER_MS))
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
    record["ccsd_t_energy"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        **bound(tensor_bytes(*args) + 8 * nv ** 3, triples_operations(no, nv) / FP64_PER_MS)}
    return (f"kernels (T): o {no}, v {nv}; E {e_kernel:.15e}, |diff| {err:.3e} "
            f"(relative {err / abs(e_plain):.3e}); {ms:.4f} ms vs plain {plain_ms:.4f} ms")


# ---------------------------------------------------------------------------
# Phases 4 and 5: the two paths end to end
# ---------------------------------------------------------------------------

def drive(line: str, kernels: tuple):
    """Run `line` on the card with the launch counts read from zero; every
    kernel of `kernels` must have launched."""
    output.reset_timers()
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    SCF_output, molecule, energy, P = run(line, suppress_output=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(_kernels.launches)
    for name in kernels:
        require(launches[name] > 0, f"kernel {name} was not launched on the path {line!r}")
    n = molecule.n_basis
    require(np.isfinite(energy), f"{line}: non-finite total energy")
    require(tuple(P.shape) == (n, n) and bool(torch.all(torch.isfinite(P))),
            f"{line}: density matrix has the wrong shape or non-finite entries")
    require(tuple(SCF_output.molecular_orbitals.shape) == (n, n), f"{line}: MO matrix shape")
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

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        _, _, _, _, profiled_wall, _ = drive(line, ())
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    launch_calls = [e for e in events if e.name == "cudaLaunchKernel"]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    hand: dict = {}  # the kernels of csrc/, by their function name
    for e in kernels:
        match = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", e.name)
        if match:
            entry = hand.setdefault(match.group(1), {"launches": 0, "device_ms": 0.0})
            entry["launches"] += 1
            entry["device_ms"] += e.time_range.elapsed_us() / 1e3
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return {
        "line": line,
        "warm_wall_s": {"median": statistics.median(walls), "q1": q1, "q3": q3},
        "scf_ms_per_iteration": statistics.median(scf_ms),
        "cc_ms_per_iteration": statistics.median(cc_ms) if cc_ms else None,
        "phase_host_ms": {name: statistics.median(v) for name, v in phases.items()},
        "profiled_wall_s": profiled_wall,
        "device_kernels": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / profiled_wall if kernels else "not measured",
        "cudaLaunchKernel_calls": len(launch_calls),
        "cudaLaunchKernel_host_ms": sum(e.cpu_time_total for e in launch_calls) / 1e3,
        "top_kernels_device_ms": {name[:90]: us / 1e3 for name, us in top_kernels},
        "hand_kernels": hand,
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
        **bound(tensor_bytes(P, bfs, bf_grads, rho, grad_rho),
                density_operations(n, G, True) / FP64_PER_MS)}

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
    record["vv10_energy"] = {
        "max_abs_err": err_vv10, "ms": median_ms(kernel_vv10), "plain_ms": plain_ms,
        "library_ms": None,
        **bound(6 * 8 * M, 18.0 * M * M / FP64_PER_MS)}
    return (f"DFT kernels: N2/{molecule.basis}, {n} spherical AOs ({basis.n_ao} Cartesian), {G} grid "
            f"points, {M} VV10 points; ao_on_grid max|diff| {err_ao:.3e} "
            f"({record['ao_on_grid']['ms']:.4f} ms vs plain {record['ao_on_grid']['plain_ms']:.4f} ms); "
            f"density_on_grid max|diff| {err_rho:.3e} ({record['density_on_grid']['ms']:.4f} ms, "
            f"rho only {rho_only_ms:.4f} ms, vs plain {record['density_on_grid']['plain_ms']:.4f} ms, "
            f"einsum (rho only) {record['density_on_grid']['library_ms']:.4f} ms); "
            f"vv10_energy E {e_kernel!r}, |diff| {err_vv10:.3e} "
            f"({record['vv10_energy']['ms']:.4f} ms vs plain {plain_ms:.4f} ms, one run)")


# ---------------------------------------------------------------------------
# --compare: the coupled-cluster path's warm walls from another checkout
# ---------------------------------------------------------------------------

# Run in a fresh interpreter per package root; it needs nothing of the root
# but tuna_tpu_torch.cli.run and Output.{,correlation_}iteration_seconds.
_WALLS = """
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import tuna_tpu_torch
from tuna_tpu_torch.cli import run
line, runs = sys.argv[2], int(sys.argv[3])
walls, scf_ms, cc_ms = [], [], []
for i in range(runs + 1):
    start = time.perf_counter()
    out, _, energy, _ = run(line, suppress_output=True, device="cuda")
    torch.cuda.synchronize()
    if i:  # run 0 is cold
        walls.append(time.perf_counter() - start)
        scf_ms.append(1e3 * statistics.median(out.iteration_seconds))
        cc_ms.append(1e3 * statistics.median(out.correlation_iteration_seconds))
q1, _, q3 = statistics.quantiles(walls, n=4)
print(json.dumps({"root": sys.argv[1], "package": tuna_tpu_torch.__file__, "energy": energy,
                  "warm_wall_s": {"median": statistics.median(walls), "q1": q1, "q3": q3},
                  "scf_ms_per_iteration": statistics.median(scf_ms),
                  "cc_ms_per_iteration": statistics.median(cc_ms),
                  "iterations": [len(out.iteration_seconds),
                                 len(out.correlation_iteration_seconds)]}))
"""


def compare(roots) -> int:
    for root in roots:
        result = subprocess.run([sys.executable, "-c", _WALLS, str(pathlib.Path(root).resolve()),
                                 LINE, str(WARM_RUNS)], cwd=root, capture_output=True,
                                text=True, timeout=600)
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
    report = library.with_suffix(".log").read_text().splitlines()
    usage = [line.split("ptxas info    : ")[-1] for line in report if "Used" in line]
    print(f"build: {library.name} in {time.perf_counter() - start:.1f} s; "
          f"ptxas: {' | '.join(usage)}")

    # --- 3. K1-K3 against their plain versions -------------------------------
    record: dict = {}
    for basis in ("6-311G", "STO-3G", "6-31G**", "CC-PVTZ"):
        print(check_integrals(basis, device, record))
    print(check_triples(device, record))

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
    # each kernel's launches over the two paths' runs
    path_launches = {name: cc_launches[name] + launches[name] for name in KERNELS}
    print("profile: " + json.dumps(profile_path(LINE_DFT)))

    # --- 6. DFT kernels against their plain versions --------------------------
    print(check_dft_kernels(molecule, P, device, record))

    kernels = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": path_launches[name], **record[name]}
               for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

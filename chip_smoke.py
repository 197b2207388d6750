"""Smoke test of the PyTorch/CUDA port (tuna_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare ROOT [ROOT ...]
    python3 chip_smoke.py --uks-spe-devices
    python3 chip_smoke.py --meta-gga-spe-devices

Phases, one line each (a phase that fails raises, and the script exits
non-zero without printing a result):

  1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
     scipy versions; a visible CUDA device is required;
  2. build: compiles the CUDA kernels of tuna_tpu_torch/csrc with nvcc, with
     the build time and the registers of each kernel (ptxas);
  3. kernels: K1-K3 against their plain PyTorch versions on the card, on the
     same inputs at the coupled-cluster path's shapes (N2/6-311G and
     N2/STO-3G for the integrals, o = 7 and v = 19 for (T)) and at 6-31G**
     and cc-pVTZ, with both times; K1 and K3 against a repeated call of
     themselves (bitwise), the quartet work list's classes, light/heavy
     split and kernels a call; K3's lane schedule (warps, longest chain),
     its device ms a launch (torch.profiler), and its registers and stack
     frames (ptxas; a spill fails the run);
  4. coupled-cluster path: `SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF`
     through tuna_tpu_torch.cli.run on the card, held against tuna_tpu's
     energy on the JAX CPU backend, with the launch count of each kernel;
     then its profile (below);
  5. DFT path: `SPE : N N 1.1 : B3LYP CC-PVTZ : NL TIGHTSCF` the same way,
     with its SCF iteration count, and its profile;
  6. DFT kernels: K7a, K7b and K6 against their plain versions at the DFT
     path's shapes (N2/cc-pVTZ on the medium grid; K6 on the active points
     of the converged density of phase 5, bitwise over two calls); K7b
     with and without gradients bitwise over two calls, its rho the same
     bits in both, with its device ms a launch (torch.profiler), its time
     at every tile the card holds (one and two column buffers), the bound
     of each and the registers (no spills);
  7. DIRECT kernels: K4 (the direct Fock build) against its plain version at
     N2/cc-pVTZ and N2/6-311G with a seeded density-like P, and against a
     repeated call of itself (its atomics sum in no fixed order), beside K1
     on the same plan (bitwise over two calls); K5 (the packed
     half-transform on DMMA) against its plain version at the DIRECT path's
     shapes, both variants, and on 64 rows at the cc-pV6Z shape (N = 252,
     n_mo = 182), where it runs in panels, bitwise over two calls, with its
     device ms a launch (torch.profiler), its registers (no spills) and its
     two phases' products as torch.matmul on the expanded rows for
     library_ms; K2 again at o = 7, v = 53 (both
     K2 shapes: bitwise over two calls, peak device memory a call, stage A's
     products as one batched torch.matmul for library_ms);
  8. DIRECT path: `SPE : N N 1.1 : CCSD[T] CC-PVTZ : DIRECT TIGHTSCF`, the
     N^4 tensor never stored, held against tuna_tpu's energy and iteration
     counts and against the port's stored twin (the same line without
     DIRECT, run once), then its profile;
  9. gradient kernels: K8a (one-electron tangent) and K8b (two-electron
     energy tangent) against their plain versions at N2/cc-pVTZ and
     CO/6-31G, both bitwise over two calls; K8a's lane schedule (warps,
     longest chain) and K8b's shell-quartet schedule (shell quartets,
     tasks, class kernels), their device ms a launch (torch.profiler),
     K8b's launches and host ms a call, and their registers and stack
     frames (ptxas; a spill or a missing instantiation fails the run); K8c (the
     density's tangent on the moving grid, on DMMA) at the DFT path's grid
     with its converged density, in phase 6: with and without gradients
     1e-12 of each output's largest |entry| from its plain version and
     bitwise over two calls, its time at every tile the card holds, its
     products alone as one batched torch.matmul, the bound and the
     registers (no spills);
 10. gradient path: `OPT : N N 1.1 : B3LYP CC-PVTZ : TIGHTSCF` (optimised
     bond length, energy and iteration count) and `FREQ : C O 1.13 : HF
     CC-PVTZ : TIGHTSCF` (frequency and zero-point energy) against
     tuna_tpu's numbers, with a profile of the OPT line (wall per OPT
     iteration and the gradient's share of it, K8c's device ms a launch),
     one K8c launch a gradient on the OPT lines;
 11. BASELINE.json configs 3 and 5: `OPT : H H 1.0 : B3LYP 6-31G`, `FREQ :
     C O 1.13 : HF 6-31G` and `MD : C O 1.13 : HF 6-31G : NUM 5 NOTRAJ`
     against tuna_tpu's numbers;
 12. spin-orbital (T) kernel: K2u against its plain version on seeded
     antisymmetric inputs at the UHF paths' shapes, (o, v) = (16, 36),
     (9, 79) and (16, 104), and with QCISD's disconnected scale 2 at (16,
     36): bitwise over two calls, peak device memory a call, each stage's
     device ms a call (torch.profiler), registers without a spill (ptxas),
     stage A's products as batched torch.matmul for library_ms;
 13. UHF paths: `SPE : O O 1.21 : CCSD(T) 6-311G : ML 3 TIGHTSCF` (triplet
     O2), stored and DIRECT; `SPE : O H 0.97 : CCSD(T) CC-PVTZ : ML 2
     TIGHTSCF` (OH radical, f shells); `SPE : O O 1.21 : CCSD(T) CC-PVTZ :
     ML 3 DIRECT TIGHTSCF` with its stored twin; `SPE : O O 1.21 :
     QCISD(T) 6-311G : ML 3 TIGHTSCF`; each against tuna_tpu's SCF and
     CC energies and iteration counts, its (T) against K2u's plain version
     on the path's own amplitudes and integrals, with its profile (K2u's
     device ms by stage on lines A and C);
 14. (Q) kernel: K9 against its plain version on seeded inputs at (o, v) =
     (7, 19) and (7, 53), E_MP5 and E_MP6 each: bitwise over five calls,
     peak device memory a call, each of its three kernels' device ms a call
     (torch.profiler), registers without a spill (ptxas), the v^5 products
     of its raw terms as batched torch.matmul for library_ms;
 15. (Q) path: `SPE : N N 1.1 : CCSDT(Q) 6-311G : TIGHTSCF` against
     tuna_tpu's SCF and CCSDT energies and iteration counts and its printed
     (Q) parts and total, its (Q) against K9's plain version on the path's
     own amplitudes and integrals, one K9 launch, with its profile (K9's
     device ms by kernel); then
     CCSDTQ, UCCSDT, UCISDT and CCSDT(Q) on a UHF reference on LiH/STO-3G
     against tuna_tpu's energies and iteration counts;
 16. batched VV10 kernel: K6b against its plain version on the active
     points of the 8 densities of `SCAN : N N 1.0 : B3LYP CC-PVTZ : NL NUM
     8 STEP 0.05` (1.00-1.35 angstrom) converged at EXTREMESCF in one
     batch, each on its own grid, 1e-12 relative an element, bitwise over
     two calls; and on a ragged batch of an empty element, 300 points and
     a whole one;
 17. batched scan: that line at TIGHTSCF, its 8 points through
     parallel.scan_points_parallel on the card (one K6b launch for the
     batch) against the port's serial SCAN through cli.run (1e-8 Ha a
     point, see SCAN_TOLERANCE; the 1.10 angstrom point 1e-8 Ha from
     E_REF_DFT), and at EXTREMESCF phase 16's batch against the serial
     SCAN (1e-10 Ha); `SCAN : O O 1.21 : HF 6-311G : ML 3 NUM 4 STEP 0.05
     TIGHTSCF` batched against serial (1e-8 Ha); and a `profile` line with
     both DFT walls (the counted runs', SCF iterations a point, and one run
     each of its first three points under torch.profiler);
 18. unrestricted gradient kernels: K8bu (the two-electron energy tangent
     with exchange per spin) against its plain version at O2/cc-pVTZ and
     OH/6-31G on a seeded pair of density-like Pa != Pb (1e-12 relative),
     bitwise over two calls, and at Pa = Pb = P/2 against K8b(P) (1e-14
     relative), its device ms a launch (torch.profiler) at O2/cc-pVTZ, and
     its registers and stack frames (no spill, no more registers than
     K8b's); K8cu (both spins' density tangents in one pass) on the
     grid of `SPE : O O 1.21 : B3LYP CC-PVTZ : ML 3 TIGHTSCF` with its
     converged Pa and Pb, checked and timed as K8c in phase 6, each spin
     bitwise equal to K8c on that density;
 19. unrestricted gradient paths: that single point (energy within 1e-10
     Ha, equal SCF iteration count), `OPT : O O 1.21 : B3LYP CC-PVTZ : ML
     3 TIGHTSCF` (UKS) with its `profile` line (wall per OPT iteration,
     the gradient's share, device busy time and idle share, K7b's, K8bu's
     and K8cu's launches and device ms), `OPT : O O 1.21 : HF CC-PVTZ : ML
     3 TIGHTSCF` (UHF), `FREQ : O H 0.97 : B3LYP CC-PVTZ : TIGHTSCF` (UKS,
     doublet OH) and `MD : O H 0.97 : HF 6-31G : NUM 5 NOTRAJ` (UHF)
     against tuna_tpu's numbers; one K8bu launch a gradient (and one K8cu
     launch on the UKS OPT), and no K8b or K8c launch on these paths;
 20. meta-GGA kernels: K7bt (rho, grad rho and tau, on DMMA) against its
     plain version on the grid of `SPE : N N 1.1 : R2SCAN CC-PVTZ :
     TIGHTSCF` with its converged density, K8ct (rho, grad rho, tau and
     their tangents, on DMMA) there too, and K8cut (both spins) on the grid
     of `SPE : O O 1.21 : TPSS CC-PVTZ : ML 3 TIGHTSCF` with its converged
     Pa and Pb: 1e-13 of each output's largest |entry|, bitwise over two
     calls; K7bt's rho and grad rho bitwise K7b's, the outputs of K8ct and
     K8cut without tau bitwise K8c's and K8cu's (one template), each spin
     of K8cut bitwise K8ct's;
     with the times (K7bt's device ms a launch from torch.profiler), K7bt's,
     K8ct's and K8cut's at every tile the card holds, the products alone as one
     batched torch.matmul, the bound and the registers (no spills);
 21. meta-GGA paths: those two single points (energy within 1e-8 Ha;
     the R2SCAN one with tuna_tpu's SCF iteration count and its `profile`
     line, the UKS TPSS one with the count of the same line run on the
     card with K3's plain version, and that run's energy within 1e-10 Ha),
     `SPE : N N 1.1 : B97M-V CC-PVTZ : TIGHTSCF` (tau and VV10), `OPT : N
     N 1.1 : R2SCAN CC-PVTZ : TIGHTSCF` (one K8ct launch a gradient, with
     its `profile` line) and `OPT : O O 1.21 : TPSS CC-PVTZ : ML 3
     TIGHTSCF` (UKS, one K8cut launch a gradient) against tuna_tpu's
     numbers, no K8c or K8cu launch on these paths; a 4-point TPSS/cc-pVTZ
     batch through parallel.scan_points_parallel against the serial SCAN
     (1e-8 Ha); then a `polish` line: SCF ms an iteration with the
     polished eigh the port runs and with the library's eigh in its place
     on the CCSD[T], DFT and UKS OPT lines (POLISH_RUNS warm runs a
     variant, in the order library, polished, polished, library);
 22. perturbation theory and double hybrids: BASELINE.json config 2,
     `SPE : N N 1.1 : MP2 6-31G`, as written and at TIGHTSCF; `SPE : N N
     1.1 : MP4 CC-PVTZ : TIGHTSCF` (its MP2, MP3 and MP4 parts each) with
     its `profile` line (phase timers "MP2", "MP3", "MP4") and peak device
     memory, and its DIRECT twin (K4 and K5) against it (DIRECT_TOLERANCE);
     `SPE : N N 1.1 : B2PLYP CC-PVTZ : TIGHTSCF`, `SPE : O O 1.21 : UMP3
     CC-PVTZ : ML 3 TIGHTSCF`, IMP2, LMP2 and OMP2 of N2 at 6-31G with
     their step counts, and `SPE : H F 1.733 : MP2 6-31G : RELAXED NATORBS
     TIGHTSCF` with the relaxed density's dipole moment and natural
     occupancies: each line's total energy and MP parts within
     MP_TOLERANCE of tuna_tpu's, with its SCF cycles and steps.
 23. the rest of restricted CC/CI and the last calculation types: `SPE :
     N N 1.1 : CC3 CC-PVTZ : TIGHTSCF` with its `profile` line and peak
     device memory, CC2 and QCISD(T) at cc-pVTZ (one K2 launch at QCISD's
     disconnected scale 2; the DIRECT twin, K4 and K5, against the stored
     line), LCCD, CCD, CEPA(0) and CID of N2 at 6-311G, `ANHARM : C O 1.13
     : HF CC-PVTZ`, `SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE
     POLAR HYPER TIGHTSCF`, `IP : C O 1.13 : CCSD(T) CC-PVDZ : VERTICAL`,
     `EA : F : CCSD(T) CC-PVTZ`, `BDE : H F 0.92 : MP2 CC-PVTZ : ZPE` and
     `SPE : N N 1.1 : CCSD(T) CC-PVDZ : EXTRAPOLATE TIGHTSCF`, each against
     tuna_tpu's numbers (REFERENCES_23): energies within
     PHASE_23_TOLERANCE, the SCF cycles of every SCF and the CC iterations
     of every solve equal, each (T) also against its kernel's plain
     version on the path's inputs, each finite-field property within what
     that tolerance allows through its stencil, ANHARM's levels and
     zero-point energy within ANHARM_TOLERANCE, its fundamental and chi
     (times the harmonic frequency) within 0.01 per cm, and its scans.
 24. excited states and SCF stability: `SPE : N N 1.1 : TDHF CC-PVTZ :
     TIGHTSCF` (Casida, singlets and triplets), `SPE : N N 1.1 : CIS(D)
     CC-PVTZ : TIGHTSCF`, `SPE : N N 1.1 : SVWN CC-PVTZ : TD TIGHTSCF`
     (TD-LDA: the XC kernels by nested autograd on the grid, K7a and K7b)
     with its `profile` line, peak device memory and K_XC build ms, the
     spin-orbital `SPE : O O 1.21 : CIS(D) CC-PVTZ : ML 3 TIGHTSCF` and
     `SPE : O O 1.21 : SVWN CC-PVTZ : ML 3 TD TIGHTSCF`, and STAB of N2 HF
     and O2 UHF at cc-pVTZ, each against tuna_tpu's numbers
     (REFERENCES_24): the total energy (E_SCF plus the root's excitation),
     the first NSTATES excitation energies, the (D) correction and each
     stability Hessian's lowest eigenvalue within EXCITED_TOLERANCE, the
     oscillator strengths within STRENGTH_TOLERANCE, the SCF cycles equal.
 25. g and h shells (lmax 4-5): K1, K3 and K4 against their plain
     versions on reduced plans of N2 (one s, f and g shell of cc-pVQZ on
     each atom; s, f, g and h of cc-pV5Z): K1 and K3 within
     INTEGRAL_TOLERANCE and bitwise over two calls, K4 within
     FOCK_TOLERANCE on a seeded density, each with its ms, device ms a
     launch, bound and plain ms; K4 at the full N2/cc-pV5Z (252 functions)
     against J and K formed from K1's 8.1 GB packed matrix, with the host's
     work list build; then `SPE : N N 1.1 : CCSD[T] CC-PVQZ : TIGHTSCF`
     (its (T) against K2's plain version), `SPE : N N 1.1 : HF CC-PVTZ :
     EXTRAPOLATE TIGHTSCF`, `SPE : N N 1.1 : B3LYP DEF2-QZVP : TIGHTSCF`,
     `SPE : H F 0.917 : HF CC-PV5Z : TIGHTSCF` and its DIRECT twin, and
     `SPE : N N 1.1 : HF CC-PV5Z : DIRECT TIGHTSCF` (its 32 GB N^4 tensor
     never formed), each run twice against tuna_tpu's numbers
     (REFERENCES_25, PHASE_25_TOLERANCE, equal SCF cycles and CC
     iterations; the last line's energy has no pin, see REFERENCES_25),
     with the first and warm walls, SCF ms an iteration, K1's and K4's ms
     a call and the peak device memory.  The build line names
     the registers and spills of the kernels added for lmax 4-5.
 26. analytic gradients at g and h shells (lmax 4-5): K8a, K8b and K8bu
     against their plain versions (INTEGRAL_TOLERANCE, bitwise over two
     calls; K8bu at Pa = Pb = P/2 against K8b(P)) on reduced H2 plans (a
     g shell of cc-pV5Z, the h shell of cc-pV6Z, each with an s shell on
     the other atom), whole N2/cc-pVQZ and HF/cc-pV5Z (K8b's and K8bu's
     plain versions contracting one dense tangent, 11.8 GB at HF/cc-pV5Z),
     with ms, device ms a call back to back, bounds, K8b's launches and
     host ms a call and the registers of K8a at lmax 4-5 and of K8b's
     classes (no spill); K8b at the whole N2/cc-pV5Z against the
     four-point central difference of E_2 from K1's packed matrix
     (DIFFERENCE_TOLERANCE), with the host's shell quartets; then `FORCE :
     N N 1.1 : HF CC-PVQZ`, `FORCE : O O 1.21 : UHF CC-PVQZ : ML 3`,
     `FORCE : N N 1.1 : B3LYP CC-PVQZ` and `FORCE : H F 0.917 : HF
     CC-PV5Z` at TIGHTSCF with no plain version allowed, each against
     tuna_tpu's energy and gradient (REFERENCES_26) and against the
     central difference of the card's own EXTREMESCF energies
     (GRADIENT_TOLERANCE), and `OPT : N N 1.1 : HF CC-PVQZ : TIGHTSCF`
     against tuna_tpu's bond length, energy and iterations, with its
     `profile` line.
 27. the correlated, finite-field and UKS batches of parallel.py, each
     line through cli.run as two shards on the card (two_shards: the
     drivers are shown two devices, both the card): `SCAN : N N 1.0 :
     CCSD(T) CC-PVTZ : NUM 6 STEP 0.04 TIGHTSCF` (one K2 launch a point),
     `SCAN : O O 1.16 : B3LYP CC-PVTZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF`
     (UKS), `SCAN : O O 1.11 : CCSD(T) CC-PVDZ : ML 3 NUM 4 STEP 0.05
     TIGHTSCF` (one K2u launch a point) and its MP2/cc-pVTZ twin, an MP2
     CBS scan from cc-pVDZ and a B2PLYP/cc-pVTZ scan, each point within
     1e-8 Ha of the serial walk of the same line at EXTREMESCF; `FORCE : N
     N 1.1 : CCSD(T) CC-PVTZ : TIGHTSCF` (its two displaced energies in
     one batch against the serial FORCE's at EXTREMESCF); phase 23's
     property line and `SPE : N N
     1.1 : B3LYP CC-PVTZ : NL POLAR TIGHTSCF` (one K6b launch for its field
     batch, K6b against its plain version on the batch's densities), each
     field point within 1e-10 Ha of tuna_tpu's field batch, the properties
     printed beside phase 23's serial ones; the pinned lines' energies and
     every SCF and CC solve of their batches against tuna_tpu's batch
     (REFERENCES_27), with the walls and launches of each run.

A device time read from torch.profiler fails the run when the kernel ran
and the profile has no entry for it.  A session records the launches of
the library's kernels (csrc/, launched through ctypes) only in part, the
fewer the shorter the session, and none in the sessions right after the
UKS OPT's long one (phase 20's K7bt measurement).  So device ms are a
recorded launch's, over 50 calls where the wrapper is timed alone, and a
session without any device event, or without one of the csrc/ kernels
whose time the caller reads from it (K2u's two stages were missed so
right after the gradient paths), is run again, a second later, up to
PROFILE_ATTEMPTS times.

Each path's launch counts are read from zero: the counts are reset just
before the path runs and read just after, so launches made to compare a
kernel with its plain version do not count.  Each kernel's record carries
`bound_ms`, the least time the card could take for the same work: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its float64 operations, counted from the kernel's loop body
at this run's inputs, or from what the function needs where the kernel
does more (K1, K4, K8b and K8bu: see eri_operations; K2: triples_ms; K6:
vv10_operations, K6b its sum over the batch; K9: quadruples_ms; the phase
lines print both counts),
over the H100 SXM data sheet's float64 rates: 67
TFLOP/s for the matrix products that the tensor cores can take (K5's two
products, K7b's P^T phi and K7bt's P^T d_a phi, K8's P phi, the
contractions of (T) and (Q)), 34 TFLOP/s for the rest.  exp, sqrt and a division count as one operation each, so the bound
is a lower bound.

A path's profile, printed as one `profile` JSON line, comes from
WARM_RUNS more runs after the counted one (host clock, each ending in a
device sync: wall median and quartiles, the medians of SCF and CC ms per
iteration, and the medians of the port's phase timers) and one run under
torch.profiler (device busy time as the union of the kernel intervals, the
device idle share, kernel and cudaLaunchKernel counts, the device time
of the top kernels, the launches and device time of each kernel of csrc/,
and for K1, K4, K8b and K8bu the union of their kernels' intervals a call;
K8b's or K8bu's launched without any device time recorded fails the run).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

--compare times the three restricted paths, the (Q) path and UHF line C (O2
CCSD(T)/cc-pVTZ DIRECT), WARM_RUNS warm runs each after a cold one
(warm wall median and quartiles, SCF and CC ms per iteration, iteration
counts), then, CUDA events, median of 10 after a warm-up: K1 and K4 alone at
N2/cc-pVTZ (K4 on a seeded density), K2 alone at o = 7, v = 53 and K6 alone
at M = 51,320 points, both on seeded inputs through cc.ccsd_t_energy and
vv10.vv10_energy, with their energies; K5's two phases at N2/cc-pVTZ
(motransform.pair_packed_to_mo on the packed ERI matrix, a seeded W) beside
torch.matmul on the expanded rows, K7bt and K7b (with and without
gradients) on the N2/cc-pVTZ medium grid (a seeded density-like P), K3 and
K8a at N2/6-311G and N2/cc-pVTZ (K7b, K7bt, K3 and K8a also with their host
ms a call: 200 calls enqueued, the device left behind), and K8ct and K8c
there and K8cut and K8cu on O2's (atom 1's half moving, seeded densities),
each with a sum of its outputs; K8b at N2/cc-pVTZ, CO/6-31G and
O2/cc-pVTZ and K8bu at O2/cc-pVTZ on seeded densities (device ms a launch
from torch.profiler, ms and host ms a call, the value), and a SHA-256 of
K1's packed ERI at N2/6-311G and N2/cc-pVTZ; K9 at (o, v) =
(7, 19) and (7, 53) and K2u at the UHF lines A (16, 36) and C (16, 104)
on seeded inputs, with their energies; with the tuna_tpu_torch of each ROOT
in turn (each in its own interpreter, building its own kernels), and prints
one JSON line for each: two checkouts, say a parent commit and this one,
compared on one card in one call (run them in the order A B B A).  With
--kernels-only it times the kernels alone and leaves the paths out.

--uks-spe-devices runs phase 19's UKS single point on the card and on the
host's CPU and prints one JSON line: both distances from tuna_tpu's energy,
the two runs' SCF energies iterate by iterate, and each DIIS system's
condition number and the two runs' differences in it (spe_devices).
--meta-gga-spe-devices does the same for each of phase 21's three single
points, and --uks-td-devices for the SCF of phase 24's UKS TD line, with
that line run on the card with K7b's plain version (uks_td_devices).
"""

from __future__ import annotations

import argparse
import contextlib
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
from tuna_tpu_torch import _kernels, constants, output, parallel, props
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr, bohr_to_angstrom
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import motransform
from tuna_tpu_torch.ops.integrals import (HEAVY_THRESHOLD, KERNEL_MAX_LMAX, SHELL_TASK_THREADS,
                                          IntegralPlan, deriv_quartet_operations,
                                          quartet_operations, shell_subset)
from tuna_tpu_torch.post import cc, mp
from tuna_tpu_torch.scf.guess import natural_orbitals_of_density
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
# The (Q) path and the iterative triples family.  tuna_tpu's (Q) forms
# o^4 v^4 arrays several times over (30 GB of host memory at o = 7, v = 19),
# so its full-precision constants for LINE_Q are those of the CCSDT line
#   env JAX_PLATFORMS=cpu python -c 'from tuna_tpu.cli import run; \
#       out = run("SPE : N N 1.1 : CCSDT 6-311G : TIGHTSCF"); \
#       print(repr(out[0].energy), repr(out[2]))'
# (SCF energy, CCSDT total energy; 12 SCF cycles and 16 CCSDT rows in its
# printout), and its (Q) parts and total are the 10-decimal values of its
# printout of LINE_Q itself ("Contribution from MP5", "... MP6", "CCSDT(Q)
# correlation energy", "Final single point energy"): held to 1e-10 Ha, of
# which rounding takes up to 5e-11.  The small lines' constants come from
# the same command on each line.
LINE_Q = "SPE : N N 1.1 : CCSDT(Q) 6-311G : TIGHTSCF"
E_SCF_REF_Q = -108.89398390039997
E_CCSDT_REF_Q = -109.1789129704332
E_REF_Q = -109.1808014663           # printed: final single point energy
E_Q_REF_Q = (-0.0015224988, -0.0003659970, -0.0018884959)   # printed: MP5, MP6, (Q)
ITERATIONS_Q = (12, 16)                   # SCF, CCSDT
TRIPLES_LINES = (   # line, E_total, (SCF, CC) iterations, kernels
    ("SPE : LI H 1.6 : CCSDTQ STO-3G : TIGHTSCF", -7.882324393465053, (10, 10),
     ("eri_packed", "one_electron")),
    ("SPE : LI H 1.6 : UCCSDT STO-3G : NOROTATE TIGHTSCF", -7.882324255984166, (10, 11),
     ("eri_packed", "one_electron")),
    ("SPE : LI H 1.6 : UCISDT STO-3G : NOROTATE TIGHTSCF", -7.882321365060808, (10, 11),
     ("eri_packed", "one_electron")),
    ("SPE : LI H 1.6 : CCSDT(Q) STO-3G : ML 3 TIGHTSCF", -7.766669285383415, (9, 8),
     ("eri_packed", "one_electron", "ccsdt_q_energy")),
)
# The unrestricted gradient paths.  Constants from the reference package on
# the JAX CPU backend, printed by the command of the gradient paths above;
# for the three cc-pVTZ gradient lines with the same jax.jvp substitute for
# jax.grad (tests/test_torch_uhf_gradients.py::
# test_jvp_substitute_matches_jax_grad holds its gradient to jax.grad's on a
# UHF and a UKS line).  The SPE's energy is run(LINE)[2] and its count
# "Self-consistent field converged in 12 cycles!".
LINE_UKS_OPT = "OPT : O O 1.21 : B3LYP CC-PVTZ : ML 3 TIGHTSCF"
BOND_REF_UKS_OPT = 2.27920636383765   # bohr
E_REF_UKS_OPT = -150.3210228972032
ITERATIONS_UKS_OPT = 4
LINE_UHF_OPT = "OPT : O O 1.21 : HF CC-PVTZ : ML 3 TIGHTSCF"
BOND_REF_UHF_OPT = 2.189693058877069   # bohr
E_REF_UHF_OPT = -149.67964660021795
ITERATIONS_UHF_OPT = 6
LINE_UKS_FREQ = "FREQ : O H 0.97 : B3LYP CC-PVTZ : TIGHTSCF"
FREQUENCY_REF_UKS_FREQ = 3756.7601976353126   # per cm
ZPE_REF_UKS_FREQ = 0.008558529462628424
LINE_UHF_MD = "MD : O H 0.97 : HF 6-31G : NUM 5 NOTRAJ"
E_REF_UHF_MD = (-75.3631682461487, -75.36316829496981, -75.36316843380493,
                -75.36316866494523, -75.3631689822514)
LINE_UKS_SPE = "SPE : O O 1.21 : B3LYP CC-PVTZ : ML 3 TIGHTSCF"
E_REF_UKS_SPE = -150.3210013296221
SCF_ITERATIONS_UKS_SPE = 12
# The meta-GGA paths.  Constants from the reference package on the JAX CPU
# backend, printed by the commands of the paths above (the SPE lines'
# run(LINE)[2] and "Self-consistent field converged in N cycles!"); for the
# two OPT lines with the jax.jvp substitute for jax.grad
# (tests/test_torch_meta_gga_gradients.py::
# test_jvp_substitute_matches_jax_grad_for_a_meta_gga holds it to jax.grad
# on a UKS meta-GGA line).
LINE_MGGA = "SPE : N N 1.1 : R2SCAN CC-PVTZ : TIGHTSCF"
E_REF_MGGA = -109.50763225045708
SCF_ITERATIONS_MGGA = 11
LINE_B97MV = "SPE : N N 1.1 : B97M-V CC-PVTZ : TIGHTSCF"
E_REF_B97MV = -109.54822168354094          # VV10 included
SCF_ITERATIONS_B97MV = 12
LINE_UMGGA = "SPE : O O 1.21 : TPSS CC-PVTZ : ML 3 TIGHTSCF"
E_REF_UMGGA = -150.40359226593318
SCF_ITERATIONS_UMGGA = 13
# The card's run of LINE_UMGGA stopped one iteration early (12), 4.6e-9 Ha
# from tuna_tpu; the port on the same host's CPU took tuna_tpu's 13
# iterations and ended 3.6e-11 Ha from it (--meta-gga-spe-devices: the two
# runs' SCF energies agree within 3e-13 up to the last DIIS systems, whose
# condition numbers of 2.6e10-4.1e10 turn the card's rounding into
# coefficients 0.43 apart).  With K3 on its lane schedule (which sums a
# matrix entry's primitive pairs in another order, the same values to
# 1e-14) the card's run took 14 iterations, 6.5e-10 Ha from tuna_tpu, and
# so did the same line on the card with K3's plain version in the
# kernel's place (2.5e-11 Ha from the kernel's run).  So on the card the
# line is held to the BASELINE contract, and its count and energy to that
# run's (K3_WITNESS_TOLERANCE): a fault of K3 that moves the count fails.
K3_WITNESS_TOLERANCE = 1e-10   # Ha
LINE_MGGA_OPT = "OPT : N N 1.1 : R2SCAN CC-PVTZ : TIGHTSCF"
BOND_REF_MGGA_OPT = 2.0673995977277992   # bohr
E_REF_MGGA_OPT = -109.50773050589086
ITERATIONS_MGGA_OPT = 5
LINE_UMGGA_OPT = "OPT : O O 1.21 : TPSS CC-PVTZ : ML 3 TIGHTSCF"
BOND_REF_UMGGA_OPT = 2.3071853036665284   # bohr
E_REF_UMGGA_OPT = -150.40374948414586
ITERATIONS_UMGGA_OPT = 5
LINE_SCAN_MGGA = "SCAN : N N 1.0 : TPSS CC-PVTZ : NUM 4 STEP 0.05 TIGHTSCF"
# Perturbation theory and double hybrids (phase 22).  Constants from the
# reference package on the JAX CPU backend: the total energy run(LINE)[2],
# "Self-consistent field converged in N cycles!" and the rows of the
# IMP2/OMP2 step table of its printout, and the MP2, MP3 and MP4 parts
# that tuna_tpu.post.mp.run_perturbation_theory_calculation returns (the
# double hybrid's MP2 part before its MPC scaling), read by wrapping that
# function; for the relaxed line also the dipole moment of the density
# run(LINE)[3] (props.calculate_analytical_dipole_moment) and the natural
# occupancies that run printed.  Each: line, E_total, SCF cycles, steps,
# (E_MP2, E_MP3, E_MP4), kernels.
MP_LINES = (
    ("SPE : N N 1.1 : MP2 6-31G", -109.10705463697698, 10, 0,           # BASELINE.json config 2
     (-0.23943634781371997, 0.0, 0.0), ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : MP2 6-31G : TIGHTSCF", -109.10705463842848, 12, 0,
     (-0.23943634784597584, 0.0, 0.0), ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : B2PLYP CC-PVTZ : TIGHTSCF", -109.5059381240706, 11, 0,
     (-0.49211270439808524, 0.0, 0.0),
     ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid")),
    ("SPE : O O 1.21 : UMP3 CC-PVTZ : ML 3 TIGHTSCF", -150.12824715021233, 15, 0,
     (-0.4598463762314528, 0.006324011134660662, 0.0), ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : IMP2 6-31G : TIGHTSCF", -109.10705463842845, 12, 3,
     (-0.2394363478459534, 0.0, 0.0), ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : LMP2 6-31G : TIGHTSCF", -109.10706061432363, 12, 0,
     (-0.23944232374112942, 0.0, 0.0), ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : OMP2 6-31G : TIGHTSCF", -109.11115239864046, 12, 9,
     (-0.2435341080579576, 0.0, 0.0), ("eri_packed", "one_electron")),
)
LINE_MP4 = "SPE : N N 1.1 : MP4 CC-PVTZ : TIGHTSCF"       # 60 AOs, o = 7, v = 53
LINE_MP4_DIRECT = "SPE : N N 1.1 : MP4 CC-PVTZ : DIRECT TIGHTSCF"
E_REF_MP4 = -109.40601712791569
SCF_ITERATIONS_MP4 = 14
PARTS_REF_MP4 = (-0.40002224115077667, 0.007939274459799032, -0.030927629167002528)
LINE_MP2_RELAXED = "SPE : H F 1.733 : MP2 6-31G : RELAXED NATORBS TIGHTSCF"
E_REF_MP2_RELAXED = -99.97154581790926
SCF_ITERATIONS_MP2_RELAXED = 13
PARTS_REF_MP2_RELAXED = (-0.17282719084443018, 0.0, 0.0)
DIPOLE_REF_MP2_RELAXED = -0.8795773829975141
NATURAL_OCCUPANCIES_REF_MP2_RELAXED = (
    1.999967278211531, 1.9908659516976301, 1.9819031401710272, 1.9819031401710272,
    1.9014586154616957, 0.09892475297496857, 0.017495145991556587, 0.01749514599155656,
    0.0086231808290753, 0.0009942712043265393, 0.00036937729560392095)
MP_TOLERANCE = 1e-10         # Ha, each line's total energy and MP parts against tuna_tpu's
NATURAL_OCCUPANCY_TOLERANCE = 1e-8
DIPOLE_TOLERANCE = 1e-8      # atomic units
# The rest of restricted CC/CI and the last calculation types (phase 23).
# Constants from tests/chip_smoke_references.py: tuna_tpu on the JAX CPU
# backend with one device, each line's result, the SCF cycles of every SCF
# and the CC iterations of every coupled-cluster solve in the order they
# ran, and what the line's finite-field properties, (T) energies, IP/EA
# states, CBS parts and anharmonic levels return.  The IP line is VERTICAL
# (without it each state is a CCSD(T) geometry optimisation by finite
# differences, beyond this phase's time) and at cc-pVDZ: tuna_tpu's
# spin-orbital CCSD of CO+ at cc-pVTZ (120 spin orbitals) took more than
# 45 GB of that host's memory.
LINE_CC3 = "SPE : N N 1.1 : CC3 CC-PVTZ : TIGHTSCF"       # o = 7, v = 53
LINE_QCISD_T = "SPE : N N 1.1 : QCISD(T) CC-PVTZ : TIGHTSCF"
LINE_QCISD_T_DIRECT = "SPE : N N 1.1 : QCISD(T) CC-PVTZ : DIRECT TIGHTSCF"
LINE_ANHARM = "ANHARM : C O 1.13 : HF CC-PVTZ"
LINE_PROPERTIES = "SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF"
REFERENCES_23 = {
    "SPE : N N 1.1 : CC3 CC-PVTZ : TIGHTSCF": {
        "scf_cycles": [7, 14],
        "cc_iterations": [13],
        "energy": -109.40093117479964,
    },
    "SPE : N N 1.1 : CC2 CC-PVTZ : TIGHTSCF": {
        "scf_cycles": [7, 14],
        "cc_iterations": [9],
        "energy": -109.38989743474094,
    },
    "SPE : N N 1.1 : QCISD(T) CC-PVTZ : TIGHTSCF": {
        "scf_cycles": [7, 14],
        "cc_iterations": [13],
        "energy": -109.40045765052761,
        "restricted_T": [-0.018250761182763725],
    },
    "SPE : N N 1.1 : LCCD 6-311G : TIGHTSCF": {
        "scf_cycles": [7, 12],
        "cc_iterations": [17],
        "energy": -109.16941383994293,
    },
    "SPE : N N 1.1 : CCD 6-311G : TIGHTSCF": {
        "scf_cycles": [7, 12],
        "cc_iterations": [13],
        "energy": -109.16519153017425,
    },
    "SPE : N N 1.1 : CEPA(0) 6-311G : TIGHTSCF": {
        "scf_cycles": [7, 12],
        "cc_iterations": [16],
        "energy": -109.17461485831541,
    },
    "SPE : N N 1.1 : CID 6-311G : TIGHTSCF": {
        "scf_cycles": [7, 12],
        "cc_iterations": [14],
        "energy": -109.14618241208407,
    },
    "ANHARM : C O 1.13 : HF CC-PVTZ": {
        "scf_cycles": [13, 18, 17, 17, 14, 14, 12, 13, 18, 13, 18, 12, 17, 17, 17, 17, 17,
            16, 15, 13, 20, 16, 18, 12, 17, 16, 16, 13, 20, 18, 17, 12, 17, 16, 15, 14, 20,
            17, 19, 12, 17, 16, 16],
        "cc_iterations": [],
        "result": [-112.77630100183906, -112.76535283086623, -112.7545052588488,
            -112.74375752406415, -112.7331098531492, -112.72256148818364],
        "scans": 7,
        "levels": [-112.77630100183906, -112.76535283086623, -112.7545052588488,
            -112.74375752406415, -112.7331098531492, -112.72256148818364],
        "zero_point_energy": 0.005514948837969769,
        "chi": 0.0045519331722253835,
    },
    "SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF": {
        "scf_cycles": [12, 16, 12, 16, 12, 16, 13, 17, 13, 17, 13, 17, 13, 17, 12, 16, 12,
            16, 12, 16, 12, 16, 13, 17, 13, 17, 13, 17, 13, 17, 12, 16, 12, 16, 12, 16, 12,
            16, 12, 16, 12, 16, 12, 16, 12, 16, 13, 17, 13, 17, 13, 17, 13, 17],
        "cc_iterations": [15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
            15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15],
        "energy": -113.16317480726099,
        "calculate_numerical_dipole_moment": 0.04037625631773256,
        "calculate_numerical_quadrupole_moment": -2.365429240319337,
        "calculate_polarisability": 11.287203779630772,
        "calculate_hyperpolarisability": [19.84139353338339, 4.241003268732499],
        "polarisability_components": [14.063806596927481, 9.898902370982418],
    },
    "IP : C O 1.13 : CCSD(T) CC-PVDZ : VERTICAL": {
        "scf_cycles": [12, 14, 21, 22],
        "cc_iterations": [14, 23],
        "result": 0.5003619214008239,
        "restricted_T": [-0.010760714877424377],
        "unrestricted_T": [-0.010985752148956892],
        "state_energies": [-113.05819425318057, -112.55783233177975],
    },
    "EA : F : CCSD(T) CC-PVTZ": {
        "scf_cycles": [15, 12],
        "cc_iterations": [12, 10],
        "result": 0.07827721943907306,
        "restricted_T": [-0.005658642040431893],
        "unrestricted_T": [-0.003675623699923078],
        "state_energies": [-99.63219230900778, -99.71046952844685],
    },
    "BDE : H F 0.92 : MP2 CC-PVTZ : ZPE": {
        "scf_cycles": [9, 17, 9, 17, 9, 17, 15, 9, 17, 9, 17, 15, 9, 17, 9, 17, 12, 9, 17,
            9, 17, 10, 9, 17, 9, 17, 9, 17, 9, 17, 9, 17, 9, 17, 1, 11, 11, 19],
        "cc_iterations": [],
        "result": 0.42775095660361073,
    },
    "SPE : N N 1.1 : CCSD(T) CC-PVDZ : EXTRAPOLATE TIGHTSCF": {
        "scf_cycles": [7, 13, 7, 14],
        "cc_iterations": [13, 13],
        "energy": -109.46485248512161,
        "extrapolation": {"inputs": [-108.95379624074559, -108.98300653205771,
            -0.32560161534212284, -0.4168909569827548], "parts": [-108.9925061929965,
            -0.4723462921251032]},
        "restricted_T": [-0.012008560154231119, -0.01895383888754702],
    },
}
PHASE_23_TOLERANCE = 1e-10   # Ha, each energy against tuna_tpu's
BDE_TOLERANCE = 1e-8         # Ha: the BDE less a zero-point energy from a five-point Hessian
ANHARM_TOLERANCE = 1e-8      # Ha, each vibrational level and the zero-point energy
CM_TOLERANCE = 0.01          # per cm, the fundamental and chi times the harmonic frequency
CC3_WARM_RUNS = 2            # warm runs of LINE_CC3, for its profile
# SCF cycles an SCF of a line may differ by from tuna_tpu's, by the SCF's
# index in the order they ran (the number of SCFs is equal, every other
# SCF's cycles too): ANHARM's SCF 18, the last point of its first forward
# scan (2.3233 bohr, EXTREMESCF, started from the previous point's
# density), takes 16 cycles on the card and on the host's CPU where
# tuna_tpu takes 15 (tests/test_torch_properties.py::
# test_anharm_cc_pvtz_scf_cycles_match_tuna_tpu): the two packages'
# energies there differ by about 1e-12 Ha, and delta E after the 15th
# iteration is 9.72e-12 in tuna_tpu and 1.029e-11 in the port against
# EXTREMESCF's 1e-11 (tests/scf_convergence_margins.py)
SCF_CYCLE_SLACK = {LINE_ANHARM: {18: 1}}
# (step, sum of |coefficients| over the denominator, order) of each
# finite-field property's stencil (stencils.py): the property is held to
# what PHASE_23_TOLERANCE of energy allows through it, that sum times the
# tolerance over step ** order
FIELD_STENCILS = {
    "calculate_numerical_dipole_moment": (1e-5, 1.0, 1),
    "calculate_numerical_quadrupole_moment": (1e-5, 1.0, 1),
    "calculate_polarisability": (1e-3, 64 / 12, 2),
    "polarisability_components": (1e-3, 64 / 12, 2),
    "calculate_hyperpolarisability": (1.5e-3, 2 * (7 + 72 + 338 + 488) / 240, 3),
}
# Excited states and SCF stability (phase 24).  Constants from
# `tests/chip_smoke_references.py --phase 24`: tuna_tpu on the JAX CPU
# backend, each line's total energy, the SCF cycles of every SCF, the first
# NSTATES excitation energies and oscillator strengths of the spectrum it
# prints (sorted by energy), its (D) corrections and the lowest eigenvalue
# of each stability Hessian.  These hold under any basis of a degenerate
# pair of states (N2's and O2's Pi states), which the eigensolvers pick.
LINE_TDLDA = "SPE : N N 1.1 : SVWN CC-PVTZ : TD TIGHTSCF"
LINE_UKS_TD = "SPE : O O 1.21 : SVWN CC-PVTZ : ML 3 TD TIGHTSCF"
REFERENCES_24 = {
    "SPE : N N 1.1 : TDHF CC-PVTZ : TIGHTSCF": {
        "scf_cycles": [7, 14],
        "energy": -108.85769517811738,
        "excitation_energies": [0.12531135394033505, 0.21185654598661163, 0.21185654598661163,
            0.27883274078232556, 0.2788327407823262, 0.29026762162377634, 0.29026762162377634,
            0.3207719446512474, 0.32077194465124764, 0.3576498539878345],
        "oscillator_strengths": [0.0, 0.0, 0.0, 0.0, 0.0, 8.872974257113546e-33, 0.0,
            9.124772203410739e-32, 1.422992936253279e-30, 6.808040266125001e-25],
    },
    "SPE : N N 1.1 : CIS(D) CC-PVTZ : TIGHTSCF": {
        "scf_cycles": [7, 14],
        "energy": -108.68119799917332,
        "excitation_energies": [0.22751757577453535, 0.26709191575373703, 0.2670919157537371,
            0.29290113873938034, 0.29290113873938095, 0.3111890253723085, 0.3111890253723086,
            0.3317679318601413, 0.3317679318601413, 0.3670464005045353],
        "oscillator_strengths": [0.0, 0.0, 0.0, 0.0, 0.0, 1.4651342251345108e-32, 0.0,
            2.00907123163703e-31, 9.587835956861708e-31, 9.401012437082875e-25],
        "doubles": [0.07429095710985059],
    },
    "SPE : N N 1.1 : HF CC-PVTZ : STAB TIGHTSCF": {
        "scf_cycles": [7, 14],
        "energy": -108.98300653205771,
        "hessian_lowest": [0.20110078409164645, 0.0384122744659555],
    },
    "SPE : N N 1.1 : SVWN CC-PVTZ : TD TIGHTSCF": {
        "scf_cycles": [7, 11],
        "energy": -108.40966327098683,
        "excitation_energies": [0.2775893473818089, 0.2775893473818092, 0.2899419845702173,
            0.3248682196255882, 0.32486821977332514, 0.3344267713685983, 0.33442677136859855,
            0.35645894369336, 0.35645894369336006, 0.37742835103858896],
        "oscillator_strengths": [0.0, 0.0, 0.0, 0.0, 0.0, 2.9336350589472408e-22,
            2.9334879457655776e-22, 0.0, 1.4892605467937224e-33, 1.1270098489303097e-32],
    },
    "SPE : O O 1.21 : UHF CC-PVTZ : ML 3 STAB TIGHTSCF": {
        "scf_cycles": [9, 15],
        "energy": -149.67472478511553,
        "hessian_lowest": [0.022884365767268988],
    },
    "SPE : O O 1.21 : CIS(D) CC-PVTZ : ML 3 TIGHTSCF": {
        "scf_cycles": [9, 15],
        "energy": -149.42824762804082,
        "excitation_energies": [0.17500179118703935, 0.17500179118703946, 0.18491554698653606,
            0.2911900563683982, 0.29119005636839834, 0.30153674910208117, 0.43204200341758264,
            0.43204200341758264, 0.5430949695847445, 0.5430949695847448],
        "oscillator_strengths": [1.7806578726579662e-33, 1.936062896783308e-31,
            3.6296469071366603e-32, 5.949348321083005e-29, 6.023012646341059e-29,
            0.21504414617189213, 0.000170721963923671, 0.000170721963923671,
            5.158660590085945e-31, 9.014608543313026e-31],
        "doubles": [0.07147536588765417],
    },
    "SPE : O O 1.21 : SVWN CC-PVTZ : ML 3 TD TIGHTSCF": {
        "scf_cycles": [8, 12],
        "energy": -149.06455886399414,
        "excitation_energies": [0.25796530836986437, 0.2579653086313224, 0.2627936194408603,
            0.29179636301090317, 0.2917963630109032, 0.34800391939625597, 0.3755320371239072,
            0.3755320371239074, 0.5349559017900046, 0.5349559017900046],
        "oscillator_strengths": [1.5997176389037602e-32, 2.2567227026646952e-32,
            1.0085108711608602e-35, 8.45738308291811e-19, 8.457382825795521e-19,
            0.16951547103546713, 0.0007836653212837834, 0.0007836653212837727,
            0.06941058163706264, 0.06941058163706265],
    },
}
EXCITED_TOLERANCE = 1e-10    # Ha, energies, excitation energies, (D), stability eigenvalues
STRENGTH_TOLERANCE = 1e-8    # the oscillator strengths, absolute
TDLDA_WARM_RUNS = 2          # warm runs of LINE_TDLDA, for its profile
# Lines whose last SCF rounding decides (--uks-td-devices shows it): the
# UKS SVWN SCF of LINE_UKS_TD ends in DIIS systems of condition 5e9-7e10,
# where the card's and the host's runs, equal within 2.3e-13 Ha until
# then, take other coefficients; on an H100 the SCF stops after 14 cycles
# 2.6e-10 Ha from tuna_tpu's energy, on the host's CPU after tuna_tpu's 12
# cycles 3.1e-11 Ha from it, and with K7b's plain version in the kernel's
# place on the card after 14 cycles again.  Such a line is held to the
# 1e-8 Ha contract (excitation energies too) and its last SCF's cycles to
# a slack; every other SCF's are equal.
ROUNDING_DECIDED_24 = {LINE_UKS_TD: (1e-8, 2)}    # (Ha, the last SCF's slack in cycles)
# g and h shells (phase 25).  Constants from `tests/chip_smoke_references.py
# --phase 25`: tuna_tpu on the JAX CPU backend, each line's total (and SCF)
# energy and the SCF cycles of every SCF and CC iterations of every solve.
# tuna_tpu's restricted (T) forms o^3 v^3 arrays several times over, 2.9 GB
# each at o = 7, v = 103, more than the pinning host holds, so LINE_QZ_CC's
# constants are those of its CCSD line ("SPE : N N 1.1 : CCSD CC-PVQZ :
# TIGHTSCF"), and its (T) is held to K2's plain version on the path's inputs.
LINE_QZ_CC = "SPE : N N 1.1 : CCSD[T] CC-PVQZ : TIGHTSCF"
LINE_QZ_EXTRAPOLATE = "SPE : N N 1.1 : HF CC-PVTZ : EXTRAPOLATE TIGHTSCF"
LINE_QZVP_DFT = "SPE : N N 1.1 : B3LYP DEF2-QZVP : TIGHTSCF"
LINE_5Z_HF = "SPE : H F 0.917 : HF CC-PV5Z : TIGHTSCF"
LINE_5Z_HF_DIRECT = "SPE : H F 0.917 : HF CC-PV5Z : DIRECT TIGHTSCF"
LINE_5Z_N2_DIRECT = "SPE : N N 1.1 : HF CC-PV5Z : DIRECT TIGHTSCF"
REFERENCES_25 = {
    LINE_QZ_CC: {"scf_cycles": [7, 14], "cc_iterations": [13],
                 "scf_energy": -108.9906006517339, "ccsd_energy": -109.44280750817778},
    LINE_QZ_EXTRAPOLATE: {"scf_cycles": [7, 14, 7, 14], "cc_iterations": [],
                          "energy": -108.99288878978848},
    LINE_QZVP_DFT: {"scf_cycles": [7, 10], "cc_iterations": [], "energy": -109.52665906643259},
    LINE_5Z_HF: {"scf_cycles": [9, 14], "cc_iterations": [], "energy": -100.07043035467812},
    # tuna_tpu's DIRECT run of this line did not end within two hours on the
    # pinning host, so it has no energy here: the line is held by its SCF
    # cycles (the STO-3G guess's 7, as in every N2 line above, and the 14 an
    # H100 took, PERF.md), by its warm run, and by phase 25's K4 against K1
    # at N2/cc-pV5Z
    LINE_5Z_N2_DIRECT: {"scf_cycles": [7, 14], "cc_iterations": [], "energy": None},
}
PHASE_25_TOLERANCE = 1e-10   # Ha, every phase 25 line against tuna_tpu; DIRECT against stored
# reduced plans of N2 for the kernels against their plain versions: the
# first shell of each l on each atom
HIGH_L_PLANS = (("CC-PVQZ", (0, 3, 4)), ("CC-PV5Z", (0, 3, 4, 5)))
# clock cycles the card sleeps while the host enqueues phase 25's timed
# calls back to back (~50 ms; a call of K1 or K4 enqueues ~45-100 class
# kernels); torch.profiler is not used there: after phase 24's profiles
# its sessions recorded no device event
HIGH_L_SLEEP_CYCLES = 100_000_000
TAU_TOLERANCE = 1e-13       # relative to the largest |entry|, K7bt, K8ct, K8cut
POLISH_RUNS = 1             # warm runs a variant, for the polished eigh's cost
LINE_SCAN = "SCAN : N N 1.0 : B3LYP CC-PVTZ : NL NUM 8 STEP 0.05 TIGHTSCF"
LINE_SCAN_UHF = "SCAN : O O 1.21 : HF 6-311G : ML 3 NUM 4 STEP 0.05 TIGHTSCF"
LINE_SCAN_EXTREME = LINE_SCAN.replace("TIGHTSCF", "EXTREMESCF")
# Ha, a batched scan point against the serial SCAN's: at TIGHTSCF the two
# stop at the 1e-9 Ha energy-change criterion from other guesses (the core
# Hamiltonian; the STO-3G SCF chained by MOREAD), and differed by up to
# 3.3e-9 Ha on an H100 at this line, so the BASELINE contract holds there,
# and 1e-10 at EXTREMESCF, where they differed by at most 5.8e-12 Ha
SCAN_TOLERANCE = 1e-8
SCAN_EXTREME_TOLERANCE = 1e-10
SCAN_UHF_TOLERANCE = 1e-8   # Ha, the UHF batch against its serial SCAN
# the profiled scans of phase 17: three of LINE_SCAN's points (a profile
# of all eight took ~100 s a session with the event parsing)
LINE_SCAN_PROFILE = LINE_SCAN.replace("NUM 8", "NUM 3")
# The correlated, finite-field and unrestricted Kohn-Sham batches of
# parallel.py (phase 27), each line through cli.run with the drivers shown
# two devices, both the one card (two_shards): two shards in one lockstep
# loop.  Constants from `tests/chip_smoke_references.py --phase 27`:
# tuna_tpu.parallel on the JAX CPU backend with 8 virtual devices, each
# line's energies (the field lines': of every field batch of its property
# stencils, and the properties derived from them) and every SCF and CC
# solve inside tuna_tpu's batches as (iterations, energy).
# N2's two pinned lines run at EXTREMESCF: from 1.08 angstrom the core
# guess, every batch's start, occupies one orbital of the degenerate pi
# pair at the HOMO and LUMO, so eigh's choice in the pair (rounding) picks
# the SCF's path.  At TIGHTSCF the CCSD(T) scan on the card stopped 1.55e-10
# Ha from tuna_tpu's batch and the field batch 5.5e-10 (the port on the CPU:
# 2.7e-10, in 13-16 SCF iterations against tuna_tpu's 14-17); at EXTREMESCF
# the energies agree, the counts stay rounding's (PHASE_27_SOLVE_LIMITS)
LINE_27_SCAN_CC = "SCAN : N N 1.0 : CCSD(T) CC-PVTZ : NUM 6 STEP 0.04 EXTREMESCF"  # o = 7, v = 53
LINE_27_FIELD_VV10 = "SPE : N N 1.1 : B3LYP CC-PVTZ : NL POLAR EXTREMESCF"
LINE_27_UKS = "SCAN : O O 1.16 : B3LYP CC-PVTZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF"
# The triplet O2 lines start at 1.11 angstrom: from 1.31 angstrom at
# cc-pVDZ (1.26 at 6-31G) the core guess every batch starts from, in
# tuna_tpu's as in the port's, converges to a UHF state 0.20 Ha above the
# one the serial walk's chained densities keep (ROADMAP.md queue 3)
LINE_27_UCC = "SCAN : O O 1.11 : CCSD(T) CC-PVDZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF"  # o = 16, v = 40
LINE_27_UMP2 = "SCAN : O O 1.11 : MP2 CC-PVTZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF"
LINE_27_CBS = "SCAN : N N 1.0 : MP2 CC-PVDZ : EXTRAPOLATE NUM 4 STEP 0.05 TIGHTSCF"
LINE_27_DH = "SCAN : N N 1.0 : B2PLYP CC-PVTZ : NUM 4 STEP 0.05 TIGHTSCF"
LINE_27_FORCE = "FORCE : N N 1.1 : CCSD(T) CC-PVTZ : TIGHTSCF"
# The serial walk a correlated line is held to runs at EXTREMESCF
# (serial_line): on the card the TIGHTSCF walk of CCSD(T)/cc-pVTZ stopped
# 1.16e-8 Ha from the TIGHTSCF batch at 1.12 angstrom, the EXTREMESCF walk
# within 1.2e-10 of it at every point (a correlation energy is first-order
# in the SCF orbitals' residual rotation, and the walk starts each point
# from the previous one's density, the batch from the core guess).
# The scan lines with the kernels each must launch and the launches a
# point of the batch of those that run once a point
PHASE_27_SCANS = (
    (LINE_27_SCAN_CC, ("eri_packed", "one_electron", "ccsd_t_energy"), {"ccsd_t_energy": 1}),
    (LINE_27_UKS, ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid"), {}),
    (LINE_27_UCC, ("eri_packed", "one_electron", "uccsd_t_energy"), {"uccsd_t_energy": 1}),
    (LINE_27_UMP2, ("eri_packed", "one_electron"), {}),
    (LINE_27_CBS, ("eri_packed", "one_electron"), {}),
    (LINE_27_DH, ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid"), {}),
)
PHASE_27_TOLERANCE = 1e-10         # Ha, a point against tuna_tpu's batch of the same points
PHASE_27_SERIAL_TOLERANCE = 1e-8   # Ha, a point against the serial walk (other guesses)
# (energy limit, iteration slack) of a line's solves where they are not
# PHASE_27_TOLERANCE and equal: UKS O2 B3LYP is decided by the card's
# rounding (ROADMAP.md queue 3); N2's pinned lines take the path rounding
# picks from a degenerate guess, so their counts are printed, not held (None)
PHASE_27_SOLVE_LIMITS = {LINE_27_UKS: (1e-8, 1), LINE_27_SCAN_CC: (PHASE_27_TOLERANCE, None),
                         LINE_27_FIELD_VV10: (PHASE_27_TOLERANCE, None)}
REFERENCES_27 = {
    'SCAN : N N 1.0 : CCSD(T) CC-PVTZ : NUM 6 STEP 0.04 EXTREMESCF': {
        'bonds': [1.8897261259065457, 1.9653151709428074, 2.040904215979069, 2.116493261015331, 2.1920823060515926, 2.2676713510878543],
        'energies': [-109.36538285600096, -109.38859229295701, -109.39871693604809, -109.39894706781858, -109.39180146418047, -109.37926870952876],
        'converged': [True, True, True, True, True, True],
        'scf_solves': [(17, -134.89769832899958), (17, -133.91618611284045), (17, -132.12926807973787), (18, -132.994953455268), (18, -131.3148261383422), (18, -130.5477121628536)],
        'cc_solves': [(15, -0.3880009150683579), (16, -0.40144626986727705), (16, -0.38186781982942786), (17, -0.4087557099880904), (17, -0.39452633144085714), (18, -0.41644186009079515)],
        'seconds': 126.17026610000175,
    },
    'SPE : C O 1.13 : CCSD CC-PVTZ : DIPOLE QUADRUPOLE POLAR HYPER TIGHTSCF': {
        'field_batches': [{'fields': [[0.0, 0.0, 1e-05], [0.0, 0.0, -1e-05]], 'energies': [-113.16317518847575, -113.16317442749528]}, {'fields': [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0]], 'energies': [-113.16309904095596, -113.1632505756626, -113.1630990409561, -113.16325057566249]}, {'fields': [[0.0, 0.0, 0.002], [0.0, 0.0, 0.001], [0.0, 0.0, -0.001], [0.0, 0.0, -0.002], [0.002, 0.0, 0.0], [0.001, 0.0, 0.0], [-0.001, 0.0, 0.0], [-0.002, 0.0, 0.0]], 'energies': [-113.16327905943828, -113.16321989151342, -113.16314378690134, -113.16312681049095, -113.16319460541351, -113.16317975673556, -113.1631797567357, -113.16319460541351]}, {'fields': [[0.0, 0.0, 0.0015], [0.0, 0.0, 0.003], [0.0, 0.0, 0.0045000000000000005], [0.0, 0.0, 0.006], [0.0, 0.0, -0.0015], [0.0, 0.0, -0.003], [0.0, 0.0, -0.0045000000000000005], [0.0, 0.0, -0.006], [0.0015, 0.0, 0.0015], [-0.0015, 0.0, 0.0015], [0.0015, 0.0, -0.0015], [-0.0015, 0.0, -0.0015]], 'energies': [-113.16324771377256, -113.16335233088355, -113.16348872634626, -113.16365696762779, -113.16313354443173, -113.16312385833882, -113.1631456825462, -113.16319895099926, -113.16325885745798, -113.16325885745789, -113.1631446736443, -113.16314467364438]}],
        'calculate_numerical_dipole_moment': 0.040376259159903505,
        'calculate_numerical_quadrupole_moment': -2.3654292718200653,
        'calculate_polarisability': 11.28724011560204,
        'calculate_hyperpolarisability': [19.808135782372077, 4.288225412623164],
        'scf_solves': [(12, -133.7030778095514), (16, -135.2584573743863), (18, -135.25882474922753), (18, -135.2586889077006), (18, -135.25862600119572), (18, -135.25856644149468), (18, -135.2582108078496), (19, -135.25931228891542), (19, -135.25905353833622), (19, -135.2586368396218), (19, -135.25863683962172), (19, -135.2585329339024), (19, -135.25853293390227), (19, -135.2584766512878), (19, -135.25846219355788), (19, -135.25846219355773), (19, -135.25845839867483), (19, -135.25845635148485), (19, -135.25838181693723), (19, -135.2583818169371), (19, -135.2583617304401), (19, -135.25832979773946), (19, -135.25832979773938), (19, -135.25831894962062), (19, -135.25827953358373), (19, -135.25813303103476), (19, -135.25808570101725)],
        'cc_solves': [(15, -0.38389525433499877), (15, -0.3836796830359404), (15, -0.38346551075841717), (15, -0.383323513578992), (15, -0.3832530474429669), (15, -0.3832530474429666), (15, -0.3832527518764051), (15, -0.38318214879777285), (15, -0.38304282471534074), (15, -0.38304194185016016), (15, -0.3830419418501597), (15, -0.3830416294846585), (15, -0.3830416294846558), (15, -0.3830415509022828), (15, -0.3830415509022825), (15, -0.38304142059914714), (15, -0.38304121174331585), (15, -0.38304121174330835), (15, -0.38304001654489517), (15, -0.38290133313112457), (15, -0.38283182174702574), (15, -0.38283182174702546), (15, -0.38283153096044803), (15, -0.3827618905148139), (15, -0.38262309683574924), (15, -0.3824161319344369), (15, -0.382210649808288)],
        'seconds': 173.04694374499923,
    },
    'SPE : N N 1.1 : B3LYP CC-PVTZ : NL POLAR EXTREMESCF': {
        'field_batches': [{'fields': [[0.0, 0.0, 0.002], [0.0, 0.0, 0.001], [0.0, 0.0, -0.001], [0.0, 0.0, -0.002], [0.002, 0.0, 0.0], [0.001, 0.0, 0.0], [-0.001, 0.0, 0.0], [-0.002, 0.0, 0.0]], 'energies': [-109.43608470355886, -109.4360632302151, -109.43606323021524, -109.43608470355875, -109.43607105531586, -109.43605981816071, -109.43605981816143, -109.43607105532439]}],
        'calculate_polarisability': 9.766140227580106,
        'scf_solves': [(7, -131.55764541306004), (14, -133.0884843028991), (15, -133.08849927629194), (16, -133.0884880462457), (17, -133.08851290616946), (17, -133.08851290616934), (17, -133.08849927628341), (17, -133.0884880462464), (19, -133.08849145371158), (19, -133.08849145371144)],
        'cc_solves': [],
        'seconds': 125.76966796600027,
    },
    'SCAN : O O 1.16 : B3LYP CC-PVTZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF': {
        'bonds': [2.192082306051593, 2.28656861234692, 2.3810549186422474, 2.4755412249375746],
        'energies': [-150.31762671726898, -150.32100132952706, -150.317345929104, -150.30876969789463],
        'converged': [True, True, True, True],
        'scf_solves': [(20, -179.51361074730187), (20, -177.19618836945173), (20, -176.1617021214352), (21, -178.3105397384842)],
        'cc_solves': [],
        'seconds': 168.97063581100065,
    },
    'SCAN : O O 1.11 : CCSD(T) CC-PVDZ : ML 3 NUM 4 STEP 0.05 TIGHTSCF': {
        'bonds': [2.097595999756266, 2.192082306051593, 2.28656861234692, 2.3810549186422474],
        'energies': [-149.9693564232338, -149.98456375835408, -149.98936934957447, -149.98700191604385],
        'converged': [True, True, True, True],
        'scf_solves': [(17, -180.1375206191388), (17, -178.82824735972375), (17, -177.61684579612083), (18, -176.493653253424)],
        'cc_solves': [(14, -0.34370359968922204), (14, -0.3354344734596976), (15, -0.36097103242722856), (15, -0.3522309125029748)],
        'seconds': 240.26826111499759,
    },
}
Q_TOLERANCE = 1e-10         # Ha, the (Q) path and the triples lines against tuna_tpu
BOND_TOLERANCE = 1e-6       # angstrom
FREQUENCY_TOLERANCE = 0.01  # per cm
E_TOLERANCE = 1e-8          # Ha, the BASELINE contract
DIRECT_TOLERANCE = 1e-10    # Ha, DIRECT against the port's stored twin
UHF_TOLERANCE = 1e-10       # Ha, the UHF paths' energies against tuna_tpu's
# Ha: the card's run of LINE_MGGA stopped 3.8e-10 Ha from tuna_tpu, the
# port on the same host's CPU 7.2e-11, both in 11 iterations
# (--meta-gga-spe-devices: the two runs agree within 1.2e-12 Ha up to the
# last iterate, where a DIIS system of condition 5.2e9 turns the card's
# rounding into coefficients 0.17 apart), so the line is held to the
# BASELINE contract; LINE_UMGGA too (see K3_WITNESS_TOLERANCE)
MGGA_TOLERANCE = E_TOLERANCE
INTEGRAL_TOLERANCE = 1e-12  # absolute, kernel against plain version
TRIPLES_TOLERANCE = 1e-12   # relative, kernel against plain version
GRID_TOLERANCE = 1e-12      # absolute, AO values and density on the grid
VV10_TOLERANCE = 1e-12      # relative, VV10 energy
FOCK_TOLERANCE = 1e-12      # relative to the largest |entry| of J and of K
TRANSFORM_TOLERANCE = 1e-12  # relative to the largest |entry| of the output
DERIV_GRID_TOLERANCE = 1e-12  # relative to the largest |entry| of each K8c output
UNRESTRICTED_HALF_TOLERANCE = 1e-14  # relative, K8bu at Pa = Pb = P/2 against K8b(P)

# The analytic gradient at g and h shells (phase 26).  Constants from
# `tests/chip_smoke_references.py --phase 26` (tuna_tpu on the JAX CPU
# backend, its jax.grad through the jax.jvp substitute): each line's energy
# at the input geometry, the SCF cycles of every SCF and tuna_tpu's
# gradient (HF/cc-pV5Z's took 1212 s and 31 GB on the pinning host); the
# OPT line's bond length, energy and geometry iterations.  At TIGHTSCF the
# B3LYP line stops 2.6e-10 Ha from tuna_tpu's on the card and on the host's
# CPU alike (the port on both 1.4e-11 apart), in as many cycles: both runs
# stop within the 1e-9 Ha energy criterion of the same minimum, which `SPE :
# N N 1.1 : B3LYP CC-PVQZ : EXTREMESCF` reaches in both packages 6.6e-13
# apart.  So that line's energy is held to the BASELINE contract, and the
# card's EXTREMESCF single point at its geometry to tuna_tpu's
# ("extreme_energy") at PHASE_26_TOLERANCE.
LINE_QZ_FORCE = "FORCE : N N 1.1 : HF CC-PVQZ : TIGHTSCF"
LINE_QZ_UHF_FORCE = "FORCE : O O 1.21 : UHF CC-PVQZ : ML 3 TIGHTSCF"
LINE_QZ_DFT_FORCE = "FORCE : N N 1.1 : B3LYP CC-PVQZ : TIGHTSCF"
LINE_5Z_FORCE = "FORCE : H F 0.917 : HF CC-PV5Z : TIGHTSCF"
LINE_QZ_OPT = "OPT : N N 1.1 : HF CC-PVQZ : TIGHTSCF"
REFERENCES_26 = {
    LINE_QZ_FORCE: {"scf_cycles": [7, 14], "energy": -108.9906006517254,
                    "gradient": 0.11451397033788469},
    LINE_QZ_UHF_FORCE: {"scf_cycles": [9, 16], "energy": -149.686951469586,
                        "gradient": 0.09727650535069365},
    LINE_QZ_DFT_FORCE: {"scf_cycles": [7, 11], "energy": -109.5245496811221,
                        "energy_tolerance": E_TOLERANCE, "extreme_energy": -109.52454968077438,
                        "gradient": 0.027830415091774863},
    LINE_5Z_FORCE: {"scf_cycles": [9, 15], "energy": -100.07043035444228,
                    "gradient": 0.025569084218005023},
    LINE_QZ_OPT: {"bond_length": 2.013660760420279, "energy": -108.99447021418584,
                  "iterations": 6},
}
PHASE_26_TOLERANCE = 1e-10          # Ha, each line's energy at its input geometry
GRADIENT_TOLERANCE = 1e-6           # Ha/bohr, a line's gradient against its central difference
GRADIENT_PIN_TOLERANCE = 1e-8       # Ha/bohr, a line's gradient against tuna_tpu's
# bohr: the step of the four-point central differences (R +- h, R +- 2h),
# whose truncation error h^4 E^(5) / 30 stays below 1e-9 Ha/bohr here
DIFFERENCE_STEP = 0.005
DIFFERENCE_TOLERANCE = 1e-8         # Ha/bohr, K8b against K1's E_2 at N2/cc-pV5Z
# the gradient kernels' plans: reduced diatomics (a g shell of H/cc-pV5Z, the
# h shell of H/cc-pV6Z, each with an s shell on the other atom), then whole
# N2/cc-pVQZ (140 functions) and HF/cc-pV5Z (196)
HIGH_L_GRADIENT_PLANS = (("H", None, 0.74, "CC-PV5Z", ((0, 4), (1, 0))),
                         ("H", None, 0.74, "CC-PV6Z", ((0, 5), (1, 0))),
                         ("N", None, 1.1, "CC-PVQZ", None),
                         ("H", "F", 0.917, "CC-PV5Z", None))
WARM_RUNS = 2                  # warm runs of a path, for its profile and --compare
PROFILE_ATTEMPTS = 5           # torch.profiler sessions tried before a run fails

BYTES_PER_MS = 3.35e12 / 1e3   # H100 SXM device memory
FP64_PER_MS = 34e12 / 1e3      # float64 outside the tensor cores
FP64_MMA_PER_MS = 67e12 / 1e3  # float64 matrix products on the tensor cores (DMMA)

KERNELS = {
    "eri_packed": ("tuna_tpu_torch/csrc/eri.cu", "tuna_tpu/ops/integrals.py:470"),
    "one_electron": ("tuna_tpu_torch/csrc/one_electron.cu", "tuna_tpu/ops/integrals.py:332"),
    "ccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t.cu", "tuna_tpu/post/cc.py:1741"),
    "uccsd_t_energy": ("tuna_tpu_torch/csrc/ccsd_t_u.cu", "tuna_tpu/post/cc.py:1783"),
    "ccsdt_q_energy": ("tuna_tpu_torch/csrc/ccsdt_q.cu", "tuna_tpu/post/cc.py:1821"),
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
    "vv10_energy_batch": ("tuna_tpu_torch/csrc/vv10.cu", "tuna_tpu/dft/vv10.py:63"),
    "eri_deriv_energy_unrestricted": ("tuna_tpu_torch/csrc/eri_deriv.cu",
                                      "tuna_tpu/drivers/gradients.py:272"),
    "density_deriv_on_grid_spin": ("tuna_tpu_torch/csrc/dft_grid.cu",
                                   "tuna_tpu/drivers/gradients.py:184"),
    "density_tau_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu", "tuna_tpu/dft/__init__.py:48"),
    "density_tau_deriv_on_grid": ("tuna_tpu_torch/csrc/dft_grid.cu",
                                  "tuna_tpu/drivers/gradients.py:157"),
    "density_tau_deriv_on_grid_spin": ("tuna_tpu_torch/csrc/dft_grid.cu",
                                       "tuna_tpu/drivers/gradients.py:157"),
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
Q_PATH_KERNELS = ("eri_packed", "one_electron", "ccsdt_q_energy")
BATCH_PATH_KERNELS = ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid",
                      "vv10_energy_batch")
# the unrestricted gradient paths: UKS (OPT O2 B3LYP, FREQ OH B3LYP) and UHF
# (OPT O2 HF, MD OH HF); the UKS single point launches the first two and
# the grid kernels
UKS_GRADIENT_PATH_KERNELS = ("eri_packed", "one_electron", "one_electron_deriv",
                             "eri_deriv_energy_unrestricted", "ao_on_grid", "density_on_grid",
                             "density_deriv_on_grid_spin")
UHF_GRADIENT_PATH_KERNELS = UKS_GRADIENT_PATH_KERNELS[:4]
UKS_PATH_KERNELS = ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid")
# the meta-GGA paths: K7b builds the guess density on the grid, K7bt serves
# the SCF (once a spin for UKS); the OPT lines add K8a, K8b (K8bu) and K8ct
# (K8cut)
MGGA_PATH_KERNELS = ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid",
                     "density_tau_on_grid")
MGGA_GRADIENT_PATH_KERNELS = MGGA_PATH_KERNELS + ("one_electron_deriv", "eri_deriv_energy",
                                                  "density_tau_deriv_on_grid")
UMGGA_GRADIENT_PATH_KERNELS = MGGA_PATH_KERNELS + ("one_electron_deriv",
                                                   "eri_deriv_energy_unrestricted",
                                                   "density_tau_deriv_on_grid_spin")

# the lines of phase 23 with the kernels each must launch
PHASE_23_LINES = (
    (LINE_CC3, ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CC2 CC-PVTZ : TIGHTSCF", ("eri_packed", "one_electron")),
    (LINE_QCISD_T, ("eri_packed", "one_electron", "ccsd_t_energy")),
    ("SPE : N N 1.1 : LCCD 6-311G : TIGHTSCF", ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CCD 6-311G : TIGHTSCF", ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CEPA(0) 6-311G : TIGHTSCF", ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CID 6-311G : TIGHTSCF", ("eri_packed", "one_electron")),
    (LINE_ANHARM, HF_GRADIENT_PATH_KERNELS),
    (LINE_PROPERTIES, ("eri_packed", "one_electron")),
    ("IP : C O 1.13 : CCSD(T) CC-PVDZ : VERTICAL", UHF_PATH_KERNELS + ("ccsd_t_energy",)),
    ("EA : F : CCSD(T) CC-PVTZ", UHF_PATH_KERNELS + ("ccsd_t_energy",)),
    ("BDE : H F 0.92 : MP2 CC-PVTZ : ZPE", ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CCSD(T) CC-PVDZ : EXTRAPOLATE TIGHTSCF", CC_PATH_KERNELS),
)

# the lines of phase 24 with the kernels each must launch
PHASE_24_LINES = (
    ("SPE : N N 1.1 : TDHF CC-PVTZ : TIGHTSCF", ("eri_packed", "one_electron")),
    ("SPE : N N 1.1 : CIS(D) CC-PVTZ : TIGHTSCF", ("eri_packed", "one_electron")),
    (LINE_TDLDA, ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid")),
    ("SPE : O O 1.21 : CIS(D) CC-PVTZ : ML 3 TIGHTSCF", ("eri_packed", "one_electron")),
    (LINE_UKS_TD, ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid")),
    ("SPE : N N 1.1 : HF CC-PVTZ : STAB TIGHTSCF", ("eri_packed", "one_electron")),
    ("SPE : O O 1.21 : UHF CC-PVTZ : ML 3 STAB TIGHTSCF", ("eri_packed", "one_electron")),
)

# the lines of phase 25 with the kernels each must launch; the DIRECT lines
# form no N^4 tensor (no K1 launch)
PHASE_25_LINES = (
    (LINE_QZ_CC, CC_PATH_KERNELS),
    (LINE_QZ_EXTRAPOLATE, ("eri_packed", "one_electron")),
    (LINE_QZVP_DFT, ("eri_packed", "one_electron", "ao_on_grid", "density_on_grid")),
    (LINE_5Z_HF, ("eri_packed", "one_electron")),
    (LINE_5Z_HF_DIRECT, ("one_electron", "fock_direct")),
    (LINE_5Z_N2_DIRECT, ("one_electron", "fock_direct")),
)

# the lines of phase 26 with the kernels each must launch
PHASE_26_LINES = (
    (LINE_QZ_FORCE, HF_GRADIENT_PATH_KERNELS),
    (LINE_QZ_UHF_FORCE, UHF_GRADIENT_PATH_KERNELS),
    (LINE_QZ_DFT_FORCE, GRADIENT_PATH_KERNELS),
    (LINE_5Z_FORCE, HF_GRADIENT_PATH_KERNELS),
)


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


def back_to_back_ms(fn, calls: int = 20, repeats: int = 5, sleep_cycles: int = 5_000_000) -> float:
    """Device ms a call of fn() with its launches back to back: the card
    is kept busy (torch.cuda._sleep, `sleep_cycles` clock cycles: a few ms
    by default) while the host enqueues `calls` calls, so CUDA events
    around them time the device alone, gaps between launches included;
    median of `repeats` after a warm-up.  For comparing a kernel's tiles,
    and timing the quartet kernels at g and h shells, without the
    profiler's sessions."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(sleep_cycles)   # longer than enqueueing the calls
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


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

def eri_operations(plan: IntegralPlan, derivative: bool = False) -> tuple[float, float]:
    """(needed, kernel's) float64 operations of the packed ERI matrix over
    the unordered AO-pair quartets with matching x/y parities, each at its
    own class (L_bra, L_ket), from ops/integrals.py::quartet_operations;
    higher orders are exact zeros.  With `derivative`, those of K8b's
    derivative quartets (deriv_quartet_operations), without the quartets on
    one atom, which it skips: the components of IntegralPlan.shell_quartets.

    The kernel computes every part of quartet_operations for each primitive
    quartet of each AO-pair quartet.  The function needs the shared part
    (alpha and T, Boys, the R^n_00v recursion) only once a primitive
    quartet of a shell-pair quartet (IntegralPlan.shell_pairs), and the own
    part (Hermite products, x/y pairing, contraction) for each AO-pair
    quartet: that count is the bound's.  With `derivative`, the kernel's
    count is K8b's first form's, every part for each primitive quartet of
    each AO-pair quartet (the kernel's own is deriv_operations).  pair_rows_kernel,
    ~0.1% of either, is left out."""
    shell_pair, shell_prim = plan.shell_pairs()
    shell_prim = shell_prim.astype(np.float64)
    if derivative:   # every AO-pair quartet of a shell quartet has its primitive quartets
        _, quartets = plan.shell_quartets()
        la, lb, sa, sb, begin, end = (quartets[:, k].astype(np.int64) for k in range(6))
        top = int(la.max(initial=0)) + 1
        ops = np.array([[deriv_quartet_operations(a, b) for b in range(top)]
                        for a in range(top)], dtype=np.float64).reshape(top, top, 2)
        shared, own = ops[la, lb, 0], ops[la, lb, 1]
        prims, count = shell_prim[sa] * shell_prim[sb], (end - begin).astype(np.float64)
        return (float(np.sum((own * count + shared) * prims)),
                float(np.sum((shared + own) * count * prims)))
    quartets, classes = plan.work_list()
    n_prim = np.diff(plan.pair_start).astype(np.float64)
    counts = n_prim[quartets[:, 0]] * n_prim[quartets[:, 1]]
    n_shell_pairs = len(shell_prim)
    needed = kernel = 0.0
    for la, lb, begin, _, end, _, _ in classes:
        shared, own = quartet_operations(la, lb)
        primitive_quartets = counts[begin:end].sum()
        kernel += (shared + own) * primitive_quartets
        bra, ket = shell_pair[quartets[begin:end, 0]], shell_pair[quartets[begin:end, 1]]
        seen = np.zeros(n_shell_pairs * n_shell_pairs, dtype=bool)   # the class's shell quartets
        seen[np.maximum(bra, ket) * n_shell_pairs + np.minimum(bra, ket)] = True
        shell_quartets = np.flatnonzero(seen)
        needed += own * primitive_quartets + shared * np.sum(
            shell_prim[shell_quartets // n_shell_pairs] * shell_prim[shell_quartets % n_shell_pairs])
    return float(needed), float(kernel)


def deriv_launches(plan: IntegralPlan) -> int:
    """Kernel launches of one K8b or K8bu call: rows, weights, the shared
    parts of the cut runs (when there are any), a kernel a class and the
    reduction."""
    _, classes = plan.deriv_schedule()
    _, owner, _ = plan.deriv_tables()
    return len(classes) + 3 + (len(owner) > 0)


def deriv_operations(plan: IntegralPlan) -> float:
    """Float64 operations of K8b's and K8bu's algorithm (csrc/eri_deriv.cu):
    the shared part once a primitive quartet of each shell quartet (in its
    task, or in deriv_shared_kernel for the runs cut into several tasks)
    and the own part once an item (IntegralPlan.deriv_schedule),
    deriv_quartet_operations each; the shared part depends on L_bra + L_ket
    alone."""
    tasks, classes = plan.deriv_schedule()
    runs, _, _ = plan.deriv_tables()
    total = sum(deriv_quartet_operations(int(l_sum), 0)[0] * float(n)
                for l_sum, n in zip(runs[:, 3], runs[:, 5]))
    for la, lb, begin, end, _ in classes:
        shared, own = deriv_quartet_operations(int(la), int(lb))
        prims = tasks[begin:end, 4].astype(np.float64)
        total += shared * prims[tasks[begin:end, 7] < 0].sum()
        total += own * np.sum(prims * (tasks[begin:end, 6] - tasks[begin:end, 5]))
    return total


def deriv_schedule_summary(plan: IntegralPlan) -> str:
    """K8b's shell quartets, tasks and class kernels (one call launches the
    rows, the weights, a kernel a class and the reduction)."""
    components, quartets = plan.shell_quartets()
    tasks, classes = plan.deriv_schedule()
    _, shell_prim = plan.shell_pairs()
    prims = shell_prim[quartets[:, 2]] * shell_prim[quartets[:, 3]]
    items = tasks[:, 4].astype(np.int64) * (tasks[:, 6] - tasks[:, 5])
    return (f"{len(quartets)} shell quartets of {int(prims.sum())} primitive quartets and "
            f"{len(components)} AO-pair quartets, {int(items.sum())} items in {len(tasks)} "
            f"tasks, at most "
            f"{int((-(-items // SHELL_TASK_THREADS)).max(initial=0))} items a thread; a call "
            f"launches {deriv_launches(plan)} kernels, {len(classes)} of them class kernels; "
            f"{len(plan.deriv_tables()[1])} shared parts formed before the class kernels, for "
            f"the runs cut into several tasks")


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


def ptxas_report(log: str, frames: dict | None = None) -> dict:
    """Registers of each kernel, and its spill stores if any, from the
    build's ptxas report, keyed by source and kernel (the class kernels as
    quartet_light_kernel<L_bra,L_ket>[PackedOut] for K1, [FockOut] for K4,
    or deriv_shell_kernel<L_bra,L_ket>,
    K8bu's weight pass as deriv_weights_kernel[unrestricted], the grid
    kernels with their template arguments, as
    moving_grid_kernel<2,2,true> for K8cut with P whole).  With `frames`,
    each kernel's stack frame in bytes goes there under the same key."""
    report, unit, kernel, spills, frame = {}, "", "", 0, 0
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
                args = [value if kind == "i" else ("false", "true")[int(value)]
                        for kind, value in re.findall(r"L([ib])(\d+)E", rest)]
                kernel += f"<{','.join(args)}>" if args else ""
                kernel += "[unrestricted]" if "UnrestrictedEnergyWeight" in rest else ""
                kernel += next((f"[{out}]" for out in ("PackedOut", "FockOut") if out in rest),
                               "")
        elif "bytes spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
            frame = int(line.split("bytes stack frame")[0].split()[-1])
        elif "registers" in line and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            report[f"{unit}:{kernel}"] = f"{regs} ({spills} B spilled)" if spills else regs
            if frames is not None:
                frames[f"{unit}:{kernel}"] = frame
            spills = frame = 0
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
    """K7b (csrc/dft_grid.cu density_on_grid_kernel<0 or 1, P whole>): per
    point, Y = P^T phi (2 n^2, a matrix product), rho (2 n) and with
    gradients three more dot products (6 n) and their doubling (3)."""
    rest = 2.0 * n + ((6.0 * n + 3) if with_gradients else 0.0)
    return n_points * (2.0 * n * n / FP64_MMA_PER_MS + rest / FP64_PER_MS)


def one_electron_deriv_operations(plan: IntegralPlan) -> tuple[float, float]:
    """(needed, first form's) float64 operations of K8a.  Needed, as
    csrc/one_electron_deriv.cu forms them: per primitive pair the x and y
    Hermite chains raised i + j + 2 times on rows of 2 lmax + 3 entries; in
    z one i-chain raised iz + 1 times and three j-chains raised jz + 2
    (from row iz + 1), jz + 2 (from row iz - 1, only when iz > 0) and jz + 3
    (from row iz) times, on rows of 2 lmax + 4 entries; 5 operations an
    entry and raise.  The first form's count, kept beside it: seven full
    recursions of 2 lmax + 5 entries (x and y at (i, j), z at (i, j) and
    its four neighbours, each z one raised iz + jz + 3 times).  Both add
    the tangent terms, the x/y pairing, and per atom whose weight is not
    zero a Boys evaluation and a Hermite Coulomb table of order 2 lmax + 1."""
    L = plan.lmax
    NMAX = 2 * L + 1
    l_xy = (plan.l1[:, :2] + plan.l2[:, :2]).sum(axis=1).astype(np.float64)
    iz, jz = plan.l1[:, 2].astype(np.float64), plan.l2[:, 2].astype(np.float64)
    z_chains = (iz + 1) + (jz + 2) + np.where(iz > 0, jz + 2, 0.0) + (jz + 3)
    needed_raises = 5 * (2 * L + 3) * (l_xy + 4) + 5 * (2 * L + 4) * z_chains
    first_raises = 5 * (2 * L + 5) * (l_xy + 4 + 5 * (iz + jz + 3))
    terms = 100 + 3 * (L + 1) ** 2
    moving_a, moving_b = plan.atom1 == 1, plan.atom2 == 1
    atoms_with_weight = (moving_a | moving_b).astype(np.float64) + (~(moving_a & moving_b))
    per_atom = (23 + 4 * NMAX) + 4 * (NMAX + 1) + 1 + 5 * NMAX * (NMAX + 1) // 2 + 4 * NMAX + 8
    rest = np.sum(terms + atoms_with_weight * per_atom)
    return float(np.sum(needed_raises) + rest), float(np.sum(first_raises) + rest)


def density_tau_ms(n: int, n_points: int) -> float:
    """K7bt (csrc/dft_grid.cu density_on_grid_kernel<2, P whole>): per point the
    four products Y_a = P^T B_a (B_0 = phi, B_a = d_a phi; 2 n^2 each, matrix
    products), the epilogue's dot products (rho 2 n, grad rho 6 n, tau 6
    n) and its four scalings."""
    return density_ms(n, n_points, True) + n_points * (
        3 * 2.0 * n * n / FP64_MMA_PER_MS + (3 * 2.0 * n + 1) / FP64_PER_MS)


def density_deriv_ms(basis: grid.GridBasis, n_points: int, with_gradients: bool,
                     n_spins: int = 1, with_tau: bool = False) -> float:
    """csrc/dft_grid.cu moving_grid_kernel over n_spins densities (K8c,
    K8ct: 1; K8cu, K8cut: 2): per point, each AO's value and z derivative
    (~16 + 5 a primitive) once, then for each density Y = P phi (2 n^2, a
    matrix product) and rho and rho' = 2 phi' . Y (4 n); with gradients
    each AO's gradient and Hessian z column (~70 + 7 a primitive) once, for
    each density Y' = P phi' (2 n^2) and their products with Y and Y' (15
    n).  With tau (K8ct, K8cut): each AO's three gradient columns in the
    first loop (~20 n), and for each density Y_a = P d_a phi (6 n^2, matrix
    products) and tau and tau' from them (15 n)."""
    n = basis.n_ao
    n_prim = float(len(basis.exps))
    products = 2.0 * n * n
    rest = 16.0 * n + 5 * n_prim + n_spins * 4 * n
    if with_gradients:
        products += 2.0 * n * n
        rest += 70.0 * n + 7 * n_prim + n_spins * 15 * n
    if with_tau:
        products += 6.0 * n * n
        rest += 20.0 * n + n_spins * 15 * n
    return n_points * (n_spins * products / FP64_MMA_PER_MS + rest / FP64_PER_MS)


# ---------------------------------------------------------------------------
# Phase 3: K1-K3
# ---------------------------------------------------------------------------

def lane_summary(plan: IntegralPlan) -> str:
    """The lane schedule of K3 and K8a: warps, busy lanes, and the longest
    chain of primitive pairs a lane walks (their first forms walked each AO
    pair's whole chain on one thread)."""
    lanes = plan.lane_schedule()
    count = np.diff(plan.pair_start)
    live = lanes[:, 0] >= 0
    chain = int(np.max(-(-count[lanes[live, 0]] // lanes[live, 1])))
    return (f"lane schedule {lanes.shape[0] // 32} warps, {int(live.sum())} busy lanes, longest "
            f"chain {chain} primitive pairs a lane (one thread an AO pair: {int(count.max())})")


def lane_kernel_registers(unit: str, kernel: str, entry: dict, registers: dict,
                          frames: dict) -> dict:
    """ptxas's registers and stack frame of each instantiation of a
    lane-scheduled kernel (K3 and K8a: lmax 0-5; the unit is its
    KERNEL_MAX_LMAX key), into its record entry; a spill or a missing
    instantiation fails the run."""
    instantiations = {key: (value, frames.get(key)) for key, value in registers.items()
                      if key.startswith(f"{unit}:{kernel}<")}
    require(len(instantiations) == KERNEL_MAX_LMAX[unit][1] + 1
            and all(isinstance(regs, int) and frame is not None
                    for regs, frame in instantiations.values()),
            f"{kernel}: registers and stack frames {instantiations} (a spill or a missing "
            f"entry)")
    entry["registers"] = {key.split(":")[1]: regs for key, (regs, _) in instantiations.items()}
    entry["stack_frame_bytes"] = {key.split(":")[1]: frame
                                  for key, (_, frame) in instantiations.items()}
    return instantiations


def check_integrals(basis: str, device, record: dict, registers: dict, frames: dict) -> str:
    """K3 and K1 on N2 at `basis` against their plain versions
    (INTEGRAL_TOLERANCE) and bitwise over two calls; K3's device ms a
    launch (torch.profiler), and its registers and stack frames (a spill
    fails the run).  The record keeps the times at 6-311G, and K3's device
    ms a launch at every basis."""
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

    got_1e, again_1e = kernel_1e(), kernel_1e()
    err_1e = max(float(torch.max(torch.abs(k - p))) for k, p in zip(got_1e, plain_1e()))
    packed_kernel, packed_again, packed_plain = kernel_eri(), kernel_eri(), plain_eri()
    require(bool(torch.all(torch.isfinite(packed_kernel))), f"{basis}: non-finite ERI")
    err_eri = float(torch.max(torch.abs(packed_kernel - packed_plain)))
    torch.cuda.synchronize()
    require(err_1e <= INTEGRAL_TOLERANCE,
            f"{basis}: one-electron kernel off its plain version by {err_1e:.3e}")
    require(all(torch.equal(a, b) for a, b in zip(got_1e, again_1e)),
            f"{basis}: two one-electron kernel calls differ")
    require(err_eri <= INTEGRAL_TOLERANCE,
            f"{basis}: ERI kernel off its plain version by {err_eri:.3e}")
    require(torch.equal(packed_kernel, packed_again), f"{basis}: two ERI kernel calls differ")
    times = {"one_electron": (median_ms(kernel_1e), median_ms(plain_1e)),
             "eri_packed": (median_ms(kernel_eri), median_ms(plain_eri))}
    launch_ms = device_ms_a_launch(kernel_1e, "one_electron_kernel")
    for name, err in (("one_electron", err_1e), ("eri_packed", err_eri)):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    one_electron = record["one_electron"]
    one_electron.setdefault("device_ms_a_launch", {})[basis] = launch_ms
    instantiations = lane_kernel_registers("one_electron", "one_electron_kernel", one_electron,
                                           registers, frames)
    needed, algorithm = eri_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + 8 * plan.n_pairs ** 2,
                      needed / FP64_PER_MS)
    t = plan.tensors(device)
    N = plan.n_basis
    one_electron_bound = bound(
        tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"],
                     t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"], t["boys_one_electron"])
        + 8 * 9 * N * N, one_electron_operations(plan) / FP64_PER_MS)
    one_electron.setdefault("bound_ms_at", {})[basis] = one_electron_bound["bound_ms"]
    if basis == "6-311G":
        record["eri_packed"].update(
            ms=times["eri_packed"][0], plain_ms=times["eri_packed"][1], library_ms=None,
            **eri_bound)
        one_electron.update(
            ms=times["one_electron"][0], plain_ms=times["one_electron"][1], library_ms=None,
            host_ms_a_call=times["one_electron"][0] - launch_ms, **one_electron_bound)
    return (f"kernels {basis}: lmax {plan.lmax}, {plan.n_pairs} AO pairs, "
            f"{plan.n_prim_pairs} primitive pairs, {work_list_summary(plan)}; one_electron "
            f"max|diff| {err_1e:.3e}, two calls bitwise equal ({lane_summary(plan)}; "
            f"{times['one_electron'][0]:.4f} ms vs plain {times['one_electron'][1]:.4f} ms; "
            f"device ms a launch {launch_ms:.5f}; "
            f"bound {one_electron_bound['bound_ms']:.5f} ms by {one_electron_bound['bound_by']}; "
            f"registers and stack frame bytes (ptxas) {json.dumps(instantiations)}); eri_packed "
            f"max|diff| {err_eri:.3e}, two calls bitwise equal ({times['eri_packed'][0]:.4f} ms "
            f"vs plain {times['eri_packed'][1]:.4f} ms, bound {eri_bound['bound_ms']:.5f} ms by "
            f"{eri_bound['bound_by']}; {needed:.4g} operations needed, {algorithm:.4g} in the "
            f"kernel's algorithm, {algorithm / FP64_PER_MS:.5f} ms)")


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


def profile_path(line: str, warm_runs: int = WARM_RUNS, needs: tuple = ()) -> dict:
    """warm_runs warm runs of `line`, then one under torch.profiler (see
    profiled_call for `needs`)."""
    walls, scf_ms, cc_ms, phases = [], [], [], {}
    for _ in range(warm_runs):
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
        **profiled_run(line, needs),
    }


# the kernels of each quartet-engine wrapper, by kernel name: K1's and K4's
# class kernels; all of K8b's and K8bu's (rows, weights, the class kernels
# both share, the reduction), which no session launches both of
QUARTET_KERNELS = {"eri_packed": r"PackedOut", "fock_direct": r"FockOut",
                   "eri_deriv_energy": r"::deriv_(rows|shared|shell|reduce)_kernel"
                                       r"|::deriv_weights_kernel<[^>]*::EnergyWeight>",
                   "eri_deriv_energy_unrestricted":
                       r"::deriv_(rows|shared|shell|reduce)_kernel"
                       r"|::deriv_weights_kernel<[^>]*UnrestrictedEnergyWeight>"}
# the kernels that every K8b or K8bu call launches once each, by which a
# session's recorded calls are counted (the most recorded of them)
DERIV_CALL_KERNELS = {"eri_deriv_energy": (r"::deriv_rows_kernel", r"::deriv_reduce_kernel",
                                           r"::deriv_weights_kernel<[^>]*::EnergyWeight>"),
                      "eri_deriv_energy_unrestricted":
                          (r"::deriv_rows_kernel", r"::deriv_reduce_kernel",
                           r"::deriv_weights_kernel<[^>]*UnrestrictedEnergyWeight>")}


def hand_kernels(kernels) -> dict:
    """Launches and device ms of each csrc/ kernel among a profile's device
    events, by function name (and K1/K4 output, K8b/K8bu weight, the
    moving-grid kernel's densities and output set, as
    moving_grid_kernel[1,1] for K8c, [2,1] for K8cu, [1,2] for K8ct, [2,2]
    for K8cut, [S,0] without gradients; the density kernel's output set, as
    density_on_grid_kernel[1] for K7b, [0] for K7b without gradients, [2]
    for K7bt)."""
    hand: dict = {}
    for e in kernels:
        match = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", e.name)
        if match:
            output_of = re.search(r"(PackedOut|FockOut|UnrestrictedEnergyWeight)"
                                  r"|moving_grid_kernel<(\d+), ?(\d+)"
                                  r"|density_on_grid_kernel<(\d+)", e.name)
            tag = output_of and (output_of.group(1) or output_of.group(4)
                                 or f"{output_of.group(2)},{output_of.group(3)}")
            key = match.group(1) + (f"[{tag}]" if tag else "")
            entry = hand.setdefault(key, {"launches": 0, "device_ms": 0.0})
            entry["launches"] += 1
            entry["device_ms"] += e.time_range.elapsed_us() / 1e3
    return hand


def recorded(key: str, kernels, hand: dict) -> bool:
    """Whether a profile has device time for `key`: a key of hand_kernels,
    or a wrapper of QUARTET_KERNELS (K8b's and K8bu's by the kernels that
    each of their calls launches once, by which their calls are counted)."""
    if key in DERIV_CALL_KERNELS:
        return any(re.search(once, e.name) for once in DERIV_CALL_KERNELS[key] for e in kernels)
    if key in QUARTET_KERNELS:
        return any(re.search(QUARTET_KERNELS[key], e.name) for e in kernels)
    return key in hand


def profiled_run(line: str, needs: tuple = ()) -> dict:
    """One run of `line` under torch.profiler (see profiled_call)."""
    return profiled_call(lambda: run_counted(line, ())[1:], needs)


def profiled_call(counted, needs: tuple = ()) -> dict:
    """One call of counted() (which returns its wall seconds and launches)
    under torch.profiler: device busy time as the union of the kernel
    intervals, the idle share, kernel and cudaLaunchKernel counts, the top
    kernels, each csrc/ kernel's launches and device time, and for the
    quartet-engine wrappers the union of their class kernels' intervals a
    call.  `needs` names the csrc/ kernels (keys of hand_kernels, or
    wrappers of QUARTET_KERNELS) that the caller reads from the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=activities) as prof:
            profiled_wall, profiled_launches = counted()
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        hand = hand_kernels(kernels)
        missing = [key for key in needs if not recorded(key, kernels, hand)]
        if kernels and not missing:
            break
        # a session records the launches of the library's kernels only in
        # part, and short sessions after a long one have come back with
        # none of them: wait a second and run it again
        print(f"profiler: a session of {len(events)} events recorded {len(kernels)} device "
              f"events and none of {missing or 'the kernels'} (attempt {attempt} of "
              f"{PROFILE_ATTEMPTS})")
        time.sleep(1.0)
    require(bool(kernels) and not missing,
            f"torch.profiler recorded no device event of {missing or 'any kernel'} in "
            f"{PROFILE_ATTEMPTS} sessions; the last one's csrc/ kernels: {sorted(hand)}")
    busy_us = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    launch_calls = [e for e in events if e.name == "cudaLaunchKernel"]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    # the quartet engine's class kernels overlap on side streams: a wrapper
    # call's device time is the union of its kernels' intervals, over its
    # calls (K8b's and K8bu's over their recorded calls: a session records
    # the library's launches only in part)
    require(not (profiled_launches["eri_deriv_energy"]
                 and profiled_launches["eri_deriv_energy_unrestricted"]),
            "a profiled session launched both K8b and K8bu, whose class kernels are one")
    quartet_ms_a_launch = {}
    for name, pattern in QUARTET_KERNELS.items():
        if not profiled_launches[name]:
            continue
        calls = profiled_launches[name]
        if name in DERIV_CALL_KERNELS:
            calls = max(sum(1 for e in kernels if re.search(once, e.name))
                        for once in DERIV_CALL_KERNELS[name])
            require(calls > 0, f"{name}: {profiled_launches[name]} launches and no device time "
                               f"recorded for them")
        quartet_ms_a_launch[name] = _busy_us([(e.time_range.start, e.time_range.end)
                                              for e in kernels
                                              if re.search(pattern, e.name)]) / 1e3 / calls
    return {
        "profile_attempts": attempt,
        "profiled_wall_s": profiled_wall,
        "profiled_launches": {name: n for name, n in profiled_launches.items() if n},
        "device_kernels": len(kernels),
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / profiled_wall,
        "cudaLaunchKernel_calls": len(launch_calls),
        "cudaLaunchKernel_host_ms": sum(e.cpu_time_total for e in launch_calls) / 1e3,
        "top_kernels_device_ms": {name[:90]: us / 1e3 for name, us in top_kernels},
        "hand_kernels": hand,
        "quartet_class_kernels_busy_ms_a_launch": quartet_ms_a_launch,
    }


# ---------------------------------------------------------------------------
# Phase 6: K7a, K7b, K6 at the DFT path's shapes
# ---------------------------------------------------------------------------

def check_dft_kernels(molecule, P_converged, device, record: dict, registers: dict) -> str:
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

    def kernel_rho_only():
        return grid.density_on_grid(P, bfs)

    def plain_rho():
        return grid._density_on_grid_plain(P, bfs, bf_grads)

    def library_rho():
        return torch.einsum("ij,ik,jk->k", P, bfs, bfs)

    (rho, grad_rho), (rho_p, grad_rho_p) = kernel_rho(), plain_rho()
    (rho_again, grad_rho_again), (rho_only, _) = kernel_rho(), kernel_rho_only()
    err_rho = max(float(torch.max(torch.abs(rho - rho_p))),
                  float(torch.max(torch.abs(grad_rho - grad_rho_p))),
                  float(torch.max(torch.abs(library_rho() - rho))))
    require(err_rho <= GRID_TOLERANCE, f"density_on_grid off its plain version by {err_rho:.3e}")
    require(torch.equal(rho, rho_again) and torch.equal(grad_rho, grad_rho_again)
            and torch.equal(rho_only, kernel_rho_only()[0]),
            "two density_on_grid calls differ")
    require(torch.equal(rho_only, rho), "density_on_grid's rho differs without gradients")
    ms, rho_only_ms, plain_ms, library_ms = medians_ms(
        (kernel_rho, kernel_rho_only, plain_rho, library_rho), 5)
    launch_ms = device_ms_a_launch(kernel_rho, "density_on_grid_kernel[1]")
    rho_only_launch_ms = device_ms_a_launch(kernel_rho_only, "density_on_grid_kernel[0]")
    rho_only_bound = bound(tensor_bytes(P, bfs, rho), density_ms(n, G, False))
    # device ms a launch back to back at every tile that fits, for the
    # choice in density_layout
    tiles = {}
    for outputs, grads_in in ((grid.DENSITY_GRADIENTS, bf_grads), (grid.DENSITY_RHO, None)):
        for points_a_tile, whole, buffers, _ in grid.density_layouts(n, outputs):
            key = (f"{points_a_tile},{'whole' if whole else 'rows'},{buffers} buffers"
                   + ("" if grads_in is not None else ",rho only"))
            tiles[key] = back_to_back_ms(
                lambda: grid._density_kernel(P, bfs, grads_in, False,
                                             (points_a_tile, whole, buffers)))
    found = {key: value for key, value in registers.items()
             if key.startswith(("dft_grid:density_on_grid_kernel<0,",
                                "dft_grid:density_on_grid_kernel<1,"))}
    require(len(found) == 4 and all(isinstance(v, int) for v in found.values()),
            f"density_on_grid: registers {found} (a spill or a missing entry)")
    points_a_tile, whole_p, buffers, shared = grid.density_layout(n, grid.DENSITY_GRADIENTS)
    record["density_on_grid"] = {
        "max_abs_err": err_rho, "ms": ms, "device_ms_a_launch": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        **bound(tensor_bytes(P, bfs, bf_grads, rho, grad_rho), density_ms(n, G, True)),
        "host_ms_a_call": ms - launch_ms,
        "rho_only_ms": rho_only_ms, "rho_only_device_ms_a_launch": rho_only_launch_ms,
        "rho_only_bound_ms": rho_only_bound["bound_ms"],
        "registers": {key.split(":")[1]: value for key, value in found.items()},
        "tiles_back_to_back_ms": tiles}
    density_line = (
        f"density_on_grid max|diff| {err_rho:.3e}, two calls bitwise equal, rho bitwise equal "
        f"without gradients; {points_a_tile} points a tile, P^T "
        f"{'whole' if whole_p else 'in 16 rows'}, {buffers} column buffers, {shared} B a block; "
        f"{ms:.4f} ms ({launch_ms:.5f} device ms a launch, bound "
        f"{record['density_on_grid']['bound_ms']:.5f} ms by "
        f"{record['density_on_grid']['bound_by']}), rho only {rho_only_ms:.4f} ms "
        f"({rho_only_launch_ms:.5f} device ms a launch, bound {rho_only_bound['bound_ms']:.5f} "
        f"ms by {rho_only_bound['bound_by']}), vs plain {plain_ms:.4f} ms, einsum (rho only) "
        f"{library_ms:.4f} ms; device ms a launch back to back at each tile "
        f"{json.dumps(tiles)}; registers (ptxas) {json.dumps(found)}")

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
            f"{density_line}; "
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


def repeated_calls(fn, calls: int):
    """A counted() for profiled_call: `calls` calls of fn(), and twice as
    many in each session that profiled_call runs again (a session misses
    the first launches of the library's kernels, so a longer one records
    more of them)."""
    sessions = []

    def counted():
        sessions.append(calls * 2 ** len(sessions))
        _kernels.reset_launch_counts()
        torch.ones(1, device="cuda")   # one torch kernel in the session as well
        start = time.perf_counter()
        for _ in range(sessions[-1]):
            fn()
        torch.cuda.synchronize()
        return time.perf_counter() - start, dict(_kernels.launches)

    return counted


def device_ms_a_launch(fn, key: str, calls: int = 50):
    """Device ms a launch of the csrc/ kernel `key` (as profiled_call names
    it in hand_kernels, or a quartet-engine wrapper of QUARTET_KERNELS:
    the union of its kernels a call) over `calls` calls of fn() under
    torch.profiler: the session records the launches of the library's
    kernels only in part, the fewer the shorter the session, so the time is
    a recorded launch's, over enough calls."""
    fn()
    profile = profiled_call(repeated_calls(fn, calls), (key,))
    if key in QUARTET_KERNELS:
        return profile["quartet_class_kernels_busy_ms_a_launch"][key]
    return _device_ms_a_launch(profile, key)


def stage_ms(profile: dict, stages: tuple, launches_a_call: int) -> dict:
    """Device ms a launch of each csrc/ kernel in `stages` (a wrapper's
    kernels, each launched launches_a_call times a call) in a profile, as
    a recorded launch's (a session may miss some), and so a call's; a stage
    without a profiler entry fails the run."""
    result = {}
    for key in stages:
        entry = profile["hand_kernels"].get(key)
        require(entry is not None, f"no profiler entry for {key}; the profile's csrc/ kernels: "
                                   f"{sorted(profile['hand_kernels'])}")
        a_launch = entry["device_ms"] / entry["launches"]
        result[key] = {"device_ms": a_launch * launches_a_call, "launches": launches_a_call,
                       "device_ms_a_launch": a_launch, "launches_recorded": entry["launches"]}
    return result


def stage_ms_a_call(fn, stages: tuple, launches_a_call: int, calls: int = 5) -> dict:
    """stage_ms over `calls` calls of fn() under torch.profiler, after one
    call outside it."""
    fn()
    return stage_ms(profiled_call(repeated_calls(fn, calls), stages), stages, launches_a_call)


def unit_registers(registers: dict, unit: str) -> dict:
    """ptxas's registers of every kernel of one source, failing the run on
    a spill."""
    found = {key: value for key, value in registers.items() if key.startswith(unit + ":")}
    spills = {key: value for key, value in found.items() if not isinstance(value, int)}
    require(bool(found) and not spills, f"{unit}.cu: kernels {found}, spills {spills}")
    return found


def check_mo_transform(device, record: dict, registers: dict) -> str:
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

    def mixed_kernel():
        return motransform.pair_packed_to_mo_mixed(G_pair, pair_index, W_left, W_right, n_mo)

    got, expected, mixed = kernel(), plain_same(), mixed_kernel()
    mixed_expected = plain(G_pair, W_left, W_right).T
    require(bool(torch.all(torch.isfinite(got))), "mo_half_transform: non-finite output")
    err = max(_relative(got, expected), _relative(mixed, mixed_expected))
    require(torch.equal(got, kernel()) and torch.equal(mixed, mixed_kernel()),
            "two mo_half_transform calls differ")

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
    rows6_got = motransform.half_transform(M6, pidx6, W6)
    columns6 = M6.T.contiguous()
    columns6_got = motransform.half_transform(columns6, pidx6, W6, transposed=True)
    err6 = max(_relative(rows6_got, expected6), _relative(columns6_got, expected6))
    require(torch.equal(rows6_got, motransform.half_transform(M6, pidx6, W6))
            and torch.equal(columns6_got, motransform.half_transform(columns6, pidx6, W6,
                                                                     transposed=True)),
            "two mo_half_transform calls at the cc-pV6Z shape differ")
    torch.cuda.synchronize()
    require(err <= TRANSFORM_TOLERANCE,
            f"mo_half_transform off its plain version by {err:.3e} (relative)")
    require(err6 <= TRANSFORM_TOLERANCE,
            f"mo_half_transform at the cc-pV6Z shape off its plain version by {err6:.3e}")
    ms, plain_ms = median_ms(kernel), median_ms(plain_same)
    # library_ms: the two phases' products as torch.matmul, W^T (M_r W), on
    # the rows expanded to dense (N, N) before the timing
    expanded = (G_pair[:, pair_index],
                motransform._chunked_half_transform(G_pair, pair_index, W, tri, 128)
                .T.contiguous()[:, pair_index])

    def library():
        for dense in expanded:
            torch.matmul(W.T, torch.matmul(dense, W))

    library_ms = median_ms(library)
    del expanded
    launch_ms = device_ms_a_launch(kernel, "half_transform_kernel")
    n_mo_pairs = n_mo * (n_mo + 1) // 2
    N = plan.n_basis
    H_bytes = 8 * plan.n_pairs * n_mo_pairs
    layout = motransform.half_transform_layout(N, n_mo)
    staged = registers.get("mo_transform:half_transform_kernel<true>")
    spills = {key: value for key, value in registers.items()
              if "half_transform_kernel" in key and not isinstance(value, int)}
    require(not spills, f"mo_half_transform spills registers: {spills}")
    record["mo_half_transform"] = {
        "max_abs_err": max(float(torch.max(torch.abs(got - expected))),
                           float(torch.max(torch.abs(mixed - mixed_expected)))),
        "ms": ms, "device_ms_a_launch": launch_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "registers": staged,
        # two launches: G -> H, then H (read transposed) -> G_mo
        **bound(tensor_bytes(G_pair, got) + 2 * H_bytes + 2 * tensor_bytes(W, pair_index),
                (half_transform_operations(plan.n_pairs, N, n_mo)
                 + half_transform_operations(n_mo_pairs, N, n_mo)) / FP64_MMA_PER_MS)}
    return (f"kernels DIRECT: mo_half_transform N2/cc-pVTZ ({plan.n_pairs} AO pairs -> "
            f"{n_mo_pairs} MO pairs, both phases; {layout}) relative max|diff| {err:.3e} "
            f"(mixed included), cc-pV6Z shape ({rows6} rows, N {N6}, n_mo {n_mo6}, "
            f"{motransform.half_transform_layout(N6, n_mo6)}) {err6:.3e}; two calls bitwise "
            f"equal; {ms:.4f} ms ({launch_ms} device ms a launch) vs plain {plain_ms:.4f} ms, "
            f"both phases' products as torch.matmul on the expanded rows {library_ms:.4f} ms; "
            f"bound {record['mo_half_transform']['bound_ms']:.5f} ms by "
            f"{record['mo_half_transform']['bound_by']}; registers (ptxas) {staged} (panels: "
            f"{registers.get('mo_transform:half_transform_kernel<false>')})")


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

def host_ms_a_call(fn, calls: int = 50) -> float:
    """Host ms a call of fn(): the enqueue of `calls` calls, the device left
    behind, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - start) / calls * 1e3
    torch.cuda.synchronize()
    return host


# K8b's and K8bu's class kernels, the deriv_shell_kernel<LA, LB>
# instantiations, one a class (L_bra, L_ket) up to (10, 10): those up to
# (6, 6) in csrc/eri_deriv.cu, those of L_bra = 7..10 in
# csrc/eri_deriv_l7.cu .. eri_deriv_l10.cu (the rows, weight, shared-part
# and reduction kernels are counted apart)
DERIV_CLASS_KERNELS = 66
DERIV_UNITS = ("eri_deriv", "eri_deriv_l7", "eri_deriv_l8", "eri_deriv_l9", "eri_deriv_l10")


def deriv_kernel_registers(entry: dict, registers: dict, frames: dict,
                           weight: str) -> dict:
    """ptxas's registers and stack frames of K8b's or K8bu's kernels (its
    weight pass `weight`, the class kernels and the rows both share, in
    DERIV_UNITS) into its record entry; a spill or a missing instantiation
    fails the run."""
    found = {}
    for key, value in registers.items():
        unit, _, kernel = key.partition(":")
        if unit in DERIV_UNITS and (kernel == weight or not kernel.startswith("deriv_weights")):
            found[key] = (value, frames.get(key))
    shells = [key for key in found if ":deriv_shell_kernel<" in key]
    rows = [key for key in found if key.startswith("eri_deriv:deriv_rows_kernel<")]
    weight_key, reduce_key = f"eri_deriv:{weight}", "eri_deriv:deriv_reduce_kernel"
    require(len(shells) == DERIV_CLASS_KERNELS and len(rows) == KERNEL_MAX_LMAX[
        "eri_deriv_energy"][1] + 1 and weight_key in found and reduce_key in found
            and "eri_deriv:deriv_shared_kernel" in found
            and all(isinstance(regs, int) and frame is not None
                    for regs, frame in found.values()),
            f"eri_deriv: registers and stack frames {found} (a spill or a missing "
            f"instantiation)")
    entry["registers"] = {key: regs for key, (regs, _) in found.items()}
    entry["stack_frame_bytes"] = {key: frame for key, (_, frame) in found.items()}
    class_registers = [found[k][0] for k in shells]
    high = [found[k][0] for k in shells if not k.startswith("eri_deriv:")]
    return {"class kernels": [min(class_registers), max(class_registers)],
            "class kernels of L_bra 7-10": [min(high), max(high)],
            weight: found[weight_key][0], "rows": [found[k][0] for k in sorted(rows)],
            "shared parts": found["eri_deriv:deriv_shared_kernel"][0],
            "stack frames": sorted({frame for _, frame in found.values()})}


def check_gradient_integrals(symbol: str, partner: str, bond_angstrom: float, basis: str,
                             device, record: dict, registers: dict, frames: dict) -> str:
    """K8a and K8b against their plain versions on one molecule (atom 1
    moving, the origin at the centre of mass), both bitwise over two calls,
    K8b on a seeded density-like P; their device ms a launch
    (torch.profiler), K8a's lane schedule and K8b's shell-quartet schedule,
    K8b's launches and host ms a call, and their registers and stack frames
    (a spill or a missing instantiation fails the run).  The record keeps
    the times at N2/cc-pVTZ, and the device ms a launch and bounds at each
    molecule."""
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

    got_1e, again_1e = kernel_1e(), kernel_1e()
    err_1e = max(float(torch.max(torch.abs(k - p))) for k, p in zip(got_1e, plain_1e()))
    e_kernel, e_again, e_plain = kernel_2e(), kernel_2e(), plain_2e()
    torch.cuda.synchronize()
    err_2e = abs(float(e_kernel - e_plain))
    require(all(bool(torch.all(torch.isfinite(x))) for x in got_1e),
            f"{basis}: non-finite one-electron tangent")
    require(bool(torch.isfinite(e_kernel)), f"{basis}: non-finite two-electron tangent")
    require(err_1e <= INTEGRAL_TOLERANCE,
            f"{basis}: one_electron_deriv off its plain version by {err_1e:.3e}")
    require(all(torch.equal(a, b) for a, b in zip(got_1e, again_1e)),
            f"{basis}: two one_electron_deriv calls differ")
    require(err_2e <= INTEGRAL_TOLERANCE,
            f"{basis}: eri_deriv_energy off its plain version by {err_2e:.3e}")
    require(torch.equal(e_kernel, e_again), f"{basis}: two eri_deriv_energy calls differ")
    ms_1e, ms_1e_plain = median_ms(kernel_1e), median_ms(plain_1e)
    ms_2e, ms_2e_plain = median_ms(kernel_2e), median_ms(plain_2e, repeats=1)
    launch_ms = device_ms_a_launch(kernel_1e, "one_electron_deriv_kernel")
    launch_ms_2e = device_ms_a_launch(kernel_2e, "eri_deriv_energy")
    host_ms_2e = host_ms_a_call(kernel_2e)
    t = plan.tensors(device)
    needed_1e, first_count_1e = one_electron_deriv_operations(plan)
    one_electron_bound = bound(
        tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"], t["atom1"],
                     t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"],
                     t["boys_one_electron_deriv"]) + 8 * 9 * N * N,
        needed_1e / FP64_PER_MS)
    needed, first_count = eri_operations(plan, derivative=True)
    algorithm = deriv_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + tensor_bytes(P, t["pid_i"], t["pid_j"]) + 8,
                      needed / FP64_PER_MS)
    for name, err in (("one_electron_deriv", err_1e), ("eri_deriv_energy", err_2e)):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    one_electron = record["one_electron_deriv"]
    molecule_name = f"{symbol}{partner or symbol}/{basis}"
    one_electron.setdefault("device_ms_a_launch", {})[molecule_name] = launch_ms
    one_electron.setdefault("bound_ms_at", {})[molecule_name] = one_electron_bound["bound_ms"]
    instantiations = lane_kernel_registers("one_electron_deriv", "one_electron_deriv_kernel",
                                           one_electron, registers, frames)
    two_electron = record["eri_deriv_energy"]
    two_electron.setdefault("device_ms_a_launch", {})[molecule_name] = launch_ms_2e
    two_electron.setdefault("host_ms_a_call", {})[molecule_name] = host_ms_2e
    two_electron.setdefault("launches_a_call", {})[molecule_name] = deriv_launches(plan)
    two_electron.setdefault("bound_ms_at", {})[molecule_name] = eri_bound["bound_ms"]
    deriv_registers = deriv_kernel_registers(two_electron, registers, frames,
                                             "deriv_weights_kernel")
    if basis == "CC-PVTZ" and partner is None:
        one_electron.update(ms=ms_1e, plain_ms=ms_1e_plain, library_ms=None,
                            host_ms_a_call=ms_1e - launch_ms, **one_electron_bound)
        two_electron.update(ms=ms_2e, plain_ms=ms_2e_plain, library_ms=None, **eri_bound)
    return (f"gradient kernels {molecule_name}: lmax {plan.lmax}, {plan.n_pairs} AO pairs, "
            f"{plan.n_prim_pairs} primitive pairs; one_electron_deriv max|diff| {err_1e:.3e}, "
            f"two calls bitwise equal ({lane_summary(plan)}; {ms_1e:.4f} ms vs plain "
            f"{ms_1e_plain:.4f} ms; device ms a launch {launch_ms:.5f}; bound "
            f"{one_electron_bound['bound_ms']:.5f} ms by {one_electron_bound['bound_by']} "
            f"({needed_1e:.4g} operations needed; the first form's count {first_count_1e:.4g}, "
            f"{first_count_1e / FP64_PER_MS:.5f} ms); registers and stack frame bytes "
            f"(ptxas) {json.dumps(instantiations)}); "
            f"eri_deriv_energy dE/dR {float(e_kernel)!r}, |diff| {err_2e:.3e}, two calls bitwise "
            f"equal ({deriv_schedule_summary(plan)}; {ms_2e:.4f} ms vs plain {ms_2e_plain:.4f} "
            f"ms, one run; device ms a launch {launch_ms_2e:.5f}, host ms a call "
            f"{host_ms_2e:.4f}; bound {eri_bound['bound_ms']:.5f} ms by "
            f"{eri_bound['bound_by']}; {needed:.4g} operations needed, {algorithm:.4g} in the "
            f"kernel's algorithm, {algorithm / FP64_PER_MS:.5f} ms (the first form's: "
            f"{first_count:.4g}, {first_count / FP64_PER_MS:.5f} ms); registers (ptxas) "
            f"{json.dumps(deriv_registers)})")


def profile_gradient_path(line: str, needs: tuple = ()) -> dict:
    """WARM_RUNS warm runs of an OPT line (the wall per OPT iteration and
    the gradient's share of it, from the port's phase timers; one analytic
    gradient, so one K8a launch, an iteration), then one under
    torch.profiler (see profiled_call for `needs`)."""
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
        **profiled_run(line, needs),
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


def check_frequency(line: str, frequency_ref: float, zpe_ref: float,
                    kernels: tuple = HF_GRADIENT_PATH_KERNELS) -> dict:
    result, wall, launches = run_counted(line, kernels)
    hessian, _, frequency, zpe = (float(x) for x in result)
    require(abs(frequency - frequency_ref) <= FREQUENCY_TOLERANCE,
            f"{line}: frequency {frequency - frequency_ref:.3e} per cm from the reference")
    require(abs(zpe - zpe_ref) <= E_TOLERANCE,
            f"{line}: zero-point energy {zpe - zpe_ref:.3e} Ha from the reference")
    print(f"end to end: {line}; force constant {hessian!r}, frequency {frequency!r} per cm "
          f"({frequency - frequency_ref:.3e} from the reference), ZPE {zpe!r} "
          f"({zpe - zpe_ref:.3e} Ha); wall {wall:.3f} s; launches {launches}")
    return launches


def check_gradient_paths(record: dict) -> dict:
    """The gradient path at full width (OPT N2 B3LYP/cc-pVTZ with its
    profile, FREQ CO HF/cc-pVTZ) and BASELINE configs 3 and 5 (OPT H2
    B3LYP/6-31G, FREQ and MD of CO HF/6-31G), each against tuna_tpu's
    numbers, one K8c launch a gradient on the OPT lines; records K8c's
    device ms a launch from the profile of the cc-pVTZ OPT and returns the
    launches summed over these runs."""
    runs = [check_optimisation(LINE_OPT, GRADIENT_PATH_KERNELS, BOND_REF_OPT, E_REF_OPT,
                               ITERATIONS_OPT)]
    profile = profile_gradient_path(LINE_OPT, ("moving_grid_kernel[1,1]",))
    record.setdefault("density_deriv_on_grid", {})["device_ms_a_launch"] = \
        _device_ms_a_launch(profile, "moving_grid_kernel[1,1]")
    print("profile: " + json.dumps(profile))
    runs.append(check_frequency(LINE_FREQ, FREQUENCY_REF_FREQ, ZPE_REF_FREQ))
    runs.append(check_optimisation(LINE_OPT_H2, GRADIENT_PATH_KERNELS, BOND_REF_OPT_H2,
                                   E_REF_OPT_H2, ITERATIONS_OPT_H2))
    for launches in (runs[0], runs[2]):
        require(launches["density_deriv_on_grid"] == launches["one_electron_deriv"] > 0,
                "an OPT line: not one K8c launch a gradient")
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


U_TRIPLES_STAGES = ("u_triples_raw_kernel", "u_triples_energy_kernel")   # K2u's stages A, B


def check_u_triples(no: int, nv: int, device, record: dict, registers: dict,
                    v_scale: float = 1.0) -> str:
    """K2u against its plain version at o = no, v = nv, bitwise over two
    calls, with its peak device memory a call and each stage's device ms a
    call (torch.profiler), no register spill (ptxas); the record keeps the
    largest error over the shapes, the times of the first shape checked
    (config A's, o = 16, v = 36) and every shape's measurements under
    `shapes`."""
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
    n_batches = len(cc.u_triples_plan(no, nv, cc.U_TRIPLES_WORKSPACE_BYTES))
    stages = stage_ms_a_call(kernel, U_TRIPLES_STAGES, n_batches)
    device_ms = sum(stage["device_ms"] for stage in stages.values())
    library_ms = u_stage_a_library_ms(args)
    u_bound = bound(tensor_bytes(*args), u_triples_ms(no, nv))
    entry = record.setdefault("uccsd_t_energy", {"max_abs_err": 0.0, "shapes": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    if "ms" not in entry:
        entry.update(ms=ms, device_ms_a_launch=device_ms, plain_ms=plain_ms,
                     library_ms=library_ms, **u_bound,
                     registers=unit_registers(registers, "ccsd_t_u"))
    entry["shapes"].append({"o": no, "v": nv, "v_scale": v_scale, "ms": ms,
                            "device_ms_a_launch": device_ms, "stages": stages,
                            "plain_ms": plain_ms, "library_ms": library_ms, "max_abs_err": err,
                            **u_bound, "peak_bytes_a_call": peak_bytes})
    return (f"kernels spin-orbital (T): o {no}, v {nv}, v_scale {v_scale}; E {e_kernel:.15e}, "
            f"|diff| {err:.3e} (relative {err / abs(e_plain):.3e}), two calls bitwise equal; "
            f"{ms:.4f} ms (device {device_ms:.4f} ms a call: stage A "
            f"{stages['u_triples_raw_kernel']['device_ms']:.4f}, B "
            f"{stages['u_triples_energy_kernel']['device_ms']:.4f}) vs plain {plain_ms:.4f} ms, "
            f"stage A as batched torch.matmul "
            f"{library_ms:.4f} ms; bound {u_bound['bound_ms']:.5f} ms by "
            f"{u_bound['bound_by']}; {n_batches} batches, peak device memory a call "
            f"{peak_bytes} bytes (one o^3 v^3 tensor: {8 * no ** 3 * nv ** 3} bytes)")


class Recorder:
    """Wraps the function `name` of `module` (post.cc unless given) while a
    path runs, keeping the positional inputs and the result of each call,
    so that the path's (T) or (Q) can be held to the kernel's plain version
    on the same tensors, and its MP parts read."""

    def __init__(self, name: str, module=cc):
        self.name, self.module = name, module

    def __enter__(self):
        self.calls, self.original = [], getattr(self.module, self.name)

        def recording(*args, **kwargs):
            result = self.original(*args, **kwargs)
            self.calls.append((args, result))
            return result

        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def check_uhf_path(line: str, kernels: tuple, iterations_ref: tuple, E_scf_ref: float,
                   E_ref: float | None = None, E_ccsd_ref: float | None = None) -> tuple:
    """A UHF CC(T) line on the card against tuna_tpu's SCF energy and
    iteration counts and its total (or, where tuna_tpu's (T) does not fit
    the host, CCSD) energy, to UHF_TOLERANCE; the path's (T) against K2u's
    plain version on the path's own inputs.  Returns (energy, SCF output,
    launches)."""
    with Recorder("uccsd_t_energy") as recorder:
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


def check_uhf_paths(record: dict) -> dict:
    """Phase 13: the UHF paths with their profiles; returns the launches
    summed over the counted runs and records K2u's device ms a launch by
    stage on lines A and C from their profiles."""
    runs = []
    energy, scf, launches = check_uhf_path(LINE_UHF, UHF_PATH_KERNELS, ITERATIONS_UHF,
                                           E_SCF_REF_UHF, E_ref=E_REF_UHF)
    runs.append(launches)
    profile = profile_path(LINE_UHF, needs=U_TRIPLES_STAGES)
    paths = record["uccsd_t_energy"].setdefault("paths", {})
    paths["A"] = stage_ms(profile, U_TRIPLES_STAGES,
                          len(cc.u_triples_plan(16, 36, cc.U_TRIPLES_WORKSPACE_BYTES)))
    print("profile: " + json.dumps(profile))
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
    profile = profile_path(LINE_UHF_TZ, needs=U_TRIPLES_STAGES)
    paths["C"] = stage_ms(profile, U_TRIPLES_STAGES,
                          len(cc.u_triples_plan(16, 104, cc.U_TRIPLES_WORKSPACE_BYTES)))
    print("profile: " + json.dumps(profile))
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phases 14 and 15: K9, the (Q) path and the iterative triples lines
# ---------------------------------------------------------------------------

def quadruples_ms(no: int, nv: int) -> tuple[float, float]:
    """(needed, K9's) ms of the (Q) energy's float64 operations.  The
    function needs, for each ordered (ijkl) and each of its v^4 elements,
    the six raw terms and alpha and beta, 4 v + 6 o multiply-adds once the
    vvvv term's half W[ijcfab] is formed (o^2 v^5 multiply-adds, one a pair
    ij; S2 and S4 are S1 and S3 with c and d exchanged, so they need none),
    and the o v^2 intermediates X, Y, V (o^4 v^2 (o + 2 v)); 2 operations
    each at the matrix-product rate.  Then, per ordered (ijkl) and element,
    the symmetrisation and Z (~20 operations), and per multiset and element
    the denominator and two products (~10).  K9 forms S2 and S4 (4 v + 8 o
    an element) and the vvvv term as two products, P = (cf|ae) t2[kl f d]
    and t2[ij e b] P, v more an element (5 v + 8 o), and X, Y, V once an
    ordering and range of min(y) of its plan at the default cap."""
    o4v4 = float(no ** 4 * nv ** 4)
    multisets = float(np.prod(range(no, no + 4)) / 24)
    rest = (20.0 * o4v4 + 10.0 * multisets * nv ** 4) / FP64_PER_MS
    xyv = float(no ** 4 * nv ** 2 * (no + 2 * nv))
    needed = o4v4 * (4 * nv + 6 * no) + xyv + float(no ** 2 * nv ** 5)
    batches = cc.quadruples_plan(no, nv, cc.QUADRUPLES_WORKSPACE_BYTES)[0]
    own = o4v4 * (5 * nv + 8 * no) + xyv * len(dict.fromkeys(map(tuple, batches[:, 6:].tolist())))
    return (2.0 * needed / FP64_MMA_PER_MS + rest, 2.0 * own / FP64_MMA_PER_MS + rest)


def quadruples_args(no: int, nv: int, device) -> tuple:
    """Seeded (Q) inputs at o = no, v = nv: the window's chemists' (pq|rs),
    symmetric as real orbitals' are, pair-symmetric t2 and t3, eps_o,
    eps_v."""
    rng = np.random.default_rng(23)
    n = no + nv
    c = rng.standard_normal((n, n, n, n))
    c = c + c.transpose(1, 0, 2, 3)
    c = c + c.transpose(0, 1, 3, 2)
    t2 = rng.standard_normal((no, no, nv, nv))
    t3 = rng.standard_normal((no, no, no, nv, nv, nv))
    t3 = t3 + t3.transpose(1, 0, 2, 4, 3, 5)

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=device)

    return (tensor(0.05 * (c + c.transpose(2, 3, 0, 1))),
            tensor(0.05 * (t2 + t2.transpose(1, 0, 3, 2))), tensor(0.01 * t3),
            tensor(np.sort(rng.uniform(-15.0, -0.5, no))),
            tensor(np.sort(rng.uniform(0.3, 5.0, nv))))


def once_ms(fn) -> float:
    """Device time of one call of fn (CUDA events), for calls of seconds."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def quadruples_library_ms(args) -> float:
    """Batched torch.matmul computing the v^5 products of K9's raw terms for
    every ordered (ijkl), the plan's slots in chunks of 16: W = (cf|a e)
    t2[ij e b], (ia|b e) t3[jkl e cd] and W t2[kl f d] (the operands are
    gathered before the timing; the o^4 v^4 products are never all held)."""
    c, t2, t3 = args[:3]
    no, nv = t2.shape[0], t2.shape[2]
    o, v = slice(0, no), slice(no, None)
    i, j, k, l = torch.as_tensor(cc.quadruples_plan(no, nv, cc.QUADRUPLES_WORKSPACE_BYTES)[1]
                                 .T.astype(np.int64), device=c.device)
    c_vvvv = c[v, v, v, v].reshape(nv ** 3, nv).contiguous()
    c_ovvv = c[o, v, v, v].reshape(no, nv * nv, nv).contiguous()
    t3_v = t3.reshape(no, no, no, nv, nv * nv)
    chunks = []
    for begin in range(0, len(i), 16):
        s = slice(begin, begin + 16)
        chunks.append((c_ovvv[i[s]], t3_v[j[s], k[s], l[s]].contiguous(),
                       t2[i[s], j[s]].contiguous(), t2[k[s], l[s]].contiguous()))
    out1 = torch.empty((16, nv * nv, nv * nv), dtype=torch.float64, device=c.device)
    w = torch.empty((16, nv ** 3, nv), dtype=torch.float64, device=c.device)
    out5 = torch.empty((16, nv ** 3, nv), dtype=torch.float64, device=c.device)

    def products():
        for a1, b1, t2_ij, t2_kl in chunks:
            n = len(a1)
            torch.matmul(a1, b1, out=out1[:n])
            torch.matmul(c_vvvv, t2_ij, out=w[:n])
            torch.matmul(w[:n], t2_kl, out=out5[:n])

    products()
    ms = once_ms(products)
    del chunks, out1, w, out5
    return ms


QUADRUPLES_STAGES = ("quadruples_xyv_kernel", "quadruples_raw_kernel",
                     "quadruples_energy_kernel")   # K9's kernels, in the order of a batch


def check_quadruples(no: int, nv: int, device, record: dict, registers: dict) -> str:
    """K9 against its plain version at o = no, v = nv (E_MP5 and E_MP6 each
    to TRIPLES_TOLERANCE relative), bitwise over two calls, with its peak
    device memory a call; the record keeps the largest error over the
    shapes, the times of the first shape checked (the (Q) path's, v = 19)
    and every shape's measurements under `shapes`.  Kernel ms: median of
    three timed calls after the first, each bitwise equal to it; plain ms:
    the compared call (calls take seconds at v = 53)."""
    args = quadruples_args(no, nv, device)
    results = []

    def kernel():
        results.append(cc.ccsdt_q_energy(*args))

    def plain():
        results.append(cc._ccsdt_q_energy_plain(*args))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernel()
    peak_bytes = torch.cuda.max_memory_allocated() - before
    first = results[-1]
    plain_ms = once_ms(plain)
    e_kernel, e_plain = first.tolist(), results[-1].tolist()
    errors = [abs(a - b) for a, b in zip(e_kernel, e_plain)]
    require(all(np.isfinite(e_kernel)), "(Q) kernel returned a non-finite energy")
    require(all(err <= TRIPLES_TOLERANCE * abs(b) for err, b in zip(errors, e_plain)),
            f"(Q) kernel {e_kernel} off its plain version {e_plain}")
    times = []
    for _ in range(3):
        times.append(once_ms(kernel))
        require(torch.equal(results[-1], first), "two (Q) kernel calls differ")
    ms = statistics.median(times)
    batches = cc.quadruples_plan(no, nv, cc.QUADRUPLES_WORKSPACE_BYTES)[0]
    stages = stage_ms_a_call(kernel, QUADRUPLES_STAGES, len(batches), calls=1)
    require(torch.equal(results[-1], first), "two (Q) kernel calls differ")
    device_ms = sum(stage["device_ms"] for stage in stages.values())
    library_ms = quadruples_library_ms(args)
    needed, own = quadruples_ms(no, nv)
    q_bound = bound(tensor_bytes(*args), needed)
    entry = record.setdefault("ccsdt_q_energy", {"max_abs_err": 0.0, "shapes": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], *errors)
    if "ms" not in entry:
        entry.update(ms=ms, device_ms_a_launch=device_ms, plain_ms=plain_ms,
                     library_ms=library_ms, **q_bound,
                     registers=unit_registers(registers, "ccsdt_q"))
    entry["shapes"].append({"o": no, "v": nv, "ms": ms, "device_ms_a_launch": device_ms,
                            "stages": stages, "plain_ms": plain_ms,
                            "library_ms": library_ms, "max_abs_err": max(errors), **q_bound,
                            "kernel_own_count_ms": own, "peak_bytes_a_call": peak_bytes,
                            "batches": len(batches), "ranges": len(np.unique(batches[:, 6]))})
    relative = [err / abs(b) for err, b in zip(errors, e_plain)]
    return (f"kernels (Q): o {no}, v {nv}; E_MP5 {e_kernel[0]:.15e}, E_MP6 {e_kernel[1]:.15e}, "
            f"relative {relative[0]:.3e}, {relative[1]:.3e}; five calls bitwise equal; "
            f"{ms:.4f} ms (device {device_ms:.4f} ms a call: "
            + ", ".join(f"{key.split('_')[1]} {value['device_ms']:.4f}"
                        for key, value in stages.items())
            + f") vs plain {plain_ms:.4f} ms, the v^5 products as batched "
            f"torch.matmul {library_ms:.4f} ms; bound {q_bound['bound_ms']:.5f} ms by "
            f"{q_bound['bound_by']} (W once a pair; K9's count, the vvvv term as two products: "
            f"{own:.5f} ms); {len(batches)} batches over {len(np.unique(batches[:, 6]))} ranges "
            f"of min(y), peak device memory a call {peak_bytes} "
            f"bytes (one o^4 v^4 tensor: {8 * no ** 4 * nv ** 4} bytes)")


def check_triples_line(line: str, energy_ref: float, iterations_ref: tuple,
                       kernels: tuple) -> dict:
    """A line of the iterative triples family on the card against tuna_tpu's
    total energy (Q_TOLERANCE) and SCF and CC iteration counts; its (Q),
    where it has one, against K9's plain version on the path's own inputs.
    Returns the launches."""
    with Recorder("ccsdt_q_energy") as recorder:
        SCF_output, _, energy, _, wall, launches = drive(line, kernels)
    iterations = (len(SCF_output.iteration_seconds),
                  len(SCF_output.correlation_iteration_seconds))
    require(iterations == iterations_ref,
            f"{line}: {iterations} SCF and CC iterations, the reference takes {iterations_ref}")
    require(abs(energy - energy_ref) <= Q_TOLERANCE,
            f"{line}: E_total {energy - energy_ref:.3e} Ha from the reference")
    require(len(recorder.calls) == ("(Q)" in line),
            f"{line}: {len(recorder.calls)} (Q) calls")
    note = ""
    for args, energies in recorder.calls:
        plain = cc._ccsdt_q_energy_plain(*args).tolist()
        errors = [abs(a - b) for a, b in zip(energies.tolist(), plain)]
        require(all(err <= TRIPLES_TOLERANCE * max(abs(b), 1e-300) or err == 0.0
                    for err, b in zip(errors, plain)),
                f"{line}: (Q) {energies.tolist()} off its plain version {plain}")
        note = f"; (Q) {energies.tolist()} against its plain version |diff| {max(errors):.3e}"
    print(f"end to end: {line}; E_total {energy!r}, E_total - E_ref {energy - energy_ref:.3e} "
          f"Ha; SCF {iterations[0]} and CC {iterations[1]} iterations (the reference's); CC "
          f"median {statistics.median(SCF_output.correlation_iteration_seconds) * 1e3:.3f} "
          f"ms/iteration; wall {wall:.3f} s{note}; launches {launches}")
    return launches


def check_quadruples_path(record: dict) -> dict:
    """Phase 15: LINE_Q against tuna_tpu's numbers, its (Q) against K9's
    plain version on the path's own amplitudes and integrals, one K9 launch,
    its profile (K9's device ms by stage, recorded); then the small triples
    lines.  Returns the launches summed over the counted runs."""
    with Recorder("ccsdt_q_energy") as recorder:
        SCF_output, _, energy, _, wall, launches = drive(LINE_Q, Q_PATH_KERNELS)
    require(launches["ccsdt_q_energy"] == 1 and len(recorder.calls) == 1,
            f"{LINE_Q}: {launches['ccsdt_q_energy']} K9 launches")
    args, energies = recorder.calls[0]
    E_MP5, E_MP6 = energies.tolist()
    plain = cc._ccsdt_q_energy_plain(*args).tolist()
    errors = [abs(a - b) for a, b in zip((E_MP5, E_MP6), plain)]
    require(all(err <= TRIPLES_TOLERANCE * abs(b) for err, b in zip(errors, plain)),
            f"{LINE_Q}: (Q) {(E_MP5, E_MP6)} off its plain version {plain}")
    iterations = (len(SCF_output.iteration_seconds),
                  len(SCF_output.correlation_iteration_seconds))
    require(iterations == ITERATIONS_Q,
            f"{LINE_Q}: {iterations} SCF and CCSDT iterations, the reference takes "
            f"{ITERATIONS_Q}")
    deltas = {"E_SCF": SCF_output.energy - E_SCF_REF_Q,
              "E_total - E_(Q)": energy - (E_MP5 + E_MP6) - E_CCSDT_REF_Q,
              "E_total (printed)": energy - E_REF_Q,
              "E_MP5 (printed)": E_MP5 - E_Q_REF_Q[0], "E_MP6 (printed)": E_MP6 - E_Q_REF_Q[1],
              "E_(Q) (printed)": E_MP5 + E_MP6 - E_Q_REF_Q[2]}
    for name, delta in deltas.items():
        require(abs(delta) <= Q_TOLERANCE, f"{LINE_Q}: {name} {delta:.3e} Ha from the reference")
    print(f"end to end: {LINE_Q}; E_total {energy!r}, E_MP5 {E_MP5!r}, E_MP6 {E_MP6!r} (plain "
          f"version relative {max(e / abs(b) for e, b in zip(errors, plain)):.3e}); from the "
          f"reference: " + ", ".join(f"{name} {delta:.3e} Ha" for name, delta in deltas.items())
          + f"; SCF {iterations[0]} iterations, median "
          f"{statistics.median(SCF_output.iteration_seconds) * 1e3:.3f} ms/iteration; CCSDT "
          f"{iterations[1]} iterations, median "
          f"{statistics.median(SCF_output.correlation_iteration_seconds) * 1e3:.3f} "
          f"ms/iteration; wall {wall:.3f} s; launches {launches}")
    runs = [launches]
    profile = profile_path(LINE_Q, needs=QUADRUPLES_STAGES)
    record["ccsdt_q_energy"]["path"] = stage_ms(
        profile, QUADRUPLES_STAGES, len(cc.quadruples_plan(7, 19, cc.QUADRUPLES_WORKSPACE_BYTES)[0]))
    print("profile: " + json.dumps(profile))
    for line, energy_ref, iterations_ref, kernels in TRIPLES_LINES:
        runs.append(check_triples_line(line, energy_ref, iterations_ref, kernels))
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phases 16 and 17: K6b, the batched scan
# ---------------------------------------------------------------------------

def scan_setup(line: str):
    """(calculation, atomic symbols, bond lengths in bohr) of a SCAN line,
    the bond lengths stepped as the serial walk steps them."""
    calculation_type, method, basis, symbols, coordinates, params = parse_input(line)
    calculation = Config(calculation_type, process_method(method), time.time(), params, basis,
                         symbols, suppress_output=True)
    bonds, bond = [], float(coordinates[1][2])
    for _ in range(calculation.number_of_steps):
        bonds.append(bond)
        bond = bond + angstrom_to_bohr(calculation.step)
    return calculation, symbols, bonds


def vv10_ragged(elements, b: float, C: float):
    """K6b and its plain version over the active points of each element
    (density, weights, sigma, points): (kernel call, plain call, counts)."""
    counts = [int(e[0].shape[0]) for e in elements]
    inputs = [torch.cat(parts).contiguous() for parts in zip(*elements)]
    terms = vv10._vv10_point_terms(*inputs[:3], b, C)
    return (lambda: vv10.vv10_energy_batch(counts, *inputs, b, C),
            lambda: vv10._vv10_pair_sums_plain(counts, inputs[3], *terms), counts)


def check_vv10_batch(device, record: dict, registers: dict) -> np.ndarray:
    """Phase 16: K6b against its plain version on the active points of the
    scan's densities converged at EXTREMESCF, on their own grids (a batched
    solve of the scan's points, not counted), and on a ragged batch of an
    empty element, 300 points around the densest one (one tile) and one
    element whole.  Returns that batch's total energies."""
    calculation, symbols, bonds = scan_setup(LINE_SCAN_EXTREME)
    energies, converged, P, meta = parallel.stencil_points_parallel(calculation, symbols, bonds,
                                                                    [device])
    require(converged.all() and np.all(np.isfinite(energies)),
            f"{LINE_SCAN_EXTREME}: the batch of its points did not converge")
    b, C, _ = vv10._parameters(calculation.functional)
    active = []
    for P_point, m in zip(P, meta):
        bfs, w, grads, pts = m["grid"]
        active.append(vv10._active_points(P_point, bfs, grads, w, pts))

    kernel, plain, counts = vv10_ragged(active, b, C)
    e_kernel, e_plain = kernel(), plain()
    err = torch.abs(e_kernel - e_plain)
    relative = float(torch.max(err / torch.abs(e_plain)))
    require(bool(torch.all(torch.isfinite(e_kernel))) and relative <= VV10_TOLERANCE,
            f"vv10_energy_batch off its plain version by {relative:.3e} relative")
    require(torch.equal(kernel(), kernel()), "two vv10_energy_batch calls differ")
    empty = tuple(x[:0] for x in active[0])
    densest = max(int(torch.argmax(active[0][0])), 150)   # 300 points around it: one tile
    small = tuple(x[densest - 150:densest + 150] for x in active[0])
    kernel_r, plain_r, counts_r = vv10_ragged([empty, small, active[1]], b, C)
    e_r, e_rp = kernel_r(), plain_r()
    relative_r = float(torch.max(torch.abs(e_r - e_rp)[1:] / torch.abs(e_rp[1:])))
    require(float(e_r[0]) == 0.0 and relative_r <= VV10_TOLERANCE
            and torch.equal(kernel_r(), e_r),
            f"vv10_energy_batch on counts {counts_r}: {e_r.tolist()} against {e_rp.tolist()}")
    needed = sum(vv10_operations(m)[0] for m in counts)
    batch_bound = bound(6 * 8 * sum(counts) + 8 * len(counts), needed / FP64_PER_MS)
    plain_ms = median_ms(plain, repeats=1)
    record["vv10_energy_batch"] = {
        "max_abs_err": float(torch.max(err)), "ms": median_ms(kernel), "plain_ms": plain_ms,
        "library_ms": None, **batch_bound}
    kernel_registers = {k: v for k, v in registers.items() if k.startswith("vv10:")}
    print(f"K6b: {LINE_SCAN_EXTREME}'s {len(counts)} converged densities, {counts} active "
          f"points; energies {e_kernel.tolist()}, relative to the plain version "
          f"{relative:.3e}, two calls bitwise equal ({record['vv10_energy_batch']['ms']:.4f} ms "
          f"vs plain {plain_ms:.4f} ms, one run; bound {batch_bound['bound_ms']:.5f} ms by "
          f"{batch_bound['bound_by']}); ragged {counts_r}: {e_r.tolist()}, relative "
          f"{relative_r:.3e}, bitwise; registers {kernel_registers}")
    return energies


@contextlib.contextmanager
def scf_iterations():
    """The SCF iteration counts a point of the runs inside the block:
    "serial" from each run_self_consistent_field of the energy driver at
    the largest basis seen (not the STO-3G guess SCFs), "batch" from each
    lockstep batch of parallel.py."""
    from tuna_tpu_torch.drivers import energy
    counts = {"serial": [], "batch": []}
    serial_scf, lockstep = energy.run_self_consistent_field, parallel.run_in_lockstep

    def serial_counted(molecule, *args, **kwargs):
        SCF_output = serial_scf(molecule, *args, **kwargs)
        counts["serial"].append((molecule.n_basis, len(SCF_output.iteration_seconds)))
        return SCF_output

    def batch_counted(loops):
        results = lockstep(loops)
        counts["batch"].extend(int(n) for result in results for n in result[0])
        return results

    energy.run_self_consistent_field, parallel.run_in_lockstep = serial_counted, batch_counted
    try:
        yield counts
    finally:
        energy.run_self_consistent_field, parallel.run_in_lockstep = serial_scf, lockstep
        largest = max((n for n, _ in counts["serial"]), default=0)
        counts["serial"] = [its for n, its in counts["serial"] if n == largest]


def batched_scan(line: str, device):
    """parallel.scan_points_parallel over a SCAN line's points on one card,
    the launch counts read from zero: (energies, converged, dipoles), wall
    seconds, launches."""
    calculation, symbols, bonds = scan_setup(line)
    _kernels.reset_launch_counts()
    start = time.perf_counter()
    result = parallel.scan_points_parallel(calculation, symbols, bonds, devices=[device])
    torch.cuda.synchronize()
    return result, time.perf_counter() - start, dict(_kernels.launches)


def check_batched_scan(device, extreme_batch: np.ndarray) -> dict:
    """Phase 17: the scan's 8 points through parallel.scan_points_parallel
    (one K6b launch) and through the serial cli.run SCAN, point by point;
    the 1.10 angstrom point against E_REF_DFT; the EXTREMESCF batch of
    phase 16 against the serial SCAN at EXTREMESCF; a 4-point UHF batch
    against its serial SCAN; a profile of both DFT walls (the counted
    runs' walls, and one run each of LINE_SCAN_PROFILE under
    torch.profiler).
    Returns the launches summed over the four counted runs."""
    _, _, bonds = scan_setup(LINE_SCAN)
    with scf_iterations() as iterations:
        (energies, converged, dipoles), batch_wall, batch_launches = batched_scan(LINE_SCAN,
                                                                                  device)
        (serial_bonds, serial_energies, _), serial_wall, serial_launches = run_counted(
            LINE_SCAN, DFT_PATH_KERNELS)
    for name in BATCH_PATH_KERNELS:
        require(batch_launches[name] > 0, f"kernel {name} was not launched by the batched scan")
    require(batch_launches["vv10_energy_batch"] == 1,
            f"{batch_launches['vv10_energy_batch']} K6b launches for one batch")
    require(converged.all() and energies.shape == (8,) and np.all(np.isfinite(energies))
            and np.all(np.isfinite(dipoles)), f"{LINE_SCAN}: batch {energies}, {converged}")
    require(np.allclose(serial_bonds, bonds, rtol=0, atol=1e-12),
            f"{LINE_SCAN}: the serial walk took other bond lengths")
    deltas = np.asarray(energies) - np.asarray(serial_energies)
    require(np.max(np.abs(deltas)) <= SCAN_TOLERANCE,
            f"{LINE_SCAN}: batch minus serial {deltas.tolist()} Ha")
    at_ref = int(np.argmin(np.abs(np.array(bonds) - angstrom_to_bohr(1.1))))
    delta_ref = energies[at_ref] - E_REF_DFT
    require(abs(delta_ref) <= E_TOLERANCE,
            f"{LINE_SCAN}: {delta_ref:.3e} Ha from the reference at 1.10 angstrom")
    extreme_serial = run(LINE_SCAN_EXTREME, suppress_output=True, device="cuda")[1]
    extreme_deltas = extreme_batch - np.asarray(extreme_serial)
    require(np.max(np.abs(extreme_deltas)) <= SCAN_EXTREME_TOLERANCE,
            f"{LINE_SCAN_EXTREME}: batch minus serial {extreme_deltas.tolist()} Ha")

    (u_energies, u_converged, _), u_wall, u_launches = batched_scan(LINE_SCAN_UHF, device)
    (_, u_serial, _), u_serial_wall, u_serial_launches = run_counted(
        LINE_SCAN_UHF, ("eri_packed", "one_electron"))
    u_deltas = np.asarray(u_energies) - np.asarray(u_serial)
    require(u_converged.all() and np.max(np.abs(u_deltas)) <= SCAN_UHF_TOLERANCE,
            f"{LINE_SCAN_UHF}: batch minus serial {u_deltas.tolist()} Ha")
    print(f"end to end: {LINE_SCAN}; batch energies {energies.tolist()}, minus the serial "
          f"SCAN's {deltas.tolist()} Ha (at EXTREMESCF {extreme_deltas.tolist()} Ha); 1.10 "
          f"angstrom point {delta_ref:.3e} Ha from the reference; SCF iterations batch "
          f"{iterations['batch']}, serial {iterations['serial']}; wall batch "
          f"{batch_wall:.3f} s, serial {serial_wall:.3f} s; launches batch {batch_launches}, "
          f"serial {serial_launches}. {LINE_SCAN_UHF}: batch minus serial "
          f"{u_deltas.tolist()} Ha; wall batch {u_wall:.3f} s, serial {u_serial_wall:.3f} s")

    def batch_counted():
        return batched_scan(LINE_SCAN_PROFILE, device)[1:]

    def serial_counted():
        return run_counted(LINE_SCAN_PROFILE, ())[1:]

    print("profile: " + json.dumps({
        "line": LINE_SCAN, "points": len(bonds), "profiled_line": LINE_SCAN_PROFILE,
        "batch": {"warm_wall_s": batch_wall, "scf_iterations": iterations["batch"],
                  **profiled_call(batch_counted)},
        "serial": {"warm_wall_s": serial_wall, "scf_iterations": iterations["serial"],
                   **profiled_call(serial_counted)}}))
    runs = (batch_launches, serial_launches, u_launches, u_serial_launches)
    return {name: sum(r[name] for r in runs) for name in KERNELS}

# ---------------------------------------------------------------------------
# Phases 18 and 19: K8bu, K8cu, the unrestricted gradient paths
# ---------------------------------------------------------------------------

def check_unrestricted_eri_deriv(symbol: str, partner: str | None, bond_angstrom: float,
                                 basis: str, device, record: dict, registers: dict,
                                 frames: dict) -> str:
    """K8bu against its plain version on a seeded pair of density-like
    Pa != Pb (relative), against a repeated call of itself (bitwise), and at
    Pa = Pb = P/2 against K8b(P) (relative); its device ms a launch
    (torch.profiler), host ms a call, and registers and stack frames (a
    spill or a missing instantiation fails the run; its class kernels are
    K8b's)."""
    molecule = diatomic(symbol, bond_angstrom, basis, partner)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    N = plan.n_basis
    rng = np.random.default_rng(14)
    C_a, C_b = (rng.standard_normal((N, k)) / np.sqrt(N) for k in (8, 7))
    P_a = torch.as_tensor(C_a @ C_a.T, dtype=torch.float64, device=device)
    P_b = torch.as_tensor(C_b @ C_b.T, dtype=torch.float64, device=device)
    hfx = 0.2

    def kernel():
        return plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, hfx)

    def plain():
        return plan._eri_deriv_energy_unrestricted_plain(coords, P_a, P_b, hfx)

    e_kernel, e_again, e_plain = kernel(), kernel(), plain()
    P = P_a + P_b
    e_half = plan.eri_deriv_energy_unrestricted(coords, P / 2, P / 2, hfx)
    e_restricted = plan.eri_deriv_energy(coords, P, hfx)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(e_kernel)), f"{basis}: non-finite unrestricted tangent")
    err = abs(float(e_kernel - e_plain))
    relative = err / abs(float(e_plain))
    half = abs(float(e_half - e_restricted)) / abs(float(e_restricted))
    require(relative <= TRIPLES_TOLERANCE,
            f"{basis}: eri_deriv_energy_unrestricted off its plain version by {relative:.3e}")
    require(torch.equal(e_kernel, e_again),
            f"{basis}: two eri_deriv_energy_unrestricted calls differ")
    require(half <= UNRESTRICTED_HALF_TOLERANCE,
            f"{basis}: K8bu at Pa = Pb = P/2 off K8b(P) by {half:.3e} (relative)")
    ms, plain_ms = median_ms(kernel), median_ms(plain, repeats=1)
    launch_ms = device_ms_a_launch(kernel, "eri_deriv_energy_unrestricted")
    restricted_launch_ms = device_ms_a_launch(lambda: plan.eri_deriv_energy(coords, P, hfx),
                                              "eri_deriv_energy")
    host_ms = host_ms_a_call(kernel)
    t = plan.tensors(device)
    needed, first_count = eri_operations(plan, derivative=True)
    algorithm = deriv_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + 3 * tensor_bytes(P)
                      + tensor_bytes(t["pid_i"], t["pid_j"]) + 8, needed / FP64_PER_MS)
    molecule_name = f"{symbol}{partner or symbol}/{basis}"
    entry = record.setdefault("eri_deriv_energy_unrestricted", {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry.setdefault("device_ms_a_launch", {})[molecule_name] = launch_ms
    entry.setdefault("k8b_device_ms_a_launch", {})[molecule_name] = restricted_launch_ms
    entry.setdefault("host_ms_a_call", {})[molecule_name] = host_ms
    entry.setdefault("launches_a_call", {})[molecule_name] = deriv_launches(plan)
    entry.setdefault("bound_ms_at", {})[molecule_name] = eri_bound["bound_ms"]
    own = deriv_kernel_registers(entry, registers, frames, "deriv_weights_kernel[unrestricted]")
    if basis == "CC-PVTZ":
        entry.update(ms=ms, plain_ms=plain_ms, library_ms=None, **eri_bound)
    return (f"unrestricted gradient kernels {molecule_name}: "
            f"eri_deriv_energy_unrestricted dE/dR {float(e_kernel)!r}, relative |diff| "
            f"{relative:.3e}, two calls bitwise equal; at Pa = Pb = P/2 {half:.3e} from "
            f"eri_deriv_energy(P); {ms:.4f} ms vs plain {plain_ms:.4f} ms (one run); device ms "
            f"a launch {launch_ms:.5f} (eri_deriv_energy on P in the same run "
            f"{restricted_launch_ms:.5f}), host ms a call {host_ms:.4f}, "
            f"{deriv_launches(plan)} launches a call; bound {eri_bound['bound_ms']:.5f} ms by "
            f"{eri_bound['bound_by']} ({needed:.4g} operations needed, {algorithm:.4g} in the "
            f"kernel's algorithm, the first form's {first_count:.4g}); registers (ptxas; the "
            f"class kernels are eri_deriv_energy's) {json.dumps(own)}")


def check_unrestricted_gradient_kernels(device, record: dict, registers: dict,
                                        frames: dict) -> str:
    """Phase 18: K8bu at O2/cc-pVTZ and OH/6-31G, then K8cu on the grid of
    the UKS path with its converged densities (one uncounted run of
    LINE_UKS_SPE gives them)."""
    for symbol, partner, bond_angstrom, basis in (("O", None, 1.21, "CC-PVTZ"),
                                                  ("O", "H", 0.97, "6-31G")):
        print(check_unrestricted_eri_deriv(symbol, partner, bond_angstrom, basis, device,
                                           record, registers, frames))
    SCF_output, molecule, _, _ = run(LINE_UKS_SPE, suppress_output=True, device="cuda")
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    P_stack = torch.stack([U.T @ SCF_output.P_alpha @ U, U.T @ SCF_output.P_beta @ U])
    return check_moving_grid(molecule, P_stack, device, record, registers)


def profile_unrestricted_path(line: str) -> dict:
    """profile_gradient_path of the UKS OPT line, with K7b's (with
    gradients, and rho only for the guess densities), K8bu's and K8cu's
    launches and device ms from its profiled run."""
    profile = profile_gradient_path(line, (
        "density_on_grid_kernel[1]", "density_on_grid_kernel[0]", "deriv_shell_kernel",
        "eri_deriv_energy_unrestricted", "moving_grid_kernel[2,1]"))
    launches = profile["profiled_launches"]
    profile["path_kernels"] = {
        "density_on_grid (K7b)": hand_entry(profile, "density_on_grid_kernel[1]"),
        "density_on_grid (K7b, rho only)": hand_entry(profile, "density_on_grid_kernel[0]"),
        "eri_deriv_energy_unrestricted (K8bu)": {
            "launches": launches.get("eri_deriv_energy_unrestricted", 0),
            "class_kernel_launches": hand_entry(profile, "deriv_shell_kernel")["launches"],
            "device_ms_a_launch": profile["quartet_class_kernels_busy_ms_a_launch"][
                "eri_deriv_energy_unrestricted"]},
        "density_deriv_on_grid_spin (K8cu)": hand_entry(profile, "moving_grid_kernel[2,1]"),
    }
    return profile


def check_unrestricted_gradient_paths(record: dict | None = None) -> dict:
    """Phase 19: the UKS single point (energy and SCF iteration count), the
    UKS OPT of triplet O2 with its profile (one K8cu launch a gradient,
    whose device ms a launch goes into record), the UHF OPT of triplet O2,
    the UKS FREQ of OH and the UHF MD of OH against tuna_tpu's numbers; none
    of them launches K8b or K8c.  Returns the launches summed over these
    runs."""
    record = {} if record is None else record
    SCF_output, _, energy, _, wall, launches = drive(LINE_UKS_SPE, UKS_PATH_KERNELS)
    delta = energy - E_REF_UKS_SPE
    iterations = len(SCF_output.iteration_seconds)
    require(abs(delta) <= UHF_TOLERANCE,
            f"{LINE_UKS_SPE}: E_total {delta:.3e} Ha from the reference")
    require(iterations == SCF_ITERATIONS_UKS_SPE,
            f"{LINE_UKS_SPE}: {iterations} SCF iterations, the reference takes "
            f"{SCF_ITERATIONS_UKS_SPE}")
    print(f"end to end: {LINE_UKS_SPE}; E_total {energy!r} ({delta:.3e} Ha); {iterations} SCF "
          f"iterations as the reference, median "
          f"{statistics.median(SCF_output.iteration_seconds) * 1e3:.3f} ms/iteration; wall "
          f"{wall:.3f} s; launches {launches}")
    runs = [launches]
    for line, kernels, bond_ref, energy_ref, iterations_ref in (
            (LINE_UKS_OPT, UKS_GRADIENT_PATH_KERNELS, BOND_REF_UKS_OPT, E_REF_UKS_OPT,
             ITERATIONS_UKS_OPT),
            (LINE_UHF_OPT, UHF_GRADIENT_PATH_KERNELS, BOND_REF_UHF_OPT, E_REF_UHF_OPT,
             ITERATIONS_UHF_OPT)):
        launches = check_optimisation(line, kernels, bond_ref, energy_ref, iterations_ref)
        require(launches["eri_deriv_energy_unrestricted"] == launches["one_electron_deriv"],
                f"{line}: not one K8bu launch a gradient")
        runs.append(launches)
        if line == LINE_UKS_OPT:
            require(launches["density_deriv_on_grid_spin"] == launches["one_electron_deriv"],
                    f"{line}: not one K8cu launch a gradient")
            profile = profile_unrestricted_path(line)
            record.setdefault("density_deriv_on_grid_spin", {})["device_ms_a_launch"] = \
                _device_ms_a_launch(profile, "moving_grid_kernel[2,1]")
            record.setdefault("density_on_grid", {})["uks_opt_device_ms_a_launch"] = \
                _device_ms_a_launch(profile, "density_on_grid_kernel[1]")
            print("profile: " + json.dumps(profile))
    runs.append(check_frequency(LINE_UKS_FREQ, FREQUENCY_REF_UKS_FREQ, ZPE_REF_UKS_FREQ,
                                UKS_GRADIENT_PATH_KERNELS))
    energies, wall, launches = run_counted(LINE_UHF_MD, UHF_GRADIENT_PATH_KERNELS)
    deltas = [e - ref for e, ref in zip(energies, E_REF_UHF_MD)]
    require(len(energies) == len(E_REF_UHF_MD) and max(map(abs, deltas)) <= E_TOLERANCE,
            f"{LINE_UHF_MD}: step energies off the reference by {deltas}")
    print(f"end to end: {LINE_UHF_MD}; {len(energies)} steps, largest |E - E_ref| "
          f"{max(map(abs, deltas)):.3e} Ha; wall {wall:.3f} s; launches {launches}")
    runs.append(launches)
    for r in runs:
        require(r["eri_deriv_energy"] == r["density_deriv_on_grid"] == 0,
                "a restricted gradient kernel ran on an unrestricted path")
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phases 20 and 21: K7bt, K8ct and K8cut, the meta-GGA paths
# ---------------------------------------------------------------------------

def _grid_of(molecule, device):
    points_np, _ = grid.build_molecular_grid(
        *grid.grid_parameters(molecule, molecule.calculation), molecule.bond_length,
        molecule.atoms)
    G = points_np.shape[1] * points_np.shape[2]
    return torch.as_tensor(points_np.reshape(3, G), dtype=torch.float64, device=device), G


def _largest_relative(got, expected) -> float:
    return max(_relative(a, b) for a, b in zip(got, expected))


def check_tau_kernel(molecule, P_converged, device, record: dict, registers: dict) -> str:
    """K7bt against its plain version on the grid of LINE_MGGA with its
    converged density (TAU_TOLERANCE), bitwise over two calls, and its rho
    and grad rho bit for bit K7b's (one template, the same code for them);
    its device time back to back at every tile the card holds
    (tiles_back_to_back_ms)."""
    points, G = _grid_of(molecule, device)
    values, grads = grid.ao_on_grid(grid.GridBasis(molecule.cartesian_basis_functions), points,
                                    True)
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    bfs, bf_grads = (U @ values).contiguous(), torch.matmul(U, grads).contiguous()
    del values, grads
    n, P = bfs.shape[0], P_converged.contiguous()

    def kernel():
        return grid.density_on_grid(P, bfs, bf_grads, with_tau=True)

    def plain():
        return grid._density_on_grid_plain(P, bfs, bf_grads, with_tau=True)

    def library():
        return 0.5 * torch.einsum("ij,aik,ajk->k", P, bf_grads, bf_grads)

    got, again, expected = kernel(), kernel(), plain()
    require(all(bool(torch.all(torch.isfinite(x))) for x in got), "K7bt: non-finite output")
    relative = max(_largest_relative(got, expected), _relative(library(), got[2]))
    require(relative <= TAU_TOLERANCE, f"density_tau_on_grid off its plain version by "
                                       f"{relative:.3e} (relative)")
    require(all(torch.equal(a, b) for a, b in zip(got, again)), "two K7bt calls differ")
    rho, gradient = grid.density_on_grid(P, bfs, bf_grads)
    require(torch.equal(rho, got[0]) and torch.equal(gradient, got[1]),
            "K7bt's rho and grad rho differ from K7b's")
    ms, plain_ms, library_ms, k7b_ms = medians_ms(
        (kernel, plain, library, lambda: grid.density_on_grid(P, bfs, bf_grads)), 5)
    launch_ms = device_ms_a_launch(kernel, "density_on_grid_kernel[2]")
    tau_bound = bound(tensor_bytes(P, bfs, bf_grads, *got), density_tau_ms(n, G))
    tiles = {f"{t},{'whole' if w else 'rows'},{b} buffers": back_to_back_ms(
        lambda: grid._density_kernel(P, bfs, bf_grads, True, (t, w, b)))
        for t, w, b, _ in grid.density_layouts(n, grid.DENSITY_TAU)}
    points_a_tile, whole_p, buffers, shared = grid.density_layout(n, grid.DENSITY_TAU)
    found = {key: value for key, value in registers.items()
             if key.startswith("dft_grid:density_on_grid_kernel<2,")}
    require(len(found) == 2 and all(isinstance(v, int) for v in found.values()),
            f"density_tau_on_grid: registers {found} (a spill or a missing entry)")
    key = f"dft_grid:density_on_grid_kernel<2,{'true' if whole_p else 'false'}>"
    record["density_tau_on_grid"] = {
        "max_abs_err": max(float(torch.max(torch.abs(a - b))) for a, b in zip(got, expected)),
        "ms": ms, "device_ms_a_launch": launch_ms, "host_ms_a_call": ms - launch_ms,
        "plain_ms": plain_ms, "library_ms": library_ms, **tau_bound,
        "registers": registers[key], "tiles_back_to_back_ms": tiles}
    return (f"meta-GGA kernels: density_tau_on_grid N2/{molecule.basis}, {n} spherical AOs, "
            f"{G} points, the converged P of {LINE_MGGA}; {points_a_tile} points a tile, P^T "
            f"{'whole' if whole_p else 'in 16 rows'}, {buffers} column buffers, {shared} B of "
            f"shared memory a block; relative max|diff| {relative:.3e} (largest tau "
            f"{float(torch.max(torch.abs(expected[2]))):.4g}), two calls bitwise equal, rho and "
            f"grad rho bitwise K7b's; {ms:.4f} ms ({launch_ms} device ms a launch; K7b "
            f"{k7b_ms:.4f} ms) vs plain {plain_ms:.4f} ms, einsum (tau only) {library_ms:.4f} "
            f"ms; device ms a launch back to back at each tile {json.dumps(tiles)}; bound "
            f"{tau_bound['bound_ms']:.5f} ms by "
            f"{tau_bound['bound_by']}; registers (ptxas) {json.dumps(found)}")


def deriv_products_ms(basis, origin, moves, points, first_moving: int, P_stack,
                      with_tau: bool) -> float:
    """The products alone of the moving-grid kernel on P_stack's densities
    (one: K8c, K8ct; two: K8cu, K8cut): Y_s = P_s [phi | phi'] (with tau
    also P_s d_c phi, c = x, y, z) for every density as one batched
    torch.matmul on columns handed to it (formed by K7a before the timing);
    not the function, which also forms the columns and contracts them with
    Y.  A reference beside the kernel, not a library call."""
    values, grads = grid.ao_on_grid(basis, points, True)
    G = points.shape[1]
    point_moves = (torch.arange(G, device=points.device) >= first_moving).to(torch.float64)
    d_phi = (point_moves[None, :] - moves.to(torch.float64)[:, None]) * grads[2]
    columns = torch.stack([values, d_phi, *grads] if with_tau else [values, d_phi])
    del values, grads, d_phi
    return median_ms(lambda: torch.matmul(P_stack[:, None], columns[None]))


def check_moving_grid(molecule, P_stack, device, record: dict, registers: dict,
                      with_tau: bool = False) -> str:
    """The moving-grid kernel (csrc/dft_grid.cu moving_grid_kernel) on the
    molecule's grid, atom 1's half of the points moving, for P_stack's one
    density (K8c; K8ct with tau) or two (K8cu; K8cut): against its plain
    version (DERIV_GRID_TOLERANCE, with tau TAU_TOLERANCE, of each output's
    largest |entry|) and bitwise over two calls; without tau the LDA branch
    (with_gradients=False) the same way; with tau its first four outputs
    bitwise the kernel's without tau; for two densities each spin bitwise
    the one-density kernel's.  Its time at the host's tile and at every
    other tile the card holds (tiles_ms), the products alone as one batched
    torch.matmul on columns handed to it (products_matmul_ms; no PyTorch
    call computes the function, so library_ms is null), the bound and the
    registers of its instantiations (ptxas; a spill or a missing entry
    fails the run)."""
    points, G = _grid_of(molecule, device)
    basis = grid.GridBasis(molecule.cartesian_basis_functions)
    origin = torch.as_tensor(basis.origin, dtype=torch.float64, device=device)
    moves = torch.as_tensor([bf.atom_index == 1 for bf in molecule.cartesian_basis_functions],
                            dtype=torch.int32, device=device)
    n, n_spins = basis.n_ao, P_stack.shape[0]
    name = ("density_tau_deriv_on_grid" if with_tau else "density_deriv_on_grid") + \
        ("_spin" if n_spins == 2 else "")
    P = P_stack.contiguous() if n_spins == 2 else P_stack[0].contiguous()
    call = grid.density_deriv_on_grid_spin if n_spins == 2 else grid.density_deriv_on_grid
    tolerance = TAU_TOLERANCE if with_tau else DERIV_GRID_TOLERANCE

    def kernel(with_gradients=True):
        return call(basis, origin, moves, points, G // 2, P, with_gradients, with_tau)

    def plain(with_gradients=True):
        outs = [grid._density_deriv_on_grid_plain(basis, origin, moves, points, G // 2, Ps,
                                                  with_gradients, with_tau) for Ps in P_stack]
        if n_spins == 1:
            return outs[0]
        return tuple(torch.stack(parts) if parts[0] is not None else None
                     for parts in zip(*outs))

    def held(with_gradients):
        """(relative, absolute) off the plain version; bitwise over two calls."""
        got, again, expected = kernel(with_gradients), kernel(with_gradients), \
            plain(with_gradients)
        pairs = [(a, b) for a, b in zip(got, expected) if b is not None]
        require(all(bool(torch.all(torch.isfinite(a))) for a, _ in pairs),
                f"{name}: non-finite output")
        relative = max(_relative(a[s], b[s]) if n_spins == 2 else _relative(a, b)
                       for a, b in pairs for s in range(n_spins))
        require(relative <= tolerance, f"{name} (with_gradients={with_gradients}) off its "
                                       f"plain version by {relative:.3e} (relative)")
        require(all(a is b is None or torch.equal(a, b) for a, b in zip(got, again)),
                f"two {name} calls differ (with_gradients={with_gradients})")
        if n_spins == 2:
            for s in range(2):
                single = grid.density_deriv_on_grid(basis, origin, moves, points, G // 2,
                                                    P_stack[s].contiguous(), with_gradients,
                                                    with_tau)
                require(all(a is b is None or torch.equal(a[s], b)
                            for a, b in zip(got, single)),
                        f"{name}: spin {s} differs from the one-density kernel")
        return got, relative, max(float(torch.max(torch.abs(a - b))) for a, b in pairs)

    got, relative, absolute = held(True)
    checks = [f"relative max|diff| {relative:.3e}, absolute {absolute:.3e}"]
    branches = [True]
    if with_tau:
        without = call(basis, origin, moves, points, G // 2, P, True)
        require(all(torch.equal(a, b) for a, b in zip(got[:4], without)),
                f"{name}: rho, grad rho and their tangents differ from the kernel without tau")
        checks.append("the first four outputs bitwise the kernel's without tau")
    else:
        _, lda_relative, lda_absolute = held(False)
        checks.append(f"without gradients {lda_relative:.3e} (relative), {lda_absolute:.3e}")
        branches.append(False)
    checks.append("bitwise over two calls" + (", each spin bitwise the one-density kernel's"
                                              if n_spins == 2 else ""))
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    # without tau: the LDA branch; with tau: the kernel without it
    other_ms = median_ms(lambda: call(basis, origin, moves, points, G // 2, P, with_tau))
    products_ms = deriv_products_ms(basis, origin, moves, points, G // 2, P_stack, with_tau)
    tile, whole_p, shared = grid.density_deriv_layout(n, n_spins)
    # every tile that fits, for the choice in density_deriv_layout
    tiles = {}
    for with_gradients in branches:
        for points_a_tile in (32, 16, 8):
            for whole in (True, False):
                bytes_a_block = grid.density_deriv_bytes(n, n_spins, points_a_tile, whole,
                                                         with_gradients)
                if points_a_tile * n_spins > 32 or bytes_a_block > _kernels.SHARED_MEMORY_A_BLOCK:
                    continue
                key = (f"{points_a_tile},{'whole' if whole else 'rows'}"
                       + ("" if with_gradients else ",without gradients"))
                tiles[key] = median_ms(
                    lambda: grid._density_deriv_kernel(
                        name, "tuna_" + name, basis, origin, moves, points, G // 2, P,
                        with_gradients, with_tau, layout=(points_a_tile, whole)))
    deriv_bound = bound(tensor_bytes(points, origin, moves, P, *got)
                        + tensor_bytes(*basis.tensors(device).values()),
                        density_deriv_ms(basis, G, True, n_spins, with_tau))
    outputs = 2 if with_tau else 1
    prefixes = [f"moving_grid_kernel<{n_spins},{outputs},"] + \
        ([] if with_tau else [f"moving_grid_kernel<{n_spins},0,"])
    found = {key: value for key, value in registers.items()
             if any(f"dft_grid:{prefix}" in key for prefix in prefixes)}
    require(len(found) == 2 * len(prefixes) and all(isinstance(v, int) for v in found.values()),
            f"{name}: registers {found} (a spill or a missing entry)")
    key = f"dft_grid:moving_grid_kernel<{n_spins},{outputs},{'true' if whole_p else 'false'}>"
    record[name] = {"max_abs_err": absolute, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                    **deriv_bound, "products_matmul_ms": products_ms,
                    "registers": registers.get(key), "tiles_ms": tiles}
    other = "the kernel without tau" if with_tau else "without gradients"
    return (f"moving-grid kernel: {name} {'-'.join(molecule.atomic_symbols)}/{molecule.basis}, "
            f"{n} Cartesian AOs, {G} points ({G // 2} moving), converged P; {tile} points a "
            f"tile, P {'whole' if whole_p else 'in 16 rows'}, {shared} B of shared memory a "
            f"block; {'; '.join(checks)}; {ms:.4f} ms ({other} {other_ms:.4f} ms) vs plain "
            f"{plain_ms:.4f} ms, the products alone as batched torch.matmul {products_ms:.4f} "
            f"ms; at each tile {json.dumps(tiles)}; bound {deriv_bound['bound_ms']:.5f} ms by "
            f"{deriv_bound['bound_by']}; registers (ptxas) {json.dumps(found)}")


def check_meta_gga_kernels(device, record: dict, registers: dict) -> str:
    """Phase 20: K7bt and K8ct on the grid of LINE_MGGA with its converged
    density, K8cut on the grid of LINE_UMGGA with its converged Pa and Pb
    (one uncounted run of each line gives them)."""
    SCF_output, molecule, _, P = run(LINE_MGGA, suppress_output=True, device="cuda")
    print(check_tau_kernel(molecule, P, device, record, registers))
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    print(check_moving_grid(molecule, (U.T @ P @ U)[None], device, record, registers,
                            with_tau=True))
    SCF_output, molecule, _, _ = run(LINE_UMGGA, suppress_output=True, device="cuda")
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    P_stack = torch.stack([U.T @ SCF_output.P_alpha @ U, U.T @ SCF_output.P_beta @ U])
    return check_moving_grid(molecule, P_stack, device, record, registers, with_tau=True)


def k3_plain_witness(line: str) -> tuple[float, int]:
    """(E_total, SCF iterations) of `line` on the card with K3's plain
    version in the kernel's place (no K3 launch), every other kernel the
    port's."""
    kernel = IntegralPlan._one_electron_kernel
    IntegralPlan._one_electron_kernel = IntegralPlan._one_electron_plain
    try:
        (SCF_output, _, energy, _), _, launches = run_counted(line, ())
    finally:
        IntegralPlan._one_electron_kernel = kernel
    require(launches["one_electron"] == 0, f"{line}: K3 launched in its plain version's run")
    return energy, len(SCF_output.iteration_seconds)


def check_meta_gga_spe(line: str, energy_ref: float, iterations_ref: int, kernels: tuple,
                       spins: int, tolerance: float = UHF_TOLERANCE,
                       witness: tuple[float, int] | None = None) -> dict:
    """A meta-GGA single point against tuna_tpu's energy (`tolerance`) and
    iteration count; with a witness (k3_plain_witness's energy and count)
    the count is held to the witness's instead of the reference's, and the
    energy to the witness's as well (K3_WITNESS_TOLERANCE)."""
    SCF_output, _, energy, _, wall, launches = drive(line, kernels)
    delta = energy - energy_ref
    iterations = len(SCF_output.iteration_seconds)
    print(f"end to end: {line}; E_total {energy!r} ({delta:.3e} Ha, limit {tolerance:.0e}); "
          f"{iterations} SCF iterations (the reference's: {iterations_ref}), median "
          f"{statistics.median(SCF_output.iteration_seconds) * 1e3:.3f} ms/iteration; "
          f"E_VV10 {SCF_output.dispersion_energy!r}; wall {wall:.3f} s; launches {launches}")
    require(abs(delta) <= tolerance, f"{line}: E_total {delta:.3e} Ha from the reference")
    if witness is None:
        require(iterations == iterations_ref,
                f"{line}: {iterations} SCF iterations, the reference takes {iterations_ref}")
    else:
        witness_energy, witness_iterations = witness
        print(f"  against K3's plain version on the card: E_total {witness_energy!r} "
              f"({energy - witness_energy:.3e} Ha, limit {K3_WITNESS_TOLERANCE:.0e}), "
              f"{witness_iterations} SCF iterations")
        require(iterations == witness_iterations,
                f"{line}: {iterations} SCF iterations, {witness_iterations} with K3's plain "
                f"version (the reference takes {iterations_ref})")
        require(abs(energy - witness_energy) <= K3_WITNESS_TOLERANCE,
                f"{line}: E_total {energy - witness_energy:.3e} Ha from the run with K3's "
                f"plain version")
    # K7bt serves every SCF iteration of the line (once a spin) and of its
    # STO-3G guess SCF
    require(launches["density_tau_on_grid"] >= spins * iterations,
            f"{line}: {launches['density_tau_on_grid']} K7bt launches in {iterations} "
            f"iterations")
    return launches


def profile_meta_gga_opt(line: str) -> dict:
    """profile_gradient_path of a meta-GGA OPT line, with K7bt's, K8ct's
    and K7b's (the guess densities, rho only) launches and device ms from
    its profiled run."""
    profile = profile_gradient_path(line, ("density_on_grid_kernel[2]",
                                           "moving_grid_kernel[1,2]",
                                           "density_on_grid_kernel[0]"))
    profile["path_kernels"] = {
        "density_tau_on_grid (K7bt)": hand_entry(profile, "density_on_grid_kernel[2]"),
        "density_tau_deriv_on_grid (K8ct)": hand_entry(profile, "moving_grid_kernel[1,2]"),
        "density_on_grid (K7b, rho only)": hand_entry(profile, "density_on_grid_kernel[0]"),
    }
    return profile


def hand_entry(profile: dict, key: str) -> dict:
    """The launches and device ms of the csrc/ kernel `key` in a profile; a
    kernel that ran there and has no entry fails the run."""
    entry = profile["hand_kernels"].get(key)
    require(entry is not None, f"no profiler entry for {key}; the profile's csrc/ kernels: "
                               f"{sorted(profile['hand_kernels'])}")
    return entry


def _device_ms_a_launch(profile: dict, key: str) -> float:
    """Device ms a launch of the csrc/ kernel `key` in a profile; a kernel
    that ran there and has no entry fails the run."""
    entry = hand_entry(profile, key)
    return entry["device_ms"] / entry["launches"]


def check_meta_gga_paths(device, record: dict) -> dict:
    """Phase 21: the meta-GGA paths at cc-pVTZ against tuna_tpu's numbers:
    the R2SCAN single point with its profile, B97M-V (tau and VV10), the
    UKS TPSS single point, the R2SCAN OPT with its profile (one K8ct launch
    a gradient) and the UKS TPSS OPT (one K8cut launch a gradient; one
    profiled FORCE of the same line gives K8cut's device time); none
    launches K8c or K8cu.
    Then a 4-point TPSS batch against the serial SCAN.  Returns the
    launches summed over these runs; records each tau kernel's device ms a
    launch."""
    runs = [check_meta_gga_spe(LINE_MGGA, E_REF_MGGA, SCF_ITERATIONS_MGGA, MGGA_PATH_KERNELS, 1,
                               MGGA_TOLERANCE)]
    profile = profile_path(LINE_MGGA, needs=("density_on_grid_kernel[2]",))
    record["density_tau_on_grid"]["device_ms_a_launch"] = _device_ms_a_launch(
        profile, "density_on_grid_kernel[2]")
    print("profile: " + json.dumps(profile))
    runs.append(check_meta_gga_spe(LINE_B97MV, E_REF_B97MV, SCF_ITERATIONS_B97MV,
                                   MGGA_PATH_KERNELS + ("vv10_energy",), 1))
    witness = k3_plain_witness(LINE_UMGGA)
    runs.append(check_meta_gga_spe(LINE_UMGGA, E_REF_UMGGA, SCF_ITERATIONS_UMGGA,
                                   MGGA_PATH_KERNELS, 2, MGGA_TOLERANCE, witness))
    for line, kernels, bond_ref, energy_ref, iterations_ref, tau_kernel in (
            (LINE_MGGA_OPT, MGGA_GRADIENT_PATH_KERNELS, BOND_REF_MGGA_OPT, E_REF_MGGA_OPT,
             ITERATIONS_MGGA_OPT, "density_tau_deriv_on_grid"),
            (LINE_UMGGA_OPT, UMGGA_GRADIENT_PATH_KERNELS, BOND_REF_UMGGA_OPT, E_REF_UMGGA_OPT,
             ITERATIONS_UMGGA_OPT, "density_tau_deriv_on_grid_spin")):
        launches = check_optimisation(line, kernels, bond_ref, energy_ref, iterations_ref)
        require(launches[tau_kernel] == launches["one_electron_deriv"],
                f"{line}: not one {tau_kernel} launch a gradient")
        runs.append(launches)
        if line == LINE_MGGA_OPT:
            profile = profile_meta_gga_opt(line)
            record[tau_kernel]["device_ms_a_launch"] = _device_ms_a_launch(
                profile, "moving_grid_kernel[1,2]")
            print("profile: " + json.dumps(profile))
        else:
            # one gradient (FORCE) at the OPT's start: a profile of the whole OPT
            # took ~100 s with the event parsing
            force = line.replace("OPT", "FORCE", 1)
            profile = profiled_run(force, ("moving_grid_kernel[2,2]",))
            record[tau_kernel]["device_ms_a_launch"] = _device_ms_a_launch(
                profile, "moving_grid_kernel[2,2]")
            print(f"profiled run: {force}; " + json.dumps(
                {key: profile[key] for key in ("profiled_wall_s", "device_busy_ms",
                                               "device_idle_share", "hand_kernels")}))
    for r in runs:
        require(r["density_deriv_on_grid"] == r["density_deriv_on_grid_spin"] == 0,
                "a gradient kernel without tau ran on a meta-GGA path")
    _, _, bonds = scan_setup(LINE_SCAN_MGGA)
    (energies, converged, _), batch_wall, batch_launches = batched_scan(LINE_SCAN_MGGA, device)
    (serial_bonds, serial, _), serial_wall, serial_launches = run_counted(LINE_SCAN_MGGA,
                                                                          MGGA_PATH_KERNELS)
    require(batch_launches["density_tau_on_grid"] > 0, "the meta-GGA batch did not run K7bt")
    deltas = np.asarray(energies) - np.asarray(serial)
    require(converged.all() and np.allclose(serial_bonds, bonds, rtol=0, atol=1e-12)
            and np.max(np.abs(deltas)) <= SCAN_TOLERANCE,
            f"{LINE_SCAN_MGGA}: batch minus serial {deltas.tolist()} Ha")
    print(f"end to end: {LINE_SCAN_MGGA}; batch minus serial {deltas.tolist()} Ha; wall batch "
          f"{batch_wall:.3f} s, serial {serial_wall:.3f} s; launches batch {batch_launches}")
    runs += [batch_launches, serial_launches]
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 22: perturbation theory and double hybrids
# ---------------------------------------------------------------------------

def check_mp_line(line: str, E_ref: float, scf_ref: int, steps_ref: int, parts_ref: tuple,
                  kernels: tuple) -> tuple:
    """One MPn, IMP2, LMP2, OMP2 or double-hybrid line on the card against
    tuna_tpu's total energy and MP2, MP3 and MP4 parts (MP_TOLERANCE), its
    SCF cycles and IMP2/OMP2 steps, with the peak device memory of the run.
    Returns (SCF output, molecule, energy, P, parts, launches)."""
    torch.cuda.reset_peak_memory_stats()
    with Recorder("run_perturbation_theory_calculation", mp) as recorder:
        SCF_output, molecule, energy, P, wall, launches = drive(line, kernels)
    peak = torch.cuda.max_memory_allocated()
    require(len(recorder.calls) == 1, f"{line}: {len(recorder.calls)} perturbation calls")
    parts = tuple(float(x) for x in recorder.calls[0][1][:3])
    counts = (len(SCF_output.iteration_seconds), len(SCF_output.correlation_iteration_seconds))
    require(counts == (scf_ref, steps_ref),
            f"{line}: {counts} SCF cycles and steps, the reference takes {(scf_ref, steps_ref)}")
    deltas = {"E_total": energy - E_ref,
              **{name: parts[i] - parts_ref[i] for i, name in enumerate(("E_MP2", "E_MP3",
                                                                         "E_MP4"))}}
    for name, delta in deltas.items():
        require(abs(delta) <= MP_TOLERANCE, f"{line}: {name} {delta:.3e} Ha from the reference")
    print(f"end to end: {line}; E_total {energy!r}, MP parts {parts}; from the reference: "
          + ", ".join(f"{name} {delta:.3e} Ha" for name, delta in deltas.items())
          + f"; SCF {counts[0]} iterations, median "
          f"{statistics.median(SCF_output.iteration_seconds) * 1e3:.3f} ms/iteration; "
          f"{counts[1]} steps; wall {wall:.3f} s; peak device memory {peak} B; "
          f"launches {({name: n for name, n in launches.items() if n})}")
    return SCF_output, molecule, energy, P, parts, launches


def check_perturbation_paths() -> dict:
    """Phase 22: BASELINE.json config 2 (as written and at TIGHTSCF), MP4
    at cc-pVTZ (MP2, MP3 and MP4 parts each) with its profile and peak
    memory and its DIRECT twin (K4, K5) against the stored line, B2PLYP at
    cc-pVTZ, UMP3 of triplet O2 at cc-pVTZ, IMP2, LMP2 and OMP2 with their
    step counts, and the relaxed MP2 density of HF with its dipole moment
    and natural occupancies, against tuna_tpu's numbers.  Returns the
    launches summed over the counted runs."""
    runs = []
    for line, E_ref, scf_ref, steps_ref, parts_ref, kernels in MP_LINES[:2]:
        runs.append(check_mp_line(line, E_ref, scf_ref, steps_ref, parts_ref, kernels)[-1])
    stored, _, stored_energy, _, stored_parts, launches = check_mp_line(
        LINE_MP4, E_REF_MP4, SCF_ITERATIONS_MP4, 0, PARTS_REF_MP4, ("eri_packed", "one_electron"))
    runs.append(launches)
    torch.cuda.reset_peak_memory_stats()
    profile = profile_path(LINE_MP4)
    profile["peak_device_memory_bytes"] = torch.cuda.max_memory_allocated()
    print("profile: " + json.dumps(profile))
    direct, _, direct_energy, _, direct_parts, launches = check_mp_line(
        LINE_MP4_DIRECT, E_REF_MP4, SCF_ITERATIONS_MP4, 0, PARTS_REF_MP4,
        DIRECT_PATH_KERNELS[:-1])
    require(direct.integrals.ERI_AO is None and stored.integrals.ERI_AO is not None,
            f"{LINE_MP4_DIRECT}: the ERI tensor was stored")
    twin = tuple(float(x) for x in np.subtract((direct_energy, *direct_parts),
                                                (stored_energy, *stored_parts)))
    require(max(abs(x) for x in twin) <= DIRECT_TOLERANCE,
            f"{LINE_MP4_DIRECT}: DIRECT minus stored {twin} Ha")
    print(f"twin: {LINE_MP4_DIRECT} minus {LINE_MP4}: E_total and MP parts {twin} Ha")
    runs.append(launches)
    for line, E_ref, scf_ref, steps_ref, parts_ref, kernels in MP_LINES[2:]:
        runs.append(check_mp_line(line, E_ref, scf_ref, steps_ref, parts_ref, kernels)[-1])
    SCF_output, molecule, _, P, _, launches = check_mp_line(
        LINE_MP2_RELAXED, E_REF_MP2_RELAXED, SCF_ITERATIONS_MP2_RELAXED, 0,
        PARTS_REF_MP2_RELAXED, ("eri_packed", "one_electron"))
    runs.append(launches)
    dipole = props.calculate_analytical_dipole_moment(
        molecule.centre_of_mass, molecule.charges, molecule.coordinates, P.cpu().numpy(),
        SCF_output.integrals.D.cpu().numpy())[0]
    occupancies = natural_orbitals_of_density(P, SCF_output.X, SCF_output.S)[0].cpu().numpy()
    occupancy_error = float(np.max(np.abs(occupancies - NATURAL_OCCUPANCIES_REF_MP2_RELAXED)))
    require(abs(dipole - DIPOLE_REF_MP2_RELAXED) <= DIPOLE_TOLERANCE
            and occupancy_error <= NATURAL_OCCUPANCY_TOLERANCE,
            f"{LINE_MP2_RELAXED}: dipole {dipole!r}, natural occupancies off by "
            f"{occupancy_error:.3e}")
    print(f"relaxed density: {LINE_MP2_RELAXED}; dipole {dipole!r} (reference "
          f"{DIPOLE_REF_MP2_RELAXED!r}); natural occupancies within {occupancy_error:.3e}")
    return {name: sum(r[name] for r in runs) for name in KERNELS}


# ---------------------------------------------------------------------------
# Phase 23: the rest of restricted CC/CI and the last calculation types
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def solve_counts():
    """The SCF cycles of every SCF and the CC iterations of every CC solve
    of the runs inside the block, in the order they ran (the STO-3G guess
    SCFs included): what tests/chip_smoke_references.py reads from
    tuna_tpu's log."""
    from tuna_tpu_torch.drivers import energy
    counts = {"scf_cycles": [], "cc_iterations": []}
    serial_scf, solve = energy.run_self_consistent_field, cc.solve_amplitudes

    def scf_counted(*args, **kwargs):
        SCF_output = serial_scf(*args, **kwargs)
        counts["scf_cycles"].append(len(SCF_output.iteration_seconds))
        return SCF_output

    def solve_counted(*args, **kwargs):
        result = solve(*args, **kwargs)
        counts["cc_iterations"].append(result[0])
        return result

    energy.run_self_consistent_field, cc.solve_amplitudes = scf_counted, solve_counted
    try:
        yield counts
    finally:
        energy.run_self_consistent_field, cc.solve_amplitudes = serial_scf, solve


def _within(name: str, got, expected, limit: float, deltas: dict,
            failures: list | None = None) -> None:
    """deltas[name] = the largest distance of got from expected; beyond
    `limit` it fails, or, where `failures` is given, is added to it."""
    delta = float(np.max(np.abs(np.subtract(got, expected))))
    deltas[name] = delta
    message = (f"{name} {np.asarray(got).tolist()!r} is {delta:.3e} from the reference "
               f"{np.asarray(expected).tolist()!r} (limit {limit:.1e})")
    if failures is None:
        require(delta <= limit, message)
    elif not delta <= limit:
        failures.append(message)


def check_line_23(line: str, kernels: tuple) -> tuple:
    """One line of phase 23 on the card against tuna_tpu's numbers in
    REFERENCES_23: its result, the SCF cycles of every SCF and the CC
    iterations of every solve, and where the line has them its (T)
    energies (each K2 and K2u call also against its plain version on the
    path's inputs), IP/EA states, finite-field properties, CBS parts and
    anharmonic levels.  Returns (what run returns, launches, recorders,
    wall seconds)."""
    from tuna_tpu_torch.drivers import common, electric, energy, freq
    ref = REFERENCES_23[line]
    watched = (("restricted_CCSD_T", cc), ("unrestricted_CCSD_T", cc), ("ccsd_t_energy", cc),
               ("uccsd_t_energy", cc), ("second_derivative", electric),
               *((name, electric) for name in FIELD_STENCILS if hasattr(electric, name)),
               ("evaluate_molecular_energy", energy), ("scan_coordinate", energy),
               ("extrapolate_energies", common), ("solve_nuclear_schroedinger", freq),
               ("_process_anharmonic_output", freq), ("calculate_harmonic_frequency", freq))
    with contextlib.ExitStack() as stack:
        counts = stack.enter_context(solve_counts())
        rec = {name: stack.enter_context(Recorder(name, module)) for name, module in watched}
        result, wall, launches = run_counted(line, kernels)
    slack = SCF_CYCLE_SLACK.get(line, {})
    require(len(counts["scf_cycles"]) == len(ref["scf_cycles"])
            and all(abs(a - b) <= slack.get(i, 0)
                    for i, (a, b) in enumerate(zip(counts["scf_cycles"], ref["scf_cycles"])))
            and counts["cc_iterations"] == ref["cc_iterations"],
            f"{line}: SCF cycles {counts['scf_cycles']}, CC iterations "
            f"{counts['cc_iterations']}; the reference {ref['scf_cycles']}, "
            f"{ref['cc_iterations']}")
    deltas: dict = {}
    for name, plain in (("ccsd_t_energy", cc._ccsd_t_energy_plain),
                        ("uccsd_t_energy", cc._uccsd_t_energy_plain)):
        for args, E_T in rec[name].calls:
            _within(f"{name} against its plain version", float(E_T), float(plain(*args)),
                    TRIPLES_TOLERANCE * abs(float(E_T)), deltas)
    for name in ("restricted_T", "unrestricted_T"):
        got = [float(r) for _, r in rec[name.replace("_T", "_CCSD_T")].calls]
        require(len(got) == len(ref.get(name, [])), f"{line}: {len(got)} {name} energies")
        if got:
            _within(name, got, ref[name], PHASE_23_TOLERANCE, deltas)
    if line.startswith("SPE"):
        _within("E_total", float(result[2]), ref["energy"], PHASE_23_TOLERANCE, deltas)
    elif line.startswith(("IP", "EA")):
        states = [float(r[2]) for _, r in rec["evaluate_molecular_energy"].calls]
        _within("state energies", states, ref["state_energies"], PHASE_23_TOLERANCE, deltas)
        _within("result", float(result), ref["result"], PHASE_23_TOLERANCE, deltas)
    elif line.startswith("BDE"):
        _within("result", float(result), ref["result"], BDE_TOLERANCE, deltas)
    for name, (step, weight, order) in FIELD_STENCILS.items():
        if name in ref:
            got = ([-float(r) for _, r in rec["second_derivative"].calls]
                   if name == "polarisability_components"
                   else rec[name].calls[0][1])
            _within(name, got, ref[name], weight * PHASE_23_TOLERANCE / step ** order, deltas)
    if "extrapolation" in ref:
        args, parts = rec["extrapolate_energies"].calls[0]
        _within("CBS inputs", args[1:5], ref["extrapolation"]["inputs"], PHASE_23_TOLERANCE,
                deltas)
        _within("CBS parts", parts, ref["extrapolation"]["parts"], PHASE_23_TOLERANCE, deltas)
    if line.startswith("ANHARM"):
        levels, _, _, _, V = rec["solve_nuclear_schroedinger"].calls[-1][1]
        chi = rec["_process_anharmonic_output"].calls[0][0][4]
        harmonic_cm = rec["calculate_harmonic_frequency"].calls[0][1][2]
        scans = len(rec["scan_coordinate"].calls)
        require(scans == ref["scans"], f"{line}: {scans} scans, the reference {ref['scans']}")
        _within("levels", levels, ref["levels"], ANHARM_TOLERANCE, deltas)
        _within("zero-point energy", levels[0] - np.min(V), ref["zero_point_energy"],
                ANHARM_TOLERANCE, deltas)
        per_cm = constants.PER_CM_IN_HARTREE
        _within("fundamental (per cm)", (levels[1] - levels[0]) * per_cm,
                (ref["levels"][1] - ref["levels"][0]) * per_cm, CM_TOLERANCE, deltas)
        _within("chi times the harmonic frequency (per cm)", chi * harmonic_cm,
                ref["chi"] * harmonic_cm, CM_TOLERANCE, deltas)
        print(f"anharmonic: {line}; fundamental {float(levels[1] - levels[0]) * per_cm!r} per cm, "
              f"chi {float(chi)!r}, zero-point energy {float(levels[0] - np.min(V))!r}, "
              f"harmonic {float(harmonic_cm)!r} per cm, {scans} scans ({(scans - 1) // 2} widening "
              f"iterations)")
    print(f"end to end: {line}; from the reference: "
          + ", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items())
          + f"; {len(counts['scf_cycles'])} SCFs ({sum(counts['scf_cycles'])} cycles, "
          f"{sum(a != b for a, b in zip(counts['scf_cycles'], ref['scf_cycles']))} unlike the "
          f"reference's), CC iterations {counts['cc_iterations']}; wall {wall:.3f} s; launches "
          f"{({name: n for name, n in launches.items() if n})}")
    return result, launches, rec, wall


def check_phase_23(serial_properties: dict) -> dict:
    """Phase 23: every line of PHASE_23_LINES against tuna_tpu's numbers
    (check_line_23); LINE_CC3's profile with its peak device memory; one K2
    launch a QCISD(T) line, with QCISD's disconnected scale 2; and the
    QCISD(T) line's DIRECT twin (K4, K5) against the stored line.  Puts
    LINE_PROPERTIES's properties and wall into serial_properties (phase 27
    prints them beside its batch's).  Returns the launches summed over the
    counted runs."""
    start = time.perf_counter()
    runs = []
    for line, kernels in PHASE_23_LINES:
        torch.cuda.reset_peak_memory_stats()
        result, launches, rec, wall = check_line_23(line, kernels)
        runs.append(launches)
        if line == LINE_PROPERTIES:
            serial_properties.update({name: rec[name].calls[0][1] for name in FIELD_STENCILS
                                      if name in rec and rec[name].calls}, wall=wall)
        if line == LINE_CC3:
            peak = torch.cuda.max_memory_allocated()
            profile = profile_path(LINE_CC3, CC3_WARM_RUNS)
            profile["peak_device_memory_bytes"] = peak
            print("profile: " + json.dumps(profile))
        if line == LINE_QCISD_T:
            calls = rec["ccsd_t_energy"].calls
            require(launches["ccsd_t_energy"] == 1 and len(calls) == 1 and calls[0][0][-1] == 2.0,
                    f"{line}: K2 launched {launches['ccsd_t_energy']} times, v_scale "
                    f"{[args[-1] for args, _ in calls]}")
            stored_scf, _, stored_energy, _ = result
            direct, _, direct_energy, _, wall, launches = drive(LINE_QCISD_T_DIRECT,
                                                               DIRECT_PATH_KERNELS)
            runs.append(launches)
            counts = (len(direct.iteration_seconds), len(direct.correlation_iteration_seconds))
            require(direct.integrals.ERI_AO is None
                    and abs(direct_energy - stored_energy) <= DIRECT_TOLERANCE
                    and counts == (len(stored_scf.iteration_seconds),
                                   len(stored_scf.correlation_iteration_seconds)),
                    f"{LINE_QCISD_T_DIRECT}: {direct_energy - stored_energy:.3e} Ha from the "
                    f"stored line, counts {counts}")
            print(f"twin: {LINE_QCISD_T_DIRECT} minus {LINE_QCISD_T}: "
                  f"{direct_energy - stored_energy:.3e} Ha; wall {wall:.3f} s; launches "
                  f"{({name: n for name, n in launches.items() if n})}")
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    print(f"phase 23: {time.perf_counter() - start:.1f} s; launches "
          f"{({name: n for name, n in launches.items() if n})}")
    return launches


def check_line_24(line: str, kernels: tuple) -> tuple:
    """One line of phase 24 on the card against tuna_tpu's numbers in
    REFERENCES_24.  Returns (what run returns, launches, wall seconds)."""
    from tuna_tpu_torch.post import excited, rpa
    ref = REFERENCES_24[line]
    watched = (("print_absorption_spectrum", excited), ("restricted_doubles_correction", excited),
               ("unrestricted_doubles_correction", excited), ("orbital_hessian_lowest", rpa))
    with contextlib.ExitStack() as stack:
        counts = stack.enter_context(solve_counts())
        rec = {name: stack.enter_context(Recorder(name, module)) for name, module in watched}
        result, wall, launches = run_counted(line, kernels)
    tolerance, slack = ROUNDING_DECIDED_24.get(line, (EXCITED_TOLERANCE, 0))
    deltas: dict = {}
    _within("E_total", float(result[2]), ref["energy"], tolerance, deltas)
    spectra = rec["print_absorption_spectrum"].calls
    require(len(spectra) == ("excitation_energies" in ref), f"{line}: {len(spectra)} spectra")
    if spectra:
        args, _ = spectra[0]
        n = len(ref["excitation_energies"])
        energies, strengths = (args[i].detach().cpu().numpy() for i in (1, 4))
        require(len(energies) >= n, f"{line}: {len(energies)} states, the reference {n}")
        _within("excitation energies", energies[:n], ref["excitation_energies"],
                tolerance, deltas)
        _within("oscillator strengths", strengths[:n], ref["oscillator_strengths"],
                STRENGTH_TOLERANCE, deltas)
    for key, names in (("doubles", ("restricted_doubles_correction",
                                    "unrestricted_doubles_correction")),
                       ("hessian_lowest", ("orbital_hessian_lowest",))):
        got = [float(r) for name in names for _, r in rec[name].calls]
        require(len(got) == len(ref.get(key, [])), f"{line}: {len(got)} {key}")
        if got:
            _within(key, got, ref[key], tolerance, deltas)
    print(f"end to end: {line}; from the reference: "
          + ", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items())
          + f"; SCF cycles {counts['scf_cycles']}; wall {wall:.3f} s; launches "
          f"{({name: n for name, n in launches.items() if n})}")
    cycles, expected = counts["scf_cycles"], ref["scf_cycles"]
    require(len(cycles) == len(expected) and cycles[:-1] == expected[:-1]
            and abs(cycles[-1] - expected[-1]) <= slack,
            f"{line}: SCF cycles {cycles}, the reference {expected} (slack {slack})")
    return result, launches, wall


@contextlib.contextmanager
def kernel_build_ms():
    """The device-synchronised ms of each restricted and unrestricted XC
    kernel build (dft/kernels.py) inside the block."""
    from tuna_tpu_torch.dft import kernels
    times: list = []
    originals = {name: getattr(kernels, name) for name in
                 ("restricted_xc_kernel_matrices", "unrestricted_xc_kernel_matrices")}

    def timed(original):
        def build(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = original(*args, **kwargs)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            return result
        return build

    for name, original in originals.items():
        setattr(kernels, name, timed(original))
    try:
        yield times
    finally:
        for name, original in originals.items():
            setattr(kernels, name, original)


def check_phase_24() -> dict:
    """Phase 24: every line of PHASE_24_LINES against tuna_tpu's numbers
    (check_line_24), LINE_TDLDA's profile with its peak device memory and
    the ms of its K_XC builds.  Returns the launches summed over the
    counted runs."""
    start = time.perf_counter()
    runs = []
    for line, kernels in PHASE_24_LINES:
        torch.cuda.reset_peak_memory_stats()
        with kernel_build_ms() as build_ms:
            _, launches, wall = check_line_24(line, kernels)
        peak = torch.cuda.max_memory_allocated()
        runs.append(launches)
        print(f"excited: {line}; wall {wall:.3f} s, peak device memory {peak} bytes, "
              f"K_XC builds {[round(ms, 3) for ms in build_ms]} ms")
        if line == LINE_TDLDA:
            with kernel_build_ms() as build_ms:
                profile = profile_path(LINE_TDLDA, TDLDA_WARM_RUNS)
            profile["peak_device_memory_bytes"] = peak
            profile["k_xc_build_ms"] = statistics.median(build_ms[:TDLDA_WARM_RUNS])
            print("profile: " + json.dumps(profile))
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    print(f"phase 24: {time.perf_counter() - start:.1f} s; launches "
          f"{({name: n for name, n in launches.items() if n})}")
    return launches


# ---------------------------------------------------------------------------
# Phase 25: K1, K4 and K3 at g and h shells, and the lines they open
# ---------------------------------------------------------------------------

def high_l_build_summary(registers: dict) -> str:
    """ptxas's registers and spills of the instantiations that take g and h
    shells: K1's and K4's light and heavy kernels of the classes with
    L_bra = 7..10 (csrc/quartet_l7.cu .. quartet_l10.cu; the classes up
    to (6, 6) are those of lmax 3), K1's and K4's pair rows and K3 at lmax
    4 and 5."""
    added = ("eri:pair_rows_kernel<4>", "eri:pair_rows_kernel<5>",
             "fock_direct:pair_rows_kernel<4>", "fock_direct:pair_rows_kernel<5>",
             "one_electron:one_electron_kernel<4>", "one_electron:one_electron_kernel<5>")
    new = {key: value for key, value in registers.items()
           if key in added or (key.startswith("quartet_l") and ":quartet_" in key)}
    classes = [key for key in new if "quartet_" in key]
    require(len(classes) == 2 * 2 * sum(la + 1 for la in range(7, 11)),
            f"{len(classes)} class kernels of L_bra 7..10, expected 152")
    regs = [value if isinstance(value, int) else int(value.split()[0]) for value in new.values()]
    spilled = {key: value for key, value in new.items() if not isinstance(value, int)}
    return (f"the {len(new)} kernels added for lmax 4-5 ({len(classes)} class kernels of K1 "
            f"and K4, the pair rows, K3): {min(regs)}-{max(regs)} registers, "
            f"{len(spilled)} with spill stores {json.dumps(spilled)}")


def fock_from_packed(plan: IntegralPlan, packed, P):
    """J and K of a symmetric P from K1's packed matrix: J_ij = sum_kl
    (ij|kl) P_kl from the pair vector, K_ij = sum_kl (ik|jl) P_kl a row i
    at a time, (N, N, N) gathered from the packed rows of the pairs (i, k)."""
    t = plan.tensors(packed.device)
    pair_index, pi, pj = t["pair_index"], t["pid_i"].long(), t["pid_j"].long()
    J_pair = packed @ (P[pi, pj] * torch.where(pi == pj, 1.0, 2.0))
    J = torch.zeros_like(P)
    J[pi, pj] = J_pair
    J[pj, pi] = J_pair
    K = torch.empty_like(P)
    for i in range(plan.n_basis):
        K[i] = torch.einsum("kjl,kl->j", packed[pair_index[i]][:, pair_index], P)
    return J, K


def check_high_l_kernels(device, record: dict) -> str:
    """Phase 25 (a): K1, K3 and K4 on reduced plans of N2 (HIGH_L_PLANS: g
    shells at cc-pVQZ, classes up to (8, 8); g and h at cc-pV5Z, up to (10,
    10)) against their plain versions: K1 and K3 within INTEGRAL_TOLERANCE
    and bitwise over two calls, K4 within FOCK_TOLERANCE of the largest
    |entry| on a seeded density; ms (CUDA events, median of 5), device ms a
    call back to back (back_to_back_ms: 10 calls, median of 3), bound, and
    plain ms (the checked call, host clock to a sync) of each, into
    record[...]["high_l"], and the lmax reached into
    record[...]["lmax_reached"]."""
    parts = []
    for basis, ls in HIGH_L_PLANS:
        molecule = diatomic("N", 1.1, basis)
        functions = shell_subset(molecule.cartesian_basis_functions,
                                 [(atom, l) for atom in (0, 1) for l in ls])
        plan = IntegralPlan(functions, molecule.n_atoms)
        coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
        charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=device)
        origin = molecule.centre_of_mass
        N = plan.n_basis
        C = np.random.default_rng(25).standard_normal((N, 7)) / np.sqrt(N)
        P = torch.as_tensor(C @ C.T, dtype=torch.float64, device=device)
        fns = {"eri_packed": (lambda: plan.eri_pair_packed(coords),
                              lambda: plan._eri_packed_plain(coords)),
               "one_electron": (lambda: plan.one_electron(coords, charges, origin),
                                lambda: plan._one_electron_plain(coords, charges, origin)),
               "fock_direct": (lambda: plan.fock_direct(coords, P),
                               lambda: plan._fock_direct_plain(coords, P))}
        got, plain_ms = {}, {}
        for name, (kernel, plain) in fns.items():
            first, again = kernel(), kernel()
            torch.cuda.synchronize()
            start = time.perf_counter()
            expected = plain()
            torch.cuda.synchronize()
            plain_ms[name] = (time.perf_counter() - start) * 1e3
            got[name] = (first, again, expected)
        errors = {}
        for name, (first, again, plain) in got.items():
            first, again, plain = ((x,) if torch.is_tensor(x) else x
                                   for x in (first, again, plain))
            require(all(bool(torch.all(torch.isfinite(x))) for x in first),
                    f"{name} N2/{basis}: non-finite values")
            if name == "fock_direct":
                errors[name] = max(_relative(a, b) for a, b in zip(first, plain))
                require(errors[name] <= FOCK_TOLERANCE,
                        f"fock_direct N2/{basis}: {errors[name]:.3e} from its plain version")
                absolute = max(float(torch.max(torch.abs(a - b))) for a, b in zip(first, plain))
            else:
                errors[name] = absolute = max(float(torch.max(torch.abs(a - b)))
                                              for a, b in zip(first, plain))
                require(errors[name] <= INTEGRAL_TOLERANCE,
                        f"{name} N2/{basis}: {errors[name]:.3e} from its plain version")
                require(all(torch.equal(a, b) for a, b in zip(first, again)),
                        f"{name} N2/{basis}: two calls differ")
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"], absolute)
        del got
        t = plan.tensors(device)
        needed, algorithm = eri_operations(plan)
        fock_needed, _ = fock_direct_operations(plan)
        bounds = {
            "eri_packed": bound(eri_input_bytes(plan, coords) + 8 * plan.n_pairs ** 2,
                                needed / FP64_PER_MS),
            "fock_direct": bound(eri_input_bytes(plan, coords)
                                 + tensor_bytes(P, t["pid_i"], t["pid_j"]) + 2 * 8 * N * N,
                                 fock_needed / FP64_PER_MS),
            "one_electron": bound(
                tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"],
                             t["atom1"], t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"],
                             t["boys_one_electron"]) + 8 * 9 * N * N,
                one_electron_operations(plan) / FP64_PER_MS)}
        shape = f"N2/{basis} {'+'.join('spdfgh'[l] for l in ls)} ({N} functions)"
        texts = []
        for name, (kernel, _) in fns.items():
            entry = {"lmax": plan.lmax, "classes": len(plan.work_list()[1]),
                     "max_abs_err" if name != "fock_direct" else "relative_err": errors[name],
                     "ms": median_ms(kernel), "plain_ms": plain_ms[name],
                     "device_ms_a_launch": back_to_back_ms(kernel, calls=10, repeats=3,
                                                           sleep_cycles=HIGH_L_SLEEP_CYCLES),
                     **bounds[name]}
            record[name].setdefault("high_l", {})[shape] = entry
            record[name]["lmax_reached"] = max(record[name].get("lmax_reached", 0), plan.lmax)
            texts.append(f"{name} {errors[name]:.3e} ({entry['ms']:.4f} ms, back to back "
                         f"{entry['device_ms_a_launch']:.4f}, bound {entry['bound_ms']:.6f} ms "
                         f"by {entry['bound_by']}, plain {entry['plain_ms']:.2f} ms)")
        parts.append(f"{shape}, lmax {plan.lmax}, {work_list_summary(plan)}: "
                     + "; ".join(texts) + f"; K1's algorithm {algorithm:.4g} operations, "
                     f"{needed:.4g} needed")
    return "kernels g and h shells: " + " | ".join(parts)


def check_fock_against_eri_full(device, record: dict) -> str:
    """Phase 25 (a), full size: K4 at N2/cc-pV5Z (252 functions, 31,878 AO
    pairs) against J and K formed from K1's packed matrix (8.1 GB) on a
    seeded density, FOCK_TOLERANCE of the largest |entry|; the host's work
    list build, K1 and K4 ms (CUDA events) and device ms a call back to
    back (3 calls, median of 3), their bounds."""
    molecule = diatomic("N", 1.1, "CC-PV5Z")
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    start = time.perf_counter()
    quartets, classes = plan.work_list()
    work_list_s = time.perf_counter() - start
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
    N = plan.n_basis
    C = np.random.default_rng(13).standard_normal((N, 7)) / np.sqrt(N)
    P = torch.as_tensor(C @ C.T, dtype=torch.float64, device=device)
    J, K = plan.fock_direct(coords, P)
    packed = plan.eri_pair_packed(coords)
    J_ref, K_ref = fock_from_packed(plan, packed, P)
    del packed
    torch.cuda.synchronize()
    err = max(_relative(J, J_ref), _relative(K, K_ref))
    require(bool(torch.all(torch.isfinite(J)) and torch.all(torch.isfinite(K))),
            "fock_direct N2/cc-pV5Z: non-finite J or K")
    require(err <= FOCK_TOLERANCE, f"fock_direct N2/cc-pV5Z: {err:.3e} from K1's J and K")
    fock_ms = median_ms(lambda: plan.fock_direct(coords, P), repeats=3)
    eri_ms = median_ms(lambda: plan.eri_pair_packed(coords), repeats=3)
    fock_launch = back_to_back_ms(lambda: plan.fock_direct(coords, P), calls=3, repeats=3,
                                  sleep_cycles=HIGH_L_SLEEP_CYCLES)
    eri_launch = back_to_back_ms(lambda: plan.eri_pair_packed(coords), calls=3, repeats=3,
                                 sleep_cycles=HIGH_L_SLEEP_CYCLES)
    t = plan.tensors(device)
    needed, algorithm = eri_operations(plan)
    fock_needed, _ = fock_direct_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + 8 * plan.n_pairs ** 2,
                      needed / FP64_PER_MS)
    fock_bound = bound(eri_input_bytes(plan, coords) + tensor_bytes(P, t["pid_i"], t["pid_j"])
                       + 2 * 8 * N * N, fock_needed / FP64_PER_MS)
    shape = "N2/CC-PV5Z (252 functions)"
    record["fock_direct"].setdefault("high_l", {})[shape] = {
        "relative_err_against_eri_packed": err, "ms": fock_ms,
        "device_ms_a_launch": fock_launch, **fock_bound}
    record["eri_packed"].setdefault("high_l", {})[shape] = {
        "ms": eri_ms, "device_ms_a_launch": eri_launch, "work_list_host_s": work_list_s,
        **eri_bound}
    return (f"kernels full size {shape}: {work_list_summary(plan)}, built on the host in "
            f"{work_list_s:.2f} s; fock_direct against J and K from eri_packed's packed matrix "
            f"{err:.3e}; fock_direct {fock_ms:.3f} ms (back to back {fock_launch:.3f}, "
            f"bound {fock_bound['bound_ms']:.4f} ms by {fock_bound['bound_by']}); eri_packed "
            f"{eri_ms:.3f} ms (back to back {eri_launch:.3f}, bound "
            f"{eri_bound['bound_ms']:.4f} ms by {eri_bound['bound_by']}; {needed:.4g} operations "
            f"needed, {algorithm:.4g} in the kernel's algorithm)")


@contextlib.contextmanager
def integral_call_ms():
    """The device ms of every K1 (eri_pair_packed) and K4 (fock_direct) call
    of the runs inside the block, by CUDA events on the caller's stream
    (the side streams join it), read when the block ends."""
    events = {"eri_packed": [], "fock_direct": []}
    originals = {"eri_packed": IntegralPlan.eri_pair_packed,
                 "fock_direct": IntegralPlan.fock_direct}

    def timed(name):
        def call(self, coords, *args):
            if coords.device.type != "cuda":
                return originals[name](self, coords, *args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = originals[name](self, coords, *args)
            end.record()
            events[name].append((start, end))
            return result
        return call

    times: dict = {}
    IntegralPlan.eri_pair_packed = timed("eri_packed")
    IntegralPlan.fock_direct = timed("fock_direct")
    try:
        yield times
    finally:
        IntegralPlan.eri_pair_packed = originals["eri_packed"]
        IntegralPlan.fock_direct = originals["fock_direct"]
        torch.cuda.synchronize()
        times.update({name: [start.elapsed_time(end) for start, end in pairs]
                      for name, pairs in events.items()})


def check_line_25(line: str, kernels: tuple) -> dict:
    """One line of phase 25 on the card, twice (the first run, then a warm
    one), against tuna_tpu's numbers in REFERENCES_25 (a DIRECT HF line
    against its stored twin's run too): the energy within
    PHASE_25_TOLERANCE, the SCF cycles of every SCF and the CC iterations
    of every solve equal; a (T) against K2's plain version on the path's
    inputs.  Prints the walls, SCF ms an iteration, K1's and K4's ms a call
    and the peak device memory; returns the first run's launches and what
    it returned."""
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        with contextlib.ExitStack() as stack:
            counts = stack.enter_context(solve_counts())
            triples = stack.enter_context(Recorder("ccsd_t_energy"))
            call_ms = stack.enter_context(integral_call_ms())
            result, wall, launches = run_counted(line, kernels)
        runs.append((result, wall, launches, counts, triples.calls, call_ms))
    peak = torch.cuda.max_memory_allocated()
    result, wall, launches, counts, triple_calls, _ = runs[0]
    SCF_output, energy = result[0], float(result[2])
    reference = REFERENCES_25.get(line, REFERENCES_25.get(line.replace(" DIRECT", "")))
    deltas: dict = {}
    require(runs[1][3] == counts, f"{line}: the warm run's counts {runs[1][3]} are not the "
                                  f"first's {counts}")
    _within("warm run", float(runs[1][0][2]), energy, PHASE_25_TOLERANCE, deltas)
    require(counts == {key: reference[key] for key in ("scf_cycles", "cc_iterations")},
            f"{line}: SCF cycles {counts['scf_cycles']}, CC iterations "
            f"{counts['cc_iterations']}; the reference {reference['scf_cycles']}, "
            f"{reference['cc_iterations']}")
    if "ccsd_energy" in reference:
        require(len(triple_calls) == 1, f"{line}: {len(triple_calls)} (T) calls")
        args, E_T = triple_calls[0]
        _within("(T) against its plain version", float(E_T),
                float(cc._ccsd_t_energy_plain(*args)), TRIPLES_TOLERANCE * abs(float(E_T)),
                deltas)
        _within("E_SCF", float(SCF_output.energy), reference["scf_energy"], PHASE_25_TOLERANCE,
                deltas)
        _within("E_total - E_(T)", energy - float(E_T), reference["ccsd_energy"],
                PHASE_25_TOLERANCE, deltas)
    elif reference["energy"] is not None:
        _within("E_total", energy, reference["energy"], PHASE_25_TOLERANCE, deltas)
    if "DIRECT" in line:
        require(SCF_output.integrals.ERI_AO is None and launches["eri_packed"] == 0,
                f"{line}: the N^4 tensor was formed")
    scf_ms = statistics.median(runs[1][0][0].iteration_seconds) * 1e3
    integral_ms = {name: [round(ms, 3) for ms in times] for name, times in runs[1][5].items()
                   if times}
    print(f"end to end: {line}; E_total {energy!r}; from the reference: "
          + (", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items()))
          + f"; SCF cycles {counts['scf_cycles']}, CC iterations {counts['cc_iterations']}; "
          f"wall {wall:.3f} s first, {runs[1][1]:.3f} s warm; SCF {scf_ms:.3f} ms an iteration "
          f"(warm); K1/K4 ms a call (warm, CUDA events) {json.dumps(integral_ms)}; peak device "
          f"memory {peak} bytes; launches {({name: n for name, n in launches.items() if n})}")
    return {"result": result, "launches": launches, "counts": counts}


def check_phase_25() -> dict:
    """Phase 25 (b): every line of PHASE_25_LINES (check_line_25); each
    DIRECT HF line also against the stored line before it, where there is
    one (LINE_5Z_HF_DIRECT against LINE_5Z_HF: PHASE_25_TOLERANCE and equal
    counts).  Returns the launches summed over the first runs."""
    start = time.perf_counter()
    runs, outcomes = [], {}
    for line, kernels in PHASE_25_LINES:
        outcomes[line] = check_line_25(line, kernels)
        runs.append(outcomes[line]["launches"])
    stored, direct = outcomes[LINE_5Z_HF], outcomes[LINE_5Z_HF_DIRECT]
    difference = float(direct["result"][2]) - float(stored["result"][2])
    require(abs(difference) <= PHASE_25_TOLERANCE and direct["counts"] == stored["counts"],
            f"{LINE_5Z_HF_DIRECT}: {difference:.3e} Ha from the stored line, counts "
            f"{direct['counts']} against {stored['counts']}")
    print(f"twin: {LINE_5Z_HF_DIRECT} minus {LINE_5Z_HF}: {difference:.3e} Ha, equal counts")
    print(f"unpinned: {LINE_5Z_N2_DIRECT}: tuna_tpu's DIRECT run of this line did not end "
          f"within two hours on the pinning host, so its energy is held by no constant: the "
          f"line is held by its SCF cycles, its warm run and phase 25's K4 against K1 at "
          f"N2/cc-pV5Z (ROADMAP queue 3)")
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    print(f"phase 25: {time.perf_counter() - start:.1f} s; launches "
          f"{({name: n for name, n in launches.items() if n})}")
    return launches


# ---------------------------------------------------------------------------
# Phase 26: K8a, K8b and K8bu at g and h shells, and the gradient lines
# ---------------------------------------------------------------------------

def check_high_l_gradient_kernels(device, record: dict, registers: dict, frames: dict) -> str:
    """Phase 26 (a): K8a, K8b and K8bu on HIGH_L_GRADIENT_PLANS (atom 1
    moving, the origin at the centre of mass; K8b on a seeded density-like
    P, K8bu on seeded Pa != Pb) against their plain versions within
    INTEGRAL_TOLERANCE, each bitwise over two calls, K8bu at Pa = Pb = P/2
    against K8b(P); K8b's and K8bu's plain versions contract one dense
    tangent (11.8 GB at HF/cc-pV5Z).  Into record[...]["high_l"] for each
    plan: ms (CUDA events, median of 5), device ms a call back to back,
    plain ms, the bound (eri_operations, one_electron_deriv_operations), K8b's
    launches and host ms a call and the host's build of its schedule; the
    registers and stack frames of K8a at lmax 4-5 and of K8b's classes of
    L_bra 7-10 (a spill fails the run)."""
    parts = []
    for symbol, partner, bond, basis, keep in HIGH_L_GRADIENT_PLANS:
        molecule = diatomic(symbol, bond, basis, partner)
        functions = (shell_subset(molecule.cartesian_basis_functions, keep) if keep
                     else molecule.cartesian_basis_functions)
        plan = IntegralPlan(functions, molecule.n_atoms)
        start = time.perf_counter()
        plan.deriv_schedule()
        schedule_s = time.perf_counter() - start
        coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64, device=device)
        charges = torch.as_tensor(molecule.charges, dtype=torch.float64, device=device)
        masses = np.asarray(molecule.masses, dtype=np.float64)
        fraction = float(masses[1] / masses.sum())
        origin = fraction * molecule.bond_length
        N = plan.n_basis
        rng = np.random.default_rng(26)
        C, C_a, C_b = (rng.standard_normal((N, k)) / np.sqrt(N) for k in (7, 8, 7))
        P, P_a, P_b = (torch.as_tensor(x @ x.T, dtype=torch.float64, device=device)
                       for x in (C, C_a, C_b))
        hfx = 0.2
        fns = {"one_electron_deriv": lambda: plan.one_electron_deriv(coords, charges, origin,
                                                                     fraction),
               "eri_deriv_energy": lambda: plan.eri_deriv_energy(coords, P, hfx),
               "eri_deriv_energy_unrestricted":
                   lambda: plan.eri_deriv_energy_unrestricted(coords, P_a, P_b, hfx)}
        got = {name: (fn(), fn()) for name, fn in fns.items()}
        half = plan.eri_deriv_energy_unrestricted(coords, P / 2, P / 2, hfx)
        torch.cuda.synchronize()
        plain_ms = {}
        start = time.perf_counter()
        expected = {"one_electron_deriv": plan._one_electron_deriv_plain(coords, charges, origin,
                                                                         fraction)}
        torch.cuda.synchronize()
        plain_ms["one_electron_deriv"] = (time.perf_counter() - start) * 1e3
        start = time.perf_counter()
        tangent = plan._eri_tangent_plain(coords)
        torch.cuda.synchronize()
        tangent_ms = (time.perf_counter() - start) * 1e3
        for name, plain, args in (
                ("eri_deriv_energy", plan._eri_deriv_energy_plain, (P, hfx)),
                ("eri_deriv_energy_unrestricted", plan._eri_deriv_energy_unrestricted_plain,
                 (P_a, P_b, hfx))):
            start = time.perf_counter()
            expected[name] = plain(coords, *args, tangent=tangent)
            torch.cuda.synchronize()
            plain_ms[name] = tangent_ms + (time.perf_counter() - start) * 1e3
        del tangent
        torch.cuda.empty_cache()
        errors = {}
        for name, (first, again) in got.items():
            first, again, plain = ((x,) if torch.is_tensor(x) else x
                                   for x in (first, again, expected[name]))
            require(all(bool(torch.all(torch.isfinite(x))) for x in first),
                    f"{name} {basis}: non-finite values")
            errors[name] = max(float(torch.max(torch.abs(a - b))) for a, b in zip(first, plain))
            require(errors[name] <= INTEGRAL_TOLERANCE,
                    f"{name} {basis}: {errors[name]:.3e} from its plain version")
            require(all(torch.equal(a, b) for a, b in zip(first, again)),
                    f"{name} {basis}: two calls differ")
            record[name]["max_abs_err"] = max(record[name]["max_abs_err"], errors[name])
        restricted = got["eri_deriv_energy"][0]
        half_err = abs(float(half - restricted)) / abs(float(restricted))
        require(half_err <= UNRESTRICTED_HALF_TOLERANCE,
                f"{basis}: K8bu at Pa = Pb = P/2 off K8b(P) by {half_err:.3e} (relative)")
        t = plan.tensors(device)
        needed_1e, _ = one_electron_deriv_operations(plan)
        needed_2e, _ = eri_operations(plan, derivative=True)
        algorithm = deriv_operations(plan)
        eri_bytes = eri_input_bytes(plan, coords) + tensor_bytes(t["pid_i"], t["pid_j"]) + 8
        bounds = {
            "one_electron_deriv": bound(
                tensor_bytes(coords, charges, t["a"], t["b"], t["coef"], t["l1"], t["l2"],
                             t["atom1"], t["atom2"], t["pair_start"], t["ao_i"], t["ao_j"],
                             t["boys_one_electron_deriv"]) + 8 * 9 * N * N,
                needed_1e / FP64_PER_MS),
            "eri_deriv_energy": bound(eri_bytes + tensor_bytes(P), needed_2e / FP64_PER_MS),
            "eri_deriv_energy_unrestricted": bound(eri_bytes + 3 * tensor_bytes(P),
                                                   needed_2e / FP64_PER_MS)}
        shape = (f"{symbol}{partner or symbol}/{basis}"
                 + (f" {'+'.join('spdfgh'[l] + str(atom) for atom, l in keep)}" if keep else "")
                 + f" ({N} functions)")
        texts = []
        for name, fn in fns.items():
            entry = {"lmax": plan.lmax, "max_abs_err": errors[name], "ms": median_ms(fn),
                     "plain_ms": plain_ms[name],
                     "device_ms_a_launch": back_to_back_ms(fn, calls=10, repeats=3,
                                                           sleep_cycles=HIGH_L_SLEEP_CYCLES),
                     **bounds[name]}
            if name != "one_electron_deriv":
                entry.update(launches_a_call=deriv_launches(plan), host_ms_a_call=host_ms_a_call(fn),
                             operations_needed=needed_2e, operations_in_kernel=algorithm,
                             schedule_host_s=schedule_s)
            record[name].setdefault("high_l", {})[shape] = entry
            record[name]["lmax_reached"] = max(record[name].get("lmax_reached", 0), plan.lmax)
            texts.append(f"{name} {errors[name]:.3e} ({entry['ms']:.4f} ms, back to back "
                         f"{entry['device_ms_a_launch']:.4f}, bound {entry['bound_ms']:.6f} ms by "
                         f"{entry['bound_by']}, plain {entry['plain_ms']:.1f} ms"
                         + (f", {entry['launches_a_call']} launches and host "
                            f"{entry['host_ms_a_call']:.3f} ms a call" if "host_ms_a_call" in entry
                            else "") + ")")
        parts.append(f"{shape}, lmax {plan.lmax}: " + "; ".join(texts)
                     + f"; K8bu at Pa = Pb = P/2 {half_err:.1e} from K8b(P); "
                     f"{deriv_schedule_summary(plan)}, built on the host in {schedule_s:.2f} s; "
                     f"K8b's algorithm {algorithm:.4g} operations, {needed_2e:.4g} needed")
        del plan
    one_electron = lane_kernel_registers("one_electron_deriv", "one_electron_deriv_kernel",
                                         record["one_electron_deriv"], registers, frames)
    deriv = deriv_kernel_registers(record["eri_deriv_energy"], registers, frames,
                                   "deriv_weights_kernel")
    return ("gradient kernels g and h shells: " + " | ".join(parts)
            + f"; registers and stack frame bytes (ptxas): K8a {json.dumps(one_electron)}, "
            f"K8b {json.dumps(deriv)}")


def two_electron_energy(plan: IntegralPlan, coords, P, hfx: float) -> float:
    """E_2 = 1/2 sum P_ij P_kl (ij|kl) - hfx/4 sum P_ik P_jl (ij|kl) from
    K1's packed matrix at `coords` (fock_from_packed's J and K)."""
    packed = plan.eri_pair_packed(coords)
    J, K = fock_from_packed(plan, packed, P)
    del packed
    return float(0.5 * torch.sum(P * J) - 0.25 * hfx * torch.sum(P * K))


def four_point_difference(energy, R: float, h: float) -> float:
    """dE/dR from energy(R +- h) and energy(R +- 2h): error h^4 E^(5) / 30."""
    return (8.0 * (energy(R + h) - energy(R - h)) - (energy(R + 2 * h) - energy(R - 2 * h))) / (
        12.0 * h)


def check_deriv_against_eri_difference(device, record: dict) -> str:
    """Phase 26 (a), full size: K8b at N2/cc-pV5Z (252 functions, lmax 5) on
    a seeded density-like P against the four-point central difference of
    E_2(R) formed from K1's packed matrix (8.1 GB) at the same P
    (DIFFERENCE_STEP, DIFFERENCE_TOLERANCE); the host's shell quartets and
    schedule, K8b's ms, device ms a call back to back, host ms a call and
    bound."""
    molecule = diatomic("N", 1.1, "CC-PV5Z")
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    start = time.perf_counter()
    components, _ = plan.shell_quartets()
    shell_quartets_s = time.perf_counter() - start
    start = time.perf_counter()
    plan.deriv_schedule()
    schedule_s = time.perf_counter() - start
    N, R = plan.n_basis, molecule.bond_length
    C = np.random.default_rng(26).standard_normal((N, 7)) / np.sqrt(N)
    P = torch.as_tensor(C @ C.T, dtype=torch.float64, device=device)
    hfx = 0.2

    def coords_at(r):
        return torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, r]], dtype=torch.float64, device=device)

    coords = coords_at(R)
    got = float(plan.eri_deriv_energy(coords, P, hfx))
    difference = four_point_difference(lambda r: two_electron_energy(plan, coords_at(r), P, hfx),
                                       R, DIFFERENCE_STEP)
    err = abs(got - difference)
    require(np.isfinite(got), "eri_deriv_energy N2/cc-pV5Z: non-finite tangent")
    require(err <= DIFFERENCE_TOLERANCE,
            f"eri_deriv_energy N2/cc-pV5Z: {got!r} is {err:.3e} from the central difference of "
            f"K1's E_2, {difference!r}")

    def fn():
        return plan.eri_deriv_energy(coords, P, hfx)

    t = plan.tensors(device)
    needed, _ = eri_operations(plan, derivative=True)
    algorithm = deriv_operations(plan)
    eri_bound = bound(eri_input_bytes(plan, coords) + tensor_bytes(P, t["pid_i"], t["pid_j"]) + 8,
                      needed / FP64_PER_MS)
    shape = "N2/CC-PV5Z (252 functions)"
    entry = {"error_against_eri_packed_difference": err, "ms": median_ms(fn, repeats=3),
             "device_ms_a_launch": back_to_back_ms(fn, calls=3, repeats=3,
                                                   sleep_cycles=HIGH_L_SLEEP_CYCLES),
             "host_ms_a_call": host_ms_a_call(fn, calls=10),
             "launches_a_call": deriv_launches(plan), "shell_quartets_host_s": shell_quartets_s,
             "schedule_host_s": schedule_s, "operations_needed": needed,
             "operations_in_kernel": algorithm, **eri_bound}
    record["eri_deriv_energy"].setdefault("high_l", {})[shape] = entry
    return (f"gradient kernels full size {shape}: {len(components)} AO-pair quartets in shell "
            f"quartets built on the host in {shell_quartets_s:.2f} s, the schedule in "
            f"{schedule_s:.2f} s ({deriv_schedule_summary(plan)}); eri_deriv_energy dE_2/dR "
            f"{got!r}, the four-point difference of eri_packed's E_2 (h = {DIFFERENCE_STEP} "
            f"bohr) {difference!r}, {err:.3e} apart; {entry['ms']:.3f} ms (back to back "
            f"{entry['device_ms_a_launch']:.3f}, host {entry['host_ms_a_call']:.3f} ms a call, "
            f"{entry['launches_a_call']} launches; bound {eri_bound['bound_ms']:.4f} ms by "
            f"{eri_bound['bound_by']}; {needed:.4g} operations needed, {algorithm:.4g} in the "
            f"kernel's algorithm)")


@contextlib.contextmanager
def no_plain_versions():
    """Inside the block, any plain version of the integral kernels raises
    (a line on the card must run every kernel it needs)."""
    names = ("_one_electron_plain", "_eri_packed_plain", "_fock_direct_plain",
             "_one_electron_deriv_plain", "_eri_deriv_energy_plain",
             "_eri_deriv_energy_unrestricted_plain")
    originals = {name: getattr(IntegralPlan, name) for name in names}

    def refused(*args, **kwargs):
        raise SmokeFailure("a plain version of an integral kernel ran on the card")

    for name in names:
        setattr(IntegralPlan, name, refused)
    try:
        yield
    finally:
        for name, original in originals.items():
            setattr(IntegralPlan, name, original)


def displaced_line(line: str, bond_bohr: float) -> str:
    """`line` as an EXTREMESCF single point at another bond length."""
    _, atoms, method, keywords = line.split(" : ")
    symbols = " ".join(atoms.split()[:2])
    keywords = " ".join(k for k in keywords.split() if k != "TIGHTSCF") + " EXTREMESCF"
    return f"SPE : {symbols} {bohr_to_angstrom(bond_bohr)!r} : {method} : {keywords.strip()}"


def check_line_26(line: str, kernels: tuple) -> dict:
    """One gradient line of phase 26 on the card, with no plain version of
    an integral kernel allowed: its energy at the input geometry against
    tuna_tpu's (PHASE_26_TOLERANCE, or the line's "energy_tolerance" with
    its EXTREMESCF single point at PHASE_26_TOLERANCE) with equal SCF
    cycles, its analytic gradient against the four-point central
    difference of the card's own EXTREMESCF energies (GRADIENT_TOLERANCE)
    and against tuna_tpu's (GRADIENT_PIN_TOLERANCE).  Prints the
    wall, the gradient's ms, the moving grid's tile and the peak device
    memory; returns the launches, the energy and the gradient."""
    from tuna_tpu_torch.drivers import energy as energy_driver
    from tuna_tpu_torch.drivers import gradients as gradient_driver
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(no_plain_versions())
        counts = stack.enter_context(solve_counts())
        energies = stack.enter_context(Recorder("evaluate_molecular_energy", energy_driver))
        gradients = stack.enter_context(Recorder("calculate_analytic_gradient", gradient_driver))
        _, wall, launches = run_counted(line, kernels)
    peak = torch.cuda.max_memory_allocated()
    require(len(energies.calls) == 1 and len(gradients.calls) == 1,
            f"{line}: {len(energies.calls)} energies and {len(gradients.calls)} gradients")
    _, molecule, energy, _ = energies.calls[0][1]
    gradient = float(gradients.calls[0][1])
    reference = REFERENCES_26[line]
    deltas: dict = {}
    _within("E", float(energy), reference["energy"],
            reference.get("energy_tolerance", PHASE_26_TOLERANCE), deltas)
    require(counts["scf_cycles"] == reference["scf_cycles"],
            f"{line}: SCF cycles {counts['scf_cycles']}, the reference {reference['scf_cycles']}")
    R = molecule.bond_length
    if "extreme_energy" in reference:
        _within("E at EXTREMESCF", float(run(displaced_line(line, R), suppress_output=True,
                                             device="cuda")[2]),
                reference["extreme_energy"], PHASE_26_TOLERANCE, deltas)
    start = time.perf_counter()
    difference = four_point_difference(
        lambda r: float(run(displaced_line(line, r), suppress_output=True, device="cuda")[2]),
        R, DIFFERENCE_STEP)
    difference_s = time.perf_counter() - start
    _within("gradient against the central difference", gradient, difference, GRADIENT_TOLERANCE,
            deltas)
    _within("gradient against tuna_tpu", gradient, reference["gradient"],
            GRADIENT_PIN_TOLERANCE, deltas)
    n = molecule.n_cartesian_basis
    tile = (f"; the moving grid's tile {grid.density_deriv_layout(n, 1)[:2]} (points, P whole)"
            if launches["density_deriv_on_grid"] else "")
    print(f"end to end: {line}; E {energy!r}, dE/dR {gradient!r} Ha/bohr; the central "
          f"difference of EXTREMESCF single points (h = {DIFFERENCE_STEP} bohr, {difference_s:.1f} "
          f"s) {difference!r}; from the references: "
          + ", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items())
          + f"; SCF cycles {counts['scf_cycles']}; {n} Cartesian functions, lmax "
          f"{max(bf.l_total for bf in molecule.cartesian_basis_functions)}{tile}; wall "
          f"{wall:.3f} s, gradient {dict(output.timer_table()).get('Gradient', 0.0):.3f} s; peak "
          f"device memory {peak} bytes; launches "
          f"{({name: k for name, k in launches.items() if k})}")
    return {"launches": launches, "energy": float(energy), "gradient": gradient}


def check_phase_26(record: dict) -> dict:
    """Phase 26 (b): every line of PHASE_26_LINES (check_line_26), then
    LINE_QZ_OPT with its `profile` line: its first energy and gradient
    those of LINE_QZ_FORCE bit for bit, one K8a, K8b launch a geometry
    iteration, its bond length, energy and iterations against tuna_tpu's
    (BOND_TOLERANCE, E_TOLERANCE, equal).  Returns the launches summed over
    the counted runs."""
    from tuna_tpu_torch.drivers import energy as energy_driver
    from tuna_tpu_torch.drivers import gradients as gradient_driver
    start = time.perf_counter()
    runs, outcomes = [], {}
    for line, kernels in PHASE_26_LINES:
        outcomes[line] = check_line_26(line, kernels)
        runs.append(outcomes[line]["launches"])
    reference = REFERENCES_26[LINE_QZ_OPT]
    with contextlib.ExitStack() as stack:
        stack.enter_context(no_plain_versions())
        energies = stack.enter_context(Recorder("evaluate_molecular_energy", energy_driver))
        gradients = stack.enter_context(Recorder("calculate_analytic_gradient", gradient_driver))
        launches = check_optimisation(LINE_QZ_OPT, HF_GRADIENT_PATH_KERNELS,
                                      reference["bond_length"], reference["energy"],
                                      reference["iterations"])
    force = outcomes[LINE_QZ_FORCE]
    steps = [float(g) for _, g in gradients.calls]
    require(float(energies.calls[0][1][2]) == force["energy"] and steps[0] == force["gradient"],
            f"{LINE_QZ_OPT}: its first energy and gradient are not {LINE_QZ_FORCE}'s")
    require(launches["one_electron_deriv"] == launches["eri_deriv_energy"] == len(steps),
            f"{LINE_QZ_OPT}: {launches['one_electron_deriv']} K8a and "
            f"{launches['eri_deriv_energy']} K8b launches for {len(steps)} gradients")
    runs.append(launches)
    print(f"{LINE_QZ_OPT}: gradients {steps}; its first energy and gradient "
          f"{LINE_QZ_FORCE}'s bit for bit")
    profile = profile_gradient_path(LINE_QZ_OPT, ("one_electron_deriv_kernel", "eri_deriv_energy"))
    record["eri_deriv_energy"]["qz_opt_device_ms_a_launch"] = profile[
        "quartet_class_kernels_busy_ms_a_launch"]["eri_deriv_energy"]
    record["one_electron_deriv"]["qz_opt_device_ms_a_launch"] = _device_ms_a_launch(
        profile, "one_electron_deriv_kernel")
    print("profile: " + json.dumps(profile))
    total = {name: sum(r[name] for r in runs) for name in KERNELS}
    print(f"phase 26: {time.perf_counter() - start:.1f} s; launches "
          f"{({name: n for name, n in total.items() if n})}")
    return total


def polish_cost() -> dict:
    """SCF ms an iteration with the polished eigh (ops/linalg.py::eigh, what
    the port runs) and with the library's eigh in its place, on the
    CCSD[T], the DFT and the UKS OPT lines: POLISH_RUNS warm runs a
    variant, in the order library, polished, polished, library; medians
    of the runs' median ms an iteration (the UKS OPT: over all its SCFs)."""
    from tuna_tpu_torch.ops import linalg
    polished = linalg.eigh

    result = {}
    for line in (LINE, LINE_DFT, LINE_UKS_OPT):
        times = {"library": [], "polished": []}
        for variant in ("library", "polished", "polished", "library"):
            linalg.eigh = torch.linalg.eigh if variant == "library" else polished
            try:
                for _ in range(POLISH_RUNS):
                    with scf_seconds() as seconds:
                        run_counted(line, ())
                    times[variant].append(statistics.median(seconds) * 1e3)
            finally:
                linalg.eigh = polished
        result[line] = {variant: statistics.median(v) for variant, v in times.items()}
    return result


@contextlib.contextmanager
def scf_seconds():
    """The seconds of every SCF iteration of the runs inside the block."""
    from tuna_tpu_torch.drivers import energy
    seconds, serial_scf = [], energy.run_self_consistent_field

    def recorded(*args, **kwargs):
        SCF_output = serial_scf(*args, **kwargs)
        seconds.extend(SCF_output.iteration_seconds)
        return SCF_output

    energy.run_self_consistent_field = recorded
    try:
        yield seconds
    finally:
        energy.run_self_consistent_field = serial_scf


# ---------------------------------------------------------------------------
# Phase 27: the correlated, finite-field and UKS batches as two shards
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def two_shards(device):
    """The drivers' view of a machine of two cards, both `device`: their
    gates then hand scans, stencils and field stencils to parallel.py,
    which runs them as two shards on the one card."""
    count, like = parallel.device_count, parallel.devices_like
    parallel.device_count = lambda: 2
    parallel.devices_like = lambda _device: [device, device]
    try:
        yield
    finally:
        parallel.device_count, parallel.devices_like = count, like


@contextlib.contextmanager
def batch_solves():
    """(iterations, electronic energy) of every point of every lockstep SCF
    batch, padding included, and (iterations, correlation energy) of every
    CC solve, of the runs inside the block."""
    solves = {"scf": [], "cc": []}
    lockstep, solve = parallel.run_in_lockstep, cc.solve_amplitudes

    def lockstep_recorded(loops):
        results = lockstep(loops)
        for n_steps, _, E, *_ in results:
            solves["scf"] += [(int(n), float(e)) for n, e in zip(n_steps, E.tolist())]
        return results

    def solve_recorded(*args, **kwargs):
        result = solve(*args, **kwargs)
        solves["cc"].append((int(result[0]), float(result[3])))
        return result

    parallel.run_in_lockstep, cc.solve_amplitudes = lockstep_recorded, solve_recorded
    try:
        yield solves
    finally:
        parallel.run_in_lockstep, cc.solve_amplitudes = lockstep, solve


def matched_solves(name: str, got: list, pinned: list, limit: float, slack: int | None,
                   failures: list) -> float:
    """Each (iterations, energy) of `got` against the pinned pair nearest in
    energy (tuna_tpu's batch reports its solves in its devices' order):
    within `limit`, the iterations within `slack` (None: not held); each
    that is not is added to `failures`.  Returns the largest energy
    distance."""
    if not (got and pinned):
        failures.append(f"{name}: {len(got)} solves, {len(pinned)} pinned")
        return float("inf")
    worst = 0.0
    for n, E in got:
        n_ref, E_ref = min(pinned, key=lambda pair: abs(pair[1] - E))
        if not (abs(E - E_ref) <= limit and (slack is None or abs(n - n_ref) <= slack)):
            failures.append(f"{name}: a solve of {n} iterations at {E!r}; the nearest pinned "
                            f"one {n_ref} at {E_ref!r} (limits {limit:.0e}, {slack} iterations)")
        worst = max(worst, abs(E - E_ref))
    return worst


def check_phase_27_pins(line: str, solves: dict, deltas: dict, failures: list) -> None:
    """The SCF and CC solves of a pinned line's batch against tuna_tpu's."""
    ref = REFERENCES_27[line]
    limit, slack = PHASE_27_SOLVE_LIMITS.get(line, (PHASE_27_TOLERANCE, 0))
    deltas["SCF solves from tuna_tpu's"] = matched_solves(
        f"{line}: SCF", solves["scf"], ref["scf_solves"], limit, slack, failures)
    if ref["cc_solves"]:
        deltas["CC solves from tuna_tpu's"] = matched_solves(
            f"{line}: CC", solves["cc"], ref["cc_solves"], limit, slack, failures)


def serial_line(line: str) -> str:
    """The line a phase 27 batch is held to: the same, at EXTREMESCF where
    the energy has a correlation part (the UKS line's is variational in
    its orbitals, and its UKS SCF is rounding-sensitive at EXTREMESCF)."""
    return line if line == LINE_27_UKS else line.replace("TIGHTSCF", "EXTREMESCF")


def single_points(line: str, bonds: list, kernels: tuple) -> tuple:
    """The single points of a SCAN line at `bonds` (bohr) through run_counted:
    (energies, wall seconds, launches), summed over the points."""
    _, atoms, method, keywords = line.split(":")
    keywords = re.sub(r"\b(NUM|STEP) \S+", "", keywords).split()
    energies, wall, launches = [], 0.0, dict.fromkeys(KERNELS, 0)
    for R in bonds:
        spe = (f"SPE : {' '.join(atoms.split()[:2])} {bohr_to_angstrom(R)!r} :{method}: "
               + " ".join(keywords))
        result, seconds, counts = run_counted(spe, kernels)
        energies.append(float(result[2]))
        wall += seconds
        launches = {name: launches[name] + counts[name] for name in KERNELS}
    return energies, wall, launches


def check_scan_27(line: str, kernels: tuple, launches_a_point: dict, device,
                  card: str) -> dict:
    """A SCAN line through cli.run with two shards on the card against the
    serial walk of serial_line(line) (an EXTRAPOLATE line: its single
    points) within PHASE_27_SERIAL_TOLERANCE a point and, where pinned, against
    tuna_tpu's batch (PHASE_27_TOLERANCE a point, its SCF and CC solves as
    check_phase_27_pins holds them).  Returns the launches of both runs."""
    with two_shards(device), batch_solves() as solves:
        with Recorder(*(("cbs_scan_points_parallel", parallel) if "EXTRAPOLATE" in line
                        else ("scan_points_parallel", parallel))) as batched:
            (bonds, energies, dipoles), wall, launches = run_counted(line, kernels)
    require(len(batched.calls) == 1, f"{line}: {len(batched.calls)} batches")
    n = len(bonds)
    for name, per_point in launches_a_point.items():
        require(launches[name] == per_point * n,
                f"{line}: {launches[name]} {name} launches for {n} points")
    if "EXTRAPOLATE" in line:
        # the serial SCAN walk hands a point's large-basis density to the next
        # point's small-basis SCF and fails at its second point, as tuna_tpu's
        # does (ROADMAP.md queue 3): the batch is held to single points
        serial, serial_wall, serial_launches = single_points(serial_line(line), bonds, kernels)
        serial_bonds = bonds
    else:
        (serial_bonds, serial, _), serial_wall, serial_launches = run_counted(
            serial_line(line), kernels)
    require(np.allclose(serial_bonds, bonds, rtol=0, atol=1e-12) and np.all(np.isfinite(dipoles)),
            f"{line}: the batch took other bond lengths")
    deltas = {"batch minus serial": float(np.max(np.abs(np.subtract(energies, serial))))}
    if line == LINE_27_SCAN_CC:
        # the serial walk at TIGHTSCF beside it, printed and not held: the
        # gap an EXTREMESCF walk closes
        (_, tight, _), tight_wall, tight_launches = run_counted(
            line.replace("EXTREMESCF", "TIGHTSCF"), kernels)
        deltas["batch minus the TIGHTSCF serial walk"] = float(
            np.max(np.abs(np.subtract(energies, tight))))
        print(f"{line}: batch minus the TIGHTSCF serial walk "
              f"{np.subtract(energies, tight).tolist()} Ha, minus the EXTREMESCF walk "
              f"{np.subtract(energies, serial).tolist()} Ha (TIGHTSCF walk {tight_wall:.3f} s)")
        serial_launches = {name: serial_launches[name] + tight_launches[name]
                           for name in KERNELS}
    failures = []
    if not deltas["batch minus serial"] <= PHASE_27_SERIAL_TOLERANCE:
        failures.append(f"{line}: batch minus serial {np.subtract(energies, serial).tolist()} Ha")
    if line in REFERENCES_27:
        ref = REFERENCES_27[line]
        _within("energies from tuna_tpu's batch", energies, ref["energies"],
                PHASE_27_SOLVE_LIMITS.get(line, (PHASE_27_TOLERANCE, 0))[0], deltas, failures)
        check_phase_27_pins(line, solves, deltas, failures)
    print(f"end to end: {line}; two shards on the card, {n} points; "
          + ", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items())
          + f" Ha; the batch's SCF iterations {[n for n, _ in solves['scf']]}, CC iterations "
          f"{[n for n, _ in solves['cc']]}; wall batch {wall:.3f} s, serial {serial_wall:.3f} s "
          f"({card}); launches batch {({k: v for k, v in launches.items() if v})}, serial "
          f"{({k: v for k, v in serial_launches.items() if v})}")
    require(not failures, "\n".join(failures))
    return {name: launches[name] + serial_launches[name] for name in KERNELS}


def check_force_27(device, card: str) -> dict:
    """LINE_27_FORCE through cli.run with two shards: its central
    difference's two displaced energies in one batch (one K2 launch each)
    against those of the serial FORCE of serial_line(LINE_27_FORCE)
    (PHASE_27_SERIAL_TOLERANCE)."""
    from tuna_tpu_torch.drivers import energy, opt
    kernels = CC_PATH_KERNELS
    with two_shards(device), Recorder("stencil_points_parallel", parallel) as batched, \
            Recorder("calculate_gradient", opt) as batch_gradient:
        _, wall, launches = run_counted(LINE_27_FORCE, kernels)
    require(len(batched.calls) == 1 and len(batched.calls[0][1][0]) == 2
            and launches["ccsd_t_energy"] == 3,
            f"{LINE_27_FORCE}: {len(batched.calls)} batches, {launches['ccsd_t_energy']} K2 "
            f"launches (one for the single point, one a displaced point)")
    with Recorder("evaluate_molecular_energy", energy) as serial_energies, \
            Recorder("calculate_gradient", opt) as serial_gradient:
        _, serial_wall, serial_launches = run_counted(serial_line(LINE_27_FORCE), kernels)
    E_backward, E_forward = batched.calls[0][1][0]
    serial_forward, serial_backward = (float(r[2]) for _, r in serial_energies.calls[1:3])
    deltas = np.array([E_backward - serial_backward, E_forward - serial_forward])
    require(np.max(np.abs(deltas)) <= PHASE_27_SERIAL_TOLERANCE,
            f"{LINE_27_FORCE}: displaced energies batch minus serial {deltas.tolist()} Ha")
    print(f"end to end: {LINE_27_FORCE}; two shards on the card: displaced energies batch "
          f"minus serial {deltas.tolist()} Ha; gradient batch "
          f"{float(batch_gradient.calls[0][1])!r}, serial {float(serial_gradient.calls[0][1])!r} "
          f"Ha/bohr; wall batch {wall:.3f} s, serial {serial_wall:.3f} s ({card}); launches "
          f"batch {({k: v for k, v in launches.items() if v})}")
    return {name: launches[name] + serial_launches[name] for name in KERNELS}


def check_field_27(line: str, kernels: tuple, device, serial: dict, card: str) -> dict:
    """A property line through cli.run with two shards: each field batch's
    energies against tuna_tpu's field batch (PHASE_27_TOLERANCE a point),
    its SCF and CC solves as check_phase_27_pins holds them, and the
    properties the driver derives from the batches printed beside tuna_tpu's
    and, where `serial` has them, beside phase 23's serial walk.  With
    VV10: one K6b launch for the whole line, and K6b against its plain
    version on the batch's own densities (VV10_TOLERANCE relative,
    bitwise over two calls).  Returns the launches."""
    from tuna_tpu_torch.drivers import electric
    ref = REFERENCES_27[line]
    names = [name for name in FIELD_STENCILS if hasattr(electric, name)]
    with contextlib.ExitStack() as stack:
        stack.enter_context(two_shards(device))
        solves = stack.enter_context(batch_solves())
        batches = stack.enter_context(Recorder("field_energies_parallel", parallel))
        vv10_calls = stack.enter_context(Recorder("vv10_energies_batch", vv10))
        properties = {name: stack.enter_context(Recorder(name, electric)) for name in names}
        _, wall, launches = run_counted(line, kernels)
    require(len(batches.calls) == len(ref["field_batches"]),
            f"{line}: {len(batches.calls)} field batches, tuna_tpu's {len(ref['field_batches'])}")
    deltas: dict = {}
    failures = []
    for k, ((args, (energies, converged)), pinned) in enumerate(zip(batches.calls,
                                                                   ref["field_batches"])):
        require(bool(converged.all()) and np.allclose(np.asarray(args[3], dtype=float),
                                                      pinned["fields"], rtol=0, atol=1e-15),
                f"{line}: field batch {k} did not converge, or took other fields")
        _within(f"field batch {k} ({len(energies)} points)", energies, pinned["energies"],
                PHASE_27_TOLERANCE, deltas, failures)
    check_phase_27_pins(line, solves, deltas, failures)
    got = {name: rec.calls[0][1] for name, rec in properties.items() if rec.calls}
    if "vv10_energy_batch" in kernels:
        require(launches["vv10_energy_batch"] == 1 and len(vv10_calls.calls) == 1,
                f"{line}: {launches['vv10_energy_batch']} K6b launches for one field batch")
        (P, bfs, grads, w, pts, functional), _ = vv10_calls.calls[0]
        b, C, _ = vv10._parameters(functional)
        active = [vv10._active_points(P_i, bfs, grads, w, pts) for P_i in P]
        kernel, plain, counts = vv10_ragged(active, b, C)
        e_kernel, e_plain = kernel(), plain()
        relative = float(torch.max(torch.abs(e_kernel - e_plain) / torch.abs(e_plain)))
        require(relative <= VV10_TOLERANCE and torch.equal(kernel(), e_kernel),
                f"{line}: K6b on the field batch's densities {relative:.3e} from its plain "
                f"version, or two calls differ")
        deltas["K6b from its plain version (relative)"] = relative
        print(f"K6b: {line}'s field batch, {len(counts)} densities on one grid, {counts} active "
              f"points; relative to the plain version {relative:.3e}, two calls bitwise equal")
    print(f"end to end: {line}; two shards on the card, {len(batches.calls)} field batches of "
          f"{[len(c[1][0]) for c in batches.calls]} points; from tuna_tpu's: "
          + ", ".join(f"{name} {delta:.3e}" for name, delta in deltas.items())
          + f"; properties from the batches {json.dumps({k: np.asarray(v).tolist() for k, v in got.items()})}, "
          f"tuna_tpu's batches {json.dumps({k: ref[k] for k in got if k in ref})}, phase 23's "
          f"serial walk {json.dumps({k: np.asarray(v).tolist() for k, v in serial.items() if k in got})}"
          f" (serial wall {serial.get('wall', float('nan')):.3f} s); SCF iterations "
          f"{[s[0] for s in solves['scf']]}; wall {wall:.3f} s ({card}); launches "
          f"{({k: v for k, v in launches.items() if v})}")
    for name, value in got.items():
        if name in ref:
            step, weight, order = FIELD_STENCILS[name]
            _within(f"{name} from tuna_tpu's batches", value, ref[name],
                    weight * PHASE_27_TOLERANCE / step ** order, deltas, failures)
    require(not failures, "\n".join(failures))
    return launches


def check_phase_27(device, serial_properties: dict, card: str) -> dict:
    """Phase 27: PHASE_27_SCANS (check_scan_27), the field lines
    (check_field_27: LINE_PROPERTIES, which phase 23 ran serially, and
    LINE_27_FIELD_VV10) and LINE_27_FORCE (check_force_27), each as two
    shards on the card.  Returns the launches summed over the counted
    runs."""
    start = time.perf_counter()
    runs = []
    for line, kernels, per_point in PHASE_27_SCANS:
        runs.append(check_scan_27(line, kernels, per_point, device, card))
    runs.append(check_field_27(LINE_PROPERTIES, ("eri_packed", "one_electron"), device,
                               serial_properties, card))
    runs.append(check_field_27(LINE_27_FIELD_VV10, BATCH_PATH_KERNELS, device, {}, card))
    runs.append(check_force_27(device, card))
    launches = {name: sum(r[name] for r in runs) for name in KERNELS}
    print(f"phase 27: {time.perf_counter() - start:.1f} s ({card}); launches "
          f"{({name: n for name, n in launches.items() if n})}")
    return launches


# ---------------------------------------------------------------------------
# --uks-spe-devices, --meta-gga-spe-devices: where a single point's distance
# from tuna_tpu arises
# ---------------------------------------------------------------------------

def spe_devices(line: str = LINE_UKS_SPE, reference: float = E_REF_UKS_SPE) -> dict:
    """`line` on the card and on the host's CPU, with every SCF energy
    (the STO-3G guess SCF's, then the cc-pVTZ SCF's) and every DIIS system
    recorded: each run's distance from tuna_tpu's energy and its SCF
    iteration count, the energies' differences between the two runs, and
    for each DIIS solve the condition number of its bordered matrix (as
    scf._diis_coefficients scales it, on the CPU run's Gram matrix), the
    largest difference of the two runs' Gram matrices relative to the
    largest |entry|, and the largest difference of their coefficients."""
    from tuna_tpu_torch import scf
    energy_fn, coefficients_fn = scf._electronic_energy, scf._diis_coefficients
    runs = {}
    for device in ("cuda", "cpu"):
        energies, systems = [], []

        def recorded_energy(*args, **kwargs):
            E, components = energy_fn(*args, **kwargs)
            energies.append(float(E))
            return E, components

        def recorded_coefficients(B):
            ok, c = coefficients_fn(B)
            systems.append((B.cpu().numpy(), c.cpu().numpy()))
            return ok, c

        scf._electronic_energy, scf._diis_coefficients = recorded_energy, recorded_coefficients
        try:
            start = time.perf_counter()
            SCF_output, _, energy, _ = run(line, suppress_output=True, device=device)
            seconds = time.perf_counter() - start
        finally:
            scf._electronic_energy, scf._diis_coefficients = energy_fn, coefficients_fn
        runs[device] = {"energy": energy, "delta": energy - reference,
                        "scf_iterations": len(SCF_output.iteration_seconds),
                        "seconds": seconds, "energies": energies, "systems": systems}
    card, host = runs["cuda"], runs["cpu"]
    diis = []
    for (B_card, c_card), (B_host, c_host) in zip(card["systems"], host["systems"]):
        n = B_host.shape[0]
        A = -np.ones((n + 1, n + 1))
        A[:n, :n] = B_host / max(np.max(np.abs(B_host)), 1e-30)
        A[n, n] = 0.0
        diis.append({"n": n, "condition": float(np.linalg.cond(A)),
                     "gram_relative_difference": float(np.max(np.abs(B_card - B_host))
                                                       / np.max(np.abs(B_host))),
                     "coefficient_difference": float(np.max(np.abs(c_card - c_host)))})
    return {"line": line, "reference": reference,
            **{f"{name}_{key}": runs[device][key] for name, device in (("card", "cuda"),
                                                                       ("cpu", "cpu"))
               for key in ("energy", "delta", "scf_iterations", "seconds")},
            "energy_differences": [a - b for a, b in zip(card["energies"], host["energies"])],
            "diis": diis}


def uks_td_devices() -> dict:
    """LINE_UKS_TD's SCF on the card and on the host's CPU (spe_devices, the
    reference tuna_tpu's SCF energy: its total energy less the first
    excitation), and the whole line on the card with K7b's plain version in
    the kernel's place: its distance from tuna_tpu and its SCF cycles."""
    import tuna_tpu_torch.dft as dft
    ref = REFERENCES_24[LINE_UKS_TD]
    devices = spe_devices(LINE_UKS_TD.replace(" TD", ""),
                          ref["energy"] - ref["excitation_energies"][0])
    kernel = grid.density_on_grid

    def plain(P, bfs, grads=None, with_tau=False):
        return grid._density_on_grid_plain(P, bfs, grads, with_tau)

    grid.density_on_grid = dft.density_on_grid = plain
    try:
        with solve_counts() as counts:
            result, _, launches = run_counted(LINE_UKS_TD, ())
    finally:
        grid.density_on_grid = dft.density_on_grid = kernel
    require(launches["density_on_grid"] == 0, "K7b launched in its plain version's run")
    devices["k7b_plain_witness"] = {"delta": float(result[2]) - ref["energy"],
                                    "scf_cycles": counts["scf_cycles"]}
    return devices


# ---------------------------------------------------------------------------
# --compare: the coupled-cluster path's warm walls from another checkout
# ---------------------------------------------------------------------------

# Run in a fresh interpreter per package root; it needs nothing of the root
# but tuna_tpu_torch.cli.run, Output.{,correlation_}iteration_seconds,
# IntegralPlan.eri_pair_packed and .fock_direct, post.cc.ccsd_t_energy,
# dft.vv10.vv10_energy, ops.motransform.pair_packed_to_mo and
# .half_transform, dft.grid's ao_on_grid, density_on_grid (with and without
# gradients and tau) and density_deriv_on_grid(_spin) with and without tau,
# IntegralPlan.one_electron and .one_electron_deriv, and
# post.cc.ccsdt_q_energy and .uccsd_t_energy, which every checkout with the
# meta-GGAs has.
_WALLS = """
import hashlib, json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import tuna_tpu_torch
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.dft import grid, vv10
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.ops import motransform
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


def host_ms(fn, calls=200):   # host ms a call: enqueue only, the device left behind
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return 1e3 * elapsed / calls


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
points_vv10 = [gpu(density), gpu(rng.uniform(0.0, 0.05, M)),
               gpu(density ** (8 / 3) * rng.uniform(0.0, 4.0, M)),
               gpu(rng.uniform(-8.0, 8.0, (M, 3)))]
# K5's two phases at N2/cc-pVTZ on the packed ERI matrix with a seeded W,
# beside torch.matmul on the rows expanded to dense (N, N) before the timing
U = gpu(mol.spherical_transformation)
n_mo = U.shape[0]
W = (U.T @ gpu(np.random.default_rng(17).standard_normal((n_mo, n_mo)) / np.sqrt(n_mo)))
W = W.contiguous()
G_pair, pair_index = plan.eri_pair_packed(coords), plan.tensors(coords.device)["pair_index"]
transform = lambda: motransform.pair_packed_to_mo(G_pair, pair_index, W, n_mo)
H = motransform.half_transform(G_pair, pair_index, W)
expanded = (G_pair[:, pair_index], H.T.contiguous()[:, pair_index])
del H
matmul = lambda: [torch.matmul(W.T, torch.matmul(dense, W)) for dense in expanded]
transform_ms, transform_sum, matmul_ms = median_ms(transform), float(transform().sum()), \
    median_ms(matmul)
del expanded
# K7bt on the N2/cc-pVTZ medium grid with a seeded density-like P
dft = Config("SPE", lookup_method("B3LYP"), 0.0, [], "CC-PVTZ", ["N", "N"],
             suppress_output=True)
dft_mol = Molecule(["N", "N"], mol.coordinates, dft)
points, _ = grid.build_molecular_grid(*grid.grid_parameters(dft_mol, dft), dft_mol.bond_length,
                                      dft_mol.atoms)
points = gpu(points.reshape(3, -1))
values, grads = grid.ao_on_grid(grid.GridBasis(dft_mol.cartesian_basis_functions), points, True)
bfs, bf_grads = (U @ values).contiguous(), torch.matmul(U, grads).contiguous()
del values, grads
C = np.random.default_rng(14).standard_normal((n_mo, 7)) / np.sqrt(n_mo)
P_tau = gpu(C @ C.T)
tau_call = lambda: grid.density_on_grid(P_tau, bfs, bf_grads, with_tau=True)
# K7b on the same grid and P, with and without gradients
rho_call = lambda: grid.density_on_grid(P_tau, bfs, bf_grads)
rho_only_call = lambda: grid.density_on_grid(P_tau, bfs)
# K3 and K8a (atom 1 moving) at N2/6-311G and N2/cc-pVTZ
one_electron = {}
for tag, basis_1e in (("6_311g", "6-311G"), ("cc_pvtz", "CC-PVTZ")):
    cfg_1e = Config("SPE", lookup_method("HF"), 0.0, [], basis_1e, ["N", "N"],
                    suppress_output=True)
    mol_1e = Molecule(["N", "N"], mol.coordinates, cfg_1e)
    plan_1e = IntegralPlan(mol_1e.cartesian_basis_functions, mol_1e.n_atoms)
    fraction_1e = float(mol_1e.masses[1] / mol_1e.masses.sum())
    for name, fn, args_1e in (
            ("one_electron", plan_1e.one_electron,
             (gpu(mol_1e.coordinates), gpu(mol_1e.charges), mol_1e.centre_of_mass)),
            ("one_electron_deriv", plan_1e.one_electron_deriv,
             (gpu(mol_1e.coordinates), gpu(mol_1e.charges),
              fraction_1e * mol_1e.bond_length, fraction_1e))):
        one_electron[f"{name}_{tag}_ms"] = median_ms(lambda: fn(*args_1e))
        one_electron[f"{name}_{tag}_host_ms"] = host_ms(lambda: fn(*args_1e))
        one_electron[f"{name}_{tag}_sums"] = [float(x.sum()) for x in fn(*args_1e)]
# K8ct and K8c on N2/cc-pVTZ's medium grid, K8cut and K8cu on O2's (atom
# 1's half of the points moving), seeded density-like P
tau_deriv = {}
for symbol, bond, spins, seed in (("N", 1.1, 1, 15), ("O", 1.21, 2, 16)):
    tpss = Config("SPE", lookup_method("TPSS"), 0.0, [], "CC-PVTZ", [symbol, symbol],
                  suppress_output=True)
    tpss_mol = Molecule([symbol, symbol], np.array([[0.0, 0.0, 0.0],
                                                    [0.0, 0.0, angstrom_to_bohr(bond)]]), tpss)
    deriv_points, _ = grid.build_molecular_grid(*grid.grid_parameters(tpss_mol, tpss),
                                                tpss_mol.bond_length, tpss_mol.atoms)
    deriv_points = gpu(deriv_points.reshape(3, -1))
    deriv_basis = grid.GridBasis(tpss_mol.cartesian_basis_functions)
    deriv_moves = torch.as_tensor([bf.atom_index == 1 for bf in tpss_mol.cartesian_basis_functions],
                                  dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(seed)
    Cs = [rng.standard_normal((deriv_basis.n_ao, 8)) / np.sqrt(deriv_basis.n_ao)
          for _ in range(spins)]
    P_deriv = gpu(np.stack([C @ C.T for C in Cs]) if spins == 2 else Cs[0] @ Cs[0].T)
    deriv_fn = grid.density_deriv_on_grid_spin if spins == 2 else grid.density_deriv_on_grid
    name = f"density_tau_deriv_on_grid{'_spin' if spins == 2 else ''}_{symbol.lower()}2_cc_pvtz"
    deriv_call = lambda: deriv_fn(deriv_basis, gpu(deriv_basis.origin), deriv_moves, deriv_points,
                                  deriv_points.shape[1] // 2, P_deriv, True, with_tau=True)
    tau_deriv[name + "_ms"] = median_ms(deriv_call)
    tau_deriv[name + "_points"] = deriv_points.shape[1]
    tau_deriv[name + "_sums"] = [float(x.sum()) for x in deriv_call()]
    name = f"density_deriv_on_grid{'_spin' if spins == 2 else ''}_{symbol.lower()}2_cc_pvtz"
    deriv_call = lambda: deriv_fn(deriv_basis, gpu(deriv_basis.origin), deriv_moves, deriv_points,
                                  deriv_points.shape[1] // 2, P_deriv, True)
    tau_deriv[name + "_ms"] = median_ms(deriv_call)
    tau_deriv[name + "_sums"] = [float(x.sum()) for x in deriv_call()]
# K9 at the (Q) path's (7, 19) and cc-pVTZ's (7, 53), K2u at the UHF
# lines A (16, 36) and C (16, 104), seeded, through the public wrappers
def quadruples_inputs(no, nv, seed):
    rng = np.random.default_rng(seed)
    n = no + nv
    c = rng.standard_normal((n, n, n, n))
    c = c + c.transpose(1, 0, 2, 3)
    c = c + c.transpose(0, 1, 3, 2)
    t2 = rng.standard_normal((no, no, nv, nv))
    return [gpu(0.05 * (c + c.transpose(2, 3, 0, 1))), gpu(0.05 * (t2 + t2.transpose(1, 0, 3, 2))),
            gpu(0.01 * rng.standard_normal((no, no, no, nv, nv, nv))),
            gpu(np.sort(rng.uniform(-15.0, -0.5, no))), gpu(np.sort(rng.uniform(0.3, 5.0, nv)))]


def u_triples_inputs(no, nv, seed):
    rng = np.random.default_rng(seed)

    def pairs(x):
        x = x - x.swapaxes(0, 1) if x.shape[0] == x.shape[1] else x
        return x - x.swapaxes(2, 3)

    return [gpu(0.1 * pairs(rng.standard_normal((no, no, nv, nv)))),
            gpu(0.1 * pairs(rng.standard_normal((nv, no, nv, nv)))),
            gpu(0.1 * pairs(rng.standard_normal((no, nv, no, no)))),
            gpu(0.01 * rng.standard_normal((no, nv))),
            gpu(0.05 * pairs(rng.standard_normal((no, no, nv, nv)))),
            gpu(np.sort(rng.uniform(-15.0, -0.5, no))), gpu(np.sort(rng.uniform(0.3, 5.0, nv)))]


def median_of(fn, repeats):   # CUDA events, median of `repeats` after a warm-up
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def union_ms_a_call(fn, once, calls=50):   # torch.profiler: a call's kernels' union
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, -float("inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy, end = busy + max(0.0, e - max(s, end)), max(end, e)
    recorded = sum(once in e.name for e in events)   # calls recorded: the kernel run once a call
    return busy / 1e3 / recorded if recorded else None


def diatomic_plan(symbols, bond, basis):
    config = Config("SPE", lookup_method("HF"), 0.0, [], basis, list(symbols),
                    suppress_output=True)
    molecule = Molecule(list(symbols), np.array([[0.0, 0.0, 0.0],
                                                 [0.0, 0.0, angstrom_to_bohr(bond)]]), config)
    return (IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms),
            torch.as_tensor(molecule.coordinates, dtype=torch.float64, device="cuda"))


# K8b and K8bu alone on seeded density-like matrices (chip_smoke's phases 9
# and 18): device ms a launch (the union of a call's kernels over the calls
# that the profiler recorded, counted by the rows kernel, which both
# checkouts launch once a call), CUDA-event ms and host ms a call, and the
# value; K1's packed ERI at N2/6-311G and cc-pVTZ as a SHA-256 of its bytes
kernels = {}
for symbols, bond, basis in ((("N", "N"), 1.1, "CC-PVTZ"), (("C", "O"), 1.13, "6-31G"),
                             (("O", "O"), 1.21, "CC-PVTZ")):
    deriv_plan, deriv_coords = diatomic_plan(symbols, bond, basis)
    n = deriv_plan.n_basis
    key = f"{''.join(symbols).lower()}_{basis.lower().replace('-', '_')}"
    C = np.random.default_rng(13).standard_normal((n, 7)) / np.sqrt(n)
    P_deriv = gpu(C @ C.T)
    restricted = lambda: deriv_plan.eri_deriv_energy(deriv_coords, P_deriv, 0.2)
    kernels[f"eri_deriv_energy_{key}"] = float(restricted())
    kernels[f"eri_deriv_energy_{key}_device_ms_a_launch"] = union_ms_a_call(
        restricted, "deriv_rows_kernel")
    kernels[f"eri_deriv_energy_{key}_ms"] = median_ms(restricted)
    kernels[f"eri_deriv_energy_{key}_host_ms"] = host_ms(restricted)
    if symbols == ("O", "O"):
        rng = np.random.default_rng(14)
        C_a, C_b = (rng.standard_normal((n, k)) / np.sqrt(n) for k in (8, 7))
        P_a, P_b = gpu(C_a @ C_a.T), gpu(C_b @ C_b.T)
        spins = lambda: deriv_plan.eri_deriv_energy_unrestricted(deriv_coords, P_a, P_b, 0.2)
        kernels[f"eri_deriv_energy_unrestricted_{key}"] = float(spins())
        kernels[f"eri_deriv_energy_unrestricted_{key}_device_ms_a_launch"] = union_ms_a_call(
            spins, "deriv_rows_kernel")
        kernels[f"eri_deriv_energy_unrestricted_{key}_ms"] = median_ms(spins)
        kernels[f"eri_deriv_energy_unrestricted_{key}_host_ms"] = host_ms(spins)
for basis in ("6-311G", "CC-PVTZ"):
    eri_plan, eri_coords = diatomic_plan(("N", "N"), 1.1, basis)
    kernels[f"eri_packed_n2_{basis.lower().replace('-', '_')}_sha256"] = hashlib.sha256(
        eri_plan.eri_pair_packed(eri_coords).cpu().numpy().tobytes()).hexdigest()
del deriv_plan, eri_plan
for no, nv, repeats in ((7, 19, 10), (7, 53, 3)):
    q_args = quadruples_inputs(no, nv, 23)
    kernels[f"ccsdt_q_energy_o{no}_v{nv}_ms"] = median_of(lambda: cc.ccsdt_q_energy(*q_args),
                                                          repeats)
    kernels[f"ccsdt_q_energy_o{no}_v{nv}"] = cc.ccsdt_q_energy(*q_args).tolist()
    del q_args
for line, no, nv in (("A", 16, 36), ("C", 16, 104)):
    u_args = u_triples_inputs(no, nv, 17)
    kernels[f"uccsd_t_energy_{line}_o{no}_v{nv}_ms"] = median_of(
        lambda: cc.uccsd_t_energy(*u_args), 10)
    kernels[f"uccsd_t_energy_{line}_o{no}_v{nv}"] = float(cc.uccsd_t_energy(*u_args))
    del u_args
print(json.dumps({"root": sys.argv[1], "package": tuna_tpu_torch.__file__, **kernels,
                  "paths": paths,
                  "eri_packed_cc_pvtz_ms": median_ms(lambda: plan.eri_pair_packed(coords)),
                  "fock_direct_cc_pvtz_ms": median_ms(lambda: plan.fock_direct(coords, P)),
                  "ccsd_t_energy_o7_v53_ms": median_ms(lambda: cc.ccsd_t_energy(*triples)),
                  "ccsd_t_energy_o7_v53": float(cc.ccsd_t_energy(*triples)),
                  "vv10_energy_m51320_ms": median_ms(lambda: vv10.vv10_energy(*points_vv10, 6.0,
                                                                             0.01)),
                  "vv10_energy_m51320": float(vv10.vv10_energy(*points_vv10, 6.0, 0.01)),
                  "mo_half_transform_cc_pvtz_ms": transform_ms,
                  "mo_half_transform_cc_pvtz_sum": transform_sum,
                  "mo_half_transform_cc_pvtz_matmul_ms": matmul_ms,
                  "density_tau_on_grid_cc_pvtz_ms": median_ms(tau_call),
                  "density_tau_on_grid_cc_pvtz_points": points.shape[1],
                  "density_tau_on_grid_cc_pvtz_sums": [float(x.sum()) for x in tau_call()],
                  "density_on_grid_cc_pvtz_ms": median_ms(rho_call),
                  "density_on_grid_cc_pvtz_host_ms": host_ms(rho_call),
                  "density_tau_on_grid_cc_pvtz_host_ms": host_ms(tau_call),
                  "density_on_grid_cc_pvtz_sums": [float(x.sum()) for x in rho_call()],
                  "density_on_grid_rho_only_cc_pvtz_ms": median_ms(rho_only_call),
                  "density_on_grid_rho_only_cc_pvtz_sum": float(rho_only_call()[0].sum()),
                  **one_electron, **tau_deriv}))
"""


def compare(roots, with_paths: bool = True) -> int:
    lines = (LINE, LINE_DFT, LINE_DIRECT, LINE_Q, LINE_UHF_TZ) if with_paths else ()
    for root in roots:
        result = subprocess.run([sys.executable, "-c", _WALLS, str(pathlib.Path(root).resolve()),
                                 str(WARM_RUNS), *lines], cwd=root, capture_output=True,
                                text=True, timeout=900)
        if result.returncode != 0:
            print(result.stderr[-4000:], file=sys.stderr)
            return result.returncode
        print("compare: " + result.stdout.strip().splitlines()[-1])
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compare", nargs="+", metavar="ROOT")
    parser.add_argument("--kernels-only", action="store_true",
                        help="with --compare: the kernels alone, not the paths' walls")
    parser.add_argument("--uks-spe-devices", action="store_true")
    parser.add_argument("--meta-gga-spe-devices", action="store_true")
    parser.add_argument("--uks-td-devices", action="store_true")
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
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    if args.compare:
        return compare(args.compare, with_paths=not args.kernels_only)
    if args.uks_spe_devices:
        _kernels.build()
        print("uks_spe_devices: " + json.dumps(spe_devices()))
        return 0
    if args.uks_td_devices:
        _kernels.build()
        print("uks_td_devices: " + json.dumps(uks_td_devices()))
        return 0
    if args.meta_gga_spe_devices:
        _kernels.build()
        for line, reference in ((LINE_MGGA, E_REF_MGGA), (LINE_B97MV, E_REF_B97MV),
                                (LINE_UMGGA, E_REF_UMGGA)):
            print("spe_devices: " + json.dumps(spe_devices(line, reference)))
        return 0
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
    frames: dict = {}
    registers = ptxas_report(library.with_suffix(".log").read_text(), frames)
    print(f"build: {library.name} in {time.perf_counter() - start:.1f} s; {len(registers)} "
          f"kernels; {high_l_build_summary(registers)}; registers (ptxas): "
          f"{json.dumps(registers)}")

    # --- 3. K1-K3 against their plain versions -------------------------------
    record: dict = {}
    for basis in ("6-311G", "STO-3G", "6-31G**", "CC-PVTZ"):
        print(check_integrals(basis, device, record, registers, frames))
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
    profile = profile_path(LINE, needs=("one_electron_kernel",))
    record["one_electron"]["cc_path_device_ms_a_launch"] = _device_ms_a_launch(
        profile, "one_electron_kernel")
    print("profile: " + json.dumps(profile))

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
    profile = profile_path(LINE_DFT, needs=("density_on_grid_kernel[1]",))
    print("profile: " + json.dumps(profile))

    # --- 6. DFT kernels against their plain versions --------------------------
    print(check_dft_kernels(molecule, P, device, record, registers))
    record["density_on_grid"]["dft_path_device_ms_a_launch"] = _device_ms_a_launch(
        profile, "density_on_grid_kernel[1]")
    U = torch.as_tensor(molecule.spherical_transformation, dtype=torch.float64, device=device)
    print(check_moving_grid(molecule, (U.T @ P @ U)[None], device, record, registers))

    # --- 7. DIRECT kernels against their plain versions -----------------------
    for basis in ("CC-PVTZ", "6-311G"):
        print(check_fock_direct(basis, device, record))
    print(check_mo_transform(device, record, registers))
    print(check_triples(7, 53, device, record))   # K2 at the DIRECT path's shape

    # --- 8. DIRECT path ---------------------------------------------------------
    launches = check_direct_path()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 9. gradient kernels against their plain versions ---------------------
    for symbol, partner, bond_angstrom, basis in (("N", None, 1.1, "CC-PVTZ"),
                                                  ("C", "O", 1.13, "6-31G")):
        print(check_gradient_integrals(symbol, partner, bond_angstrom, basis, device, record,
                                       registers, frames))

    # --- 10 and 11. gradient paths, BASELINE configs 3 and 5 --------------------
    launches = check_gradient_paths(record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 12. the spin-orbital (T) kernel against its plain version -----------
    for no, nv, v_scale in ((16, 36, 1.0), (16, 36, 2.0), (9, 79, 1.0), (16, 104, 1.0)):
        print(check_u_triples(no, nv, device, record, registers, v_scale))

    # --- 13. UHF paths ---------------------------------------------------------
    launches = check_uhf_paths(record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 14. the (Q) kernel against its plain version --------------------------
    for no, nv in ((7, 19), (7, 53)):
        print(check_quadruples(no, nv, device, record, registers))

    # --- 15. the (Q) path and the iterative triples lines -----------------------
    launches = check_quadruples_path(record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 16. K6b against its plain version at the scan's densities -------------
    extreme_batch = check_vv10_batch(device, record, registers)

    # --- 17. the batched scan against the serial SCAN ---------------------------
    launches = check_batched_scan(device, extreme_batch)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 18. K8bu and K8cu against their plain versions -------------------------
    print(check_unrestricted_gradient_kernels(device, record, registers, frames))

    # --- 19. the unrestricted gradient paths --------------------------------------
    launches = check_unrestricted_gradient_paths(record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 20. K7bt, K8ct and K8cut against their plain versions -----------------
    print(check_meta_gga_kernels(device, record, registers))

    # --- 21. the meta-GGA paths ------------------------------------------------------
    launches = check_meta_gga_paths(device, record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}
    print("polish: " + json.dumps(polish_cost()))

    # --- 22. perturbation theory and double hybrids -----------------------------------
    launches = check_perturbation_paths()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 23. the rest of restricted CC/CI and the last calculation types --------------
    serial_properties: dict = {}
    launches = check_phase_23(serial_properties)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 24. excited states and SCF stability -------------------------------------------
    launches = check_phase_24()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 25. g and h shells: K1, K4 and K3 at lmax 4-5, and the lines they open -----------
    print(check_high_l_kernels(device, record))
    print(check_fock_against_eri_full(device, record))
    launches = check_phase_25()
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 26. g and h shells: K8a, K8b and K8bu at lmax 4-5, and the gradient lines -------
    print(check_high_l_gradient_kernels(device, record, registers, frames))
    print(check_deriv_against_eri_difference(device, record))
    launches = check_phase_26(record)
    path_launches = {name: path_launches[name] + launches[name] for name in KERNELS}

    # --- 27. the correlated, finite-field and UKS batches as two shards on the card -------
    launches = check_phase_27(device, serial_properties, card)
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

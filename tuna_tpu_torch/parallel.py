"""The mean-field SCF of a batch of geometries in lockstep: scans and
finite-difference stencils.

Twin of the mean-field part of tuna_tpu/parallel.py.  tuna_tpu vmaps its
jitted SCF while_loop over a stack of bond lengths and shards the batch
axis over a device mesh; here the batch is padded to a multiple of the
number of devices (repeating the last geometry), cut into contiguous
shards, one a device, each advanced by scf.scf_batch_iterations (one
batched op for all of its geometries where tuna_tpu's loop body has one),
all shards in one lockstep host loop, and trimmed afterwards.  The
post-SCF VV10 term of a DFT batch comes from dft.vv10.vv10_energies_batch:
one launch of kernel K6b a shard.  The drivers take this path only when
more than one device is visible (device_count), as tuna_tpu does.

Not ported yet: the correlated batches (MP2, CC, their unrestricted forms,
double hybrids, CBS), the finite-field batch and the tensor-parallel Fock
build.
"""

from __future__ import annotations

import numpy as np
import torch

from .dft import make_xc_closure, unported_functional
from .dft import grid as dft_grid
from .dft import vv10
from .drivers import common
from .output import error
from .periodic import make_atom
from .scf import run_in_lockstep, scf_batch_iterations, scf_settings
from .system import Molecule


def device_count() -> int:
    """The number of visible CUDA devices (tuna_tpu: jax.device_count())."""
    return torch.cuda.device_count()


def device_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first n_devices visible CUDA devices, all of them by default;
    raises when there are fewer (there is no CPU fallback)."""
    available = device_count()
    n = available if n_devices is None else n_devices
    if available == 0 or n > available:
        error(f"{n or 1} CUDA device(s) requested, {available} visible: the batched SCF "
              "of tuna_tpu_torch runs on GPUs, or on CPU devices a caller passes.")
    return [torch.device("cuda", i) for i in range(n)]


def devices_like(device) -> list[torch.device]:
    """The devices a driver running on `device` batches over: every visible
    CUDA device, or, for a CPU run, `device` once per device_count()."""
    device = torch.device(device)
    if device.type == "cuda":
        return device_mesh()
    return [device] * device_count()


def _needs_vv10(calculation):
    """The post-SCF VV10 term applies with the NL keyword or the B97M-V
    functional."""
    return (getattr(calculation, "VV10", False)
            or calculation.method.name == "B97M-V")


def _restricted_reference(calculation, atomic_symbols):
    """The reference is decided only when a Molecule is processed
    (system.py), so replicate that decision from the multiplicity,
    electron parity and method flags."""
    n_electrons = (sum(make_atom(s.upper(), (0.0, 0.0, 0.0)).charge
                       for s in atomic_symbols)
                   - calculation.charge)
    multiplicity = calculation.multiplicity
    if calculation.default_multiplicity and n_electrons % 2 != 0:
        multiplicity = 2
    return (multiplicity == 1 and not calculation.method.unrestricted
            and calculation.method.restricted_available)


def mean_field_batchable(calculation, atomic_symbols, *, fields_free=True):
    """True when a calculation's SCF solves can ride the batch:
    Hartree-Fock (RHF or UHF) or restricted Kohn-Sham with a functional
    the port has, stored integrals, no CBS extrapolation, no checkpoint,
    no double hybrid (its MP2 stage is not in the batch) and, with
    fields_free, no applied field.  Unrestricted Kohn-Sham walks serially
    (the batch's XC call is restricted); what the serial path refuses is
    left to it, and it raises."""
    plain_hf = calculation.method.name in ("HF", "UHF")
    batchable_dft = (calculation.DFT_calculation
                     and not getattr(calculation, "MPC_prop", 0)
                     and _restricted_reference(calculation, atomic_symbols)
                     and unported_functional(calculation) is None)
    ok = ((plain_hf or batchable_dft)
          and not getattr(calculation, "extrapolate", False)
          and not getattr(calculation, "direct_scf", False)
          and not getattr(calculation, "checkpoint", False)
          and not getattr(calculation, "read_checkpoint", False)
          # the serial path adds VV10 to Hartree-Fock too; tuna_tpu's batch does not
          and (calculation.DFT_calculation or not _needs_vv10(calculation)))
    if fields_free:
        ok = (ok and not np.any(calculation.electric_field)
              and not np.any(calculation.electric_field_gradient))
    return ok


def _batched_inputs(calculation, atomic_symbols, bond_lengths, device):
    """Per-geometry integrals, orthogonalisers and core guesses, stacked on
    `device`, XC closures for DFT, and per-geometry metadata: coordinates,
    integrals, D2 dispersion and, for DFT, the quadrature grid.  "E_add" is
    the classical additive term (nuclear repulsion + D2 dispersion) the
    SCF electronic energy lacks."""
    mats = {"T": [], "V": [], "ERI": [], "S": [], "X": [], "Pa": [], "Pb": [], "E_add": []}
    xc_closures, meta = [], []
    molecule = None
    for R in bond_lengths:
        coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, float(R)]])
        molecule = Molecule(list(atomic_symbols), coords, calculation)
        integrals = common.calculate_analytical_integrals(molecule, calculation, True, device)
        molecule.process_basis_functions(calculation, int(integrals.n_basis))
        X, _, _ = common.calculate_orthogonalisation_matrix(integrals.S, calculation, True)

        H = integrals.T + integrals.V_NE
        _, C0 = torch.linalg.eigh(X.T @ H @ X)
        C0 = X @ C0
        P_a = C0[:, :molecule.n_alpha] @ C0[:, :molecule.n_alpha].T
        P_b = C0[:, :molecule.n_beta] @ C0[:, :molecule.n_beta].T
        for key, value in (("T", integrals.T), ("V", integrals.V_NE), ("ERI", integrals.ERI_AO),
                           ("S", integrals.S), ("X", X), ("Pa", P_a), ("Pb", P_b)):
            mats[key].append(value)
        V_NN = float(np.prod([float(c) for c in molecule.charges])) / float(R)
        E_disp = common.calculate_additive_dispersion_energy(molecule, calculation, True)
        mats["E_add"].append(V_NN + float(E_disp))
        meta.append({"coordinates": coords, "centre_of_mass": molecule.centre_of_mass,
                     "charges": molecule.charges, "integrals": integrals,
                     "E_disp": float(E_disp)})
        if calculation.DFT_calculation:
            meta[-1]["grid"] = dft_grid.set_up_integration_grid(molecule, P_a, P_b,
                                                                calculation, True, device)
            xc_closures.append(make_xc_closure(calculation, meta[-1]["grid"]))
    stacked = {key: torch.stack(values) for key, values in mats.items() if key != "E_add"}
    stacked["E_add"] = np.array(mats["E_add"])
    # each geometry's ERI becomes a view of the stack: one copy of the N^4 tensors
    for i, m in enumerate(meta):
        m["integrals"].ERI_AO = stacked["ERI"][i]
    return molecule, stacked, xc_closures or None, meta


def _solve_points(calculation, atomic_symbols, bond_lengths, devices=None):
    """The batched SCF of a list of bond lengths over `devices` (a list of
    torch devices; device_mesh() by default): total energies (numpy),
    convergence flags (numpy), total densities (a tensor each, on its
    shard's device) and per-point metadata (see _batched_inputs), with
    the SCF iterations each point took as meta[i]["scf_iterations"]."""
    devices = device_mesh() if devices is None else list(devices)
    n_points = len(bond_lengths)
    n_dev = len(devices)
    n_padded = -(-n_points // n_dev) * n_dev
    padded = list(bond_lengths) + [bond_lengths[-1]] * (n_padded - n_points)
    per_shard = n_padded // n_dev
    conv = calculation.SCF_conv
    static_damping = calculation.damping_factor or 0.0

    shards, loops = [], []
    for k, device in enumerate(devices):
        bonds = padded[k * per_shard:(k + 1) * per_shard]
        molecule, batch, xc_closures, meta = _batched_inputs(
            calculation, atomic_symbols, bonds, torch.device(device))
        shards.append((batch, meta))
        loops.append(scf_batch_iterations(
            scf_settings(calculation, molecule), batch["T"], batch["V"], batch["ERI"],
            batch["S"], batch["X"], batch["Pa"], batch["Pb"], calculation.HFX_prop, conv,
            static_damping, calculation.max_damping, xc_closures, calculation.DFX_prop,
            calculation.DFC_prop))

    energies, converged, P, meta_all = [], [], [], []
    for k, ((batch, meta), result) in enumerate(zip(shards, run_in_lockstep(loops))):
        n_steps, shard_converged, E, P_a, P_b, _ = result
        n_keep = min(per_shard, n_points - k * per_shard)   # trim the padding
        if n_keep <= 0:
            break
        shard_E = E[:n_keep].cpu().numpy() + batch["E_add"][:n_keep]
        shard_P = list((P_a + P_b)[:n_keep])
        if calculation.DFT_calculation and _needs_vv10(calculation):
            # post-SCF non-local dispersion per point (serial counterpart:
            # drivers/energy.py calculate_VV10_energy)
            bfs, w, grads, pts = zip(*(m["grid"] for m in meta[:n_keep]))
            shard_E = shard_E + vv10.vv10_energies_batch(
                shard_P, bfs, grads, w, pts, calculation.functional).cpu().numpy()
        for i in range(n_keep):
            meta[i]["scf_iterations"] = int(n_steps[i])
        energies.append(shard_E)
        converged.append(shard_converged[:n_keep])
        P.extend(shard_P)
        meta_all.extend(meta[:n_keep])
    return np.concatenate(energies), np.concatenate(converged), P, meta_all


def _solve_points_components(calculation, atomic_symbols, bond_lengths, devices=None):
    """(E_scf_total, E_corr, E_disp, converged, P, meta) per point, E_scf_total
    = electronic + V_NN + dispersion; E_corr is zero, the batch being
    mean-field only so far."""
    energies, converged, P, meta = _solve_points(calculation, atomic_symbols, bond_lengths,
                                                 devices)
    E_disp = np.array([m["E_disp"] for m in meta])
    return energies, np.zeros(len(meta)), E_disp, converged, P, meta


def _solve_points_correlated(calculation, atomic_symbols, bond_lengths, devices=None):
    """(total energies, converged, P_SCF, meta) per point."""
    energies, E_corr, _, converged, P, meta = _solve_points_components(
        calculation, atomic_symbols, bond_lengths, devices)
    return energies + E_corr, converged, P, meta


def scan_points_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """Converged energies, convergence flags and analytic dipole moments of
    a batch of bond lengths: the fast path of the SCAN driver
    (drivers/energy.scan_coordinate) when more than one device is
    visible."""
    from . import props
    energies, converged, P, meta = _solve_points_correlated(
        calculation, atomic_symbols, bond_lengths, devices)
    dipoles = np.array([
        props.calculate_analytical_dipole_moment(
            m["centre_of_mass"], m["charges"], m["coordinates"], P[i].cpu().numpy(),
            m["integrals"].D.cpu().numpy())[0]
        for i, m in enumerate(meta)])
    return energies, converged, dipoles


def stencil_points_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """A finite-difference geometry stencil's displaced bond lengths in one
    batch: (energies, converged, total densities, meta); meta[i]["integrals"]
    holds each displaced geometry's integrals (the dipole derivative needs
    its D)."""
    return _solve_points(calculation, atomic_symbols, bond_lengths, devices)


def scan_energies_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """Converged SCF total energies and convergence flags of a batch of bond
    lengths (see scan_points_parallel)."""
    energies, converged, _ = scan_points_parallel(calculation, atomic_symbols, bond_lengths,
                                                  devices)
    return energies, converged

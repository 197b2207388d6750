"""Batches of geometries, and of applied fields at one geometry, solved in
lockstep: scans, finite-difference stencils and finite-field property
stencils.

Twin of tuna_tpu/parallel.py.  tuna_tpu vmaps its jitted SCF while_loop
over a stack of bond lengths (or of fields) and shards the batch axis over
a device mesh; here the batch is padded to a multiple of the number of
devices (repeating the last point), cut into contiguous shards, one a
device, each advanced by scf.scf_batch_iterations (one batched op for all
of its points where tuna_tpu's loop body has one), all shards in one
lockstep host loop, and trimmed afterwards.  The post-SCF VV10 term comes
from dft.vv10.vv10_energies_batch: one launch of kernel K6b a shard of a
geometry batch, one for a whole field batch (its points share one grid).
The correlated batches (restricted and spin-orbital MP2 and CC/CI with
(T), double hybrids, CBS) solve each converged point's correlation on its
shard's device with the serial path's pieces: the (T) of a point is one
launch of K2 (restricted) or K2u (spin-orbital), and each point's CC
stops at its own convergence, as each vmapped lane of tuna_tpu's
while_loop does.  The drivers take these batches only when more than one
device is visible (device_count), as tuna_tpu does.

Not ported: the tensor-parallel Fock build (tuna_tpu's fock_build_sharded,
auto_tp_mesh and tp_hbm_budget_bytes), which needs several cards.
"""

from __future__ import annotations

import numpy as np
import torch

from . import props
from .dft import make_xc_closure, unported_functional
from .dft import grid as dft_grid
from .dft import vv10
from .drivers import common
from .output import error
from .periodic import make_atom
from .post import cc, mp, transforms
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


def _port_can_batch(calculation, atomic_symbols):
    """What the port's batches leave to the serial walk where tuna_tpu's
    batch it: a checkpoint written or read (the serial path keeps its
    stages), a functional the port lacks (the serial path refuses it) and
    VV10 on a Hartree-Fock reference (the serial path adds it; tuna_tpu's
    batch does not)."""
    reference = "RHF" if _restricted_reference(calculation, atomic_symbols) else "UHF"
    return (not getattr(calculation, "checkpoint", False)
            and not getattr(calculation, "read_checkpoint", False)
            and (not calculation.DFT_calculation
                 or unported_functional(calculation, reference) is None)
            and (calculation.DFT_calculation or not _needs_vv10(calculation)))


def mean_field_batchable(calculation, atomic_symbols, *, fields_free=True):
    """True when a calculation's SCF solves can ride the batch:
    Hartree-Fock (RHF or UHF) or Kohn-Sham (RKS or UKS) without a double
    hybrid's MP2 stage, stored integrals and no CBS extrapolation, and,
    with fields_free, no applied field (the field batch,
    field_energies_parallel, owns its field axis); what _port_can_batch
    leaves to the serial walk walks serially."""
    plain_hf = calculation.method.name in ("HF", "UHF")
    batchable_dft = (calculation.DFT_calculation
                     and not getattr(calculation, "MPC_prop", 0))
    ok = ((plain_hf or batchable_dft)
          and not getattr(calculation, "extrapolate", False)
          and not getattr(calculation, "direct_scf", False)
          and _port_can_batch(calculation, atomic_symbols))
    if fields_free:
        ok = (ok and not np.any(calculation.electric_field)
              and not np.any(calculation.electric_field_gradient))
    return ok


def _scan_common_ok(calculation, allow_extrapolate=False):
    """Stored integrals, no checkpoint read, no applied field and, unless
    allowed, no CBS extrapolation: what every correlated gate asks."""
    return not ((getattr(calculation, "extrapolate", False) and not allow_extrapolate)
                or getattr(calculation, "direct_scf", False)
                or getattr(calculation, "read_checkpoint", False)
                or np.any(calculation.electric_field)
                or np.any(calculation.electric_field_gradient))


def _wavefunction_ok(calculation, atomic_symbols, allow_extrapolate, restricted):
    """A wavefunction method on the batched SCF of the given reference
    (RHF when `restricted`, else UHF) that _scan_common_ok and
    _port_can_batch admit."""
    return (not calculation.DFT_calculation
            and _scan_common_ok(calculation, allow_extrapolate)
            and _restricted_reference(calculation, atomic_symbols) == restricted
            and _port_can_batch(calculation, atomic_symbols))


_MPN_SCAN_METHODS = ("MP2", "SCS-MP2", "MP3", "SCS-MP3",
                     "MP4", "MP4[SDTQ]", "MP4(SDTQ)", "MP4[SDQ]", "MP4(SDQ)",
                     "MP4[DQ]", "MP4(DQ)")


def mp2_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Restricted closed-form MPn: MP2 and SCS-MP2, and MP3 and MP4 without
    FREEZECORE, as tuna_tpu batches them.  Iterative, orbital-optimised
    and Laplace variants and UHF references beyond plain MP2
    (ump2_scan_batchable) walk serially."""
    name = calculation.method.name
    return (name in _MPN_SCAN_METHODS
            and not (name not in ("MP2", "SCS-MP2") and calculation.freeze_core)
            and _wavefunction_ok(calculation, atomic_symbols, allow_extrapolate, True))


def dh_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Restricted double hybrids: the batched Kohn-Sham SCF, then each
    point's MP2 stage scaled by the functional's MPC coefficient (with SCS
    where the functional is spin-scaled).  Excited-state, TD and
    relaxed-density variants walk serially."""
    return (bool(calculation.DFT_calculation)
            and float(getattr(calculation, "MPC_prop", 0.0) or 0.0) > 0.0
            and _scan_common_ok(calculation, allow_extrapolate)
            and not calculation.time_dependent
            and not calculation.method.excited_state_method
            and not getattr(calculation, "relaxed_density", False)
            and _restricted_reference(calculation, atomic_symbols)
            and _port_can_batch(calculation, atomic_symbols))


# The CC/CI methods whose amplitude solve batches: CC2 and CC3 (the AO
# tensor dressed every iteration) and the iterative triples walk serially.
# [T]/(T) suffixes batch too: the perturbative correction is a function of
# the converged amplitudes.
_CC_SCAN_BASES = ("LCCD", "CCD", "LCCSD", "CID", "CISD", "QCISD", "CCSD")


def _cc_base_name(name):
    for tag in ("[T]", "(T)"):
        name = name.split(tag)[0]
    return name


def cc_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Restricted CC/CI of _CC_SCAN_BASES, with (T) or [T]."""
    return (_cc_base_name(calculation.method.name) in _CC_SCAN_BASES
            and _wavefunction_ok(calculation, atomic_symbols, allow_extrapolate, True))


def ump2_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """Plain MP2 on a UHF reference, through the spin-orbital formula
    E = 1/4 sum t g (equal to the serial alpha/beta split for canonical
    orbitals); SCS (it needs the split) and FREEZECORE (frozen per spin in
    the serial path, not per sorted spin orbital) walk serially."""
    return (calculation.method.name == "MP2"
            and not calculation.freeze_core
            and _wavefunction_ok(calculation, atomic_symbols, allow_extrapolate, False))


def ucc_scan_batchable(calculation, atomic_symbols, allow_extrapolate=False):
    """CC/CI of _CC_SCAN_BASES on a UHF reference, through the spin-orbital
    solver, with (T) for CCSD and QCISD."""
    return (_cc_base_name(calculation.method.name) in _CC_SCAN_BASES
            and _wavefunction_ok(calculation, atomic_symbols, allow_extrapolate, False))


def cbs_scan_batchable(calculation, atomic_symbols):
    """EXTRAPOLATE scans as two batches (the small and the next basis) and
    the two-point formula a point: Hartree-Fock, Kohn-Sham without VV10 or
    a double hybrid, and the correlated methods the gates above batch."""
    from .drivers.energy import _NEXT_BASIS
    if (not getattr(calculation, "extrapolate", False)
            or _NEXT_BASIS.get(calculation.basis.upper()) is None
            or not _scan_common_ok(calculation, allow_extrapolate=True)
            or getattr(calculation, "VV10", False)
            or not _port_can_batch(calculation, atomic_symbols)):
        return False
    plain = calculation.method.name in ("HF", "UHF")
    dft = calculation.DFT_calculation and not getattr(calculation, "MPC_prop", 0)
    corr = any(gate(calculation, atomic_symbols, allow_extrapolate=True)
               for gate in (mp2_scan_batchable, cc_scan_batchable, ump2_scan_batchable,
                            ucc_scan_batchable))
    return plain or dft or corr


# ---------------------------------------------------------------------------
# The batched SCF
# ---------------------------------------------------------------------------

def _geometry_inputs(calculation, atomic_symbols, coords, device):
    """One geometry's inputs on `device`: its coordinates, the processed
    Molecule, integrals, orthogonaliser X, core guess (P_a, P_b), D2
    dispersion E_disp and "E_add", the classical additive term (nuclear
    repulsion + D2 dispersion) the SCF electronic energy lacks, and, for
    DFT, the quadrature grid and the XC closure."""
    molecule = Molecule(list(atomic_symbols), coords, calculation)
    integrals = common.calculate_analytical_integrals(molecule, calculation, True, device)
    molecule.process_basis_functions(calculation, int(integrals.n_basis))
    X, _, _ = common.calculate_orthogonalisation_matrix(integrals.S, calculation, True)
    P_a, P_b = _core_guess(integrals, X, molecule)
    V_NN = float(np.prod([float(c) for c in molecule.charges])
                 / np.linalg.norm(coords[1] - coords[0]))
    E_disp = float(common.calculate_additive_dispersion_energy(molecule, calculation, True))
    inputs = {"coordinates": coords, "centre_of_mass": molecule.centre_of_mass,
              "charges": molecule.charges, "molecule": molecule, "integrals": integrals,
              "X": X, "P_a": P_a, "P_b": P_b, "E_disp": E_disp, "E_add": V_NN + E_disp,
              "grid": None, "xc_closure": None}
    if calculation.DFT_calculation:
        inputs["grid"] = dft_grid.set_up_integration_grid(molecule, P_a, P_b, calculation,
                                                          True, device)
        inputs["xc_closure"] = make_xc_closure(calculation, inputs["grid"])
    return inputs


def _as_triples(points):
    """Points as (coordinates, field, field gradient): a bond length R
    (bohr) is the diatomic from the origin to (0, 0, R), with no field."""
    return [p if isinstance(p, tuple)
            else (np.array([[0.0, 0.0, 0.0], [0.0, 0.0, float(p)]]), None, None)
            for p in points]


def _batched_inputs(calculation, atomic_symbols, points, device, cache=None):
    """The inputs of a shard of points on `device`: (the last point's
    Molecule, the stacked matrices T, V, ERI, S, X, Pa, Pb and, for a field
    batch, Fld and G, the XC closures for DFT or None, per-point metadata:
    see _geometry_inputs).  A point is a bond length (bohr) or a triple
    (coordinates, field, field gradient); `cache` maps coordinates to
    their inputs, so points of one geometry share its integrals, grid and
    core guess, and a shard of one geometry broadcasts them instead of
    stacking copies of the N^4 tensors."""
    cache = {} if cache is None else cache
    points = _as_triples(points)
    inputs = []
    for coords, _, _ in points:
        key = coords.tobytes()
        if key not in cache:
            cache[key] = _geometry_inputs(calculation, atomic_symbols, coords, device)
        inputs.append(cache[key])
    keys = {"T": "T", "V": "V_NE", "ERI": "ERI_AO", "S": "S"}
    one_geometry = all(m is inputs[0] for m in inputs)
    if one_geometry:
        m = inputs[0]
        stacked = {key: getattr(m["integrals"], name).expand(len(points), *getattr(
            m["integrals"], name).shape) for key, name in keys.items()}
        stacked.update({key: m[name].expand(len(points), *m[name].shape)
                        for key, name in (("X", "X"), ("Pa", "P_a"), ("Pb", "P_b"))})
    else:
        stacked = {key: torch.stack([getattr(m["integrals"], name) for m in inputs])
                   for key, name in keys.items()}
        stacked.update({key: torch.stack([m[name] for m in inputs])
                        for key, name in (("X", "X"), ("Pa", "P_a"), ("Pb", "P_b"))})
        # each geometry's ERI becomes a view of the stack: one copy of the N^4 tensors
        for i, m in enumerate(inputs):
            m["integrals"].ERI_AO = stacked["ERI"][i]
    if points[0][1] is not None:
        stacked["Fld"] = torch.stack([common.apply_electric_field(m["integrals"].D, field)
                                      for m, (_, field, _) in zip(inputs, points)])
        stacked["G"] = torch.stack([
            common.apply_electric_field_gradient(m["integrals"].Q, gradient)
            for m, (_, _, gradient) in zip(inputs, points)])
    stacked["E_add"] = np.array([m["E_add"] for m in inputs])
    xc_closures = [m["xc_closure"] for m in inputs] if calculation.DFT_calculation else None
    return inputs[-1]["molecule"], stacked, xc_closures, [dict(m) for m in inputs]


def _core_guess(integrals, X, molecule):
    """The alpha and beta densities of the core Hamiltonian's orbitals, the
    guess of every batch, as tuna_tpu's."""
    _, C0 = torch.linalg.eigh(X.T @ (integrals.T + integrals.V_NE) @ X)
    C0 = X @ C0
    return (C0[:, :molecule.n_alpha] @ C0[:, :molecule.n_alpha].T,
            C0[:, :molecule.n_beta] @ C0[:, :molecule.n_beta].T)


def _solve_points(calculation, atomic_symbols, points, devices=None):
    """The batched SCF of a list of points (see _batched_inputs: bond
    lengths, or coordinates with a field each) over `devices` (a list of
    torch devices; device_mesh() by default): total energies (numpy),
    convergence flags (numpy), total densities (a tensor each, on its
    shard's device) and per-point metadata (see _geometry_inputs), with the
    SCF iterations each point took as meta[i]["scf_iterations"] and its
    converged orbitals and orbital energies as meta[i]["orbitals"] =
    (mos_a, eps_a, mos_b, eps_b).  With VV10, one K6b launch a shard over
    its points' grids or, for a field batch (every point at one geometry),
    one launch over the whole batch on that geometry's grid."""
    devices = device_mesh() if devices is None else [torch.device(d) for d in devices]
    points = _as_triples(points)
    field_batch = points[0][1] is not None      # one geometry, so one grid
    n_points = len(points)
    n_dev = len(devices)
    n_padded = -(-n_points // n_dev) * n_dev
    padded = list(points) + [points[-1]] * (n_padded - n_points)
    per_shard = n_padded // n_dev
    conv = calculation.SCF_conv
    static_damping = calculation.damping_factor or 0.0

    caches, shards, loops = {}, [], []
    for k, device in enumerate(devices):
        molecule, batch, xc_closures, meta = _batched_inputs(
            calculation, atomic_symbols, padded[k * per_shard:(k + 1) * per_shard], device,
            caches.setdefault(device, {}))
        shards.append((batch, meta))
        loops.append(scf_batch_iterations(
            scf_settings(calculation, molecule), batch["T"], batch["V"], batch["ERI"],
            batch["S"], batch["X"], batch["Pa"], batch["Pb"], calculation.HFX_prop, conv,
            static_damping, calculation.max_damping, xc_closures, calculation.DFX_prop,
            calculation.DFC_prop, Fld=batch.get("Fld"), G=batch.get("G")))

    vv10_needed = calculation.DFT_calculation and _needs_vv10(calculation)
    energies, converged, P, meta_all = [], [], [], []
    for k, ((batch, meta), result) in enumerate(zip(shards, run_in_lockstep(loops))):
        n_steps, shard_converged, E, P_a, P_b, outs = result
        n_keep = min(per_shard, n_points - k * per_shard)   # trim the padding
        if n_keep <= 0:
            break
        shard_E = E[:n_keep].cpu().numpy() + batch["E_add"][:n_keep]
        shard_P = list((P_a + P_b)[:n_keep])
        if vv10_needed and not field_batch:
            # post-SCF non-local dispersion per point (serial counterpart:
            # drivers/energy.py calculate_VV10_energy)
            bfs, w, grads, pts = zip(*(m["grid"] for m in meta[:n_keep]))
            shard_E = shard_E + vv10.vv10_energies_batch(
                shard_P, bfs, grads, w, pts, calculation.functional).cpu().numpy()
        for i in range(n_keep):
            meta[i]["scf_iterations"] = int(n_steps[i])
            meta[i]["orbitals"] = tuple(outs[key][i] for key in ("mos_a", "eps_a", "mos_b",
                                                                  "eps_b"))
        energies.append(shard_E)
        converged.append(shard_converged[:n_keep])
        P.extend(shard_P)
        meta_all.extend(meta[:n_keep])
    energies = np.concatenate(energies)
    if vv10_needed and field_batch:
        # one grid for the whole batch: one launch over every density
        bfs, w, grads, pts = meta_all[0]["grid"]
        energies = energies + vv10.vv10_energies_batch(
            [P_i.to(devices[0]) for P_i in P], bfs, grads, w, pts, calculation.functional,
            grid_axes=(None, None, None, None)).cpu().numpy()
    return energies, np.concatenate(converged), P, meta_all


# ---------------------------------------------------------------------------
# The correlated energies of converged points
# ---------------------------------------------------------------------------

def _batched_restricted_mp2(calculation, meta):
    """Restricted MP2 or SCS-MP2 (a double hybrid's scaled by its MPC
    coefficient), and MP3 and MP4, of each converged point of meta, on its
    device, by the serial path's cores (post/mp.py).  Returns the
    correlation energies (numpy)."""
    name = calculation.method.name
    base = calculation.method.method_base      # "MP2" | "MP3" | "MP4"
    do_scs = mp._spin_component_scaling_active(calculation)
    same_spin = calculation.same_spin_scaling if do_scs else 1.0
    opposite_spin = calculation.opposite_spin_scaling if do_scs else 1.0
    # double hybrids scale the MP2 stage (drivers/post_scf.py); DFT never
    # reaches MP3 or MP4
    dh_scale = calculation.MPC_prop if calculation.DFT_calculation else 1.0
    energies = []
    for m in meta:
        molecule, (C, e, _, _) = m["molecule"], m["orbitals"]
        o = slice(molecule.n_core_orbitals if calculation.freeze_core else 0,
                  molecule.n_doubly_occ)
        v = slice(molecule.n_doubly_occ, None)
        MO = transforms.ao_to_mo_chemists(m["integrals"].ERI_AO, C)
        e_ijab = transforms.doubles_epsilons(e, e, o, o, v, v)
        E_OS, E_SS, *_ = mp._restricted_mp2_core(
            transforms.chemists_to_physicists(MO)[o, o, v, v], e_ijab)
        E = (opposite_spin * float(E_OS) + same_spin * float(E_SS)) * dh_scale
        if base in ("MP3", "MP4"):
            # the gate keeps FREEZECORE off these: o is the whole occupied block
            E_MP3, e_ijab, t_ijab, t_dash, L = mp._restricted_mp3_core(MO, e_ijab, o, v)
            E += (calculation.MP3_scaling if name == "SCS-MP3" else 1.0) * float(E_MP3)
            if base == "MP4":
                parts = mp._restricted_mp4_core(
                    MO, e_ijab, t_ijab, t_dash, L, e, o, v,
                    name not in ("MP4[DQ]", "MP4(DQ)"),
                    name in ("MP4", "MP4[SDTQ]", "MP4(SDTQ)"))
                for part in parts:
                    E += float(part)
        energies.append(E)
    return np.array(energies)


def _cc_settings(calculation, base, restricted, n_occ):
    return cc.CCSettings(
        method=base, restricted=restricted,
        update_singles=base not in cc._NO_SINGLES,
        keep_disconnected=base not in cc._NO_DISCONNECTED,
        n_occ=n_occ,
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter))


def _solve_cc(calculation, settings, s, g, F, e_ia, e_ijab, t_ia, t_ijab):
    """cc.solve_amplitudes from the MP2 guess with FREEZECORE's offset s:
    (E_CC, t1, t2, converged and not failed)."""
    g_l, F_l = (g[s:, s:, s:, s:], F[s:, s:]) if s else (g, F)
    _, converged, failed, E_CC, t1, t2, _ = cc.solve_amplitudes(
        settings, g_l, F_l, e_ia, e_ijab, t_ia, t_ijab, calculation.energy_convergence,
        calculation.amp_conv)
    return E_CC, t1, t2, converged and not failed


def _batched_restricted_cc(calculation, meta):
    """Restricted CC/CI of each converged point of meta, on its device: the
    MO transform, the MP2 guess, cc.solve_amplitudes to the point's own
    convergence and, for [T]/(T), cc.ccsd_t_energy (one K2 launch on the
    card; QCISD scales the disconnected term by 2).  Returns (correlation
    energies, converged and not failed), numpy."""
    name = calculation.method.name
    base = _cc_base_name(name)
    energies, ok = [], []
    for m in meta:
        molecule, (C, e, _, _) = m["molecule"], m["orbitals"]
        s = molecule.n_core_orbitals if calculation.freeze_core else 0
        o, v = slice(s, molecule.n_doubly_occ), slice(molecule.n_doubly_occ, None)
        g = transforms.ao_to_mo_chemists(m["integrals"].ERI_AO, C).transpose(1, 2)
        F = torch.diag(e)
        e_ia = transforms.singles_epsilons(e, o, v)
        e_ijab = transforms.doubles_epsilons(e, e, o, o, v, v)
        settings = _cc_settings(calculation, base, True, molecule.n_doubly_occ - s)
        E, t1, t2, point_ok = _solve_cc(calculation, settings, s, g, F, e_ia, e_ijab,
                                        e_ia * F[o, v], g[o, o, v, v] * e_ijab)
        if name != base:
            E += float(cc.ccsd_t_energy(
                g[o, o, v, v].contiguous(), g[o, v, v, v].contiguous(),
                g[o, o, v, o].contiguous(), t1.contiguous(), t2.contiguous(),
                e[o].contiguous(), e[v].contiguous(), 2.0 if "QCISD" in base else 1.0))
        energies.append(E)
        ok.append(point_ok)
    return np.array(energies), np.array(ok)


def _batched_unrestricted_corr(calculation, meta):
    """Spin-orbital MP2 or CC/CI of each converged UHF point of meta, on its
    device: the orbitals of both spins in one list sorted by energy, the
    spin-blocked transform, then 1/4 sum t g (MP2) or cc.solve_amplitudes
    and, for CCSD and QCISD with [T]/(T), cc.uccsd_t_energy (one K2u launch
    on the card; QCISD scales the disconnected term by 2).  Returns
    (correlation energies, converged and not failed), numpy."""
    name = calculation.method.name
    base = _cc_base_name(name)
    do_T = base != name and base in ("CCSD", "QCISD")
    energies, ok = [], []
    for m in meta:
        molecule, (C_a, e_a, C_b, e_b) = m["molecule"], m["orbitals"]
        s = molecule.n_core_spin_orbitals if calculation.freeze_core else 0
        n_occ = molecule.n_occ
        o, v = slice(s, n_occ), slice(n_occ, None)
        combined = np.append(e_a.cpu().numpy(), e_b.cpu().numpy())
        C = transforms.spin_block_orbitals(C_a, C_b, combined)
        ERI = m["integrals"].ERI_AO
        g = transforms.antisymmetrise(
            transforms.ao_to_so_physicists(transforms.spin_block_eri(ERI), C, C))
        e = torch.as_tensor(combined[transforms.spin_orbital_order(combined)],
                            device=C.device)
        e_ijab = transforms.doubles_epsilons(e, e, o, o, v, v)
        t_ijab = g[o, o, v, v] * e_ijab
        if name == "MP2":
            energies.append(0.25 * float(torch.sum(t_ijab * g[o, o, v, v])))
            ok.append(True)
            continue
        H_core_SO = C.T @ transforms.spin_block_matrix(m["integrals"].H_core) @ C
        F = transforms.spin_orbital_fock(H_core_SO, g, slice(0, n_occ))
        e_ia = transforms.singles_epsilons(e, o, v)
        settings = _cc_settings(calculation, base, False, n_occ - s)
        E, t1, t2, point_ok = _solve_cc(calculation, settings, s, g, F, e_ia, e_ijab,
                                        e_ia * F[o, v], t_ijab)
        if do_T:
            E += float(cc.uccsd_t_energy(
                g[o, o, v, v].contiguous(), g[v, o, v, v].contiguous(),
                g[o, v, o, o].contiguous(), t1.contiguous(), t2.contiguous(),
                e[o].contiguous(), e[v].contiguous(), 2.0 if "QCISD" in base else 1.0))
        energies.append(E)
        ok.append(point_ok)
    return np.array(energies), np.array(ok)


def _correlation_energies(calculation, atomic_symbols, meta, allow_extrapolate=False):
    """(correlation energies, converged) of the converged points of meta
    under the gate that batches the calculation, or None for a mean-field
    one."""
    gates = dict(allow_extrapolate=allow_extrapolate)
    if (dh_scan_batchable(calculation, atomic_symbols, **gates)
            or mp2_scan_batchable(calculation, atomic_symbols, **gates)):
        return _batched_restricted_mp2(calculation, meta), np.ones(len(meta), dtype=bool)
    if cc_scan_batchable(calculation, atomic_symbols, **gates):
        return _batched_restricted_cc(calculation, meta)
    if (ump2_scan_batchable(calculation, atomic_symbols, **gates)
            or ucc_scan_batchable(calculation, atomic_symbols, **gates)):
        return _batched_unrestricted_corr(calculation, meta)
    return None


def _solve_points_components(calculation, atomic_symbols, bond_lengths, devices=None,
                             allow_extrapolate=False):
    """(E_scf_total, E_corr, E_disp, converged, P, meta) per point:
    E_scf_total = electronic + V_NN + dispersion; E_corr is zero for a
    mean-field method; a point whose CC did not converge is not converged.
    The CBS scan needs the split; the other batches add the parts."""
    energies, converged, P, meta = _solve_points(calculation, atomic_symbols, bond_lengths,
                                                 devices)
    correlation = _correlation_energies(calculation, atomic_symbols, meta, allow_extrapolate)
    E_corr = np.zeros(len(meta))
    if correlation is not None:
        E_corr, corr_ok = correlation
        converged = converged & corr_ok      # the serial walk takes an unconverged point
    E_disp = np.array([m["E_disp"] for m in meta])
    return energies, E_corr, E_disp, converged, P, meta


def _solve_points_correlated(calculation, atomic_symbols, bond_lengths, devices=None):
    """(total energies, converged, P_SCF, meta) per point; the densities are
    the SCF's, so callers that need a correlated density walk serially."""
    energies, E_corr, _, converged, P, meta = _solve_points_components(
        calculation, atomic_symbols, bond_lengths, devices)
    return energies + E_corr, converged, P, meta


def _dipoles(P, meta):
    """The analytic dipole moment of each point's total density."""
    return np.array([
        props.calculate_analytical_dipole_moment(
            m["centre_of_mass"], m["charges"], m["coordinates"], P[i].cpu().numpy(),
            m["integrals"].D.cpu().numpy())[0]
        for i, m in enumerate(meta)])


def cbs_scan_points_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """An EXTRAPOLATE scan as two batches, at the small basis and at the
    next (drivers/energy.py _NEXT_BASIS), combined a point by
    drivers/common.extrapolate_energies as the serial
    calculate_extrapolated_energy combines them: the SCF and correlation
    parts extrapolated, the large basis's dispersion added.  Returns
    (energies, converged, dipoles of the large basis's densities)."""
    from .drivers.energy import _NEXT_BASIS, _detect_zeta

    small = calculation.basis.upper()
    large = _NEXT_BASIS[small]
    zeta = _detect_zeta(small)
    E_s, C_s, D_s, conv_s, _, _ = _solve_points_components(
        calculation, atomic_symbols, bond_lengths, devices, allow_extrapolate=True)
    old_basis = calculation.basis
    calculation.basis = large
    try:
        E_l, C_l, D_l, conv_l, P_l, meta_l = _solve_points_components(
            calculation, atomic_symbols, bond_lengths, devices, allow_extrapolate=True)
    finally:
        calculation.basis = old_basis
    totals = []
    for i in range(len(bond_lengths)):
        E_scf_cbs, E_corr_cbs = common.extrapolate_energies(
            small, E_s[i] - D_s[i], E_l[i] - D_l[i], C_s[i], C_l[i], zeta)
        totals.append(E_scf_cbs + E_corr_cbs + D_l[i])
    return np.array(totals), conv_s & conv_l, _dipoles(P_l, meta_l)


def scan_points_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """Converged energies (correlated where a gate batches the method),
    convergence flags and analytic dipole moments of the SCF densities of a
    batch of bond lengths: the fast path of the SCAN driver
    (drivers/energy.scan_coordinate) when more than one device is
    visible."""
    energies, converged, P, meta = _solve_points_correlated(
        calculation, atomic_symbols, bond_lengths, devices)
    return energies, converged, _dipoles(P, meta)


def stencil_points_parallel(calculation, atomic_symbols, bond_lengths, devices=None,
                            include_correlation=False):
    """A finite-difference geometry stencil's displaced bond lengths in one
    batch: (energies, converged, total densities, meta); meta[i]["integrals"]
    holds each displaced geometry's integrals (the dipole derivative needs
    its D).  With include_correlation the correlation energy of a method a
    gate batches is added a point (energy-only callers: numerical
    gradients, VPT windows); the densities stay the SCF's."""
    if include_correlation:
        return _solve_points_correlated(calculation, atomic_symbols, bond_lengths, devices)
    return _solve_points(calculation, atomic_symbols, bond_lengths, devices)


def scan_energies_parallel(calculation, atomic_symbols, bond_lengths, devices=None):
    """Converged total energies and convergence flags of a batch of bond
    lengths (see scan_points_parallel)."""
    energies, converged, _ = scan_points_parallel(calculation, atomic_symbols, bond_lengths,
                                                  devices)
    return energies, converged


# ---------------------------------------------------------------------------
# The finite-field batch
# ---------------------------------------------------------------------------

def field_energies_parallel(calculation, atomic_symbols, coordinates, fields,
                            field_gradients=None, devices=None):
    """Converged total energies and convergence flags at ONE geometry for a
    batch of uniform electric fields and field gradients (absolute: any
    user-applied base field included), the finite-field property stencils
    of drivers/electric.py in one batch over `devices`.

    Every point shares the geometry's integrals (once a device), its
    field-free core guess and, for DFT, its grid; a field enters only
    through the stacked one-electron matrices Fld = sum_i E_i D_i and G
    (drivers/common.py), as tuna_tpu's vmapped kernel takes them.  With
    VV10 one K6b launch takes the whole batch's densities on that grid; a
    method a gate batches adds each point's correlation energy from the
    one AO tensor."""
    coords = common.clean_coordinates(np.asarray(coordinates, dtype=float))
    n_f = len(fields) if fields is not None else len(field_gradients)
    if fields is None:
        fields = [np.zeros(3)] * n_f
    if field_gradients is None:
        field_gradients = [np.zeros(3)] * n_f
    energies, converged, _, meta = _solve_points(
        calculation, atomic_symbols, list(zip([coords] * n_f, fields, field_gradients)),
        devices)
    correlation = _correlation_energies(calculation, atomic_symbols, meta)
    if correlation is not None:
        energies = energies + correlation[0]
        converged = converged & correlation[1]
    return energies, converged

"""Orbital-basis transformations for correlated methods.

Twin of the spatial-orbital pieces of tuna_tpu/post/transforms.py: the AO
ERI tensor is stored in chemists' notation (mn|kl); `ao_to_mo_chemists`
returns (pq|rs); physicists' <pq|rs> = chemists (pr|qs).  Under DIRECT no
AO tensor is stored, and `transform_direct_mo_chemists` builds (pq|rs)
from the packed pair matrix.
"""

from __future__ import annotations

import torch

from ..drivers import common
from ..ops import motransform
from ..output import error, log, timer


def ao_to_mo_chemists(ERI_AO, C):
    """(mn|kl) -> (pq|rs) over molecular orbitals C."""
    out = ERI_AO
    for _ in range(4):
        out = torch.movedim(torch.tensordot(C.T, out, dims=([1], [0])), 0, 3)
    return out


def transform_direct_mo_chemists(molecule, SCF_output, calculation):
    """Chemists' MO tensor straight from the packed pair sweep, the
    integral-direct correlation path (DIRECT keyword): the dense N^4 AO
    tensor, Cartesian or spherical, is never materialised."""
    plan = common.get_integral_plan(molecule)
    C = SCF_output.molecular_orbitals
    device = C.device
    coords = torch.as_tensor(molecule.coordinates, dtype=C.dtype, device=device)
    if calculation.cartesian_harmonics:
        W = C
    else:
        W = torch.as_tensor(molecule.spherical_transformation, dtype=C.dtype,
                            device=device).T @ C
    n_mo = int(C.shape[1])
    G_pair = plan.eri_pair_packed(coords)
    G_mo = motransform.pair_packed_to_mo(G_pair, plan.tensors(device)["pair_index"],
                                         W.contiguous(), n_mo)
    return motransform.expand_mo_chemists(G_mo, n_mo)


# --- energy denominators ---------------------------------------------------

def singles_epsilons(epsilons, o, v, level_shift=0.0):
    return 1.0 / (epsilons[o, None] - epsilons[None, v] - level_shift)


def doubles_epsilons(eps1, eps2, o1, o2, v1, v2, level_shift=0.0):
    return 1.0 / (eps1[o1, None, None, None] + eps2[None, o2, None, None]
                  - eps1[None, None, v1, None] - eps2[None, None, None, v2]
                  - 2 * level_shift)


def triples_epsilons(epsilons, o, v, level_shift=0.0):
    e_o, e_v = epsilons[o], epsilons[v]
    n = None
    return 1.0 / (e_o[:, n, n, n, n, n] + e_o[n, :, n, n, n, n]
                  + e_o[n, n, :, n, n, n] - e_v[n, n, n, :, n, n]
                  - e_v[n, n, n, n, :, n] - e_v[n, n, n, n, n, :]
                  - 3 * level_shift)


# --- calculation preamble ---------------------------------------------------

def begin_spatial_orbital_calculation(molecule, ERI_AO, SCF_output, calculation,
                                      silent=False):
    """Spatial-orbital setup: chemists' MO integrals + occupied/virtual slices."""
    minimum_orbital = molecule.n_core_orbitals if calculation.freeze_core else 0
    if molecule.n_core_orbitals * 2 > molecule.n_electrons:
        error("Not enough spatial orbitals to freeze!")
    if molecule.n_core_orbitals < 0:
        error("Cannot freeze a negative number of orbitals!")

    o = slice(minimum_orbital, molecule.n_doubly_occ)
    v = slice(molecule.n_doubly_occ, None)

    log("\n Preparing transformation to spatial orbital basis...", calculation, 1,
        silent=silent)
    timer("Molecular orbital transformation", 0)
    if ERI_AO is None:
        # Integral-direct SCF deferred the stored tensor; transform straight
        # from the packed pair sweep.
        ERI_MO = transform_direct_mo_chemists(molecule, SCF_output, calculation)
    else:
        ERI_MO = ao_to_mo_chemists(ERI_AO, SCF_output.molecular_orbitals)
    timer("Molecular orbital transformation", 1)

    if calculation.freeze_core and molecule.n_core_orbitals != 0:
        log(f"\n The {molecule.n_core_orbitals} lowest energy orbitals will be "
            "frozen.", calculation, 1, silent=silent)
    else:
        log("\n All electrons will be correlated.", calculation, 1, silent=silent)

    return ERI_MO, SCF_output.molecular_orbitals, SCF_output.epsilons, o, v

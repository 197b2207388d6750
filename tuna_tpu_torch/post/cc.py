"""Coupled cluster and iterative CI with the (T)/[T] triples and the (Q)/[Q]
quadruples energies: restricted CCSD and CISD, and on UHF references the
spin-orbital LCCD, CCD, LCCSD (CEPA), CID, CISD, QCISD and CCSD; CCSDT,
CISDT and CCSDTQ are iterated by post/cc_triples.py.

Twin of tuna_tpu/post/cc.py's restricted closed-shell path (the
spin-adapted spatial-orbital equations in the tau-based formulation with
occupied-leading integral blocks and L = 2<pq|rs> - <pq|sr>, the fused CCSD
residual) and its unrestricted path (the antisymmetrised spin-orbital
equations on <pq||rs>), both on the pure-float64 amplitude DIIS loop of
`_build_cc_solver_fn` (its f32 spread extrapolation included, so iterates
follow tuna_tpu's CPU path).  A Python loop on the device takes the place
of the while_loop.

The restricted (T) energy runs through `ccsd_t_energy`, the K2 CUDA kernel
(csrc/ccsd_t.cu) on CUDA tensors; the unrestricted one through
`uccsd_t_energy`, the K2u kernel (csrc/ccsd_t_u.cu); the (Q) energy of
CCSDT[Q]/(Q) through `ccsdt_q_energy`, the K9 kernel (csrc/ccsdt_q.cu).  On
CPU tensors each takes its plain torch version.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from .. import _kernels
from ..containers import to_numpy
from ..ops import linalg
from ..output import error, log, log_spacer, timer
from . import transforms

_F64 = torch.float64


# ---------------------------------------------------------------------------
# Small tensor helpers
# ---------------------------------------------------------------------------

def permute(x, axis_1, axis_2):
    """Antisymmetric permutation P-(axis_1, axis_2): x - x with the axes swapped."""
    return x - x.transpose(axis_1, axis_2)


def permute_symmetric(x, pair_1, pair_2):
    """x plus x with both axis pairs swapped."""
    return x + x.transpose(*pair_1).transpose(*pair_2)


def _sym_pair(r):
    """Symmetrise a doubles residual over simultaneous (ij)(ab) exchange."""
    return r + r.permute(1, 0, 3, 2)


def _u_of(t2):
    """Spin-adapted contravariant combination 2 t2[ijab] - t2[ijba]."""
    return 2.0 * t2 - t2.transpose(2, 3)


def _tau_of(t1, t2):
    """tau[ijab] = t2[ijab] + t1[ia] t1[jb]."""
    return t2 + torch.einsum("ia,jb->ijab", t1, t1)


# ---------------------------------------------------------------------------
# T1 dressing (tuna_tpu/post/cc.py:505-537): CCSDT and CCSDTQ here, CC2 and
# CC3 later
# ---------------------------------------------------------------------------

def _t1_dressed_orbitals(C, t1, o, v):
    """X = C (1 - t1 on the ov block), Y = C (1 + t1^T on the vo block)."""
    X, Y = C.clone(), C.clone()
    X[:, v] -= C[:, o] @ t1
    Y[:, o] += C[:, v] @ t1.T
    return X, Y


def _t1_dressed_mo_tensor(G, t1, o, v):
    """T1-dressed chemists' tensor from the undressed full-space MO tensor G:
    four one-index updates, each contracting the small t1 block, O(o v n^4)
    instead of the O(n^5) AO rebuild; bra indices (1, 3) carry X's
    dressing, ket indices (2, 4) Y's.  G is not modified."""
    G = G.clone()
    G[v] += torch.einsum("ip,iqrs->pqrs", -t1, G[o])
    G[:, o] += torch.einsum("qb,pbrs->pqrs", t1, G[:, v])
    G[:, :, v] += torch.einsum("ir,pqis->pqrs", -t1, G[:, :, o])
    G[:, :, :, o] += torch.einsum("sd,pqrd->pqrs", t1, G[:, :, :, v])
    return G


def _t1_dressed_mo_oneelectron(H_MO, t1, o, v):
    """h_hat = A^T H_MO B with the low-rank A, B of the tensor dressing."""
    H = H_MO.clone()
    H[v] += torch.einsum("ip,iq->pq", -t1, H[o])
    H[:, o] += torch.einsum("qb,pb->pq", t1, H[:, v])
    return H


# ---------------------------------------------------------------------------
# Integral blocks
# ---------------------------------------------------------------------------

def _restricted_blocks(g, o, v):
    """Occupied-leading blocks of <pq|rs> and L = 2<pq|rs> - <pq|sr>, plus
    the loop-invariant concatenations of the fused CCSD residual."""
    L = 2.0 * g - g.transpose(2, 3)
    B = {
        "oooo": g[o, o, o, o], "ooov": g[o, o, o, v], "oovo": g[o, o, v, o],
        "oovv": g[o, o, v, v], "ovoo": g[o, v, o, o], "ovov": g[o, v, o, v],
        "ovvo": g[o, v, v, o], "ovvv": g[o, v, v, v], "vvvv": g[v, v, v, v],
        "Loovv": L[o, o, v, v], "Lovoo": L[o, v, o, o], "Lovvo": L[o, v, v, o],
        "Lovvv": L[o, v, v, v],
    }
    B = {key: value.contiguous() for key, value in B.items()}
    B.update(_ccsd_fused_cats(B))
    return B


def _unrestricted_blocks(g, o, v):
    """Spin-orbital antisymmetrised blocks <pq||rs>."""
    B = {
        "oooo": g[o, o, o, o], "ooov": g[o, o, o, v], "oovo": g[o, o, v, o],
        "oovv": g[o, o, v, v], "ovoo": g[o, v, o, o], "ovov": g[o, v, o, v],
        "ovvo": g[o, v, v, o], "ovvv": g[o, v, v, v],
        "vovv": g[v, o, v, v], "vvvo": g[v, v, v, o], "vvvv": g[v, v, v, v],
    }
    return {key: value.contiguous() for key, value in B.items()}


_NO_DISCONNECTED = ("LCCD", "LCCSD", "QCISD", "QCISD[T]", "QCISD(T)", "CISD",
                    "CID", "CISDT")
_NO_SINGLES = ("LCCD", "CCD", "CID")
# the methods that iterate t3 (tuna_tpu's calculate_triples list, less the
# perturbative and CC3 ones, which form no t3 here)
_ITERATIVE_TRIPLES = ("CCSDT", "CCSDT[Q]", "CCSDT(Q)", "CCSDTQ", "CISDT")


def _restricted_energy(B, F_ov, t1, t2, keep_disconnected: bool):
    E_singles = torch.einsum("ia,ia->", F_ov, t1)
    E_conn = torch.einsum("ijab,ijab->", B["Loovv"], t2)
    if keep_disconnected:
        E_disc = torch.einsum("ijab,ia,jb->", B["Loovv"], t1, t1)
    else:
        E_disc = torch.zeros_like(E_conn)
    return E_singles + E_conn + E_disc, E_singles, E_conn, E_disc


def _unrestricted_energy(B, F_ov, t1, t2, keep_disconnected: bool):
    E_singles = torch.einsum("ia,ia->", F_ov, t1)
    E_conn = 0.25 * torch.einsum("ijab,ijab->", B["oovv"], t2)
    if keep_disconnected:
        E_disc = 0.5 * torch.einsum("ijab,ia,jb->", B["oovv"], t1, t1)
    else:
        E_disc = torch.zeros_like(E_conn)
    return E_singles + E_conn + E_disc, E_singles, E_conn, E_disc


# ---------------------------------------------------------------------------
# Shared restricted terms
# ---------------------------------------------------------------------------

def _r_pair_ladder(Aoooo, Avvvv, t2_hh, t2_pp):
    """Hole-hole + particle-particle ladder."""
    return 0.5 * (torch.einsum("ijkl,klab->ijab", Aoooo, t2_hh)
                  + torch.einsum("abcd,ijcd->ijab", Avvvv, t2_pp))


def _r_rings(Aovvo, Aovov, t2):
    """The four spin-adapted ring contractions, blocked into one matmul."""
    no, nv = t2.shape[0], t2.shape[2]
    ia = no * nv
    A1 = Aovvo.permute(0, 2, 3, 1).reshape(ia, ia)   # (i,a),(k,c)
    A2 = Aovov.permute(0, 3, 2, 1).reshape(ia, ia)   # (i,a)/(i,b),(k,c)
    Bp = t2.permute(0, 2, 1, 3).reshape(ia, ia)      # (k,c),(j,b)
    Bq = t2.permute(0, 3, 1, 2).reshape(ia, ia)      # (k,c),(j,b)/(j,a)
    C = torch.cat([A1, A2]) @ torch.cat([Bp, Bq], dim=1)
    C = C.reshape(2, no, nv, 2, no, nv)
    c11, c12 = C[0, :, :, 0], C[0, :, :, 1]            # (i,a,j,b)
    c21, c22 = C[1, :, :, 0], C[1, :, :, 1]            # (i,a,j,b)/(i,b,j,a)
    return ((2.0 * c11 - c21 - c12).permute(0, 2, 1, 3)
            - c22.permute(0, 2, 3, 1))


def _r_singles_linear(B, t1, t2):
    """Singles terms common to LCCSD / CISD."""
    return (torch.einsum("icak,kc->ia", B["Lovvo"], t1)
            + torch.einsum("kadc,ikcd->ia", B["Lovvv"], t2)
            - torch.einsum("ickl,klac->ia", B["Lovoo"], t2))


def _r_doubles_singles_driven(B, t1):
    """t1-driven doubles terms shared by LCCSD / CISD / QCISD."""
    return (torch.einsum("icab,jc->ijab", B["ovvv"], t1)
            - torch.einsum("ijak,kb->ijab", B["oovo"], t1))


# ---------------------------------------------------------------------------
# Restricted residual -> new-amplitude maps
# ---------------------------------------------------------------------------
# Each update has signature (B, F_ov, d1, d2, t1, t2) -> (t1_new, t2_new)

def _r_cisd(B, F_ov, d1, d2, t1, t2):
    r1 = _r_singles_linear(B, t1, t2)
    r2 = _sym_pair(0.5 * B["oovv"] + _r_doubles_singles_driven(B, t1)
                   + _r_pair_ladder(B["oooo"], B["vvvv"], t2, t2)
                   + _r_rings(B["ovvo"], B["ovov"], t2))
    E_corr = torch.einsum("ijab,ijab->", B["oovv"], _u_of(t2))
    return d1 * (r1 - E_corr * t1), d2 * (r2 - E_corr * t2)


def _ccsd_fused_cats(B):
    """Loop-invariant concatenated left operands for _r_ccsd's fused groups
    (cc.py:334): contractions that share a contracted index pattern and a
    right-hand operand run as one matmul."""
    no, nv = B["ooov"].shape[0], B["ooov"].shape[3]
    o2, v2, ov = no * no, nv * nv, no * nv
    cat = {}
    # group CD: Woooo build "klcd,ijcd", particle ladder "abcd,ijcd", Y "kacd,ijcd"
    cat["cat_cd"] = torch.cat([
        B["oovv"].reshape(o2, v2),
        B["vvvv"].reshape(v2, v2),
        B["ovvv"].reshape(ov, v2)])
    # group KLC: dFvv "klcd,klad->ca" and the singles term "ickl,klac->ia"
    cat["cat_klc"] = torch.cat([
        B["Loovv"].permute(2, 0, 1, 3).reshape(nv, o2 * nv),
        B["Lovoo"].permute(0, 2, 3, 1).reshape(no, o2 * nv)])
    # group KCD: dFoo "klcd,ilcd->ik" and the singles term "kadc,ikcd->ia"
    cat["cat_kcd"] = torch.cat([
        B["Loovv"].reshape(no, no * v2),
        B["Lovvv"].permute(1, 0, 3, 2).reshape(nv, no * v2)])
    # group V_T1: Woooo "klic,jc", r2 "icab,jc", Wovvo "kacd,id", Wovov "kadc,id"
    cat["cat_v_t1"] = torch.cat([
        B["ooov"].reshape(no * o2, nv),
        B["ovvv"].permute(0, 2, 3, 1).reshape(no * v2, nv),
        B["ovvv"].reshape(ov * nv, nv),
        B["ovvv"].permute(0, 1, 3, 2).reshape(ov * nv, nv)])
    # group O_T1: r2 "ijak,kb", Wovvo "iclk,la", Wovov "ickl,la"
    cat["cat_o_t1"] = torch.cat([
        B["oovo"].reshape(o2 * nv, no),
        B["ovoo"].permute(0, 1, 3, 2).reshape(ov * no, no),
        B["ovoo"].reshape(ov * no, no)])
    # group OV_T1: Fov "klcd,ld->kc", dLoo "ickl,lc->ik", dLvv "kadc,kd->ca",
    # r1 "icak,kc->ia"
    cat["cat_ov_t1"] = torch.cat([
        B["Loovv"].permute(0, 2, 1, 3).reshape(ov, ov),
        B["Lovoo"].permute(0, 2, 3, 1).reshape(o2, ov),
        B["Lovvv"].permute(3, 1, 0, 2).reshape(v2, ov),
        B["Lovvo"].permute(0, 2, 3, 1).reshape(ov, ov)])
    # group LD: Wovvo "lkdc,ilda", Wovvo "lkdc,ilad" (Loovv), Wovov "lkcd,ilda"
    cat["cat_ld"] = torch.cat([
        B["oovv"].permute(1, 3, 0, 2).reshape(ov, ov),
        B["Loovv"].permute(1, 3, 0, 2).reshape(ov, ov),
        B["oovv"].permute(1, 2, 0, 3).reshape(ov, ov)])
    return cat


def _r_ccsd(B, F_ov, d1, d2, t1, t2):
    """Fused-contraction CCSD residual (tuna_tpu/post/cc.py::_r_ccsd)."""
    no, nv = t2.shape[0], t2.shape[2]
    o2, v2, ov = no * no, nv * nv, no * nv

    tau = _tau_of(t1, t2)
    u_t2 = _u_of(t2)

    # --- group CD: Woooo build + particle ladder + Y in ONE matmul -------
    CD = B["cat_cd"] @ tau.permute(2, 3, 0, 1).reshape(v2, o2)
    Woooo_tau = CD[:o2].reshape(no, no, no, no).permute(2, 3, 0, 1)
    ladder_pp = CD[o2:o2 + v2].reshape(nv, nv, no, no).permute(2, 3, 0, 1)
    Y = CD[o2 + v2:].reshape(no, nv, no, no)                       # kaij

    # --- group KLC: dFvv + Lovoo singles term -----------------------------
    KLC = B["cat_klc"] @ tau.permute(0, 1, 3, 2).reshape(o2 * nv, nv)
    dFvv = -KLC[:nv]                                               # (c,a)
    r1_lovoo = KLC[nv:]                                            # (i,a)

    # --- group KCD: dFoo + Lovvv singles term -----------------------------
    KCD = B["cat_kcd"] @ tau.permute(1, 2, 3, 0).reshape(no * v2, no)
    dFoo = KCD[:no].T                                              # (i,k)
    r1_lovvv = KCD[no:].T                                          # (i,a)

    # --- group V_T1 --------------------------------------------------------
    V1 = B["cat_v_t1"] @ t1.T
    n0 = no * o2
    woooo_t1 = V1[:n0].reshape(no, no, no, no).permute(2, 3, 0, 1)
    r2_ovvv = V1[n0:n0 + no * v2].reshape(no, nv, nv, no).permute(0, 3, 1, 2)
    wovvo_v = V1[n0 + no * v2:n0 + no * v2 + ov * nv].reshape(
        no, nv, nv, no).permute(3, 2, 1, 0)                        # icak
    wovov_v = V1[n0 + no * v2 + ov * nv:].reshape(
        no, nv, nv, no).permute(3, 2, 0, 1)                        # icka

    # --- group O_T1 --------------------------------------------------------
    O1 = B["cat_o_t1"] @ t1
    r2_oovo = O1[:o2 * nv].reshape(no, no, nv, nv)                 # ijab
    wovvo_o = O1[o2 * nv:o2 * nv + ov * no].reshape(
        no, nv, no, nv).permute(0, 1, 3, 2)                        # icak
    wovov_o = O1[o2 * nv + ov * no:].reshape(no, nv, no, nv)       # icka

    # --- group OV_T1 (matvec) ----------------------------------------------
    OV1 = B["cat_ov_t1"] @ t1.reshape(-1)
    Fov = OV1[:ov].reshape(no, nv)
    dLoo_t1 = OV1[ov:ov + o2].reshape(no, no)
    dLvv_t1 = OV1[ov + o2:ov + o2 + v2].reshape(nv, nv)
    r1_lovvo = OV1[ov + o2 + v2:].reshape(no, nv)

    # --- group LD: the three ring-dressing contractions ---------------------
    half = 0.5 * t2 + torch.einsum("id,la->ilda", t1, t1)
    half_ld = half.permute(1, 2, 0, 3).reshape(ov, ov)
    t2_ld = t2.permute(1, 3, 0, 2).reshape(ov, ov)
    LD = B["cat_ld"] @ torch.cat([half_ld, t2_ld], dim=1)
    w_oovv_half = LD[:ov, :ov].reshape(no, nv, no, nv).permute(2, 1, 3, 0)
    w_loovv_t2 = LD[ov:2 * ov, ov:].reshape(no, nv, no, nv).permute(2, 1, 3, 0)
    w_oovv_half_x = LD[2 * ov:, :ov].reshape(no, nv, no, nv).permute(2, 1, 0, 3)

    # --- assemble the dressed intermediates ---------------------------------
    Woooo = B["oooo"] + Woooo_tau + _sym_pair(woooo_t1)
    Wovvo = B["ovvo"] - w_oovv_half + 0.5 * w_loovv_t2 - wovvo_o + wovvo_v
    Wovov = B["ovov"] - w_oovv_half_x - wovov_o + wovov_v
    dLoo = dFoo + dLoo_t1
    dLvv = dFvv + dLvv_t1

    # --- ladder, with the Y-driven T1 dressing of the particle ladder -------
    ladder = 0.5 * (torch.einsum("ijkl,klab->ijab", Woooo, tau) + ladder_pp)
    C = (Y.permute(1, 2, 3, 0).reshape(nv * o2, no) @ t1).reshape(nv, no, no, nv)
    ladder = ladder - 0.5 * (C.permute(2, 1, 0, 3) + C.permute(1, 2, 3, 0))

    # --- residuals -------------------------------------------------------------
    r1 = (torch.einsum("ca,ic->ia", dFvv, t1)
          - torch.einsum("ik,ka->ia", dFoo, t1)
          - r1_lovoo
          + torch.einsum("kc,kica->ia", Fov, u_t2)
          + torch.einsum("kc,ic,ka->ia", Fov, t1, t1)
          + r1_lovvo
          + r1_lovvv)

    r2 = (0.5 * B["oovv"] + ladder
          + torch.einsum("ca,ijcb->ijab", dLvv, t2)
          - torch.einsum("ik,kjab->ijab", dLoo, t2)
          + r2_ovvv
          - torch.einsum("ickb,ka,jc->ijab", B["ovov"], t1, t1)
          - r2_oovo
          - torch.einsum("icak,jc,kb->ijab", B["ovvo"], t1, t1)
          + _r_rings(Wovvo, Wovov, t2))

    return d1 * r1, d2 * _sym_pair(r2)


_RESTRICTED_UPDATES = {"CCSD": _r_ccsd, "CISD": _r_cisd}


# ---------------------------------------------------------------------------
# Unrestricted (spin-orbital) residual -> new-amplitude maps
# ---------------------------------------------------------------------------
# Each update has signature (B, F, o, v, d1, d2, t1, t2) -> (t1_new, t2_new),
# F the spin-orbital Fock matrix of the correlated window.  tuna_tpu's
# three-operand einsums are written as two two-operand contractions.

def _off_diagonal(F, s):
    """The s block of F with its diagonal set to zero."""
    return F[s, s] - torch.diag(torch.diagonal(F))[s, s]


def _u_so_tau(t1, t2, factor):
    pair = torch.einsum("ia,jb->ijab", t1, t1)
    return t2 + factor * (pair - pair.transpose(2, 3))


def _u_linear_doubles(B, F_oo_off, F_vv_off, t1, t2, with_fock: bool):
    """Linear doubles terms shared by every spin-orbital method."""
    r = (B["oovv"]
         + 0.5 * torch.einsum("abcd,ijcd->ijab", B["vvvv"], t2)
         + 0.5 * torch.einsum("ijkl,klab->ijab", B["oooo"], t2)
         + permute(permute(torch.einsum("icak,jkbc->ijab", B["ovvo"], t2), 2, 3), 0, 1))
    if with_fock:
        r = r + permute(torch.einsum("ijae,be->ijab", t2, F_vv_off), 2, 3)
        r = r - permute(torch.einsum("imab,mj->ijab", t2, F_oo_off), 0, 1)
    return r


def _u_singles_driven(B, t1):
    return (permute(torch.einsum("abcj,ic->ijab", B["vvvo"], t1), 0, 1)
            - permute(torch.einsum("kbij,ka->ijab", B["ovoo"], t1), 2, 3))


def _u_singles_tail(B, t1, t2):
    """The integral terms every spin-orbital singles residual ends with."""
    return (- torch.einsum("nf,naif->ia", t1, B["ovov"])
            - 0.5 * torch.einsum("imef,maef->ia", t2, B["ovvv"])
            - 0.5 * torch.einsum("mnae,nmei->ia", t2, B["oovo"]))


def _u_linear_singles(B, F, o, v, t1, t2):
    return (F[o, v]
            + torch.einsum("ie,ae->ia", t1, _off_diagonal(F, v))
            - torch.einsum("ma,mi->ia", t1, _off_diagonal(F, o))
            + torch.einsum("imae,me->ia", t2, F[o, v])
            + _u_singles_tail(B, t1, t2))


def _u_lccd(B, F, o, v, d1, d2, t1, t2):
    return t1, d2 * _u_linear_doubles(B, None, None, t1, t2, False)


def _u_ccd(B, F, o, v, d1, d2, t1, t2):
    g = B["oovv"]
    r = _u_linear_doubles(B, None, None, t1, t2, False)
    # "cdkl,ijac,klbd->ijab" with <cd||kl> = <kl||cd>
    r = r - 0.5 * permute(torch.einsum("ijac,cb->ijab", t2,
                                       torch.einsum("klcd,klbd->cb", g, t2)), 2, 3)
    # "cdkl,ikab,jlcd->ijab"
    r = r - 0.5 * permute(torch.einsum("ikab,kj->ijab", t2,
                                       torch.einsum("klcd,jlcd->kj", g, t2)), 0, 1)
    # "cdkl,ijcd,klab->ijab"
    r = r + 0.25 * torch.einsum("ijkl,klab->ijab", torch.einsum("ijcd,klcd->ijkl", t2, g), t2)
    # "cdkl,ikac,jlbd->ijab"
    r = r + permute(torch.einsum("iald,jlbd->ijab", torch.einsum("ikac,klcd->iald", t2, g),
                                 t2), 0, 1)
    return t1, d2 * r


def _u_lccsd(B, F, o, v, d1, d2, t1, t2):
    """Incremental update (the reference quirk, tuna_cc.py:1118-1119): the
    fixed point satisfies residual = 0 either way."""
    r1 = (F[o, v] + torch.einsum("ac,ic->ia", F[v, v], t1)
          + torch.einsum("kc,ikac->ia", F[o, v], t2)
          - torch.einsum("ki,ka->ia", F[o, o], t1)
          + torch.einsum("kaci,kc->ia", B["ovvo"], t1)
          + 0.5 * torch.einsum("kacd,kicd->ia", B["ovvv"], t2)
          - 0.5 * torch.einsum("klci,klca->ia", B["oovo"], t2))
    r2 = (_u_linear_doubles(B, F[o, o], F[v, v], t1, t2, False)
          + permute(torch.einsum("bc,ijac->ijab", F[v, v], t2), 2, 3)
          - permute(torch.einsum("kj,ikab->ijab", F[o, o], t2), 0, 1)
          + _u_singles_driven(B, t1))
    return t1 + d1 * r1, t2 + d2 * r2


def _u_cid(B, F, o, v, d1, d2, t1, t2):
    off_vv = _off_diagonal(F, v)
    r = _u_linear_doubles(B, torch.zeros_like(F[o, o]), off_vv, t1, t2, False)
    r = r + permute(torch.einsum("ijae,be->ijab", t2, off_vv), 2, 3)
    E_corr = 0.25 * torch.einsum("ijab,ijab->", B["oovv"], t2)
    return t1, d2 * (r - E_corr * t2)


def _u_cisd(B, F, o, v, d1, d2, t1, t2):
    r1 = _u_linear_singles(B, F, o, v, t1, t2)
    r2 = (_u_linear_doubles(B, _off_diagonal(F, o), _off_diagonal(F, v), t1, t2, True)
          + _u_singles_driven(B, t1))
    E_corr = 0.25 * torch.einsum("ijab,ijab->", B["oovv"], t2)
    return d1 * (r1 - E_corr * t1), d2 * (r2 - E_corr * t2)


def _u_qcisd(B, F, o, v, d1, d2, t1, t2):
    g = B["oovv"]
    Pvv = _off_diagonal(F, v) - 0.5 * torch.einsum("mnaf,mnef->ae", t2, g)
    Poo = _off_diagonal(F, o) + 0.5 * torch.einsum("inef,mnef->mi", t2, g)
    Pov = F[o, v] + torch.einsum("nf,mnef->me", t1, g)

    Hoooo = B["oooo"] + 0.25 * torch.einsum("ijef,mnef->mnij", t2, g)
    Hvvvv = B["vvvv"] + 0.25 * torch.einsum("mnab,mnef->abef", t2, g)
    Hovvo = B["ovvo"] - 0.5 * torch.einsum("jnfb,mnef->mbej", t2, g)

    r1 = (F[o, v] + torch.einsum("ie,ae->ia", t1, Pvv)
          - torch.einsum("ma,mi->ia", t1, Poo)
          + torch.einsum("imae,me->ia", t2, Pov)
          + _u_singles_tail(B, t1, t2))

    r2 = (g
          + permute(torch.einsum("ijae,be->ijab", t2, Pvv), 2, 3)
          - permute(torch.einsum("imab,mj->ijab", t2, Poo), 0, 1)
          + 0.5 * torch.einsum("mnab,mnij->ijab", t2, Hoooo)
          + 0.5 * torch.einsum("ijef,abef->ijab", t2, Hvvvv)
          + permute(permute(torch.einsum("imae,mbej->ijab", t2, Hovvo), 2, 3), 0, 1)
          + _u_singles_driven(B, t1))
    return d1 * r1, d2 * r2


def _u_ccsd(B, F, o, v, d1, d2, t1, t2):
    """Spin-orbital CCSD in the standard DPD intermediate form."""
    g = B["oovv"]
    tau_h = _u_so_tau(t1, t2, 0.5)
    tau = _u_so_tau(t1, t2, 1.0)

    Pvv = (_off_diagonal(F, v)
           - 0.5 * torch.einsum("me,ma->ae", F[o, v], t1)
           + torch.einsum("mf,mafe->ae", t1, B["ovvv"])
           - 0.5 * torch.einsum("mnaf,mnef->ae", tau_h, g))
    Poo = (_off_diagonal(F, o)
           + 0.5 * torch.einsum("ie,me->mi", t1, F[o, v])
           + torch.einsum("ne,mnie->mi", t1, B["ooov"])
           + 0.5 * torch.einsum("inef,mnef->mi", tau_h, g))
    Pov = F[o, v] + torch.einsum("nf,mnef->me", t1, g)

    Hoooo = (B["oooo"]
             + permute(torch.einsum("je,mnie->mnij", t1, B["ooov"]), 2, 3)
             + 0.25 * torch.einsum("ijef,mnef->mnij", tau, g))
    Hvvvv = (B["vvvv"]
             - permute(torch.einsum("mb,amef->abef", t1, B["vovv"]), 0, 1)
             + 0.25 * torch.einsum("mnab,mnef->abef", tau, g))
    Hovvo = (B["ovvo"]
             + torch.einsum("jf,mbef->mbej", t1, B["ovvv"])
             - torch.einsum("nb,mnej->mbej", t1, B["oovo"])
             - torch.einsum("jnfb,mnef->mbej",
                            0.5 * t2 + torch.einsum("jf,nb->jnfb", t1, t1), g))

    r1 = (F[o, v] + torch.einsum("ie,ae->ia", t1, Pvv)
          - torch.einsum("ma,mi->ia", t1, Poo)
          + torch.einsum("imae,me->ia", t2, Pov)
          + _u_singles_tail(B, t1, t2))

    # "ie,ma,mbej->ijab"
    t1_t1_ovvo = torch.einsum("ma,mbij->ijab", t1, torch.einsum("ie,mbej->mbij", t1, B["ovvo"]))
    r2 = (g
          + permute(torch.einsum("ijae,be->ijab", t2,
                                 Pvv - 0.5 * torch.einsum("mb,me->be", t1, Pov)), 2, 3)
          - permute(torch.einsum("imab,mj->ijab", t2,
                                 Poo + 0.5 * torch.einsum("je,me->mj", t1, Pov)), 0, 1)
          + 0.5 * torch.einsum("mnab,mnij->ijab", tau, Hoooo)
          + 0.5 * torch.einsum("ijef,abef->ijab", tau, Hvvvv)
          + permute(permute(torch.einsum("imae,mbej->ijab", t2, Hovvo) - t1_t1_ovvo,
                            2, 3), 0, 1)
          + _u_singles_driven(B, t1))
    return d1 * r1, d2 * r2


_UNRESTRICTED_UPDATES = {
    "LCCD": _u_lccd, "CCD": _u_ccd, "LCCSD": _u_lccsd, "CID": _u_cid,
    "CISD": _u_cisd, "QCISD": _u_qcisd, "CCSD": _u_ccsd,
}


# ---------------------------------------------------------------------------
# The amplitude solver (pure float64 DIIS loop, cc.py:919-1058)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CCSettings:
    method: str            # base iterative method name ("CCSD", "CISD", ...)
    restricted: bool
    update_singles: bool
    keep_disconnected: bool
    n_occ: int
    max_iter: int
    use_diis: bool
    max_diis: int
    damping: float


def _push_ring(buf, entry, n_valid, max_n):
    """Shift-down ring push: the newest entry always lands at the LAST slot;
    validity is tracked by n_valid counting back from the end."""
    shifted = torch.roll(buf, -1, dims=0)
    shifted[max_n - 1] = entry
    return shifted, min(n_valid + 1, max_n)


def _diis_coefficients(err_buf, n_valid, M):
    """DIIS coefficients from the full Gram of the last n_valid error
    vectors (the triples loop's; the rank-2 loop keeps its Gram
    incrementally)."""
    valid = torch.arange(M, device=err_buf.device) >= (M - n_valid)
    errs = torch.where(valid[:, None], err_buf, 0.0)
    return _diis_coefficients_from_gram(errs @ errs.T, n_valid, M)


def _diis_coefficients_from_gram(G, n_valid, M):
    """Bordered DIIS solve from the Gram block of the last n_valid error
    vectors; returns (ok, coefficients over all M slots)."""
    device, dtype = G.device, G.dtype
    valid = torch.arange(M, device=device) >= (M - n_valid)
    vv = valid[:, None] & valid[None, :]
    G = torch.where(vv, G, 0.0)
    # Scale the Gram block to O(1): the bordered system's solution c is
    # invariant under G -> G/s (only the Lagrange multiplier rescales).
    s = torch.clamp(torch.max(torch.abs(G)), min=1e-30)
    eye = torch.eye(M, dtype=torch.bool, device=device)
    G = torch.where(vv, G / s, 0.0) + torch.where(eye & ~valid[:, None], 1.0, 0.0)
    A = torch.zeros((M + 1, M + 1), dtype=dtype, device=device)
    A[:M, :M] = G
    border = torch.where(valid, -1.0, 0.0).to(dtype)
    A[:M, M] = border
    A[M, :M] = border
    rhs = torch.zeros(M + 1, dtype=dtype, device=device)
    rhs[M] = -1.0
    coeffs, ok = linalg.solve_linear_small(A, rhs)
    coeffs = torch.where(valid, coeffs[:M], 0.0)
    # Exact sum-to-one: coefficient-solve error then only multiplies the
    # SPREAD of the stored amplitudes (~residual-sized), not their magnitude.
    csum = torch.sum(coeffs)
    coeffs = coeffs / torch.where(torch.abs(csum) > 1e-3, csum, torch.ones_like(csum))
    ok = ok & (torch.abs(csum) > 1e-3)
    return ok & torch.all(torch.isfinite(coeffs)), coeffs


def solve_amplitudes(settings: CCSettings, g, F, d1, d2, t1_0, t2_0, energy_conv,
                     amp_conv, on_start=None, on_iteration=None):
    """Iterate the amplitude equations to convergence.

    on_start(guess MP2 energy) is called before the first iteration and
    on_iteration(step, E, dE, seconds) after each.  Returns (n_steps,
    converged, failed, E, t1, t2, (E_singles, E_connected, E_disconnected))."""
    M = settings.max_diis
    no = settings.n_occ
    o, v = slice(0, no), slice(no, None)
    F_ov = F[o, v]
    if settings.restricted:
        B = _restricted_blocks(g, o, v)
        update = partial(_RESTRICTED_UPDATES[settings.method], B, F_ov)
        energy = _restricted_energy
    else:
        B = _unrestricted_blocks(g, o, v)
        update = partial(_UNRESTRICTED_UPDATES[settings.method], B, F, o, v)
        energy = _unrestricted_energy

    def energy_fn(t1, t2):
        return energy(B, F_ov, t1, t2, settings.keep_disconnected)

    if on_start is not None:
        on_start(float(energy_fn(torch.zeros_like(t1_0), t2_0)[0]))

    n1 = t1_0.numel()
    n_total = n1 + t2_0.numel()
    dtype, device = t2_0.dtype, t2_0.device
    E = torch.zeros((), dtype=dtype, device=device)
    t1, t2 = t1_0, t2_0
    amp_buf = torch.zeros((M, n_total), dtype=dtype, device=device)
    err_buf = torch.zeros((M, n_total), dtype=dtype, device=device)
    gram = torch.zeros((M, M), dtype=dtype, device=device)
    n_valid = 0
    converged = failed = False
    step = 1
    while step <= settings.max_iter and not converged and not failed:
        start = time.perf_counter()
        t1n, t2n = update(d1, d2, t1, t2)
        En = energy_fn(t1n, t2n)[0]
        dE = En - E

        tn_flat = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        t_flat = torch.cat([t1.reshape(-1), t2.reshape(-1)])
        r = tn_flat - t_flat
        # convergence norms in float32, as tuna_tpu's loop takes them
        r32 = r.to(torch.float32)
        amp_ok = torch.linalg.norm(r32[n1:]) < amp_conv
        if settings.update_singles:
            amp_ok = amp_ok & (torch.linalg.norm(r32[:n1]) < amp_conv)
        is_conv = (torch.abs(dE) < energy_conv) & amp_ok
        is_failed = (~torch.all(torch.isfinite(t2n))) | (En > 1000.0)

        amp_buf, _ = _push_ring(amp_buf, tn_flat, n_valid, M)
        err_buf, n_valid = _push_ring(err_buf, r, n_valid, M)

        tx = tn_flat
        if settings.use_diis:
            # Incremental Gram: the push shifts rows down one slot, so only
            # the newest vector's row/column is computed.
            g_new = err_buf @ r
            gram = torch.roll(gram, shifts=(-1, -1), dims=(0, 1))
            gram[M - 1, :] = g_new
            gram[:, M - 1] = g_new
            ok, coeffs = _diis_coefficients_from_gram(gram, n_valid, M)
            use = (step > 2) & ok & ~is_conv
            # tn + sum_m c_m (amp_m - tn), the residual-sized spread terms
            # in float32 (cc.py:1019-1022)
            spread = (amp_buf - tn_flat[None, :]).to(torch.float32)
            delta = torch.sum(coeffs.to(torch.float32)[:, None] * spread, dim=0)
            tx = torch.where(use, tn_flat + delta.to(dtype), tn_flat)
            if step > 2 and not bool(ok):
                n_valid = 0

        if settings.damping != 0.0:
            f = settings.damping
            tx = torch.where(is_conv, tx, f * t_flat + (1.0 - f) * tx)

        t1 = tx[:n1].reshape(t1_0.shape)
        t2 = tx[n1:].reshape(t2_0.shape)
        E = En
        E_value, dE_value, converged, failed = (
            torch.stack([En, dE, is_conv.to(dtype), is_failed.to(dtype)]).tolist())
        converged, failed = bool(converged), bool(failed)
        if on_iteration is not None:
            on_iteration(step, E_value, dE_value, time.perf_counter() - start)
        step += 1

    _, E_s, E_c, E_d = energy_fn(t1, t2)
    return (step - 1, converged, failed, float(E), t1, t2,
            tuple(torch.stack([E_s, E_c, E_d]).tolist()))


def _initial_print(E_MP2, method, calculation, silent):
    log_spacer(calculation, silent=silent, start="\n")
    log(f"              {method.name:>5} Energy and Density ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log(f"  Energy convergence tolerance:        {calculation.energy_convergence:.10f}", calculation, 1, silent=silent)
    log(f"  Amplitude convergence tolerance:     {calculation.amp_conv:.10f}", calculation, 1, silent=silent)

    log(f"\n  Guess t-amplitude MP2 energy:       {E_MP2:.10f}\n", calculation, 1, silent=silent)
    if calculation.correlated_damping_parameter != 0:
        log(f"  Using damping parameter of {calculation.correlated_damping_parameter:.2f} for convergence.", calculation, 1, silent=silent)
    if calculation.DIIS:
        log(f"  Using DIIS, storing {calculation.max_DIIS_matrices} matrices, for convergence.", calculation, 1, silent=silent)
    log(f"\n  Starting {method.name} iterations...\n", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Step          Correlation E               DE", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)


def calculate_coupled_cluster_energy(g, o, v, t_amplitudes, e_denominators, F,
                                     method, calculation, silent, SCF_output, integrals):
    """Solve the amplitude equations for one iterative method, restricted
    or (on a UHF reference) spin-orbital; CCSDT, CISDT and CCSDTQ go to
    post/cc_triples.py.  t_amplitudes and e_denominators hold ranks 1-4
    (None where a method has no such rank).

    Returns (E_CC, (t1, t2, t3, t4), per-iteration wall seconds)."""
    original_name = method.name
    base_name = method.name
    for tag in ("[T]", "[Q]", "(T)", "(Q)"):
        base_name = base_name.split(tag)[0]
    if base_name in ("CCSDT", "CISDT", "CCSDTQ"):
        from .cc_triples import solve_triples_method
        return solve_triples_method(g, o, v, t_amplitudes, e_denominators, F, method,
                                    base_name, calculation, silent, SCF_output, integrals)
    restricted = calculation.reference == "RHF"
    if base_name not in (_RESTRICTED_UPDATES if restricted else _UNRESTRICTED_UPDATES):
        error(f"The {base_name} method is not yet ported to tuna_tpu_torch!")

    t_ia, t_ijab = t_amplitudes[:2]
    d1, d2 = e_denominators[:2]
    settings = CCSettings(
        method=base_name,
        restricted=restricted,
        update_singles=base_name not in _NO_SINGLES,
        keep_disconnected=base_name not in _NO_DISCONNECTED,
        n_occ=o.stop - (o.start or 0),
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter),
    )
    # Frozen-core slices start at o.start; shift to local indexing.
    if (o.start or 0) != 0:
        g = g[o.start:, o.start:, o.start:, o.start:]
        F = F[o.start:, o.start:]

    iteration_seconds = []

    def on_iteration(step, E, dE, seconds):
        log(f"  {step:3.0f}           {E:13.10f}         {dE:13.10f}",
            calculation, 1, silent=silent)
        iteration_seconds.append(seconds)

    n_steps, converged, failed, E_CC, t1, t2, parts = solve_amplitudes(
        settings, g, F, d1, d2, t_ia, t_ijab, calculation.energy_convergence,
        calculation.amp_conv,
        on_start=lambda e_guess: _initial_print(e_guess, method, calculation, silent),
        on_iteration=on_iteration)

    if failed:
        error(f'Non-finite encountered in {base_name} iteration. Try stronger '
              'damping with the "CORRDAMP" keyword?.')
    if not converged:
        error(f"The {base_name} iterations failed to converge! Try increasing "
              "the maximum iterations with CORRMAXITER?")

    E_singles, E_connected, E_disconnected = parts
    log_spacer(calculation, silent=silent)
    log(f"\n  Singles contribution:               {E_singles:13.10f}", calculation, 1, silent=silent)
    log(f"  Connected doubles contribution:     {E_connected:13.10f}", calculation, 1, silent=silent)
    log(f"  Disconnected doubles contribution:  {E_disconnected:13.10f}", calculation, 1, silent=silent)
    log(f"\n  {base_name} correlation energy:  {' ' * (10 - len(base_name))}    {E_CC:.10f}",
        calculation, 1, silent=silent)
    method.name = original_name
    return E_CC, (t1, t2, *t_amplitudes[2:]), iteration_seconds


# ---------------------------------------------------------------------------
# Perturbative triples
# ---------------------------------------------------------------------------

def _restricted_T_tensors(g_oovv, g_ovvv, g_oovo, t1, t2, d3):
    """Spin-adapted (T): disconnected V, connected W and its weighted form
    (plain version; the signature of tuna_tpu's, d3 unused)."""
    V = (torch.einsum("jkbc,ia->ijkabc", g_oovv, t1)
         + torch.einsum("ikac,jb->ijkabc", g_oovv, t1)
         + torch.einsum("ijab,kc->ijkabc", g_oovv, t1))

    raw = (torch.einsum("ibaf,kjcf->ijkabc", g_ovvv, t2)
           - torch.einsum("ijam,mkbc->ijkabc", g_oovo, t2))
    W = (raw + raw.permute(1, 0, 2, 4, 3, 5) + raw.permute(2, 1, 0, 5, 4, 3)
         + raw.permute(0, 2, 1, 3, 5, 4) + raw.permute(2, 0, 1, 5, 3, 4)
         + raw.permute(1, 2, 0, 4, 5, 3))
    W_weighted = (4.0 * W + W.permute(2, 0, 1, 3, 4, 5) + W.permute(1, 2, 0, 3, 4, 5)
                  - 4.0 * W.permute(2, 1, 0, 3, 4, 5) - W.permute(0, 2, 1, 3, 4, 5)
                  - W.permute(1, 0, 2, 3, 4, 5))
    return V, W, W_weighted


def _ccsd_t_energy_plain(g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale):
    no = t1.shape[0]
    e_ijkabc = transforms.triples_epsilons(torch.cat([eps_o, eps_v]), slice(0, no),
                                           slice(no, None))
    V, W, W_weighted = _restricted_T_tensors(g_oovv, g_ovvv, g_oovo, t1, t2, e_ijkabc)
    V = V * v_scale
    return (1.0 / 3.0) * torch.einsum("ijkabc,ijkabc,ijkabc->", W + V, W_weighted, e_ijkabc)


# K2 (csrc/ccsd_t.cu) computes R_ijk[abc] once for each distinct ordering of
# each occupied multiset {i <= j <= k} into a workspace, a batch of multisets
# at a time, then the energy of the batch from it.  The workspace of a batch
# stays under TRIPLES_WORKSPACE_BYTES (tests lower it to force many batches).
# A multiset whose orderings need more than the cap (6 v^3 doubles > 128 MB
# at v > 149) is cut into batches of its own over ranges of a, the least
# virtual of an orbit: triples_slot_doubles.  Fewer, larger batches run
# faster on the H100 (PERF.md): 128 MB.
TRIPLES_WORKSPACE_BYTES = 128 * 2 ** 20
# the six orderings of three positions, in csrc/ccsd_t.cu's order
TRIPLES_ORDERINGS = ((0, 1, 2), (1, 0, 2), (2, 1, 0), (0, 2, 1), (1, 2, 0), (2, 0, 1))
_TRIPLES_THREADS = 128   # stage-B threads a block of csrc/ccsd_t.cu
_ORBIT_BITS = 21         # bits of each virtual in a packed orbit


def triples_slot_doubles(nv: int, a_begin: int, a_end: int) -> int:
    """Doubles of R that one ordering needs for the orbits a <= b <= c with
    a in [a_begin, a_end): every (x, y, z) whose least index lies in the
    range, (v - a_begin)^3 - (v - a_end)^3 of them, stored as three boxes
    (csrc/ccsd_t.cu)."""
    return (nv - a_begin) ** 3 - (nv - a_end) ** 3


def triples_plan(no: int, nv: int, cap_bytes: int):
    """The batches of K2 for o = no, v = nv: (batches, slots, multisets), int32.

    slots (n_slots, 3) lists the distinct orderings (i, j, k) of every
    multiset, batch after batch; multisets (n_multisets, 9) holds each
    multiset's (i, j, k) and the slot, counted from its batch's first slot,
    of its ordering q for q in TRIPLES_ORDERINGS; batches (n_batches, 6) the
    slot range, the multiset range and the range of a of each batch.
    Multisets join a batch over all of a while its slots hold at most
    cap_bytes of R; a multiset that alone needs more takes batches of its
    own, each over the widest range of a that fits (one a at least)."""
    batches, slots, multisets = [], [], []
    slot_begin = multiset_begin = 0
    a_ranges: dict = {}   # the ranges of a of a multiset cut over a, by its orderings

    def cut(n_orderings):
        ranges, a_begin = [], 0
        while a_begin < nv:
            a_end = a_begin + 1
            while (a_end < nv and 8 * n_orderings
                   * triples_slot_doubles(nv, a_begin, a_end + 1) <= cap_bytes):
                a_end += 1
            ranges.append((a_begin, a_end))
            a_begin = a_end
        return ranges

    def close(ranges=((0, nv),)):
        nonlocal slot_begin, multiset_begin
        if len(slots) > slot_begin:
            batches.extend((slot_begin, len(slots), multiset_begin, len(multisets), *a_range)
                           for a_range in ranges)
        slot_begin, multiset_begin = len(slots), len(multisets)

    for i in range(no):
        for j in range(i, no):
            for k in range(j, no):
                orderings = [tuple((i, j, k)[d] for d in q) for q in TRIPLES_ORDERINGS]
                distinct = list(dict.fromkeys(orderings))
                whole = 8 * len(distinct) * nv ** 3 <= cap_bytes
                grown = len(slots) - slot_begin + len(distinct)
                if not whole or 8 * grown * nv ** 3 > cap_bytes:
                    close()
                first = len(slots) - slot_begin
                slots.extend(distinct)
                multisets.append((i, j, k, *(first + distinct.index(q) for q in orderings)))
                if not whole:
                    if len(distinct) not in a_ranges:
                        a_ranges[len(distinct)] = cut(len(distinct))
                    close(a_ranges[len(distinct)])
    close()
    as_array = lambda rows, width: np.array(rows, dtype=np.int32).reshape(-1, width)
    return as_array(batches, 6), as_array(slots, 3), as_array(multisets, 9)


def triples_orbits(nv: int) -> tuple[np.ndarray, np.ndarray]:
    """(orbits, start): the virtual triples a <= b <= c, a slowest and c
    fastest, packed a | b << 21 | c << 42 (int64), and the index of the
    first orbit of each a, start[nv] = the number of orbits (int32)."""
    parts = []
    for a in range(nv):
        b, c = np.triu_indices(nv - a)
        parts.append(a | (a + b) << _ORBIT_BITS | (a + c) << 2 * _ORBIT_BITS)
    sizes = [len(part) for part in parts]
    orbits = np.concatenate(parts).astype(np.int64) if parts else np.zeros(0, dtype=np.int64)
    return orbits, np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)]).astype(np.int32)


# per (o, v, device): the cap it was planned for, then what
# _triples_tables_on returns
_triples_tables: dict = {}


def _triples_tables_on(no: int, nv: int, device):
    """triples_plan at TRIPLES_WORKSPACE_BYTES and triples_orbits, cached per
    shape: the host batches (n_batches, 8), each row extended by its range
    of orbits; the device slots, multisets and orbits; the workspace's
    doubles; the stage-B blocks of all batches."""
    key = (no, nv, str(device))
    entry = _triples_tables.get(key)
    if entry is None or entry[0] != TRIPLES_WORKSPACE_BYTES:
        batches, slots, multisets = triples_plan(no, nv, TRIPLES_WORKSPACE_BYTES)
        orbits, start = triples_orbits(nv)
        batches = np.ascontiguousarray(np.concatenate([batches, start[batches[:, 4:6]]], axis=1))
        workspace_doubles = max(
            (slot_end - slot_begin) * triples_slot_doubles(nv, a_begin, a_end)
            for slot_begin, slot_end, _, _, a_begin, a_end, _, _ in batches.tolist())
        items = ((batches[:, 3] - batches[:, 2]).astype(np.int64)
                 * (batches[:, 7] - batches[:, 6]).astype(np.int64))
        n_blocks = int(np.sum((items + _TRIPLES_THREADS - 1) // _TRIPLES_THREADS))
        entry = _triples_tables[key] = (
            TRIPLES_WORKSPACE_BYTES, batches, torch.as_tensor(slots, device=device),
            torch.as_tensor(multisets, device=device), torch.as_tensor(orbits, device=device),
            workspace_doubles, n_blocks)
    return entry[1:]


def ccsd_t_energy(g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale=1.0):
    """The restricted (T) energy (a 0-d tensor) from <oo|vv>, <ov|vv>,
    <oo|vo>, the amplitudes and the orbital energies: the K2 kernel on CUDA
    tensors, the plain version on CPU tensors.  v_scale multiplies the
    disconnected term (1 for CCSD[T], 2 for QCISD[T])."""
    device = t2.device
    if device.type == "cpu":
        return _ccsd_t_energy_plain(g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale)
    if device.type != "cuda":
        raise ValueError(f"no (T) energy for device {device}")
    no, nv = t1.shape
    for name, tensor, shape in (
            ("g_oovv", g_oovv, (no, no, nv, nv)), ("g_ovvv", g_ovvv, (no, nv, nv, nv)),
            ("g_oovo", g_oovo, (no, no, nv, no)), ("t1", t1, (no, nv)),
            ("t2", t2, (no, no, nv, nv)), ("eps_o", eps_o, (no,)), ("eps_v", eps_v, (nv,))):
        _kernels.check_tensor(name, tensor, shape, _F64, device)
    if no == 0 or nv == 0:
        return torch.zeros((), dtype=_F64, device=device)
    batches, slots, multisets, orbits, workspace_doubles, n_blocks = _triples_tables_on(
        no, nv, device)
    workspace = torch.empty(workspace_doubles, dtype=_F64, device=device)
    partial = torch.empty(n_blocks, dtype=_F64, device=device)
    _kernels.launch("ccsd_t_energy", "tuna_ccsd_t_energy", device, no, nv,
                    len(batches), batches.ctypes.data, slots.data_ptr(), multisets.data_ptr(),
                    orbits.data_ptr(), g_oovv.data_ptr(), g_ovvv.data_ptr(),
                    g_oovo.data_ptr(), t1.data_ptr(), t2.data_ptr(), eps_o.data_ptr(),
                    eps_v.data_ptr(), float(v_scale), workspace.data_ptr(), partial.data_ptr())
    return torch.sum(partial) / 3.0


def restricted_CCSD_T(g, epsilons, t_ia, t_ijab, o, v, method, calculation, silent):
    """(T) via the spin-adapted Lee formulation (ref: tuna_cc.py:2688-2758)."""
    method.name = method.name.replace("[", "(").replace("]", ")")
    log_spacer(calculation, silent=silent, start="\n")
    log(f"                    {method.name} Energy ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    space = "" if "QCISD" in method.name else " "
    log("  Forming disconnected amplitudes...         ", calculation, 1, end="", silent=silent)
    log("[Done]", calculation, 1, silent=silent)
    log("  Forming connected amplitudes...            ", calculation, 1, silent=silent)

    log(f"\n  Calculating {method.name} correlation energy... {space}", calculation, 1, end="", silent=silent)
    E_T = float(ccsd_t_energy(
        g[o, o, v, v].contiguous(), g[o, v, v, v].contiguous(), g[o, o, v, o].contiguous(),
        t_ia.contiguous(), t_ijab.contiguous(), epsilons[o].contiguous(),
        epsilons[v].contiguous(), 2.0 if "QCISD" in method.name else 1.0))
    log(f"[Done]\n\n  {method.name} correlation energy:       {space} {E_T:13.10f}",
        calculation, 1, silent=silent)
    return E_T


# The spin-orbital (T): K2u (csrc/ccsd_t_u.cu) and its plain version sum
# only the unique i < j < k, a < b < c, each standing for the 36 orderings
# that A(conn) and A(disc), antisymmetric in (ijk) and (abc), make equal.
# K2u forms X_ijk[a, (b < c)] = P(i/jk) conn_ijk for a batch of triples at a
# time into a workspace under U_TRIPLES_WORKSPACE_BYTES (at least one
# triple's v C(v, 2) doubles; tests lower it to force many batches).
U_TRIPLES_WORKSPACE_BYTES = 128 * 2 ** 20
# the three occupied orderings of P(i/jk), positions of (i, j, k) in (r, p,
# q) of conn_rpq[abc] = t2[pqae] <er||bc> - t2[rmbc] <ma||pq>, and signs
_U_ORDERINGS = (((0, 1, 2), 1.0), ((1, 0, 2), -1.0), ((2, 1, 0), -1.0))


def unique_triples(n: int) -> np.ndarray:
    """(C(n, 3), 3) int32: every i < j < k, i slowest and k fastest."""
    parts = []
    for i in range(n):
        j, k = np.triu_indices(n - i - 1, 1)
        parts.append(np.stack([np.full(len(j), i), i + 1 + j, i + 1 + k], axis=1))
    return (np.concatenate(parts) if parts else np.zeros((0, 3))).astype(np.int32)


def u_triples_plan(no: int, nv: int, cap_bytes: int) -> np.ndarray:
    """The batches of K2u for o = no, v = nv: (n_batches, 2) int32, the
    range of unique occupied triples of each, as many a batch as fit the
    cap with v C(v, 2) doubles a triple (one at least)."""
    n_triples = no * (no - 1) * (no - 2) // 6
    per_batch = max(1, cap_bytes // (8 * nv * (nv * (nv - 1) // 2))) if nv > 1 else n_triples
    starts = np.arange(0, n_triples, max(per_batch, 1))
    return np.stack([starts, np.minimum(starts + per_batch, n_triples)], axis=1).astype(np.int32)


# per (o, v, device): the cap it was planned for, then what
# _u_triples_tables_on returns
_u_triples_tables: dict = {}


def u_triples_pair_offsets(nv: int) -> np.ndarray:
    """(C(v, 2),) int32: b v + c for each pair b < c in K2u's row-major
    order of pairs, the offset of the pair in a (v, v) block; K2u's stage A
    reads its right operand along these runs of c."""
    b, c = np.triu_indices(nv, 1)
    return (b * nv + c).astype(np.int32)


def _u_triples_tables_on(no: int, nv: int, device):
    """u_triples_plan at U_TRIPLES_WORKSPACE_BYTES with the device's triples,
    pair offsets (u_triples_pair_offsets) and orbits a < b < c (packed as
    K2's), cached per shape: the host batches, the device tables, the
    workspace's doubles and the stage-B blocks of all batches."""
    key = (no, nv, str(device))
    entry = _u_triples_tables.get(key)
    if entry is None or entry[0] != U_TRIPLES_WORKSPACE_BYTES:
        batches = u_triples_plan(no, nv, U_TRIPLES_WORKSPACE_BYTES)
        triples = unique_triples(no)
        pair_offsets = u_triples_pair_offsets(nv)
        a, b, c = unique_triples(nv).astype(np.int64).T
        orbits = a | b << _ORBIT_BITS | c << 2 * _ORBIT_BITS
        per_batch = batches[:, 1] - batches[:, 0]
        n_blocks = int(np.sum((per_batch.astype(np.int64) * len(orbits) + _TRIPLES_THREADS - 1)
                              // _TRIPLES_THREADS))
        entry = _u_triples_tables[key] = (
            U_TRIPLES_WORKSPACE_BYTES, np.ascontiguousarray(batches),
            torch.as_tensor(triples, device=device), torch.as_tensor(pair_offsets, device=device),
            torch.as_tensor(orbits, device=device),
            int(per_batch.max(initial=0)) * nv * len(pair_offsets), n_blocks)
    return entry[1:]


def _uccsd_t_energy_plain(g_oovv, g_vovv, g_ovoo, t1, t2, eps_o, eps_v, v_scale=1.0):
    """K2u's sum in torch.einsum, over blocks of unique occupied triples of
    at most U_TRIPLES_WORKSPACE_BYTES of X (v^3 a triple), never o^3 v^3."""
    no, nv = t1.shape
    device = t1.device
    total = torch.zeros((), dtype=_F64, device=device)
    if no < 3 or nv < 3:
        return total
    triples = torch.as_tensor(unique_triples(no), dtype=torch.long, device=device)
    a, b, c = torch.as_tensor(unique_triples(nv), dtype=torch.long, device=device).T
    block = max(1, U_TRIPLES_WORKSPACE_BYTES // (8 * nv ** 3))
    for start in range(0, len(triples), block):
        ijk = triples[start:start + block]
        X = 0.0
        for positions, sign in _U_ORDERINGS:
            r, p, q = (ijk[:, d] for d in positions)
            conn = (torch.einsum("tae,tebc->tabc", t2[p, q], g_vovv[:, r].transpose(0, 1))
                    - torch.einsum("tma,tmbc->tabc", g_ovoo[:, :, p, q].permute(2, 0, 1), t2[r]))
            X = X + sign * conn
        A_conn = X[:, a, b, c] - X[:, b, a, c] - X[:, c, b, a]
        i, j, k = ijk.T
        o3, v3 = (i, j, k), (a, b, c)
        A_disc = 0.0
        for x in range(3):
            x1, x2 = (1, 2) if x == 0 else (0, 2) if x == 1 else (0, 1)
            for u in range(3):
                u1, u2 = (1, 2) if u == 0 else (0, 2) if u == 1 else (0, 1)
                term = (t1[o3[x]][:, v3[u]]
                        * g_oovv[o3[x1], o3[x2]][:, v3[u1], v3[u2]])
                A_disc = A_disc + (term if (x + u) % 2 == 0 else -term)
        D = ((eps_o[i] + eps_o[j] + eps_o[k])[:, None]
             - (eps_v[a] + eps_v[b] + eps_v[c])[None, :])
        total = total + torch.sum(A_conn * (A_conn + v_scale * A_disc) / D)
    return total


def u_triples_ovoo_transposed(g_ovoo):
    """<m a || p q> (o, v, o, o) as [p][q][a][m], contiguous: the integral
    part of K2u's left operand, [t2[p, q, a, :] | -<: a || p q>], then runs
    along m as the t2 part runs along e."""
    return g_ovoo.permute(2, 3, 1, 0).contiguous()


def uccsd_t_energy(g_oovv, g_vovv, g_ovoo, t1, t2, eps_o, eps_v, v_scale=1.0):
    """The spin-orbital (T) energy (a 0-d tensor) from <oo||vv>, <vo||vv>,
    <ov||oo>, the amplitudes and the orbital energies: the K2u kernel on
    CUDA tensors, the plain version on CPU tensors.  v_scale multiplies the
    disconnected term (1 for CCSD[T], 2 for QCISD[T])."""
    device = t2.device
    if device.type == "cpu":
        return _uccsd_t_energy_plain(g_oovv, g_vovv, g_ovoo, t1, t2, eps_o, eps_v, v_scale)
    if device.type != "cuda":
        raise ValueError(f"no (T) energy for device {device}")
    no, nv = t1.shape
    for name, tensor, shape in (
            ("g_oovv", g_oovv, (no, no, nv, nv)), ("g_vovv", g_vovv, (nv, no, nv, nv)),
            ("g_ovoo", g_ovoo, (no, nv, no, no)), ("t1", t1, (no, nv)),
            ("t2", t2, (no, no, nv, nv)), ("eps_o", eps_o, (no,)), ("eps_v", eps_v, (nv,))):
        _kernels.check_tensor(name, tensor, shape, _F64, device)
    if no < 3 or nv < 3:   # no unique triple i < j < k or a < b < c
        return torch.zeros((), dtype=_F64, device=device)
    batches, triples, pair_offsets, orbits, workspace_doubles, n_blocks = _u_triples_tables_on(
        no, nv, device)
    g_ovoo_t = u_triples_ovoo_transposed(g_ovoo)
    workspace = torch.empty(workspace_doubles, dtype=_F64, device=device)
    partial = torch.empty(n_blocks, dtype=_F64, device=device)
    _kernels.launch("uccsd_t_energy", "tuna_uccsd_t_energy", device, no, nv, len(batches),
                    batches.ctypes.data, triples.data_ptr(), pair_offsets.data_ptr(),
                    orbits.data_ptr(), g_oovv.data_ptr(), g_vovv.data_ptr(),
                    g_ovoo_t.data_ptr(), t1.data_ptr(), t2.data_ptr(), eps_o.data_ptr(),
                    eps_v.data_ptr(), float(v_scale), workspace.data_ptr(), partial.data_ptr())
    return torch.sum(partial)


def unrestricted_CCSD_T(g, epsilons, t_ia, t_ijab, o, v, method, calculation, silent):
    """(T) via the spin-orbital formulation (ref: tuna_cc.py:2769-2837)."""
    method.name = method.name.replace("[", "(").replace("]", ")")
    log_spacer(calculation, silent=silent, start="\n")
    log(f"                   {method.name} Energy  ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)

    space = "" if "QCISD" in method.name else " "
    log("  Forming disconnected amplitudes...         ", calculation, 1, silent=silent)
    log("  Forming connected amplitudes...            ", calculation, 1, silent=silent)
    E_T = float(uccsd_t_energy(
        g[o, o, v, v].contiguous(), g[v, o, v, v].contiguous(), g[o, v, o, o].contiguous(),
        t_ia.contiguous(), t_ijab.contiguous(), epsilons[o].contiguous(),
        epsilons[v].contiguous(), 2.0 if "QCISD" in method.name else 1.0))
    log(f"\n  Calculating {method.name} correlation energy... {space}[Done]",
        calculation, 1, silent=silent)
    log(f"\n  {method.name} correlation energy:       {space} {E_T:13.10f}",
        calculation, 1, silent=silent)
    return E_T


# ---------------------------------------------------------------------------
# Perturbative quadruples: K9
# ---------------------------------------------------------------------------
# tuna_tpu's restricted_CCSDT_Q forms t4 = e * G/2 with G the sum of six raw
# terms symmetrised over the 24 simultaneous permutations sigma of (ijkl)
# and (abcd), then E_MP5 and E_MP6 from t4 and o^4 v^4 intermediates.  Both
# energies are linear in t4, E = sum t4 Z, and t4 is symmetric under every
# sigma, so with the occupied quadruple x = (i, j, k, l) of a multiset
# {i <= j <= k <= l}, its distinct orderings x.tau and y.sigma the virtuals
# permuted alike ((y.sigma)_p = y_sigma(p)):
#
#   E = 1/2 sum_multisets sum_y e[x, y] Gsym[y] Zsym[y],
#   Gsym[y] = sum_sigma Graw[x.sigma, y.sigma],
#   Zsym[y] = sum_distinct tau Z[x.tau, y.tau].
#
# Z takes the MP5 products u2 K and u2 L and, for MP6, alpha and beta of
# the same ordering at seven permutations of their virtuals (t_bar's and
# t_tilde's permutations moved onto them; t_tilde's (i, j, l, k) ordering
# is t4's own by its symmetry).  So a multiset needs, for each distinct
# ordering (a slot), three v^4 blocks -- Graw, alpha, beta -- and never
# anything o^4 v^4.  Permuting y keeps min(y), so the sum also splits over
# ranges [a0, a1) of min(y), and a slot then needs those blocks only at the
# y with min(y) in the range.  K9 (csrc/ccsdt_q.cu) and its plain version
# run the same plan: for each range, batches of whole multisets whose slots
# fit QUADRUPLES_WORKSPACE_BYTES, or, for a multiset with more slots than
# fit, batches of its own over ranges of its slots, with Gsym and the two
# Zsym carried from one batch to the next (tests lower the cap to force
# both cuts).
QUADRUPLES_WORKSPACE_BYTES = 128 * 2 ** 20
# sigma(p) for p = 0..3, in csrc/ccsdt_q.cu's order
QUADRUPLES_PERMUTATIONS = tuple(itertools.permutations(range(4)))


def quadruples_cut(no: int, nv: int, a0: int, a1: int) -> tuple[int, int]:
    """(elements, doubles a slot) of K9 for the range [a0, a1) of min(y):
    the (a, b, c, d) with min in the range, (v - a0)^4 - (v - a1)^4, and
    what a slot stores there -- Graw, alpha and beta at those elements and
    X, Y, V (o v^2 each): the boxes of csrc/ccsdt_q.cu's Cut, box p with
    positions q < p over [a1, v), p over [a0, a1) and q > p over [a0, v).
    A carried multiset takes 3 elements more."""
    elements = 0
    for p in range(4):
        n0, n1, n2, n3 = [nv - a1] * p + [a1 - a0] + [nv - a0] * (3 - p)
        elements += n0 * n1 * n2 * n3
    return elements, 3 * elements + 3 * no * nv * nv


QUADRUPLES_TILE = 4   # csrc/ccsdt_q.cu's kTile: energy tiles up to 4 along each axis


def quadruples_tiles(nv: int, a0: int, a1: int) -> np.ndarray:
    """The energy tiles of K9 for the range [a0, a1) of min(y), in
    csrc/ccsdt_q.cu's order (Cut::tile_offset and tile_at): (n_tiles, 9)
    int32, the box and each axis's start and extent.  Box p's axis q runs
    over [a1, v) for q < p, [a0, a1) for q = p and [a0, v) for q > p, cut at
    a1 into a part below and a part above; each part is tiled by
    QUADRUPLES_TILE from its start, the last tile ragged; tiles run box
    after box, the last axis fastest.  No tile crosses a1, so every
    permutation of a tile lies in one box of a slot."""
    T = QUADRUPLES_TILE
    rows = []
    for p in range(4):
        axes = []
        for q in range(4):
            lo, hi = (a1, nv) if q < p else ((a0, a1) if q == p else (a0, nv))
            mid = a1 if q > p else hi
            axes.append([(start, min(T, end - start)) for begin, end in ((lo, mid), (mid, hi))
                         for start in range(begin, end, T)])
        for tile in itertools.product(*axes):
            rows.append((p, *(start for start, _ in tile), *(extent for _, extent in tile)))
    return np.array(rows, dtype=np.int32).reshape(-1, 9)


def quadruples_plan(no: int, nv: int, cap_bytes: int):
    """The batches of K9 for o = no, v = nv: (batches, slots, multisets),
    int32.

    slots (n_slots, 4) lists the distinct orderings (i, j, k, l) of every
    multiset, multiset after multiset; multisets (n_multisets, 29) holds
    each multiset's (i, j, k, l), the slot of its ordering x.sigma for
    sigma in QUADRUPLES_PERMUTATIONS, and a mask with bit sigma set where
    sigma is the first permutation to reach its slot; batches (n_batches, 8)
    the slot range, the multiset range, two flags -- the batch starts its
    multisets (1) or carries one on, and it ends them (1) or passes one on
    -- and the range [a0, a1) of min(y), range after range.  A range is as
    wide as fits one slot and a carry in cap_bytes (one value of a at
    least); a batch of whole multisets holds as many slots as fit the cap,
    a piece of a cut multiset as many as fit beside its carry (one at
    least).  So the workspace stays under the cap while one slot of one
    value of a and its carry fit it: up to v = 88 at o = 7 and 128 MB;
    above, it is that minimum (215 MB at v = 104, 0.65 GB at v = 150)."""
    cap = cap_bytes // 8

    def fits(a0, a1):
        elements, slot = quadruples_cut(no, nv, a0, a1)
        return 3 * elements + slot <= cap

    slots, multisets, spans = [], [], []
    for quadruple in itertools.combinations_with_replacement(range(no), 4):
        orderings = [tuple(quadruple[p] for p in sigma) for sigma in QUADRUPLES_PERMUTATIONS]
        distinct = list(dict.fromkeys(orderings))
        first = len(slots)
        slots.extend(distinct)
        spans.append((first, len(slots)))
        mask = sum(1 << s for s, ordering in enumerate(orderings)
                   if orderings.index(ordering) == s)
        multisets.append((*quadruple, *(first + distinct.index(q) for q in orderings), mask))
    batches = []
    a0 = 0
    while a0 < nv:
        # the widest that fits (W's and U's boxes make the size not monotonic in a1)
        a1 = max((b for b in range(a0 + 2, nv + 1) if fits(a0, b)), default=a0 + 1)
        elements, slot = quadruples_cut(no, nv, a0, a1)
        capacity = max(1, cap // slot)
        piece = max(1, (cap - 3 * elements) // slot)
        open_slot = open_multiset = 0
        for m, (s0, s1) in enumerate(spans):
            if s1 - open_slot > capacity:
                if m > open_multiset:
                    batches.append((open_slot, s0, open_multiset, m, 1, 1, a0, a1))
                open_slot, open_multiset = s0, m
            if s1 - s0 > capacity:
                for begin in range(s0, s1, piece):
                    end = min(begin + piece, s1)
                    batches.append((begin, end, m, m + 1, int(begin == s0), int(end == s1),
                                    a0, a1))
                open_slot, open_multiset = s1, m + 1
        if len(multisets) > open_multiset:
            batches.append((open_slot, len(slots), open_multiset, len(multisets), 1, 1, a0, a1))
        a0 = a1
    as_array = lambda rows, width: np.array(rows, dtype=np.int32).reshape(-1, width)
    return as_array(batches, 8), as_array(slots, 4), as_array(multisets, 29)


def _quadruples_blocks(c, no):
    """The blocks of the correlated window's chemists' tensor (pq|rs) that
    (Q) reads, with K[ijab] = (ia|jb) and L = 2 K - K^T of its MP5 terms."""
    o, v = slice(0, no), slice(no, None)
    K = c[o, v, o, v].permute(0, 2, 1, 3)
    return {"ovvv": c[o, v, v, v], "ovoo": c[o, v, o, o], "oooo": c[o, o, o, o],
            "ovov": c[o, v, o, v], "vvvv": c[v, v, v, v], "vvoo": c[v, v, o, o],
            "K": K, "L": 2.0 * K - K.transpose(2, 3)}


def _quadruples_slot_blocks(B, t2, t3, i, j, k, l, a0):
    """Graw, alpha and beta, (S, w, w, w, w) each with w = v - a0, of the
    orderings (i[s], j[s], k[s], l[s]): the six raw terms of tuna_tpu's G
    and its MP6 alpha and beta, all at the ordering's own (a, b, c, d) in
    [a0, v)^4 (the summed virtual indices run over every v)."""
    f = slice(a0, None)
    t2_l = t2[:, l][:, :, f, f].transpose(0, 1)                       # s, m, x, y
    t3_ji = t3[:, j, i][:, :, f, f, f].transpose(0, 1)                # s, m, c, b, a
    X = torch.einsum("smn,smac->snac", B["oooo"].permute(1, 3, 0, 2)[i, j],
                     t2[:, k][:, :, f, f].transpose(0, 1))
    Y = torch.einsum("same,seb->samb", B["ovov"][i][:, f], t2[k, j][:, :, f])
    V = torch.einsum("sbem,sce->sbmc", B["vvoo"].permute(3, 0, 1, 2)[i][:, f],
                     t2[k, j][:, f])
    W = torch.einsum("cfae,seb->scfab", B["vvvv"][f, :, f], t2[i, j][:, :, f])
    G = (torch.einsum("sabe,secd->sabcd", B["ovvv"][i][:, f, f], t3[j, k, l][:, :, f, f])
         - torch.einsum("sam,smbcd->sabcd", B["ovoo"].permute(0, 3, 1, 2)[i, j][:, f],
                        t3[:, k, l][:, :, f, f, f].transpose(0, 1))
         + torch.einsum("snac,snbd->sabcd", X, t2_l)
         - 2.0 * torch.einsum("samb,smcd->sabcd", Y, t2_l)
         + torch.einsum("scfab,sfd->sabcd", W, t2[k, l][:, :, f])
         - 2.0 * torch.einsum("sbmc,smad->sabcd", V, t2_l))
    # S1 = sum_m t3[mjicba] (ld|km), S3 the same with (kd|lm); T1 = sum_e
    # t3[kjieba] (ld|ce), T2 = sum_e t3[ljieba] (kd|ce); S2, S4 are S1, S3
    # with c and d exchanged
    ovoo = B["ovoo"].permute(0, 2, 1, 3)                              # l, k, d, m
    S1 = torch.einsum("smcba,sdm->sabcd", t3_ji, ovoo[l, k][:, f])
    S3 = torch.einsum("smcba,sdm->sabcd", t3_ji, ovoo[k, l][:, f])
    ovvv = B["ovvv"][:, f, f]
    T1 = torch.einsum("seba,sdce->sabcd", t3[k, j, i][:, :, f, f], ovvv[l])
    T2 = torch.einsum("seba,sdce->sabcd", t3[l, j, i][:, :, f, f], ovvv[k])
    alpha = 2.0 * S1 - S1.transpose(3, 4) - 2.0 * T1 + T2
    beta = 2.0 * S3 - S3.transpose(3, 4) - 2.0 * T2 + T1
    return G, alpha, beta


def _quadruples_z(B, u2, alpha, beta, i, j, k, l, a0):
    """(Z5, Z6) of the orderings (i[s], j[s], k[s], l[s]) at their own (a, b,
    c, d) in [a0, v)^4: E_MP5 = sum t4 Z5 and E_MP6 = sum t4 Z6 over those
    orderings."""
    f = slice(a0, None)
    u_kl, K_ij, L_ij = u2[k, l][:, f, f], B["K"][i, j][:, f, f], B["L"][i, j][:, f, f]
    Z5 = (torch.einsum("sab,scd->sabcd", u_kl, K_ij)
          - 2.0 * torch.einsum("sbd,sac->sabcd", u_kl, L_ij)
          + torch.einsum("scd,sab->sabcd", u_kl, L_ij))
    at = lambda x, dims: x.permute(0, *(1 + d for d in dims))
    Z6 = 2.0 * (-2.0 * alpha - at(alpha, (2, 3, 0, 1)) + at(alpha, (1, 0, 2, 3))
                + 2.0 * at(beta, (2, 1, 3, 0)) - at(beta, (2, 0, 3, 1))
                + 2.0 * at(beta, (3, 1, 0, 2)) - at(beta, (3, 0, 1, 2)))
    return Z5, Z6


def _ccsdt_q_energy_plain(c, t2, t3, eps_o, eps_v):
    """K9's sum in torch.einsum over the batches of quadruples_plan: the
    tensor (E_MP5, E_MP6) from the correlated window's chemists' (pq|rs),
    t2, the projected t3 and the orbital energies, never o^4 v^4.  A batch
    of the range [a0, a1) forms its blocks over [a0, v)^4 and sums the y
    with min(y) < a1."""
    no, nv = t2.shape[0], t2.shape[2]
    device = t2.device
    energies = torch.zeros(2, dtype=_F64, device=device)
    if no == 0 or nv == 0:
        return energies
    B = _quadruples_blocks(c, no)
    u2 = _u_of(t2)
    inverse = [tuple(int(np.argsort(sigma)[n]) for n in range(4))
               for sigma in QUADRUPLES_PERMUTATIONS]
    batches, slots, multisets = quadruples_plan(no, nv, QUADRUPLES_WORKSPACE_BYTES)
    carried = None
    for (slot_begin, slot_end, multiset_begin, multiset_end, first, last,
         a0, a1) in batches.tolist():
        i, j, k, l = torch.as_tensor(slots[slot_begin:slot_end].T.astype(np.int64),
                                     device=device)
        G, alpha, beta = _quadruples_slot_blocks(B, t2, t3, i, j, k, l, a0)
        Z5, Z6 = _quadruples_z(B, u2, alpha, beta, i, j, k, l, a0)
        del alpha, beta
        below = torch.arange(nv - a0, device=device) < a1 - a0
        in_range = (below[:, None, None, None] | below[None, :, None, None]
                    | below[None, None, :, None] | below[None, None, None, :])
        e_v = eps_v[a0:]
        eps_v4 = (e_v[:, None, None, None] + e_v[None, :, None, None]
                  + e_v[None, None, :, None] + e_v[None, None, None, :])
        for row in multisets[multiset_begin:multiset_end].tolist():
            sums = [0.0, 0.0, 0.0] if first else carried
            for s, dims in enumerate(inverse):
                slot = row[4 + s]
                if not slot_begin <= slot < slot_end:
                    continue
                sums[0] = sums[0] + G[slot - slot_begin].permute(dims)
                if row[28] >> s & 1:
                    sums[1] = sums[1] + Z5[slot - slot_begin].permute(dims)
                    sums[2] = sums[2] + Z6[slot - slot_begin].permute(dims)
            if not last:
                carried = sums
                continue
            weighted = torch.where(in_range, 0.5 * sums[0] / (eps_o[row[:4]].sum() - eps_v4),
                                   0.0)
            energies = energies + torch.stack([torch.sum(weighted * sums[1]),
                                               torch.sum(weighted * sums[2])])
    return energies


# per (o, v, device): the cap it was planned for, then what
# _quadruples_tables_on returns
_quadruples_tables: dict = {}


def _quadruples_tables_on(no: int, nv: int, device):
    """quadruples_plan at QUADRUPLES_WORKSPACE_BYTES, cached per shape: the
    host batches, the device slots and multisets, the workspace's doubles
    (the largest batch's slots, with its carry where it is a piece of a
    cut multiset), the energy blocks a multiset and the partials' doubles
    (two an energy block of each multiset of every batch that ends its
    multisets)."""
    key = (no, nv, str(device))
    entry = _quadruples_tables.get(key)
    if entry is None or entry[0] != QUADRUPLES_WORKSPACE_BYTES:
        batches, slots, multisets = quadruples_plan(no, nv, QUADRUPLES_WORKSPACE_BYTES)
        workspace = most = 0
        for slot_begin, slot_end, _, _, first, last, a0, a1 in batches.tolist():
            elements, slot = quadruples_cut(no, nv, a0, a1)
            carry = 0 if first and last else 3 * elements
            workspace = max(workspace, carry + (slot_end - slot_begin) * slot)
        for a0, a1 in dict.fromkeys(map(tuple, batches[:, 6:].tolist())):
            most = max(most, len(quadruples_tiles(nv, a0, a1)))
        # about four tiles a block, 1024 blocks at most; any count is
        # right, the kernel strides over the tiles
        energy_blocks = max(1, min(1024, -(-most // 4)))
        ends = batches[:, 5] == 1
        n_partials = 2 * energy_blocks * int(np.sum(batches[ends, 3] - batches[ends, 2]))
        entry = _quadruples_tables[key] = (
            QUADRUPLES_WORKSPACE_BYTES, np.ascontiguousarray(batches),
            torch.as_tensor(slots, device=device), torch.as_tensor(multisets, device=device),
            workspace, energy_blocks, n_partials)
    return entry[1:]


def quadruples_operands(c, t3, no: int):
    """The layouts K9's raw stage reads along runs, from the window's
    chemists' c and t3: (ia|be) as [i][a][b][e], (ld|ce) as [l][c][e][d],
    (ld|km) as [l][k][m][d] and t3[mjicba] as [j][i][a][m][c][b]."""
    cov = c[:no, no:, no:, no:].contiguous()
    return (cov, cov.permute(0, 2, 3, 1).contiguous(),
            c[:no, no:, :no, :no].permute(0, 2, 3, 1).contiguous(),
            t3.permute(1, 2, 5, 0, 3, 4).contiguous())


def ccsdt_q_energy(c, t2, t3, eps_o, eps_v):
    """The (Q) energies, a tensor (E_MP5, E_MP6), from the correlated
    window's chemists' tensor c = (pq|rs) (n = o + v a side), t2, the
    projected t3 and the orbital energies: the K9 kernel on CUDA tensors,
    the plain version on CPU tensors."""
    device = t2.device
    if device.type == "cpu":
        return _ccsdt_q_energy_plain(c, t2, t3, eps_o, eps_v)
    if device.type != "cuda":
        raise ValueError(f"no (Q) energy for device {device}")
    no, nv = t2.shape[0], t2.shape[2]
    n = no + nv
    for name, tensor, shape in (
            ("c", c, (n, n, n, n)), ("t2", t2, (no, no, nv, nv)),
            ("t3", t3, (no, no, no, nv, nv, nv)), ("eps_o", eps_o, (no,)),
            ("eps_v", eps_v, (nv,))):
        _kernels.check_tensor(name, tensor, shape, _F64, device)
    if no == 0 or nv == 0:
        return torch.zeros(2, dtype=_F64, device=device)
    batches, slots, multisets, workspace_doubles, energy_blocks, n_partials = (
        _quadruples_tables_on(no, nv, device))
    cov, cvt, clk, t3t = quadruples_operands(c, t3, no)
    workspace = torch.empty(workspace_doubles, dtype=_F64, device=device)
    partial = torch.empty(n_partials, dtype=_F64, device=device)
    _kernels.launch("ccsdt_q_energy", "tuna_ccsdt_q_energy", device, no, nv, len(batches),
                    batches.ctypes.data, slots.data_ptr(), multisets.data_ptr(),
                    c.data_ptr(), cov.data_ptr(), cvt.data_ptr(), clk.data_ptr(),
                    t2.data_ptr(), t3.data_ptr(), t3t.data_ptr(), eps_o.data_ptr(),
                    eps_v.data_ptr(), energy_blocks, workspace.data_ptr(), workspace_doubles,
                    partial.data_ptr(), n_partials)
    return torch.sum(partial.view(-1, 2), dim=0)


def restricted_CCSDT_Q(g, epsilons, t_ijab, t_ijkabc, o, v, calculation, silent):
    """Perturbative quadruples, MP5 + MP6 form (ref: tuna_cc.py:2848-2939),
    through ccsdt_q_energy: g is the physicists' <pq|rs> of every orbital
    (spin orbitals on a UHF reference, where tuna_tpu applies the same
    formula), o and v slice its correlated occupied and virtual orbitals."""
    log_spacer(calculation, silent=silent, start="\n")
    log("                   CCSDT(Q) Energy ", calculation, 1, silent=silent)
    log_spacer(calculation, silent=silent)
    log("  Forming quadruples amplitudes...           ", calculation, 1, end="", silent=silent)
    window = slice(o.start or 0, None)
    c = g[window, window, window, window].transpose(1, 2).contiguous()
    E_MP5, E_MP6 = ccsdt_q_energy(c, t_ijab.contiguous(), t_ijkabc.contiguous(),
                                  epsilons[o].contiguous(), epsilons[v].contiguous()).tolist()
    log("[Done]", calculation, 1, silent=silent)
    log("\n  Calculating MP5 contribution to energy...  ", calculation, 1, end="", silent=silent)
    log("[Done]", calculation, 1, silent=silent)
    log("  Calculating MP6 contribution to energy...  ", calculation, 1, end="", silent=silent)
    E_Q = E_MP5 + E_MP6
    log("[Done]", calculation, 1, silent=silent)

    log(f"\n  Contribution from MP5:              {E_MP5:13.10f}", calculation, 2, silent=silent)
    log(f"  Contribution from MP6:              {E_MP6:13.10f}", calculation, 2, silent=silent)
    log(f"\n  CCSDT(Q) correlation energy:        {E_Q:13.10f}", calculation, 1, silent=silent)
    return E_Q
# ---------------------------------------------------------------------------

def _linearised_density_mo(t_ia, t_ijab, n_orbitals, n_occ, o_start, o_stop, rhf):
    # o/v address the correlated window of the full orbital space (o_start
    # is nonzero under FREEZECORE); P_ref fills every occupied orbital.
    o, v = slice(o_start, o_stop), slice(o_stop, None)
    P_CC = torch.zeros((n_orbitals, n_orbitals), dtype=t_ia.dtype, device=t_ia.device)
    if rhf:
        u_ijab = _u_of(t_ijab)
        P_CC[v, v] += torch.einsum("ijbc,ijac->ab", t_ijab, u_ijab)
        P_CC[o, o] += -torch.einsum("ikab,jkab->ij", t_ijab, u_ijab)
        P_CC[o, v] += t_ia + torch.einsum("ijab,jb->ia", u_ijab, t_ia)
    else:
        P_CC[v, v] += 0.5 * torch.einsum("ijbc,ijac->ab", t_ijab, t_ijab)
        P_CC[o, o] += -0.5 * torch.einsum("ikab,jkab->ij", t_ijab, t_ijab)
        P_CC[o, v] += t_ia + torch.einsum("ijab,jb->ia", t_ijab, t_ia)
    P_CC[v, o] = P_CC[o, v].T
    P_CC[v, v] += torch.einsum("ia,ib->ab", t_ia, t_ia)
    P_CC[o, o] += -torch.einsum("ia,ja->ij", t_ia, t_ia)

    P_ref = torch.zeros_like(P_CC)
    P_ref[:n_occ, :n_occ] = torch.eye(n_occ, dtype=P_CC.dtype, device=P_CC.device)
    return P_ref + P_CC


def linearised_density(t_ia, t_ijab, n_orbitals, n_occ, o, v, calculation,
                       molecular_orbitals, silent):
    """Linearised CC density in the AO basis: (P, P_alpha, P_beta); for a
    UHF reference from the spin-orbital density and coefficients."""
    log("\n  Constructing linearised density...    ", calculation, 1, end="", silent=silent)
    P = _linearised_density_mo(t_ia, t_ijab, int(n_orbitals), int(n_occ),
                               int(o.start or 0), int(o.stop), calculation.reference == "RHF")
    C = molecular_orbitals
    if calculation.reference == "UHF":
        P, P_alpha, P_beta = transforms.density_so_to_ao(P, C, int(n_orbitals))
    else:
        P = C @ (2 * P) @ C.T
        P_alpha = P_beta = P / 2
    log("     [Done]", calculation, 1, silent=silent)
    return P, P_alpha, P_beta


def T1_diagnostic(molecule, t_ia, spin_labels_sorted, n_occ, n_alpha, n_beta,
                  calculation, silent):
    t_ia = to_numpy(t_ia)
    if calculation.reference == "UHF":
        alpha_idx = [i for i, s in enumerate(spin_labels_sorted) if s == "a" and i < n_occ]
        beta_idx = [i for i, s in enumerate(spin_labels_sorted) if s == "b" and i < n_occ]
        alpha_idx = (np.array(alpha_idx[molecule.n_core_alpha_electrons:])
                     - molecule.n_core_spin_orbitals)
        beta_idx = (np.array(beta_idx[molecule.n_core_beta_electrons:])
                    - molecule.n_core_spin_orbitals)
        t_alpha = np.array([t_ia[i] for i in alpha_idx]) if len(alpha_idx) else np.zeros((0,))
        t_beta = np.array([t_ia[i] for i in beta_idx]) if len(beta_idx) else np.zeros((0,))
        n_alpha -= molecule.n_core_alpha_electrons
        n_beta -= molecule.n_core_beta_electrons
        n_occ -= molecule.n_core_alpha_electrons + molecule.n_core_beta_electrons
        t_norm = (n_alpha / n_occ * np.linalg.norm(t_alpha)
                  + n_beta / n_occ * np.linalg.norm(t_beta))
    else:
        n_occ -= molecule.n_core_orbitals
        n_occ *= 2
        t_norm = np.linalg.norm(t_ia)
    T1 = t_norm / np.sqrt(n_occ)
    log(f"\n  Norm of singles amplitudes:         {t_norm:13.10f}", calculation, 1, silent=silent)
    log(f"  Value of T1 diagnostic:             {T1:13.10f}", calculation, 1, silent=silent)
    return T1


def print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation, spin_orbital_labels,
                             silent):
    """tuna_tpu's printout of the largest |t2| and |t1|, in one sorted list.
    For UHF it labels the amplitudes, keeps the spin-conserving ones, puts
    alpha first and drops repeats; each row is made only as the sorted list
    is walked, until print_n_amplitudes rows are found."""
    log("\n  Searching for largest amplitudes...        ", calculation, 2, end="", silent=silent)
    t_ia, t_ijab = to_numpy(t_ia), to_numpy(t_ijab)
    amplitudes = np.concatenate([np.abs(t_ijab).ravel(), np.abs(t_ia).ravel()])
    order = np.argsort(-amplitudes)

    def row_at(flat):
        """(i, j, a, b) of an amplitude, virtuals counted after n_occ; a
        single is (i, -1, a, -1)."""
        if flat < t_ijab.size:
            i, j, a, b = (int(x) for x in np.unravel_index(flat, t_ijab.shape))
            return [i, j, a + n_occ, b + n_occ]
        i, a = (int(x) for x in np.unravel_index(flat - t_ijab.size, t_ia.shape))
        return [i, -1, a + n_occ, -1]

    n_print = min(calculation.print_n_amplitudes, len(order))
    if calculation.reference == "UHF":
        labels = list(spin_orbital_labels) + ["ERR"] * n_occ
        indices, values, seen = [], [], set()
        for flat in order:
            if len(indices) == n_print:
                break
            row = [labels[x] for x in row_at(flat)]
            if row[1][-1] != row[3][-1] or row[0][-1] != row[2][-1]:
                continue
            if row[1].endswith("a") or row[0].endswith("b"):
                row = [row[1], row[0], row[3], row[2]]
            if tuple(row) not in seen:
                seen.add(tuple(row))
                indices.append(row)
                values.append(amplitudes[flat])
    else:
        indices = [[x + 1 for x in row_at(flat)] for flat in order[:n_print]]
        values = amplitudes[order[:n_print]]

    log("[Done]", calculation, 2, silent=silent)
    log("\n  Largest amplitudes:\n", calculation, 2, silent=silent)

    for i in range(len(indices)):
        a1, b1, a2, b2 = [f"{indices[i][j]:<3}" for j in (0, 1, 2, 3)]
        value = values[i]
        stars = "~~~~~~~~  "
        space, antispace = (" ", "") if calculation.reference == "RHF" else ("", " ")
        left = f"{a1}-> {space}{a2}{antispace}" if a1 != a2 else stars
        right = f"{b1}-> {space}{b2}{antispace}" if b1 != b2 else stars
        if value > 1e-6:
            log(f"    {left}   {right}  :    {value:6f}", calculation, 2, silent=silent)


# ---------------------------------------------------------------------------
# Top-level driver
# ---------------------------------------------------------------------------

def begin_coupled_cluster_calculation(method, molecule, SCF_output, integrals, X,
                                      calculation, silent):
    """CC on the SCF orbitals, spatial for RHF and spin-orbital for UHF
    references; returns (E_CC, E_perturbative, (P, P_alpha, P_beta),
    natural occupancies, natural orbitals), the last two None without
    NATORBS, and records the per-iteration wall seconds on
    SCF_output.correlation_iteration_seconds."""
    timer("Coupled cluster", 0)
    E_perturbative = 0.0
    occupancies = natural_orbitals = None

    if calculation.reference == "RHF":
        n_occ = molecule.n_doubly_occ
        g, molecular_orbitals, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)
        # All CC uses non-interleaved physicists' notation: (pr|qs) -> <pq|rs>
        g = g.transpose(1, 2)
        F = torch.diag(epsilons)
        spin_labels_sorted = spin_orbital_labels_sorted = None
    else:
        n_occ = molecule.n_occ
        (g, molecular_orbitals, epsilons, o, v, spin_labels_sorted,
         spin_orbital_labels_sorted) = transforms.begin_spin_orbital_calculation(
            molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)
        H_core_SO = transforms.transform_matrix_ao_to_so(
            transforms.spin_block_matrix(integrals.H_core), molecular_orbitals)
        F = transforms.spin_orbital_fock(H_core_SO, g, slice(0, n_occ))

    log("\n Preparing arrays for coupled cluster...     ", calculation, 1, end="", silent=silent)
    e_ia = transforms.singles_epsilons(epsilons, o, v)
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    # (Q) reads the orbital energies, so only CCSDTQ's update forms e_ijklabcd
    e_ijkabc = (transforms.triples_epsilons(epsilons, o, v)
                if method.name in _ITERATIVE_TRIPLES else None)
    e_ijklabcd = (transforms.quadruples_epsilons(epsilons, o, v)
                  if method.name == "CCSDTQ" else None)
    t_ia = e_ia * F[o, v]
    t_ijab = g[o, o, v, v] * e_ijab
    t_ijkabc = torch.zeros_like(e_ijkabc) if e_ijkabc is not None else None
    t_ijklabcd = torch.zeros_like(e_ijklabcd) if e_ijklabcd is not None else None
    log("[Done]", calculation, 1, silent=silent)

    E_CC, (t_ia, t_ijab, t_ijkabc, t_ijklabcd), iteration_seconds = (
        calculate_coupled_cluster_energy(
            g, o, v, (t_ia, t_ijab, t_ijkabc, t_ijklabcd), (e_ia, e_ijab, e_ijkabc, e_ijklabcd),
            F, method, calculation, silent, SCF_output, integrals))
    SCF_output.correlation_iteration_seconds = iteration_seconds

    T1_diagnostic(molecule, t_ia, spin_labels_sorted, n_occ, molecule.n_alpha,
                  molecule.n_beta, calculation, silent)
    print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation, spin_orbital_labels_sorted,
                             silent)

    density_matrices = linearised_density(t_ia, t_ijab, molecule.n_orbitals, n_occ,
                                          o, v, calculation, molecular_orbitals,
                                          silent=silent)
    if calculation.natural_orbitals:
        from .mp import print_natural_orbitals
        occupancies, natural_orbitals = print_natural_orbitals(
            density_matrices[0], X, SCF_output.S, calculation, silent)

    if "[T]" in method.name or "(T)" in method.name:
        triples = (restricted_CCSD_T if calculation.reference == "RHF"
                   else unrestricted_CCSD_T)
        E_perturbative = triples(g, epsilons, t_ia, t_ijab, o, v, method, calculation, silent)
    elif "[Q]" in method.name or "(Q)" in method.name:
        # on a UHF reference too, as tuna_tpu does: the restricted formula on
        # the spin-orbital integrals and amplitudes
        E_perturbative = restricted_CCSDT_Q(g, epsilons, t_ijab, t_ijkabc, o, v, calculation,
                                            silent)

    log_spacer(calculation, silent=silent)
    timer("Coupled cluster", 1)
    return E_CC, E_perturbative, density_matrices, occupancies, natural_orbitals

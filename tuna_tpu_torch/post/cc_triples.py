"""Iterative triples and quadruples methods: CCSDT, CISDT, CCSDTQ.

Twin of tuna_tpu/post/cc_triples.py.  Restricted CCSDT follows the
T1-dressed spin-adapted formulation (10.26434/chemrxiv-2024-xbnmh via
-cvs8h), with the null-space projection of the pair-symmetric triples onto
the singlet-CSF subspace that makes the redundant spin-free representation
converge (reference: tuna_cc.py:2003-2036).  CCSDTQ adds the quadruples
coupling on top of the CCSDT residuals (tuna_cc.py:2500-2687); CISDT and
unrestricted CCSDT are spin-orbital (tuna_cc.py:1389-1500, and the term
table of _uccsdt_terms).

The amplitudes are iterated by tuna_tpu's pure-float64 loop (its CPU path,
`_make_solver_fn`): every rank's update, the energy, the convergence test,
DIIS over the concatenated residuals of all ranks with the full Gram and a
float64 extrapolation, and damping, as a Python loop on the device.  Its
f32-warm Newton-Krylov production solver is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..output import error, log, log_spacer
from .cc import (_diis_coefficients, _initial_print, _push_ring, _restricted_blocks,
                 _restricted_energy, _t1_dressed_mo_oneelectron, _t1_dressed_mo_tensor,
                 _t1_dressed_orbitals, _u_of, _unrestricted_blocks, _unrestricted_energy,
                 permute, permute_symmetric)

E = torch.einsum


def _p3(array):
    """Simultaneous three-column permutation symmetriser (tuna_mp.py:57-88)."""
    return (array + array.permute(0, 2, 1, 3, 5, 4) + array.permute(1, 0, 2, 4, 3, 5)
            + array.permute(1, 2, 0, 4, 5, 3) + array.permute(2, 0, 1, 5, 3, 4)
            + array.permute(2, 1, 0, 5, 4, 3))


def _p4(array):
    array = (array + array.transpose(0, 3).transpose(4, 7)
             + array.transpose(1, 3).transpose(5, 7) + array.transpose(2, 3).transpose(6, 7))
    array = (array + array.transpose(0, 2).transpose(4, 6)
             + array.transpose(1, 2).transpose(5, 6))
    return array + array.transpose(0, 1).transpose(4, 5)


def project_triples(t3):
    """Project pair-symmetric triples onto the physical singlet-CSF subspace."""
    projected = (5.0 / 6.0) * t3
    return projected + (-1.0 / 6.0) * (
        t3.permute(0, 2, 1, 3, 4, 5) + t3.permute(1, 0, 2, 3, 4, 5)
        + t3.permute(2, 1, 0, 3, 4, 5) + t3.permute(1, 2, 0, 3, 4, 5)
        + t3.permute(2, 0, 1, 3, 4, 5))


def project_quadruples(t4):
    at = lambda *occupied: t4.permute(*occupied, 4, 5, 6, 7)
    out = (7.0 / 12.0) * t4
    out = out + (-1.0 / 6.0) * (
        at(0, 1, 3, 2) + at(0, 2, 1, 3) + at(0, 3, 2, 1) + at(1, 0, 2, 3) + at(2, 1, 0, 3)
        + at(3, 1, 2, 0))
    out = out + (-1.0 / 24.0) * (
        at(0, 2, 3, 1) + at(0, 3, 1, 2) + at(1, 2, 0, 3) + at(1, 3, 2, 0) + at(2, 0, 1, 3)
        + at(2, 1, 3, 0) + at(3, 0, 2, 1) + at(3, 1, 0, 2))
    return out + (1.0 / 12.0) * (
        at(1, 0, 3, 2) + at(2, 3, 0, 1) + at(3, 2, 1, 0) + at(1, 2, 3, 0) + at(1, 3, 0, 2)
        + at(2, 0, 3, 1) + at(2, 3, 1, 0) + at(3, 0, 1, 2) + at(3, 2, 0, 1))


# ---------------------------------------------------------------------------
# Restricted CCSDT (T1-dressed)
# ---------------------------------------------------------------------------

def _ao_dressed_tensor(ERI_AO, X, Y):
    """(X Y | X Y) of the chemists' AO tensor: g_hat[pqrs] = X_ap Y_bq X_gr
    Y_ds (ab|gd), one index at a time."""
    out = torch.tensordot(ERI_AO, Y, dims=([3], [0]))             # a b g s
    out = torch.movedim(torch.tensordot(out, X, dims=([2], [0])), 3, 2)   # a b r s
    out = torch.movedim(torch.tensordot(out, Y, dims=([1], [0])), 3, 1)   # a q r s
    return torch.tensordot(X, out, dims=([0], [0]))                # p q r s


def _restricted_ccsdt_residuals(o, v, t1, t2, t3, ERI_AO, H_core, C, G_MO=None, H_MO=None):
    """T1-dressed CCSDT residuals (r1, r2, r3) plus (g_hat, F_hat, u2).

    With the loop-invariant full-space chemists' MO tensor G_MO (and the
    MO-basis H_MO) given, the T1 dressing is four low-rank index updates of
    G_MO, O(o v n^4); otherwise the dressed tensor is rebuilt from the AO
    tensor, O(n^5) (the frozen-core route: t1 does not span the dressed
    occupied space there)."""
    if G_MO is not None:
        g_hat = _t1_dressed_mo_tensor(G_MO, t1, o, v)
        h_hat = _t1_dressed_mo_oneelectron(H_MO, t1, o, v)
    else:
        X, Y = _t1_dressed_orbitals(C, t1, o, v)
        g_hat = _ao_dressed_tensor(ERI_AO, X, Y)
        h_hat = X.T @ H_core @ Y
    l_hat = 2 * g_hat - g_hat.transpose(1, 3)
    u2 = _u_of(t2)
    u3 = 2 * t3 - t3.transpose(3, 4) - t3.transpose(3, 5)
    occ_all = slice(0, o.stop)
    F_hat = h_hat + E("kkpq->pq", l_hat[occ_all, occ_all, :, :])

    A1 = E("kicd,kcad->ia", u2, g_hat[o, v, v, v])
    B1 = -E("klac,kilc->ia", u2, g_hat[o, o, o, v])
    C1 = E("kc,ikac->ia", F_hat[o, v], u2)

    beta = (g_hat[o, o, o, o].permute(1, 3, 0, 2)
            + E("ijcd,kcld->ijkl", t2, g_hat[o, v, o, v]))
    gamma = g_hat[o, o, v, v] - 0.5 * E("liad,kdlc->kiac", t2, g_hat[o, v, o, v])
    delta = 2 * g_hat[v, o, o, v] - g_hat[o, o, v, v].permute(2, 1, 0, 3)
    delta = delta + 0.5 * E("ilad,ldkc->aikc", u2,
                            2 * g_hat[o, v, o, v] - g_hat[o, v, o, v].transpose(1, 3))
    Fvv_tt = F_hat[v, v] - E("klbd,ldkc->bc", u2, g_hat[o, v, o, v])
    Foo_tt = F_hat[o, o] + E("ljcd,kdlc->kj", u2, g_hat[o, v, o, v])

    A2 = E("ijcd,acbd->ijab", t2, g_hat[v, v, v, v])
    B2 = E("klab,ijkl->ijab", t2, beta)
    C2 = -E("kjbc,kiac->ijab", t2, gamma)
    D2 = 0.5 * E("jkbc,aikc->ijab", u2, delta)
    E2 = E("ijac,bc->ijab", t2, Fvv_tt)
    G2 = -E("ikab,kj->ijab", t2, Foo_tt)

    # triples intermediates
    Xoo = F_hat[o, o] + E("meld,imde->li", g_hat[o, v, o, v], u2)
    Xvv = F_hat[v, v] - E("meld,lmae->ad", g_hat[o, v, o, v], u2)
    Xoooo = g_hat[o, o, o, o] + E("ldme,jkde->ljmk", g_hat[o, v, o, v], t2)
    Xvvvv = g_hat[v, v, v, v] + E("ldme,lmbc->bdce", g_hat[o, v, o, v], t2)
    Xvvoo = g_hat[v, v, o, o] - E("lemd,miae->adli", g_hat[o, v, o, v], t2)
    Xvoov = g_hat[v, o, o, v] - E("lemd,imae->aild", g_hat[o, v, o, v], t2)
    Xvoov = Xvoov + E("ldme,imae->aild", g_hat[o, v, o, v], u2)

    Yvooo = g_hat[v, o, o, o] + E("ljmd,mkdc->cklj", g_hat[o, o, o, v], u2)
    Yvooo = Yvooo - E("ldmj,mkdc->cklj", g_hat[o, v, o, o], t2)
    Yvooo = Yvooo + E("cdle,kjde->cklj", g_hat[v, v, o, v], t2)
    Yvooo = Yvooo - E("ldmk,mjcd->cklj", g_hat[o, v, o, o], t2)
    Yvooo = Yvooo + E("ldme,mkjecd->cklj", g_hat[o, v, o, v], u3)

    Yvovv = g_hat[v, o, v, v] - E("ld,lkbc->ckbd", F_hat[o, v], t2)
    Yvovv = Yvovv + E("lkmd,lmcb->ckbd", g_hat[o, o, o, v], t2)
    Yvovv = Yvovv - E("beld,lkec->ckbd", g_hat[v, v, o, v], t2)
    Yvovv = Yvovv + E("bdle,lkec->ckbd", g_hat[v, v, o, v], u2)
    Yvovv = Yvovv - E("celd,lkbe->ckbd", g_hat[v, v, o, v], t2)
    Yvovv = Yvovv - E("ldme,mklecb->ckbd", g_hat[o, v, o, v], u3)

    trip2 = E("kc,ijkabc->ijab", F_hat[o, v], t3 - t3.transpose(4, 5))
    trip2 = trip2 + E("ackd,ijkcbd->ijab", g_hat[v, v, o, v],
                      2 * t3 - t3.transpose(4, 5) - t3.transpose(3, 5))
    trip2 = trip2 - E("kilc,ljkcba->ijab", g_hat[o, o, o, v], u3)

    trip3 = E("ad,ijkdbc->ijkabc", Xvv, t3)
    trip3 = trip3 - E("li,ljkabc->ijkabc", Xoo, t3)
    trip3 = trip3 + E("ljmk,ilmabc->ijkabc", Xoooo, t3)
    trip3 = trip3 - E("adli,ljkdbc->ijkabc", Xvvoo, t3)
    trip3 = trip3 + E("bdce,ijkade->ijkabc", Xvvvv, t3)
    trip3 = trip3 - E("bdli,ljkadc->ijkabc", Xvvoo, t3)
    trip3 = trip3 - E("cdli,ljkabd->ijkabc", Xvvoo, t3)
    trip3 = trip3 + E("aild,ljkdbc->ijkabc", Xvoov, u3)

    r1 = F_hat[v, o].T + A1 + B1 + C1
    r1 = r1 + E("jbkc,ijkabc->ia", l_hat[o, v, o, v], t3 - t3.transpose(3, 4))
    r2 = g_hat[v, o, v, o].permute(1, 3, 0, 2) + A2 + B2
    r2 = r2 + permute_symmetric(0.5 * C2 + C2.transpose(0, 1) + D2 + E2 + G2, (0, 1), (2, 3))
    r2 = r2 + permute_symmetric(trip2, (0, 1), (2, 3))

    def permute_short(array):
        return (array + array.permute(1, 0, 2, 4, 3, 5) + array.permute(2, 1, 0, 5, 4, 3))

    r3 = _p3(E("ijad,ckbd->ijkabc", t2, Yvovv) - E("ilab,cklj->ijkabc", t2, Yvooo))
    r3 = r3 + permute_short(trip3)
    return r1, r2, r3, g_hat, F_hat, u2


def _restricted_ccsdt_update(o, v, d1, d2, d3, t1, t2, t3, ERI_AO, H_core, C,
                             G_MO=None, H_MO=None):
    r1, r2, r3, _, _, _ = _restricted_ccsdt_residuals(o, v, t1, t2, t3, ERI_AO, H_core, C,
                                                      G_MO, H_MO)
    return t1 + d1 * r1, t2 + d2 * r2, project_triples(t3 + d3 * r3)


# ---------------------------------------------------------------------------
# Restricted CCSDTQ
# ---------------------------------------------------------------------------

def _restricted_ccsdtq_update(o, v, d1, d2, d3, d4, t1, t2, t3, t4,
                              ERI_AO, H_core, C, G_MO=None, H_MO=None):
    r1, r2, r3, g_hat, F_hat, u2 = _restricted_ccsdt_residuals(
        o, v, t1, t2, t3, ERI_AO, H_core, C, G_MO, H_MO)

    alpha = (2 * t4 - t4.transpose(4, 5) - t4.transpose(4, 6)
             - t4.permute(0, 1, 2, 3, 7, 5, 6, 4))
    beta4 = 2 * alpha - alpha.transpose(5, 6) - alpha.transpose(5, 7)
    z3 = 2 * t3 - t3.transpose(3, 4) - t3.transpose(3, 5)

    A_q = g_hat[v, v, v, o] + E("menj,mnab->aebj", g_hat[o, v, o, o], t2)
    A_q = A_q + 0.5 * (E("mfae,mjfb->aebj", 2 * g_hat[o, v, v, v], u2)
                       - E("afme,mjfb->aebj", g_hat[v, v, o, v], u2))
    mid = E("meaf,jmfb->aebj", g_hat[o, v, v, v], t2)
    A_q = A_q - 0.5 * mid - mid.transpose(0, 2)
    A_q = A_q - E("menf,nmjfab->aebj", g_hat[o, v, o, v], z3)
    A_q = A_q - E("me,mjab->aebj", F_hat[o, v], t2)

    B_q = g_hat[v, o, o, o] + E("aemf,ijef->aimj", g_hat[v, v, o, v], t2)
    B_q = B_q + 0.5 * (E("nemj,niea->aimj", 2 * g_hat[o, v, o, o], u2)
                       - E("njme,niea->aimj", g_hat[o, o, o, v], u2))
    mid = E("njme,inea->aimj", g_hat[o, o, o, v], t2)
    B_q = B_q - 0.5 * mid - mid.transpose(1, 3)
    B_q = B_q + E("me,ijae->aimj", F_hat[o, v], t2)
    B_q = B_q + E("menf,nijfae->aimj", g_hat[o, v, o, v], z3)

    Fq_vv = (F_hat[v, v] - E("nfme,nmfa->ae", 2 * g_hat[o, v, o, v], t2)
             + E("nemf,nmfa->ae", g_hat[o, v, o, v], t2))
    Fq_oo = (F_hat[o, o] + E("nfme,nife->mi", 2 * g_hat[o, v, o, v], t2)
             - E("nemf,nife->mi", g_hat[o, v, o, v], t2))
    E_q = 2 * g_hat[o, v, v, o] - g_hat[o, o, v, v].transpose(1, 3)
    E_q = E_q + (E("nfme,nifa->meai", 2 * g_hat[o, v, o, v], u2)
                 - E("nemf,nifa->meai", g_hat[o, v, o, v], u2))
    F_q = g_hat[o, o, v, v] - E("nemf,infa->miae", g_hat[o, v, o, v], t2)
    G_q = g_hat[o, o, o, o] + E("menf,ijef->minj", g_hat[o, v, o, v], t2)
    H_q = g_hat[v, v, v, v] + E("menf,mnab->aebf", g_hat[o, v, o, v], t2)

    I_q = 2 * E("meaf,jibf->ejimba", g_hat[o, v, v, v], t2)
    I_q = I_q - E("mfae,jibf->ejimba", g_hat[o, v, v, v], t2)
    I_q = I_q - 2 * E("meni,njab->ejimba", g_hat[o, v, o, o], t2)
    I_q = I_q + E("mine,njab->ejimba", g_hat[o, o, o, v], t2)
    I_q = I_q + 0.5 * E("nfme,nijfab->ejimba", g_hat[o, v, o, v], z3)
    I_q = I_q - 0.25 * E("nemf,nijfab->ejimba", g_hat[o, v, o, v], z3)
    I_q = I_q + I_q.transpose(1, 2).transpose(4, 5)

    J_q = E("mfae,jibf->iejmab", g_hat[o, v, v, v], t2)
    J_q = J_q - E("mine,njab->iejmab", g_hat[o, o, o, v], t2)
    J_q = J_q - 0.5 * E("nemf,injfab->iejmab", g_hat[o, v, o, v], t3)

    K_q = (E("menk,ijae->ikjanm", g_hat[o, v, o, o], t2)
           + 0.5 * E("menf,ijkaef->ikjanm", g_hat[o, v, o, v], t3))
    K_q = K_q + K_q.transpose(1, 2).transpose(4, 5)

    L_q = E("aemf,ijkebf->jikbam", g_hat[v, v, o, v], t3)
    L_q = L_q + 0.5 * E("meai,jkbe->jikbam", E_q, t2)
    L_q = L_q + 0.5 * E("miae,jkbe->jikbam", F_q, t2)
    L_q = L_q + E("mkae,jibe->jikbam", F_q, t2)
    L_q = L_q - 0.5 * E("mkni,njab->jikbam", G_q, t2)
    L_q = L_q + 0.5 * E("menf,nijkfabe->jikbam", g_hat[o, v, o, v], alpha)
    L_q = L_q + L_q.transpose(0, 1).transpose(3, 4)

    M_q = (0.5 * E("aebf,jkfc->ekjacb", H_q, t2)
           - 0.5 * E("menf,nmjkfabc->ekjacb", g_hat[o, v, o, v], alpha))
    M_q = M_q + M_q.transpose(1, 2).transpose(4, 5)

    r2 = r2 + permute_symmetric(
        0.25 * E("menf,mnijefab->ijab", g_hat[o, v, o, v], beta4), (0, 1), (2, 3))
    r3 = r3 + _p3((1 / 6) * E("me,mijkeabc->ijkabc", F_hat[o, v], alpha)
                  + 0.5 * E("aemf,mijkfebc->ijkabc", g_hat[v, v, o, v], alpha)
                  - 0.5 * E("menj,minkeabc->ijkabc", g_hat[o, v, o, o], alpha))

    r4 = 0.5 * E("aebj,iklecd->ijklabcd", A_q, t3)
    r4 = r4 - 0.5 * E("aimj,mklbcd->ijklabcd", B_q, t3)
    r4 = r4 + (1 / 6) * E("ae,ijklebcd->ijklabcd", Fq_vv, t4)
    r4 = r4 - (1 / 6) * E("mi,mjklabcd->ijklabcd", Fq_oo, t4)
    r4 = r4 + (1 / 12) * E("meai,mjklebcd->ijklabcd", E_q, alpha)
    mid = E("miae,jmklebcd->ijklabcd", F_q, t4)
    r4 = r4 - 0.25 * mid - 0.5 * mid.transpose(4, 5)
    r4 = r4 + 0.25 * E("minj,mnklabcd->ijklabcd", G_q, t4)
    r4 = r4 + 0.25 * E("aebf,ijklefcd->ijklabcd", H_q, t4)
    r4 = r4 + 0.125 * E("eijmab,mklecd->ijklabcd", I_q, z3)
    mid = E("iejmab,kmlecd->ijklabcd", J_q, t3)
    r4 = r4 - 0.5 * mid - mid.transpose(4, 6)
    r4 = r4 + 0.5 * E("ijkamn,mnlbcd->ijklabcd", K_q, t3)
    r4 = r4 - 0.5 * E("ijkabm,mlcd->ijklabcd", L_q, t2)
    r4 = r4 + 0.5 * E("ejkabc,iled->ijklabcd", M_q, t2)
    r4 = _p4(r4)

    return (t1 + d1 * r1, t2 + d2 * r2, project_triples(t3 + d3 * r3),
            project_quadruples(t4 + d4 * r4))


# ---------------------------------------------------------------------------
# Unrestricted CCSDT (declarative term table)
# ---------------------------------------------------------------------------

def _term_operands(g, F, o, v, t1, t2, t3):
    slices = {"o": o, "v": v}
    operands = {"F_ov": F[o, v], "F_vv": F[v, v], "F_oo": F[o, o],
                "t1": t1, "t2": t2, "t3": t3}

    def lookup(name):
        if name not in operands:
            operands[name] = g[tuple(slices[c] for c in name[2:])]
        return operands[name]

    return lookup


def _evaluate_terms(terms, lookup):
    total = None
    for factor, perms, subscripts, ops in terms:
        term = factor * E(subscripts, *[lookup(k) for k in ops])
        for i, j in perms:
            term = term - term.transpose(i, j)
        total = term if total is None else total + term
    return total


def _unrestricted_ccsdt_update(g, F, o, v, d1, d2, d3, t1, t2, t3):
    """Spin-orbital CCSDT via the term table in _uccsdt_terms (incremental
    update against the full Fock matrix)."""
    from ._uccsdt_terms import TERMS_T1, TERMS_T2, TERMS_T3
    lookup = _term_operands(g, F, o, v, t1, t2, t3)
    r1 = _evaluate_terms(TERMS_T1, lookup)
    r2 = _evaluate_terms(TERMS_T2, lookup)
    r3 = _evaluate_terms(TERMS_T3, lookup)
    return t1 + d1 * r1, t2 + d2 * r2, t3 + d3 * r3


# ---------------------------------------------------------------------------
# Unrestricted CISDT
# ---------------------------------------------------------------------------

def _unrestricted_cisdt_update(B, F, o, v, d1, d2, d3, t1, t2, t3):
    """Spin-orbital CISDT (tuna_cc.py:1389-1500)."""
    off = torch.diag(torch.diagonal(F))
    F_oo, F_vv = F[o, o] - off[o, o], F[v, v] - off[v, v]
    r1 = (F[o, v]
          + E("ab,ib->ia", F_vv, t1)
          - E("ji,ja->ia", F_oo, t1)
          + E("ajib,jb->ia", B["voov"], t1)
          + E("jb,ijab->ia", F[o, v], t2)
          + 0.5 * E("ajbc,ijbc->ia", B["vovv"], t2)
          - 0.5 * E("jkib,jkab->ia", B["ooov"], t2)
          + 0.25 * E("jkbc,ijkabc->ia", B["oovv"], t3))

    r2 = (B["oovv"]
          + permute(E("abic,jc->ijab", B["vvov"], t1), 1, 0)
          - permute(E("akij,kb->ijab", B["vooo"], t1), 3, 2)
          + 0.5 * E("klij,klab->ijab", B["oooo"], t2)
          + 0.5 * E("abcd,ijcd->ijab", B["vvvv"], t2)
          + permute(E("ki,jkab->ijab", F_oo, t2), 1, 0)
          - permute(E("ac,ijbc->ijab", F_vv, t2), 3, 2)
          + permute(permute(E("akic,jkbc->ijab", B["voov"], t2), 0, 1), 3, 2)
          + E("kc,ijkabc->ijab", F[o, v], t3)
          + permute(0.5 * E("klic,jklabc->ijab", B["ooov"], t3), 1, 0)
          - permute(0.5 * E("akcd,ijkbcd->ijab", B["vovv"], t3), 3, 2))

    r3 = permute(E("ackd,ijbd->ijkabc", B["vvov"], t2), 4, 3)
    r3 = r3 + permute(E("alij,klbc->ijkabc", B["vooo"], t2), 4, 3)
    r3 = r3 - E("abkd,ijcd->ijkabc", B["vvov"], t2)
    r3 = r3 + E("clij,klab->ijkabc", B["vooo"], t2)
    r3 = r3 - permute(E("abid,jkcd->ijkabc", B["vvov"], t2), 1, 0)
    r3 = r3 - permute(E("clik,jlab->ijkabc", B["vooo"], t2), 1, 0)
    r3 = r3 + permute(permute(E("acid,jkbd->ijkabc", B["vvov"], t2), 1, 0), 4, 3)
    r3 = r3 - permute(permute(E("alik,jlbc->ijkabc", B["vooo"], t2), 1, 0), 4, 3)
    r3 = r3 + permute(E("alkd,ijlbcd->ijkabc", B["voov"], t3), 4, 3)
    r3 = r3 + permute(E("clid,jklabd->ijkabc", B["voov"], t3), 1, 0)
    r3 = r3 + permute(E("ad,ijkbcd->ijkabc", F_vv, t3), 4, 3)
    r3 = r3 - E("lk,ijlabc->ijkabc", F_oo, t3)
    r3 = r3 + 0.5 * E("abde,ijkcde->ijkabc", B["vvvv"], t3)
    r3 = r3 + 0.5 * E("lmij,klmabc->ijkabc", B["oooo"], t3)
    r3 = r3 + E("clkd,ijlabd->ijkabc", B["voov"], t3)
    r3 = r3 + E("cd,ijkabd->ijkabc", F_vv, t3)
    r3 = r3 - permute(E("li,jklabc->ijkabc", F_oo, t3), 1, 0)
    r3 = r3 - permute(0.5 * E("acde,ijkbde->ijkabc", B["vvvv"], t3), 4, 3)
    r3 = r3 - permute(0.5 * E("lmik,jlmabc->ijkabc", B["oooo"], t3), 1, 0)
    r3 = r3 + permute(permute(E("alid,jklbcd->ijkabc", B["voov"], t3), 1, 0), 4, 3)
    st = E("abij,kc->ijkabc", B["vvoo"], t1)
    st_ijk = st - st.transpose(0, 2) - st.transpose(1, 2)
    r3 = r3 + st_ijk - st_ijk.transpose(3, 5) - st_ijk.transpose(4, 5)

    # tuna_tpu's non-incremental form with the off-diagonal Fock matrix
    # (equal to the reference's incremental update with the full one for
    # canonical orbitals, tuna_cc.py:1497-1499)
    E_corr = 0.25 * E("ijab,ijab->", B["oovv"], t2)
    return d1 * (r1 - E_corr * t1), d2 * (r2 - E_corr * t2), d3 * (r3 - E_corr * t3)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TriplesSettings:
    method: str
    restricted: bool
    rank4: bool
    n_occ: int
    max_iter: int
    use_diis: bool
    max_diis: int
    damping: float
    o_start: int


def _make_setup(settings: TriplesSettings):
    """(update, energy_fn) from the solver's array arguments
    (tuna_tpu/post/cc_triples.py:_make_setup)."""
    no = settings.n_occ

    def setup(g, F, d1, d2, d3, d4, ERI_AO, H_core, C):
        o, v = slice(0, no), slice(no, None)
        o_g = slice(settings.o_start, settings.o_start + no)
        v_g = slice(settings.o_start + no, None)
        keep_disconnected = settings.method != "CISDT"
        UB = None
        if settings.restricted:
            RB = _restricted_blocks(g, o, v)
            energy_fn = lambda t1, t2: _restricted_energy(RB, F[o, v], t1, t2, keep_disconnected)
        else:
            UB = dict(_unrestricted_blocks(g, o, v))
            UB["voov"] = g[v, o, o, v]
            UB["vooo"] = g[v, o, o, o]
            UB["vvov"] = g[v, v, o, v]
            UB["vvoo"] = g[v, v, o, o]
            energy_fn = lambda t1, t2: _unrestricted_energy(UB, F[o, v], t1, t2,
                                                            keep_disconnected)

        # With no frozen core the dressed integrals are low-rank updates of
        # the loop-invariant chemists' MO tensor (g is <pq|rs> here); with a
        # frozen core t1 does not span the dressed occupied space, and the
        # AO tensor is dressed and transformed every iteration.
        G_MO = H_MO = None
        if settings.restricted and settings.o_start == 0:
            G_MO = g.transpose(1, 2)
            H_MO = C.T @ H_core @ C

        def update(t1, t2, t3, t4):
            if settings.method == "CISDT":
                return (*_unrestricted_cisdt_update(UB, F, o, v, d1, d2, d3, t1, t2, t3), t4)
            if not settings.restricted:
                return (*_unrestricted_ccsdt_update(g, F, o, v, d1, d2, d3, t1, t2, t3), t4)
            if not settings.rank4:
                return (*_restricted_ccsdt_update(o_g, v_g, d1, d2, d3, t1, t2, t3, ERI_AO,
                                                  H_core, C, G_MO, H_MO), t4)
            return _restricted_ccsdtq_update(o_g, v_g, d1, d2, d3, d4, t1, t2, t3, t4,
                                             ERI_AO, H_core, C, G_MO, H_MO)

        return update, energy_fn

    return setup


def solve_triples_amplitudes(settings: TriplesSettings, g, F, denominators, amplitudes,
                             ERI_AO, H_core, C, energy_conv, amp_conv, on_start=None,
                             on_iteration=None):
    """Iterate the rank-3 (or, for CCSDTQ, rank-4) amplitude equations: the
    pure-float64 loop of tuna_tpu's `_make_solver_fn`, one Python iteration
    a step.  denominators and amplitudes are (d1, d2, d3, d4) and (t1, t2,
    t3, t4), d4 and t4 unused below rank 4.

    on_start(guess MP2 energy) is called before the first iteration and
    on_iteration(step, E, dE, seconds) after each.  Returns (n_steps,
    converged, failed, E, (t1, t2, t3, t4), (E_singles, E_connected,
    E_disconnected))."""
    M = settings.max_diis
    rank = 4 if settings.rank4 else 3
    update, energy_fn = _make_setup(settings)(g, F, *denominators, ERI_AO, H_core, C)
    ts = tuple(amplitudes)
    if on_start is not None:
        on_start(float(energy_fn(torch.zeros_like(ts[0]), ts[1])[0]))

    dtype, device = ts[1].dtype, ts[1].device
    E_CC = torch.zeros((), dtype=dtype, device=device)
    rings = [torch.zeros((M,) + tuple(t.shape), dtype=dtype, device=device) for t in ts[:rank]]
    err_buf = torch.zeros((M, sum(t.numel() for t in ts[:rank])), dtype=dtype, device=device)
    n_valid = 0
    converged = failed = False
    step = 1
    while step <= settings.max_iter and not converged and not failed:
        start = time.perf_counter()
        new = update(*ts)
        En = energy_fn(new[0], new[1])[0]
        dE = En - E_CC
        residuals = [(new[r] - ts[r]).reshape(-1) for r in range(rank)]
        amp_ok = torch.stack([torch.linalg.norm(res) for res in residuals]).max() < amp_conv
        is_conv = (torch.abs(dE) < energy_conv) & amp_ok
        is_failed = (~torch.all(torch.isfinite(new[1]))) | (En > 1000.0)

        rings = [_push_ring(ring, t, n_valid, M)[0] for ring, t in zip(rings, new)]
        err_buf, n_valid_new = _push_ring(err_buf, torch.cat(residuals), n_valid, M)

        mixed = list(new[:rank])
        conv_now = bool(is_conv)
        if settings.use_diis:
            ok, coeffs = _diis_coefficients(err_buf, n_valid_new, M)
            if step > 2 and ok and not conv_now:
                mixed = [torch.einsum("m,m...->...", coeffs, ring) for ring in rings]
            if step > 2 and not ok:
                n_valid_new = 0
        if settings.damping != 0.0 and not conv_now:
            f = settings.damping
            mixed = [f * old + (1 - f) * x for old, x in zip(ts, mixed)]
        ts = (*mixed, *ts[rank:])
        n_valid = n_valid_new

        E_CC = En
        E_value, dE_value, failed = torch.stack([En, dE, is_failed.to(dtype)]).tolist()
        converged, failed = conv_now, bool(failed)
        if on_iteration is not None:
            on_iteration(step, E_value, dE_value, time.perf_counter() - start)
        step += 1

    _, E_s, E_c, E_d = energy_fn(ts[0], ts[1])
    return (step - 1, converged, failed, float(E_CC), ts,
            tuple(torch.stack([E_s, E_c, E_d]).tolist()))


def solve_triples_method(g, o, v, t_amplitudes, e_denominators, F, method, base_name,
                         calculation, silent, SCF_output, integrals):
    """Host driver for CISDT / CCSDT / CCSDTQ (reference dispatch:
    tuna_cc.py:3059-3066, 3109-3113).  Returns (E_CC, (t1, t2, t3, t4),
    per-iteration wall seconds)."""
    restricted = calculation.reference == "RHF"
    if base_name == "CISDT" and restricted:
        error("CISDT is only available for unrestricted references in TUNA-TPU "
              "(as in the reference) - use UCISDT!")
    if base_name == "CCSDTQ" and not restricted:
        error("Unrestricted CCSDTQ is not yet available in TUNA-TPU!")

    t1_0, t2_0, t3_0, t4_0 = t_amplitudes
    d1, d2, d3, d4 = e_denominators
    rank4 = base_name == "CCSDTQ"
    settings = TriplesSettings(
        method=base_name, restricted=restricted, rank4=rank4,
        n_occ=o.stop - (o.start or 0),
        max_iter=int(calculation.correlated_max_iter),
        use_diis=bool(calculation.DIIS),
        max_diis=int(calculation.max_DIIS_matrices),
        damping=float(calculation.correlated_damping_parameter),
        o_start=int(o.start or 0))

    if (o.start or 0) != 0:
        g = g[o.start:, o.start:, o.start:, o.start:]
        F = F[o.start:, o.start:]

    ERI_AO = C = H_core = None
    if base_name in ("CCSDT", "CCSDTQ"):
        C = SCF_output.molecular_orbitals
        H_core = integrals.H_core.to(C)
        if settings.o_start != 0:
            ERI_AO = integrals.ERI_AO.to(C)

    iteration_seconds = []

    def on_iteration(step, E_step, dE, seconds):
        log(f"  {step:3.0f}           {E_step:13.10f}         {dE:13.10f}",
            calculation, 1, silent=silent)
        iteration_seconds.append(seconds)

    n_steps, converged, failed, E_CC, amplitudes, parts = solve_triples_amplitudes(
        settings, g, F, (d1, d2, d3, d4), (t1_0, t2_0, t3_0, t4_0), ERI_AO, H_core, C,
        calculation.energy_convergence, calculation.amp_conv,
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
    return E_CC, amplitudes, iteration_seconds

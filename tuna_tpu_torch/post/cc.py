"""Restricted coupled cluster (CCSD, CISD) with the (T)/[T] triples energy.

Twin of the restricted closed-shell path of tuna_tpu/post/cc.py: the
spin-adapted spatial-orbital equations in the tau-based formulation with
occupied-leading integral blocks and L = 2<pq|rs> - <pq|sr>, the fused CCSD
residual, and the pure-float64 amplitude DIIS loop of `_build_cc_solver_fn`
(its f32 spread extrapolation included, so iterates follow tuna_tpu's CPU
path).  A Python loop on the device takes the place of the while_loop.

The (T) energy runs through `ccsd_t_energy`: the K2 CUDA kernel
(csrc/ccsd_t.cu) on CUDA tensors, `_restricted_T_tensors` and the Lee
contraction in plain torch on CPU tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

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


_NO_DISCONNECTED = ("LCCD", "LCCSD", "QCISD", "QCISD[T]", "QCISD(T)", "CISD",
                    "CID", "CISDT")
_NO_SINGLES = ("LCCD", "CCD", "CID")


def _restricted_energy(B, F_ov, t1, t2, keep_disconnected: bool):
    E_singles = torch.einsum("ia,ia->", F_ov, t1)
    E_conn = torch.einsum("ijab,ijab->", B["Loovv"], t2)
    if keep_disconnected:
        E_disc = torch.einsum("ijab,ia,jb->", B["Loovv"], t1, t1)
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
# The amplitude solver (pure float64 DIIS loop, cc.py:919-1058)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CCSettings:
    method: str            # base iterative method name ("CCSD", "CISD")
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
    update = _RESTRICTED_UPDATES[settings.method]
    B = _restricted_blocks(g, o, v)
    F_ov = F[o, v]

    def energy_fn(t1, t2):
        return _restricted_energy(B, F_ov, t1, t2, settings.keep_disconnected)

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
        t1n, t2n = update(B, F_ov, d1, d2, t1, t2)
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
                                     method, calculation, silent):
    """Solve the amplitude equations for one iterative restricted method.

    Returns (E_CC, (t1, t2), per-iteration wall seconds)."""
    original_name = method.name
    base_name = method.name
    for tag in ("[T]", "[Q]", "(T)", "(Q)"):
        base_name = base_name.split(tag)[0]
    if base_name not in _RESTRICTED_UPDATES:
        error(f"The {base_name} method is not yet ported to tuna_tpu_torch!")

    t_ia, t_ijab = t_amplitudes
    d1, d2 = e_denominators
    settings = CCSettings(
        method=base_name,
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
    return E_CC, (t1, t2), iteration_seconds


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


# ---------------------------------------------------------------------------
# Post-processing
# ---------------------------------------------------------------------------

def _linearised_density_mo(t_ia, t_ijab, n_orbitals, n_occ, o_start, o_stop):
    o, v = slice(o_start, o_stop), slice(o_stop, None)
    P_CC = torch.zeros((n_orbitals, n_orbitals), dtype=t_ia.dtype, device=t_ia.device)
    u_ijab = _u_of(t_ijab)
    P_CC[v, v] += torch.einsum("ijbc,ijac->ab", t_ijab, u_ijab)
    P_CC[o, o] += -torch.einsum("ikab,jkab->ij", t_ijab, u_ijab)
    P_CC[o, v] += t_ia + torch.einsum("ijab,jb->ia", u_ijab, t_ia)
    P_CC[v, o] = P_CC[o, v].T
    P_CC[v, v] += torch.einsum("ia,ib->ab", t_ia, t_ia)
    P_CC[o, o] += -torch.einsum("ia,ja->ij", t_ia, t_ia)

    P_ref = torch.zeros_like(P_CC)
    P_ref[:n_occ, :n_occ] = torch.eye(n_occ, dtype=P_CC.dtype, device=P_CC.device)
    return P_ref + P_CC


def linearised_density(t_ia, t_ijab, n_orbitals, n_occ, o, v, calculation,
                       molecular_orbitals, silent):
    """Restricted linearised CC density in the AO basis: (P, P_alpha, P_beta)."""
    log("\n  Constructing linearised density...    ", calculation, 1, end="", silent=silent)
    P = _linearised_density_mo(t_ia, t_ijab, int(n_orbitals), int(n_occ),
                               int(o.start or 0), int(o.stop))
    C = molecular_orbitals
    P = C @ (2 * P) @ C.T
    P_alpha = P_beta = P / 2
    log("     [Done]", calculation, 1, silent=silent)
    return P, P_alpha, P_beta


def T1_diagnostic(molecule, t_ia, n_occ, calculation, silent):
    t_ia = to_numpy(t_ia)
    n_occ -= molecule.n_core_orbitals
    n_occ *= 2
    t_norm = np.linalg.norm(t_ia)
    T1 = t_norm / np.sqrt(n_occ)
    log(f"\n  Norm of singles amplitudes:         {t_norm:13.10f}", calculation, 1, silent=silent)
    log(f"  Value of T1 diagnostic:             {T1:13.10f}", calculation, 1, silent=silent)
    return T1


def print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation, silent):
    log("\n  Searching for largest amplitudes...        ", calculation, 2, end="", silent=silent)
    t_ia, t_ijab = to_numpy(t_ia), to_numpy(t_ijab)
    t_ijab_flat = np.abs(t_ijab).ravel()
    t_ia_flat = np.abs(t_ia).ravel()
    idx_ijab = np.vstack(np.unravel_index(np.arange(t_ijab_flat.size), t_ijab.shape)).T
    idx_ia = np.vstack(np.unravel_index(np.arange(t_ia_flat.size), t_ia.shape)).T
    idx_ijab[:, 2:] += n_occ
    idx_ia[:, 1] += n_occ
    singles = np.full((idx_ia.shape[0], 4), -1, dtype=int)
    singles[:, 0] = idx_ia[:, 0]
    singles[:, 2] = idx_ia[:, 1]
    amplitudes = np.concatenate([t_ijab_flat, t_ia_flat])
    indices = np.vstack([idx_ijab, singles])
    order = np.argsort(-amplitudes)
    values = amplitudes[order]
    indices = indices[order] + 1

    log("[Done]", calculation, 2, silent=silent)
    log("\n  Largest amplitudes:\n", calculation, 2, silent=silent)

    n_print = min(calculation.print_n_amplitudes, len(indices))
    for i in range(n_print):
        a1, b1, a2, b2 = [f"{indices[i][j]:<3}" for j in (0, 1, 2, 3)]
        value = values[i]
        stars = "~~~~~~~~  "
        left = f"{a1}->  {a2}" if a1 != a2 else stars
        right = f"{b1}->  {b2}" if b1 != b2 else stars
        if value > 1e-6:
            log(f"    {left}   {right}  :    {value:6f}", calculation, 2, silent=silent)


# ---------------------------------------------------------------------------
# Top-level driver
# ---------------------------------------------------------------------------

def begin_coupled_cluster_calculation(method, molecule, SCF_output, integrals, X,
                                      calculation, silent):
    """Restricted CC on the SCF orbitals; returns (E_CC, E_perturbative,
    (P, P_alpha, P_beta), None, None) and records the per-iteration wall
    seconds on SCF_output.correlation_iteration_seconds."""
    timer("Coupled cluster", 0)
    E_perturbative = 0.0
    if calculation.reference != "RHF":
        error("Unrestricted coupled cluster is not yet ported to tuna_tpu_torch!")
    if calculation.natural_orbitals:
        error("Natural orbitals are not yet ported to tuna_tpu_torch!")

    n_occ = molecule.n_doubly_occ
    g, molecular_orbitals, epsilons, o, v = transforms.begin_spatial_orbital_calculation(
        molecule, integrals.ERI_AO, SCF_output, calculation, silent=silent)
    # All CC uses non-interleaved physicists' notation: (pr|qs) -> <pq|rs>
    g = g.transpose(1, 2)
    F = torch.diag(epsilons)

    log("\n Preparing arrays for coupled cluster...     ", calculation, 1, end="", silent=silent)
    e_ia = transforms.singles_epsilons(epsilons, o, v)
    e_ijab = transforms.doubles_epsilons(epsilons, epsilons, o, o, v, v)
    t_ia = e_ia * F[o, v]
    t_ijab = g[o, o, v, v] * e_ijab
    log("[Done]", calculation, 1, silent=silent)

    E_CC, (t_ia, t_ijab), iteration_seconds = calculate_coupled_cluster_energy(
        g, o, v, (t_ia, t_ijab), (e_ia, e_ijab), F, method, calculation, silent)
    SCF_output.correlation_iteration_seconds = iteration_seconds

    T1_diagnostic(molecule, t_ia, n_occ, calculation, silent)
    print_largest_amplitudes(t_ia, t_ijab, n_occ, calculation, silent)

    density_matrices = linearised_density(t_ia, t_ijab, molecule.n_orbitals, n_occ,
                                          o, v, calculation, molecular_orbitals,
                                          silent=silent)

    if "[T]" in method.name or "(T)" in method.name:
        E_perturbative = restricted_CCSD_T(g, epsilons, t_ia, t_ijab, o, v,
                                           method, calculation, silent)

    log_spacer(calculation, silent=silent)
    timer("Coupled cluster", 1)
    return E_CC, E_perturbative, density_matrices, None, None

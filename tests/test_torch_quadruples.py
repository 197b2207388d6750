"""The (Q) correction of CCSDT[Q] and CCSDT(Q) (K9's plain version and its
plan, post/cc.py) against tuna_tpu's restricted_CCSDT_Q.

K9's plain version sums the multisets {i <= j <= k <= l} of a host plan and
never forms an o^4 v^4 array; tuna_tpu forms several.  On the same seeded
inputs E_MP5 and E_MP6 each agree to 1e-12 relative (the same float64
products, summed in another order), also with the workspace cap lowered
so that the plan cuts multisets over their slots and the virtual
quadruples over ranges of their smallest index.  tuna_tpu returns only
their sum, so its two parts are read from the float() calls it makes on
its four einsums.  End to end, at TIGHTSCF, total energies agree to 1e-10
Ha with equal SCF and CC iteration counts.  The CUDA kernel itself is
held to the plain version on the card (tests/test_torch_gpu.py).
"""

import builtins
import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.cli import run as jax_run
from tuna_tpu.post import cc as jax_cc
from tuna_tpu.post import transforms as jax_transforms

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.post import cc

torch.set_num_threads(2)

TOLERANCE = 1e-12   # relative, each of E_MP5 and E_MP6


def _inputs(seed, no, nv):
    """Seeded physicists' <pq|rs> over o + v orbitals, t2, t3 and orbital
    energies (occupied below the virtual ones)."""
    rng = np.random.default_rng(seed)
    n = no + nv
    return {"g": 0.1 * rng.standard_normal((n, n, n, n)),
            "t2": 0.05 * rng.standard_normal((no, no, nv, nv)),
            "t3": 0.02 * rng.standard_normal((no, no, no, nv, nv, nv)),
            "eps": np.concatenate([np.sort(rng.uniform(-15.0, -0.5, no)),
                                   np.sort(rng.uniform(0.3, 5.0, nv))])}


def _tuna_tpu_parts(x, no):
    """tuna_tpu's (E_MP5, E_MP6): restricted_CCSDT_Q computes E_MP5 from
    three float() reads and E_MP6 from two; a module-level float records
    them while it runs."""
    o, v = slice(0, no), slice(no, None)
    e4 = jax_transforms.quadruples_epsilons(jnp.asarray(x["eps"]), o, v)
    reads = []

    def recording(value):
        reads.append(builtins.float(value))
        return reads[-1]

    jax_cc.float = recording
    try:
        E_Q = jax_cc.restricted_CCSDT_Q(jnp.asarray(x["g"]), e4, jnp.asarray(x["t2"]),
                                        jnp.asarray(x["t3"]), o, v, None, True)
    finally:
        del jax_cc.float
    assert len(reads) == 5
    E_MP5, E_MP6 = reads[0] - 2 * reads[1] + reads[2], 2 * reads[3] + 2 * reads[4]
    assert abs(E_MP5 + E_MP6 - E_Q) <= 1e-15 * abs(E_Q) + 1e-300
    return E_MP5, E_MP6


def _port(x, no):
    g = torch.as_tensor(x["g"])
    return cc.ccsdt_q_energy(g.transpose(1, 2).contiguous(), torch.as_tensor(x["t2"]),
                             torch.as_tensor(x["t3"]), torch.as_tensor(x["eps"][:no]),
                             torch.as_tensor(x["eps"][no:])).tolist()


def _cap_for_slots(no, nv, slots, a1=None):
    """The workspace cap at which the range [0, a1) of min(y) (all of them
    by default) fits, and a piece of a cut multiset there holds `slots`
    slots beside its carry."""
    elements, slot = cc.quadruples_cut(no, nv, 0, nv if a1 is None else a1)
    return 8 * (3 * elements + slots * slot)


@pytest.mark.parametrize("no, nv", [(3, 4), (4, 3), (2, 5)])
def test_ccsdt_q_plain_matches_tuna_tpu(no, nv):
    """o = 3 and 4 have multisets with repeated occupied indices of every
    kind ({i, i, i, i}, {i, i, j, j}, {i, i, j, k}, ...)."""
    x = _inputs(21 + no, no, nv)
    expected = _tuna_tpu_parts(x, no)
    got = _port(x, no)
    for a, b in zip(got, expected):
        assert abs(a - b) <= TOLERANCE * abs(b)
    assert all(count == 0 for count in _kernels.launches.values())


@pytest.mark.parametrize("slots", [1, 5])
def test_ccsdt_q_plain_split_multisets_match_tuna_tpu(monkeypatch, slots):
    """With room for 1 or 5 slots a batch, multisets of up to 24 distinct
    orderings are cut over their slots, carrying Gsym and the two Zsym."""
    no, nv = 3, 4
    monkeypatch.setattr(cc, "QUADRUPLES_WORKSPACE_BYTES", _cap_for_slots(no, nv, slots))
    batches = cc.quadruples_plan(no, nv, cc.QUADRUPLES_WORKSPACE_BYTES)[0]
    assert np.any(batches[:, 4] == 0) and np.any(batches[:, 5] == 0)
    assert np.all(batches[:, 6:] == (0, nv))
    x = _inputs(25, no, nv)
    expected = _tuna_tpu_parts(x, no)
    got = _port(x, no)
    for a, b in zip(got, expected):
        assert abs(a - b) <= TOLERANCE * abs(b)


@pytest.mark.parametrize("slots, a1", [(1, 1), (1, 2), (1, 3), (2, None), (5, None)])
def test_ccsdt_q_plain_range_cuts_match_tuna_tpu(monkeypatch, slots, a1):
    """With room for one range [0, a1) of min(y) at the cap (a1 < v), the
    plan cuts the virtual quadruples over ranges of their smallest index
    as well as multisets over their slots; with a1 = v, over slots only."""
    no, nv = 4, 5
    monkeypatch.setattr(cc, "QUADRUPLES_WORKSPACE_BYTES", _cap_for_slots(no, nv, slots, a1))
    batches = cc.quadruples_plan(no, nv, cc.QUADRUPLES_WORKSPACE_BYTES)[0]
    assert len(np.unique(batches[:, 6])) > 1 if a1 else np.all(batches[:, 6:] == (0, nv))
    assert np.any(batches[:, 4] == 0)
    x = _inputs(27, no, nv)
    expected = _tuna_tpu_parts(x, no)
    got = _port(x, no)
    for a, b in zip(got, expected):
        assert abs(a - b) <= TOLERANCE * abs(b)


def _workspace_doubles(no, nv, batches):
    """csrc/ccsdt_q.cu's workspace for the largest batch of a plan."""
    most = 0
    for begin, end, _, _, first, last, a0, a1 in batches.tolist():
        elements, slot = cc.quadruples_cut(no, nv, a0, a1)
        most = max(most, (0 if first and last else 3 * elements) + (end - begin) * slot)
    return most


@pytest.mark.parametrize("no, nv, slots", [(4, 5, 1), (3, 7, 2), (7, 19, None),
                                           (7, 53, None)])
def test_quadruples_plan_ranges_cover_every_quadruple_once(no, nv, slots):
    """The ranges of min(y) tile [0, v) in order, each taking every slot in
    order; a range's elements are the y with min(y) in it; the workspace
    stays under the cap: one with room for `slots` slots of the range [0,
    1) beside a carry, or the default one at the (Q) path's (7, 19) and at
    cc-pVTZ's v = 53."""
    cap = (cc.QUADRUPLES_WORKSPACE_BYTES if slots is None
           else _cap_for_slots(no, nv, slots, a1=1))
    batches, table, _ = cc.quadruples_plan(no, nv, cap)
    ranges = list(dict.fromkeys(map(tuple, batches[:, 6:].tolist())))
    assert ranges[0][0] == 0 and ranges[-1][1] == nv
    assert all(r[1] == s[0] and r[0] < r[1] for r, s in zip(ranges, ranges[1:]))
    for a0, a1 in ranges:
        rows = batches[(batches[:, 6] == a0) & (batches[:, 7] == a1)]
        assert rows[0, 0] == 0 and rows[-1, 1] == len(table)
        assert np.all(rows[1:, 0] == rows[:-1, 1])
    assert _workspace_doubles(no, nv, batches) * 8 <= cap
    y = np.indices((nv,) * 4).reshape(4, -1).min(axis=0)
    for a0, a1 in ranges[:3]:
        assert cc.quadruples_cut(no, nv, a0, a1)[0] == np.count_nonzero((y >= a0) & (y < a1))


@pytest.mark.parametrize("slots", [1, 5, 24, 1000])
def test_quadruples_plan_covers_every_ordering_once(slots):
    no, nv = 4, 3
    batches, table, multisets = cc.quadruples_plan(no, nv, _cap_for_slots(no, nv, slots))
    # every ordered quadruple is one slot, multiset after multiset
    assert sorted(map(tuple, table.tolist())) == sorted(
        (i, j, k, l) for i in range(no) for j in range(no) for k in range(no)
        for l in range(no))
    assert len(multisets) == 35   # C(4 + 3, 4)
    for row in multisets.tolist():
        quadruple, ids, mask = row[:4], row[4:28], row[28]
        assert quadruple == sorted(quadruple)
        for sigma, slot in zip(cc.QUADRUPLES_PERMUTATIONS, ids):
            assert table[slot].tolist() == [quadruple[p] for p in sigma]
        # one first permutation for each distinct ordering
        assert bin(mask).count("1") == len(set(ids))
    # the batches tile the slots and the multisets in order
    assert batches[0, 0] == 0 and batches[-1, 1] == len(table)
    assert np.all(batches[1:, 0] == batches[:-1, 1])
    assert np.all(batches[:, 1] - batches[:, 0] <= slots)
    assert np.all(batches[:, 6:] == (0, nv))
    for begin, end, m_begin, m_end, first, last, _, _ in batches.tolist():
        if not (first and last):   # a piece of one cut multiset
            assert m_end - m_begin == 1
        for m in range(m_begin, m_end):
            ids = multisets[m, 4:28]
            if first and last:
                assert np.all((ids >= begin) & (ids < end))


def _chemists(x):
    return np.ascontiguousarray(x["g"].transpose(0, 2, 1, 3))


def _raw_emulated(c, t2, t3, slot):
    """K9's raw stage for one ordering (i, j, k, l) in NumPy, as
    csrc/ccsdt_q.cu composes it from the layouts its wrapper hands over
    (quadruples_operands) and X, Y, V as the xyv kernel stores them:
    Graw, alpha and beta over [0, v)^4."""
    no, nv = t2.shape[0], t2.shape[2]
    i, j, k, l = slot
    cov, cvt, clk, t3t = (x.numpy() for x in cc.quadruples_operands(
        torch.as_tensor(c), torch.as_tensor(t3), no))
    o, v = slice(0, no), slice(no, None)
    X = np.einsum("mn,mac->nac", c[o, i, o, j], t2[:, k])              # [n][a][c]
    Y = np.einsum("ame,eb->amb", c[i, v, o, v], t2[k, j])              # [a][m][b]
    V = np.einsum("bem,ce->cmb", c[v, v, o, i], t2[k, j])              # [c][m][b]
    P = np.einsum("cfae,fd->aced", c[v, v, v, v], t2[k, l])            # [a][c][e][d]
    cam = c[i, v, o, j]                                                # [a][m]
    G = (np.einsum("abe,ecd->abcd", cov[i], t3[j, k, l])
         + np.einsum("eb,aced->abcd", t2[i, j], P)
         - 2.0 * np.einsum("amb,mcd->abcd", Y, t2[:, l])
         - 2.0 * np.einsum("cmb,mad->abcd", V, t2[:, l])
         - np.einsum("am,mbcd->abcd", cam, t3[:, k, l])
         + np.einsum("nac,nbd->abcd", X, t2[:, l]))
    ji = t3t[j, i]                                                     # [a][m][c][b]
    S1 = np.einsum("amcb,md->abcd", ji, clk[l, k])
    S2 = np.einsum("amdb,mc->abcd", ji, clk[l, k])
    S3 = np.einsum("amcb,md->abcd", ji, clk[k, l])
    S4 = np.einsum("amdb,mc->abcd", ji, clk[k, l])
    T1 = np.einsum("aeb,ced->abcd", ji[:, k], cvt[l])
    T2 = np.einsum("aeb,ced->abcd", ji[:, l], cvt[k])
    return G, 2.0 * S1 - S2 - 2.0 * T1 + T2, 2.0 * S3 - S4 - 2.0 * T2 + T1


def _energy_emulated(blocks, c, t2, eps, no, ranges, multisets, table):
    """K9's energy stage in NumPy over the ranges of min(y): each multiset
    and tile of quadruples_tiles, each permutation staging the permuted tile
    of a slot's Graw (and of alpha and beta at Z6's 7 permutations where it
    first reaches the slot) in the slot's storage order, each element read
    back where staged_index puts it."""
    nv = t2.shape[2]
    K = c[:no, no:, :no, no:].transpose(0, 2, 1, 3)
    L = 2.0 * K - K.transpose(0, 1, 3, 2)
    u2 = 2.0 * t2 - t2.transpose(0, 1, 3, 2)
    z6 = [((0, 1, 2, 3), -2.0, 1), ((2, 3, 0, 1), -1.0, 1), ((1, 0, 2, 3), 1.0, 1),
          ((3, 1, 0, 2), 2.0, 2), ((1, 3, 0, 2), -1.0, 2), ((2, 1, 3, 0), 2.0, 2),
          ((1, 2, 3, 0), -1.0, 2)]

    def staged(array, start, extent, rho):
        # element z of the permuted box in storage order, then where the
        # tile's element u reads it: z_q = u_rho(q)
        box = np.ix_(*(np.arange(start[r], start[r] + extent[r]) for r in rho))
        flat = array[box].reshape(-1)
        u = np.indices(extent)
        index = np.zeros(extent, dtype=np.int64)
        for r in rho:
            index = index * extent[r] + u[r]
        return flat[index]

    energies = np.zeros(2)
    for a0, a1 in ranges:
        for row in multisets.tolist():
            e_o = eps[list(row[:4])].sum()
            for p, *geometry in cc.quadruples_tiles(nv, a0, a1).tolist():
                start, extent = geometry[:4], geometry[4:]
                y = np.ix_(*(np.arange(s, s + n) for s, n in zip(start, extent)))
                gs, z5, zz6 = 0.0, 0.0, 0.0
                for s, sigma in enumerate(cc.QUADRUPLES_PERMUTATIONS):
                    slot = row[4 + s]
                    G, alpha, beta = blocks[slot]
                    gs = gs + staged(G, start, extent, sigma)
                    if not row[28] >> s & 1:
                        continue
                    i, j, k, l = table[slot]
                    a, b, cv, d = (y[q] for q in sigma)
                    z5 = z5 + (u2[k, l][a, b] * K[i, j][cv, d] - 2.0 * u2[k, l][b, d] * L[i, j][a, cv]
                               + u2[k, l][cv, d] * L[i, j][a, b])
                    for pi, coefficient, which in z6:
                        rho = tuple(sigma[q] for q in pi)
                        zz6 = zz6 + 2.0 * coefficient * staged((alpha, beta)[which - 1], start,
                                                               extent, rho)
                e_v = sum(eps[no + y[q]] for q in range(4))
                weighted = 0.5 * gs / (e_o - e_v)
                energies += [np.sum(weighted * z5), np.sum(weighted * zz6)]
    return energies


@pytest.mark.parametrize("no, nv, a1", [(3, 4, None), (2, 6, 2)])
def test_quadruples_kernel_layouts_match_tuna_tpu(no, nv, a1):
    """K9's host tables emulated in NumPy with its two main stages: the raw
    stage on quadruples_operands' layouts, the vvvv term as two products
    and S2, S4 from t3[mjicba] at [j][i][a][m][c][b], equals the plain
    version's blocks; the energy stage on quadruples_tiles, through
    permuted tiles staged in storage order, gives tuna_tpu's E_MP5 and
    E_MP6, over one range of min(y) and over several."""
    x = _inputs(31 + no + nv, no, nv)
    c, t2, t3, eps = _chemists(x), x["t2"], x["t3"], x["eps"]
    cap = _cap_for_slots(no, nv, 1, a1)
    batches, table, multisets = cc.quadruples_plan(no, nv, cap)
    ranges = list(dict.fromkeys(map(tuple, batches[:, 6:].tolist())))
    assert (len(ranges) > 1) == (a1 is not None)
    B = cc._quadruples_blocks(torch.as_tensor(c), no)
    blocks = []
    for slot in table.tolist():
        got = _raw_emulated(c, t2, t3, slot)
        expected = cc._quadruples_slot_blocks(B, torch.as_tensor(t2), torch.as_tensor(t3),
                                              *(torch.tensor([n]) for n in slot), 0)
        for a, b in zip(got, expected):
            assert _relative(a, b[0].numpy()) <= 1e-13
        blocks.append(got)
    energies = _energy_emulated(blocks, c, t2, eps, no, ranges, multisets, table.tolist())
    for a, b in zip(energies, _tuna_tpu_parts(x, no)):
        assert abs(a - b) <= TOLERANCE * abs(b)


def _relative(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("nv, a0, a1", [(19, 0, 19), (9, 0, 1), (9, 2, 7), (6, 5, 6),
                                        (53, 13, 21), (2, 0, 2)])
def test_quadruples_tiles_cover_every_element_once(nv, a0, a1):
    """quadruples_tiles against a NumPy emulation of the kernel's decode
    (Cut::tiles, tile_offset and tile_at: box by offset, then the axes
    mixed-radix, the last fastest, each axis's part below a1 before its
    part above): the same tiles in the same order; together they cover the
    y with min(y) in [a0, a1) once, each in its box, none across a1."""
    tiles = cc.quadruples_tiles(nv, a0, a1)
    T = cc.QUADRUPLES_TILE

    def axis(p, q):
        lo, length = (a1, nv - a1) if q < p else ((a0, a1 - a0) if q == p else (a0, nv - a0))
        mid = a1 if q > p else lo + length
        return lo, mid, lo + length

    decoded = []
    for p in range(4):
        counts = [-(-(axis(p, q)[1] - axis(p, q)[0]) // T) - (-(axis(p, q)[2] - axis(p, q)[1]) // T)
                  for q in range(4)]
        for index in range(int(np.prod(counts))):
            starts, extents = [0] * 4, [0] * 4
            for q in (3, 2, 1, 0):
                u, index = index % counts[q], index // counts[q]
                lo, mid, hi = axis(p, q)
                below = -(-(mid - lo) // T)
                starts[q] = lo + T * u if u < below else mid + T * (u - below)
                extents[q] = min(T, (mid if u < below else hi) - starts[q])
            decoded.append((p, *starts, *extents))
    assert tiles.tolist() == [list(t) for t in decoded]
    covered = np.zeros((nv,) * 4, dtype=np.int64)
    for p, *geometry in tiles.tolist():
        start, extent = geometry[:4], geometry[4:]
        assert all(1 <= n <= T for n in extent)
        assert all(s + n <= a1 or s >= a1 for s, n in zip(start, extent))
        assert min(q for q in range(4) if start[q] < a1) == p
        covered[tuple(slice(s, s + n) for s, n in zip(start, extent))] += 1
    y = np.indices((nv,) * 4).min(axis=0)
    assert np.array_equal(covered, ((y >= a0) & (y < a1)).astype(np.int64))


def test_ccsdt_q_energy_refuses_other_devices():
    x = _inputs(26, 2, 3)
    meta = [torch.empty(t.shape, dtype=torch.float64, device="meta")
            for t in (x["g"], x["t2"], x["t3"], x["eps"][:2], x["eps"][2:])]
    with pytest.raises(ValueError, match="device"):
        cc.ccsdt_q_energy(*meta)


# ---------------------------------------------------------------------------
# End to end against tuna_tpu
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tuna_tpu(line):
    """tuna_tpu's (total energy, SCF iterations, CC iterations, printout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, _, energy, _ = jax_run(line)
    text = out.getvalue()
    scf_cycles = int(re.findall(r"converged in (\d+) cycles", text)[-1])
    table = text.split("Step          Correlation E")[-1].split("Singles contribution")[0]
    cc_rows = re.findall(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", table, re.M)
    return energy, scf_cycles, len(cc_rows), text


def _port_run(line):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scf, _, energy, _ = run(line, device="cpu")
    return scf, energy, out.getvalue()


def _quadruples_lines(text):
    return re.findall(r"^\s+(?:Contribution from MP[56]|CCSDT\(Q\) correlation energy):"
                      r"\s+-?\d+\.\d{10}$", text, re.M)


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : CCSDT(Q) 6-31G : TIGHTSCF",     # o = 7, v = 11
    "SPE : LI H 1.6 : CCSDT[Q] STO-3G : TIGHTSCF",
])
def test_ccsdt_q_matches_tuna_tpu(line):
    energy_ref, scf_ref, cc_ref, text_ref = _tuna_tpu(line)
    scf, energy, text = _port_run(line)
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == scf_ref
    assert cc_ref > 0 and len(scf.correlation_iteration_seconds) == cc_ref
    lines = _quadruples_lines(text)
    assert len(lines) == 3 and lines == _quadruples_lines(text_ref)


def test_ccsdt_bracket_and_parenthesis_q_agree():
    """tuna_tpu runs [Q] and (Q) through the same correction."""
    energies = [_port_run(f"SPE : LI H 1.6 : CCSDT{tag} STO-3G : TIGHTSCF")[1]
                for tag in ("[Q]", "(Q)")]
    assert energies[0] == energies[1]


def test_ccsdt_q_on_a_uhf_reference_matches_tuna_tpu():
    """On an open-shell reference tuna_tpu applies the restricted (Q)
    formula to the spin-orbital integrals and amplitudes (its registry bars
    only the U prefix); the port does the same, K9 included.  tuna_tpu
    prints UHF -7.7664017193, CCSDT -0.0002673166 and (Q) -0.0000002495."""
    line = "SPE : LI H 1.6 : CCSDT(Q) STO-3G : ML 3 TIGHTSCF"
    energy_ref, scf_ref, cc_ref, text_ref = _tuna_tpu(line)
    scf, energy, text = _port_run(line)
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == scf_ref
    assert len(scf.correlation_iteration_seconds) == cc_ref
    assert f"{scf.energy:.10f}" == "-7.7664017193"
    assert re.search(r"CCSDT correlation energy:\s+-0\.0002673166", text)
    assert re.search(r"CCSDT\(Q\) correlation energy:\s+-0\.0000002495", text)
    assert _quadruples_lines(text) == _quadruples_lines(text_ref)

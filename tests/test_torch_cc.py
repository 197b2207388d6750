"""The port's restricted coupled cluster and (T) against tuna_tpu.

Residuals and (T) take identical seeded numpy inputs in both packages and
agree to 1e-12 relative (the same contractions in float64, summed in
another order).  End to end, total energies agree to 1e-9 Ha and the CC
iteration counts to within one: the DIIS loop is mirrored, f32 spread
extrapolation included, but the two eigensolvers may pick different bases
of degenerate orbitals.
"""

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

NO, NV = 3, 5


def _physicists_integrals(rng, n):
    """Random <pq|rs> with the 8-fold symmetry of real orbitals."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    chem = 0.05 * (chem + chem.transpose(2, 3, 0, 1))
    return chem.transpose(0, 2, 1, 3).copy()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = NO + NV
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, NO)),
                          np.sort(rng.uniform(0.2, 3.0, NV))])
    return {
        "g": _physicists_integrals(rng, n),
        "eps": eps,
        "t1": 0.02 * rng.standard_normal((NO, NV)),
        "t2": 0.05 * rng.standard_normal((NO, NO, NV, NV)),
    }


def _relative_error(got, expected):
    return np.max(np.abs(got - expected)) / max(np.max(np.abs(expected)), 1e-300)


def _dressing_aux(seed, n_core):
    """A seeded aux of CC2/CC3: an AO tensor with the 8-fold symmetry, MO
    coefficients and a core Hamiltonian over n_core + NO + NV orbitals, the
    triples denominators, and FREEZECORE-style global slices o and v that
    start after n_core frozen orbitals."""
    rng = np.random.default_rng(seed)
    n = n_core + NO + NV
    H = rng.standard_normal((n, n))
    eps = np.sort(rng.uniform(-2.0, 3.0, NO + NV))
    e_o, e_v = eps[:NO], eps[NO:] + 2.5
    d3 = 1.0 / (e_o[:, None, None, None, None, None] + e_o[None, :, None, None, None, None]
                + e_o[None, None, :, None, None, None] - e_v[None, None, None, :, None, None]
                - e_v[None, None, None, None, :, None] - e_v[None, None, None, None, None, :])
    return {"ERI_AO": _physicists_integrals(rng, n).transpose(0, 2, 1, 3).copy(),
            "C": rng.standard_normal((n, n)) / np.sqrt(n), "H_core": 0.1 * (H + H.T),
            "d3": d3, "o": slice(n_core, n_core + NO), "v": slice(n_core + NO, None)}


_RESIDUAL_CASES = [("LCCD", 0), ("CCD", 0), ("LCCSD", 0), ("CID", 0), ("CISD", 0), ("QCISD", 0),
                   ("CCSD", 0), ("CC2", 0), ("CC2", 2), ("CC3", 0), ("CC3", 2)]


@pytest.mark.parametrize("method, n_core", _RESIDUAL_CASES,
                         ids=[m if n == 0 else f"{m}-frozen-core" for m, n in _RESIDUAL_CASES])
def test_residual_matches_tuna_tpu(method, n_core):
    x = _inputs(11)
    o, v = slice(0, NO), slice(NO, None)
    eps = x["eps"]
    d1 = 1.0 / (eps[o, None] - eps[None, v])
    d2 = 1.0 / (eps[o, None, None, None] + eps[None, o, None, None]
                - eps[None, None, v, None] - eps[None, None, None, v])
    F_ov = np.zeros((NO, NV))
    aux = _dressing_aux(7, n_core) if method in ("CC2", "CC3") else {}

    jax_blocks = jax_cc._restricted_blocks(jnp.asarray(x["g"]), o, v)
    expected = jax_cc._RESTRICTED_UPDATES[method](
        jax_blocks, jnp.asarray(F_ov), jnp.asarray(d1), jnp.asarray(d2),
        jnp.asarray(x["t1"]), jnp.asarray(x["t2"]),
        {k: a if isinstance(a, slice) else jnp.asarray(a) for k, a in aux.items()})

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    blocks = cc._restricted_blocks(t(x["g"]), o, v)
    got = cc._RESTRICTED_UPDATES[method](
        blocks, t(F_ov), t(d1), t(d2), t(x["t1"]), t(x["t2"]),
        {k: a if isinstance(a, slice) else t(a) for k, a in aux.items()})
    for g, e in zip(got, expected):
        assert _relative_error(g.numpy(), np.asarray(e)) <= 1e-12

    E = cc._restricted_energy(blocks, t(F_ov), got[0], got[1], True)[0]
    E_ref = jax_cc._restricted_energy(jax_blocks, jnp.asarray(F_ov), expected[0],
                                      expected[1], True)[0]
    assert abs(float(E) - float(E_ref)) <= 1e-12 * abs(float(E_ref))


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
def test_triples_energy_matches_tuna_tpu(v_scale):
    x = _inputs(5)
    o, v = slice(0, NO), slice(NO, None)
    g = x["g"]
    blocks = (g[o, o, v, v], g[o, v, v, v], g[o, o, v, o])
    e_ijkabc = jax_transforms.triples_epsilons(jnp.asarray(x["eps"]), o, v)
    V, W, W_weighted = jax_cc._restricted_T_tensors(
        *[jnp.asarray(b) for b in blocks], jnp.asarray(x["t1"]), jnp.asarray(x["t2"]),
        e_ijkabc)
    expected = (1.0 / 3.0) * float(jnp.einsum("ijkabc,ijkabc,ijkabc->", W + v_scale * V,
                                              W_weighted, e_ijkabc))

    _kernels.reset_launch_counts()
    got = cc.ccsd_t_energy(*[torch.as_tensor(np.ascontiguousarray(b)) for b in blocks],
                           torch.as_tensor(x["t1"]), torch.as_tensor(x["t2"]),
                           torch.as_tensor(x["eps"][o]), torch.as_tensor(x["eps"][v]),
                           v_scale)
    assert _kernels.launches["ccsd_t_energy"] == 0
    assert abs(float(got) - expected) <= 1e-12 * abs(expected)


_ORDERINGS = cc.TRIPLES_ORDERINGS


def _compose(p, s):
    """The ordering p after s: position d is p[s[d]]."""
    return _ORDERINGS.index(tuple(_ORDERINGS[p][_ORDERINGS[s][d]] for d in range(3)))


def _distinct(values):
    """(6, n) bool: ordering t of values (3, n) differs from every earlier
    ordering."""
    tuples = [torch.stack([values[d] for d in q]) for q in _ORDERINGS]
    return torch.stack([torch.stack([~torch.all(tuples[t] == tuples[e], dim=0)
                                     for e in range(t)]).all(dim=0) if t else
                        torch.ones(values.shape[1], dtype=torch.bool) for t in range(6)])


def _unpack_orbits(orbits):
    """(3, n) a, b, c of cc.triples_orbits' packed orbits."""
    packed = torch.as_tensor(orbits)
    mask = (1 << 21) - 1
    return torch.stack([packed & mask, (packed >> 21) & mask, packed >> 42])


def _slab_boxes(nv, a0, a1):
    """csrc/ccsd_t.cu's three boxes of a slot over [a0, a1) of a, in their
    order: the (a, b, c) ranges."""
    return (((a0, a1), (a0, nv), (a0, nv)), ((a1, nv), (a0, a1), (a0, nv)),
            ((a1, nv), (a1, nv), (a0, a1)))


def _slab_at(x, y, z, nv, a0, a1):
    """csrc/ccsd_t.cu's Slab::at: the offset of R[x, y, z] in such a slot,
    for min(x, y, z) in [a0, a1)."""
    L, w, L1 = nv - a0, a1 - a0, nv - a1
    return torch.where(x < a1, ((x - a0) * L + (y - a0)) * L + (z - a0),
                       torch.where(y < a1, w * L * L + ((x - a1) * w + (y - a0)) * L + (z - a0),
                                   w * L * (L + L1) + ((x - a1) * L1 + (y - a1)) * w + (z - a0)))


def _triples_by_multiset(g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale, cap):
    """K2's decomposition in plain torch: for each batch of cc.triples_plan,
    stage A forms R of each distinct ordering (i, j, k) as v products
    [G_ib | -O_ij] . [T_kj^T ; T_kb] of depth v + o and keeps the three
    boxes of the batch's range of a, one after the other; stage B reads,
    for each multiset and virtual orbit a <= b <= c with a in the range,
    the 36 values R_q[t(abc)] through Slab::at and sums (W + s V) Ww / D
    over the distinct orderings p and t."""
    no, nv = t1.shape
    batches, slots, multisets = cc.triples_plan(no, nv, cap)
    orbits, start = cc.triples_orbits(nv)
    energy = torch.zeros((), dtype=torch.float64)
    for slot_begin, slot_end, ms_begin, ms_end, a0, a1 in batches:
        assert ((slot_end - slot_begin) * 8 * cc.triples_slot_doubles(nv, a0, a1) <= cap
                or a1 - a0 == 1)
        v3 = _unpack_orbits(orbits[start[a0]:start[a1]])   # (3, orbits of the batch)
        first_t = _distinct(v3)
        R = []
        for i, j, k in slots[slot_begin:slot_end]:
            A = torch.cat([g_ovvv[i], -g_oovo[i, j].expand(nv, nv, no)], dim=2)   # (b, a, f|m)
            B = torch.cat([t2[k, j].T.expand(nv, nv, nv), t2[:, k].permute(1, 0, 2)],
                          dim=1)                                                # (b, f|m, c)
            full = torch.matmul(A, B).permute(1, 0, 2)                          # (a, b, c)
            R.append(torch.cat([full[slice(*a), slice(*b), slice(*c)].reshape(-1)
                                for a, b, c in _slab_boxes(nv, a0, a1)]))
            assert len(R[-1]) == cc.triples_slot_doubles(nv, a0, a1)
        at = [_slab_at(v3[x], v3[y], v3[z], nv, a0, a1) for x, y, z in _ORDERINGS]
        for i, j, k, *slot_of in multisets[ms_begin:ms_end]:
            o3 = torch.tensor([i, j, k])
            Rq = torch.stack([torch.stack([R[slot_of[q]][at[t]] for t in range(6)])
                              for q in range(6)])
            first_p = _distinct(o3[:, None])[:, 0]
            D = (eps_o[o3].sum() - eps_v[v3].sum(dim=0))
            for t in range(6):
                W = [sum(Rq[_compose(p, s), _compose(t, s)] for s in range(6)) for p in range(6)]
                for p in range(6):
                    if not first_p[p]:
                        continue
                    Ww = (4.0 * W[p] + W[_compose(p, 4)] + W[_compose(p, 5)]
                          - 4.0 * W[_compose(p, 2)] - W[_compose(p, 3)] - W[_compose(p, 1)])
                    oi = [int(o3[d]) for d in _ORDERINGS[p]]
                    vi = [v3[d] for d in _ORDERINGS[t]]
                    V = (g_oovv[oi[1], oi[2], vi[1], vi[2]] * t1[oi[0], vi[0]]
                         + g_oovv[oi[0], oi[2], vi[0], vi[2]] * t1[oi[1], vi[1]]
                         + g_oovv[oi[0], oi[1], vi[0], vi[1]] * t1[oi[2], vi[2]])
                    energy += torch.sum(torch.where(first_t[t], (W[p] + v_scale * V) * Ww / D,
                                                    0.0))
    return energy / 3.0


def _triples_inputs(no, nv, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((no, no, nv, nv)),
            0.1 * rng.standard_normal((no, nv, nv, nv)),
            0.1 * rng.standard_normal((no, no, nv, no)), 0.02 * rng.standard_normal((no, nv)),
            0.05 * rng.standard_normal((no, no, nv, nv)), np.sort(rng.uniform(-2.0, -0.3, no)),
            np.sort(rng.uniform(0.2, 3.0, nv)))


@pytest.mark.parametrize("v_scale", [1.0, 2.0])
@pytest.mark.parametrize("nv", [1, 4, 9])
@pytest.mark.parametrize("no", [1, 2, 3, 5])
def test_triples_decomposition_matches_tuna_tpu(no, nv, v_scale):
    """K2's batches, concatenated-depth products and distinct orderings
    (o = 1 and 2 make every multiset degenerate; v = 1 every virtual orbit)
    give tuna_tpu's (T) energy: at a cap of one ordering's R, which cuts
    every multiset of three or six orderings over ranges of a; at six
    orderings' R, one multiset a batch or more; at the default."""
    g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v = _triples_inputs(no, nv, 10 * no + nv)
    e_ijkabc = jax_transforms.triples_epsilons(jnp.asarray(np.concatenate([eps_o, eps_v])),
                                               slice(0, no), slice(no, None))
    V, W, W_weighted = jax_cc._restricted_T_tensors(
        *(jnp.asarray(x) for x in (g_oovv, g_ovvv, g_oovo, t1, t2)), e_ijkabc)
    expected = (1.0 / 3.0) * float(jnp.einsum("ijkabc,ijkabc,ijkabc->", W + v_scale * V,
                                              W_weighted, e_ijkabc))
    # at o = 1 or v = 1, W_ijk[abc] is symmetric under the orderings of ijk,
    # Ww = 0 and the energy is rounding residue: the limit is then 1e-12 of
    # the size of its terms before the cancellation, (1/3) sum |W + s V| 12
    # max|W| |1/D|
    scale = (abs(expected) if no > 1 and nv > 1 else
             4.0 * float(jnp.max(jnp.abs(W)) * jnp.sum(jnp.abs((W + v_scale * V) * e_ijkabc))))
    args = [torch.as_tensor(x) for x in (g_oovv, g_ovvv, g_oovo, t1, t2, eps_o, eps_v)]
    for cap in (8 * nv ** 3, 6 * 8 * nv ** 3, cc.TRIPLES_WORKSPACE_BYTES):
        got = float(_triples_by_multiset(*args, v_scale, cap))
        assert abs(got - expected) <= 1e-12 * scale


@pytest.mark.parametrize("no, nv, cap", [(7, 19, 8 * 19 ** 3 * 20), (7, 53, 128 * 2 ** 20),
                                         (4, 3, 1), (2, 5, 10 ** 9), (3, 40, 8 * 40 ** 3),
                                         (3, 150, 128 * 2 ** 20)])
def test_triples_plan_covers_every_ordered_triple_once(no, nv, cap):
    """Every ordered occupied triple has one slot; the batches of a multiset
    cut over a cover [0, v) in order; a batch's R fits the cap unless it is
    one a wide; the orbits and their starts."""
    batches, slots, multisets = cc.triples_plan(no, nv, cap)
    assert sorted(map(tuple, slots.tolist())) == [(i, j, k) for i in range(no)
                                                  for j in range(no) for k in range(no)]
    assert len(multisets) == no * (no + 1) * (no + 2) // 6
    assert batches[0, 0] == batches[0, 2] == batches[0, 4] == 0 and batches[-1, 1] == len(slots)
    for previous, row in zip(batches[:-1], batches[1:]):
        if row[4] == 0:   # a new group of multisets
            assert previous[5] == nv and np.all(row[[0, 2]] == previous[[1, 3]])
        else:             # the same multiset, the next range of a
            assert np.all(row[:4] == previous[:4]) and row[4] == previous[5]
            assert row[3] - row[2] == 1
    assert batches[-1, 5] == nv and np.all(batches[:, 4] < batches[:, 5])
    for slot_begin, slot_end, ms_begin, ms_end, a0, a1 in batches:
        assert ((slot_end - slot_begin) * 8 * cc.triples_slot_doubles(nv, a0, a1) <= cap
                or a1 - a0 == 1)
        for i, j, k, *slot_of in multisets[ms_begin:ms_end]:
            assert i <= j <= k
            for q, slot in zip(cc.TRIPLES_ORDERINGS, slot_of):
                assert 0 <= slot < slot_end - slot_begin
                assert tuple(slots[slot_begin + slot]) == tuple((i, j, k)[d] for d in q)
    orbits, start = cc.triples_orbits(nv)
    a, b, c = _unpack_orbits(orbits).numpy()
    assert len(orbits) == nv * (nv + 1) * (nv + 2) // 6 and np.all((a <= b) & (b <= c))
    assert len(set(orbits.tolist())) == len(orbits) and np.all(c < nv)
    assert np.array_equal(start, np.searchsorted(a, np.arange(nv + 1)))


@pytest.mark.parametrize("n_valid", [1, 3, 6])
def test_diis_coefficients_match_tuna_tpu(n_valid):
    """Same bordered DIIS system; tuna_tpu solves it with an f32 inverse and
    three f64 refinement steps, the port with an f64 LU, hence 1e-10."""
    M = 6
    rng = np.random.default_rng(n_valid)
    errors = rng.standard_normal((M, 40)) * np.logspace(-6, -1, M)[:, None]
    gram = errors @ errors.T
    ok_ref, expected = jax_cc._diis_coefficients_from_gram(jnp.asarray(gram), n_valid, M)
    ok, got = cc._diis_coefficients_from_gram(torch.as_tensor(gram), n_valid, M)
    assert bool(ok) and bool(ok_ref)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=0, atol=1e-10)
    assert abs(float(got.sum()) - 1.0) <= 1e-14


def _cc_iterations(output):
    """Number of rows in the printed CC iteration table."""
    table = output.split("Step          Correlation E")[-1].split("Singles contribution")[0]
    return len(re.findall(r"^\s+\d+\s+-?\d+\.\d{10}\s+-?\d+\.\d{10}\s*$", table, re.M))


# the first two lines keep their first limits (1e-9 Ha, CC iterations within
# one); the lines of the other restricted methods are held to 1e-10 Ha with
# equal SCF cycles and CC iterations
_FIRST_CC_LINES = ("SPE : N N 1.1 : CCSD[T] STO-3G : TIGHTSCF",
                   "SPE : H H 0.74 : CCSD[T] 6-31G : TIGHTSCF")


@pytest.mark.parametrize("line", [
    "SPE : N N 1.1 : CCSD[T] STO-3G : TIGHTSCF",
    "SPE : H H 0.74 : CCSD[T] 6-31G : TIGHTSCF",   # two electrons: reduces to CISD
    "SPE : N N 1.1 : LCCD STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : CCD STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : CEPA(0) STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : CID STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : QCISD STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : QCISD(T) STO-3G : TIGHTSCF",
    "SPE : N N 1.1 : CC2 6-31G : TIGHTSCF FREEZECORE",   # the dressing's global slices
    "SPE : N N 1.1 : CC3 STO-3G : TIGHTSCF",
])
def test_cc_energy_matches_tuna_tpu(line, capsys):
    capsys.readouterr()
    _, _, jax_energy, _ = jax_run(line)
    jax_printed = capsys.readouterr().out
    jax_iterations = _cc_iterations(jax_printed)
    scf, _, energy, P = run(line, device="cpu")
    printed = capsys.readouterr().out
    iterations = _cc_iterations(printed)
    assert jax_iterations > 0
    assert len(scf.correlation_iteration_seconds) == iterations
    assert bool(torch.all(torch.isfinite(P)))
    if line in _FIRST_CC_LINES:
        assert abs(energy - jax_energy) <= 1e-9
        assert abs(iterations - jax_iterations) <= 1
        return
    assert abs(energy - jax_energy) <= 1e-10
    assert iterations == jax_iterations
    cycles = r"converged in (\d+) cycles"
    assert re.findall(cycles, printed) == re.findall(cycles, jax_printed)


@pytest.mark.slow
def test_ccsd_t_cc_pvtz_matches_tuna_tpu(capsys):
    """CCSD[T] at cc-pVTZ (o = 7, v = 53, f shells) against tuna_tpu: the
    total energy within 1e-10 Ha with equal SCF cycles and CC iterations
    (several minutes and a few GB of host memory, hence slow)."""
    line = "SPE : N N 1.1 : CCSD[T] CC-PVTZ : TIGHTSCF"
    capsys.readouterr()
    _, _, jax_energy, _ = jax_run(line)
    jax_printed = capsys.readouterr().out
    _, _, energy, _ = run(line, device="cpu")
    printed = capsys.readouterr().out
    assert abs(energy - jax_energy) <= 1e-10
    assert _cc_iterations(printed) == _cc_iterations(jax_printed) > 0
    cycles = r"converged in (\d+) cycles"
    assert re.findall(cycles, printed) == re.findall(cycles, jax_printed)

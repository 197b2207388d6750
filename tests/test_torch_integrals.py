"""The port's integral engine (tuna_tpu_torch.ops) against tuna_tpu's.

Both packages integrate identical primitive data: the port's plan is built
from the JAX plan's arrays (IntegralPlan.from_arrays).  Tolerances: 1e-12
absolute for integrals (the same Hermite recursions in float64, summed in
another order), 1e-14 absolute for the Boys function (the same table and
recursions).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tuna_tpu.constants as jax_constants
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.methods import lookup_method as jax_lookup_method
from tuna_tpu.ops import boys as jax_boys
from tuna_tpu.ops.integrals import IntegralPlan as JaxPlan
from tuna_tpu.ops.integrals import cross_overlap as jax_cross_overlap
from tuna_tpu.system import Molecule as JaxMolecule

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.methods import lookup_method
from tuna_tpu_torch.basis import BASIS_TABLES
from tuna_tpu_torch.ops import boys, integrals
from tuna_tpu_torch.ops.integrals import (KERNEL_MAX_LMAX, SHARED_MEMORY_PER_BLOCK,
                                          TWO_PI_POW_2_5, IntegralPlan, _double_factorial,
                                          build_E_table, cross_overlap, gather_E_row,
                                          heavy_shared_bytes, shell_subset, stack_E_table)
from tuna_tpu_torch.system import Molecule

torch.set_num_threads(2)

PLAN_FIELDS = ("a", "b", "coef", "l1", "l2", "atom1", "atom2", "ao_i", "ao_j",
               "pair_id", "pair_index")
SYSTEMS = [
    (("H", "H"), 0.74, "STO-3G"),
    (("LI", "H"), 1.60, "STO-3G"),
    (("N", "N"), 1.10, "6-31G"),
    (("H", "F"), 0.95, "6-31G**"),   # d shells on F
]


def _coordinates(bond_angstrom, n_atoms):
    return np.array([[0.0, 0.0, 0.0],
                     [0.0, 0.0, jax_constants.angstrom_to_bohr(bond_angstrom)]])[:n_atoms]


def _molecules(symbols, bond, basis):
    """tuna_tpu's and the port's molecule.  A basis written "NAME:0h,1s"
    is a reduced one: each molecule keeps only the first shell of each
    (atom, l) listed (ops/integrals.py::shell_subset), the same subset in
    both packages."""
    symbols = list(symbols)
    coords = _coordinates(bond, len(symbols))
    basis, _, shells = basis.partition(":")
    jax_cfg = JaxConfig("SPE", jax_lookup_method("HF"), 0.0, [], basis, symbols,
                        suppress_output=True)
    cfg = Config("SPE", lookup_method("HF"), 0.0, [], basis, symbols, suppress_output=True)
    molecules = JaxMolecule(symbols, coords, jax_cfg), Molecule(symbols, coords, cfg)
    if shells:
        keep = [(int(shell[:-1]), "spdfgh".index(shell[-1])) for shell in shells.split(",")]
        for molecule in molecules:
            molecule.cartesian_basis_functions = shell_subset(
                molecule.cartesian_basis_functions, keep)
    return molecules


@functools.lru_cache(maxsize=None)
def _reference(symbols, bond, basis):
    """(molecule, port plan from the JAX plan's arrays, JAX one-electron
    matrices, JAX packed ERI, JAX dense ERI) for one system."""
    jax_molecule, _ = _molecules(symbols, bond, basis)
    jax_plan = JaxPlan(jax_molecule.cartesian_basis_functions, jax_molecule.n_atoms)
    plan = IntegralPlan.from_arrays(
        *[np.asarray(getattr(jax_plan, name)) for name in PLAN_FIELDS],
        n_atoms=jax_molecule.n_atoms)
    one_electron = [np.asarray(x) for x in jax_plan.one_electron(
        jax_molecule.coordinates, jax_molecule.charges.astype(float),
        jax_molecule.centre_of_mass)]
    packed = np.asarray(jax_plan.eri_pair_packed(jax_molecule.coordinates))
    dense = np.asarray(jax_plan.eri(jax_molecule.coordinates))
    return jax_molecule, plan, one_electron, packed, dense


@pytest.mark.parametrize("symbols,bond,basis", [
    (("H", "H"), 0.74, "STO-3G"),
    (("N", "N"), 1.10, "6-311G"),
])
def test_plan_arrays_match_tuna_tpu(symbols, bond, basis):
    jax_molecule, molecule = _molecules(symbols, bond, basis)
    jax_plan = JaxPlan(jax_molecule.cartesian_basis_functions, jax_molecule.n_atoms)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    for name in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(plan, name),
                                      np.asarray(getattr(jax_plan, name)), err_msg=name)
    assert (plan.n_basis, plan.n_pairs, plan.n_prim_pairs, plan.lmax) == (
        jax_plan.n_basis, jax_plan.n_pairs, jax_plan.n_prim_pairs, jax_plan.lmax)
    # CSR offsets: AO pair p owns primitive pairs pair_start[p]:pair_start[p+1]
    counts = np.bincount(np.asarray(jax_plan.pair_id), minlength=jax_plan.n_pairs)
    np.testing.assert_array_equal(np.diff(plan.pair_start), counts)


@pytest.mark.parametrize("nmax", [0, 2, 4, 12, 16, 20, 21])
def test_boys_table_matches_tuna_tpu(nmax):
    rng = np.random.default_rng(nmax)
    T = np.concatenate([np.linspace(0.0, 60.0, 2401), rng.uniform(0.0, 60.0, 2000),
                        [29.95, 30.0, 30.05, 0.05, 0.15]])
    expected = np.asarray(jax_boys.boys_table(nmax, jnp.asarray(T)))
    got = boys.boys_table(nmax, torch.as_tensor(T, dtype=torch.float64)).numpy()
    assert got.shape == (T.size, nmax + 1)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-14)


@pytest.mark.parametrize("symbols,bond,basis", SYSTEMS)
def test_one_electron_matches_tuna_tpu(symbols, bond, basis):
    molecule, plan, expected, _, _ = _reference(symbols, bond, basis)
    got = plan.one_electron(torch.as_tensor(molecule.coordinates, dtype=torch.float64),
                            torch.as_tensor(molecule.charges, dtype=torch.float64),
                            molecule.centre_of_mass)
    for name, g, e in zip("STVDQ", got, expected):
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("symbols,bond,basis", SYSTEMS)
def test_eri_matches_tuna_tpu(symbols, bond, basis):
    molecule, plan, _, packed, dense = _reference(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    np.testing.assert_allclose(plan.eri_pair_packed(coords).numpy(), packed,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(plan.eri(coords).numpy(), dense, rtol=0, atol=1e-12)


def test_cross_overlap_matches_tuna_tpu():
    jax_target, target = _molecules(("N", "N"), 1.10, "6-31G")
    jax_minimal, minimal = _molecules(("N", "N"), 1.10, "STO-3G")
    expected = jax_cross_overlap(jax_target.cartesian_basis_functions,
                                 jax_minimal.cartesian_basis_functions)
    got = cross_overlap(target.cartesian_basis_functions, minimal.cartesian_basis_functions)
    assert got.shape == (target.n_cartesian_basis, minimal.n_cartesian_basis)
    np.testing.assert_allclose(got, expected, rtol=0, atol=1e-12)


def test_kernels_dispatch_by_device():
    """CPU tensors take the plain versions and launch nothing; a device
    with no kernel raises instead of falling back."""
    molecule, plan, _, _, _ = _reference(("H", "H"), 0.74, "STO-3G")
    _kernels.reset_launch_counts()
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64)
    plan.one_electron(coords, charges, molecule.centre_of_mass)
    plan.eri_pair_packed(coords)
    assert all(count == 0 for count in _kernels.launches.values())
    with pytest.raises(ValueError):
        plan.eri_pair_packed(coords.to("meta"))
    with pytest.raises(ValueError):
        plan.one_electron(coords.to("meta"), charges.to("meta"), 0.0)


# --- the lane schedule of K3 and K8a (csrc/one_electron.cu, one_electron_deriv.cu)

LANE_SYSTEMS = SYSTEMS + [(("N", "N"), 1.10, "CC-PVTZ")]


@pytest.mark.parametrize("symbols,bond,basis", LANE_SYSTEMS)
def test_lane_schedule_holds_each_ao_pair_once(symbols, bond, basis):
    """IntegralPlan.lane_schedule: whole warps; every AO pair in exactly
    one group of w lanes, w the smallest power of two covering its
    primitive pairs (at most 32), starting at a lane that is a multiple of
    w; the pairs longest first, so a lane walks at most
    ceil(count / 32) primitive pairs."""
    _, plan = _plan(symbols, bond, basis)
    lanes = plan.lane_schedule()
    assert lanes.dtype == np.int32 and lanes.shape[1] == 2 and lanes.shape[0] % 32 == 0
    count = np.diff(plan.pair_start)
    pair, width = lanes[:, 0], lanes[:, 1]
    live = np.flatnonzero(pair >= 0)
    firsts = live[(live == 0) | (pair[live] != pair[np.maximum(live - 1, 0)]) | (live % 32 == 0)]
    assert sorted(pair[firsts]) == list(range(plan.n_pairs))    # one group each
    for lane in firsts:
        p, w = pair[lane], width[lane]
        assert lane % w == 0 and np.all(lanes[lane:lane + w] == (p, w))
        assert w == min(32, 1 << int(np.ceil(np.log2(count[p]))))
        assert w >= min(32, count[p]) and (w == 1 or w // 2 < count[p])
    assert np.all(np.diff(count[pair[firsts]]) <= 0)           # longest first
    assert np.all(width[pair < 0] == 1) and len(live) == width[firsts].sum()
    assert lanes.shape[0] - len(live) < 32


def _lane_sums_emulated(plan, values):
    """The order of K3 and K8a in NumPy: lane r of an AO pair's group of w
    sums the values (9, n_prim_pairs) of its primitive pairs r, r + w, ...
    in turn; then five butterflies over each warp (lanes 1, 2, 4, 8, 16
    apart, a step adding only inside groups at least that wide); lane 0 of
    a group gives [i, j] and [j, i] of the nine matrices."""
    lanes = plan.lane_schedule()
    N = plan.n_basis
    out = np.full((9, N, N), np.nan)
    for warp in lanes.reshape(-1, 32, 2):
        x = np.zeros((32, 9))
        for lane, (pair, width) in enumerate(warp):
            if pair >= 0:
                for k in range(plan.pair_start[pair] + (lane & (width - 1)),
                               plan.pair_start[pair + 1], width):
                    x[lane] = x[lane] + values[:, k]
        for offset in (1, 2, 4, 8, 16):
            x = np.where((warp[:, 1] > offset)[:, None], x + x[np.arange(32) ^ offset], x)
        for lane, (pair, width) in enumerate(warp):
            if pair >= 0 and lane % width == 0:
                k0 = plan.pair_start[pair]
                i, j = plan.ao_i[k0], plan.ao_j[k0]
                out[:, i, j] = out[:, j, i] = x[lane]
    return out


def _one_electron_call(function, molecule, plan):
    """The plan's `function` on the CPU: K3's integrals with the origin at
    the centre of mass, or K8a's tangents with atom 1 moving and the origin
    at its mass fraction of the bond (a single atom: the origin moving at
    half the rate)."""
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    charges = torch.as_tensor(molecule.charges, dtype=torch.float64)
    if function == "one_electron":
        return plan.one_electron(coords, charges, molecule.centre_of_mass)
    masses = np.asarray(molecule.masses, dtype=np.float64)
    fraction = float(masses[1] / masses.sum()) if molecule.n_atoms == 2 else 0.5
    return plan.one_electron_deriv(coords, charges, molecule.centre_of_mass, fraction)


@pytest.mark.parametrize("function", ["one_electron", "one_electron_deriv"])
@pytest.mark.parametrize("symbols,bond,basis", [
    (("N", "N"), 1.10, "6-311G"), (("C", "O"), 1.13, "CC-PVTZ"), (("C",), 0.0, "6-31G")])
def test_lane_sums_match_plain(function, symbols, bond, basis, monkeypatch):
    """The lane-strided sums and butterflies of K3 (one_electron) and K8a
    (one_electron_deriv), emulated in NumPy on the plain version's
    per-primitive-pair values, against the plain version's matrices: 1e-13
    of each matrix's largest |entry|, every entry written (N2/6-311G,
    CO/cc-pVTZ, and one atom)."""
    molecule, plan = _plan(symbols, bond, basis)
    captured = []
    scatter = IntegralPlan._scatter_one_electron

    def capture(self, t, s_val, t_val, v_val, d_vals, q_vals):
        captured.append(torch.stack([s_val, t_val, v_val, *d_vals, *q_vals]).numpy())
        return scatter(self, t, s_val, t_val, v_val, d_vals, q_vals)

    monkeypatch.setattr(IntegralPlan, "_scatter_one_electron", capture)
    S, T, V, D, Q = _one_electron_call(function, molecule, plan)
    expected = torch.cat([S[None], T[None], V[None], D, Q]).numpy()
    got = _lane_sums_emulated(plan, captured[0])
    assert not np.isnan(got).any()
    for m in range(9):
        assert np.max(np.abs(got[m] - expected[m])) <= 1e-13 * np.max(np.abs(expected[m])), m


# --- the quartet kernels' work list (csrc/quartet.cuh) ----------------------

WORK_LIST_SYSTEMS = [
    (("N", "N"), 1.10, "6-31G"),
    (("H", "F"), 0.95, "6-31G**"),
    (("N", "N"), 1.10, "CC-PVTZ"),   # f shells: classes up to (6, 6)
    (("H", "H"), 0.74, "CC-PV6Z:0h,1s"),   # an h shell: classes up to (10, 10)
]


@functools.lru_cache(maxsize=None)
def _plan(symbols, bond, basis):
    _, molecule = _molecules(symbols, bond, basis)
    return molecule, IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)


def _pair_angular_momenta(molecule, plan):
    """(L, x parity, y parity) of each AO pair, from the basis functions."""
    lmn = np.array([bf.lmn for bf in molecule.cartesian_basis_functions])
    pair = lmn[plan.pid_i] + lmn[plan.pid_j]
    return pair.sum(axis=1), pair[:, 0] % 2, pair[:, 1] % 2


@pytest.mark.parametrize("symbols,bond,basis", WORK_LIST_SYSTEMS)
def test_work_list_holds_each_parity_matched_quartet_once(symbols, bond, basis):
    molecule, plan = _plan(symbols, bond, basis)
    quartets, _ = plan.work_list()
    L, px, py = _pair_angular_momenta(molecule, plan)
    P, Q = np.tril_indices(plan.n_pairs)
    keep = (px[P] == px[Q]) & (py[P] == py[Q])
    expected = np.sort(P[keep].astype(np.int64) * plan.n_pairs + Q[keep])
    bra, ket = quartets[:, 0].astype(np.int64), quartets[:, 1].astype(np.int64)
    got = np.sort(np.maximum(bra, ket) * plan.n_pairs + np.minimum(bra, ket))
    np.testing.assert_array_equal(got, expected)   # each once, nothing else
    assert np.all(L[bra] >= L[ket])


def _sorted_work_list(plan):
    """IntegralPlan.work_list by a sort of every quartet: each parity
    class's unordered AO-pair quartets, the bra the pair of the larger L,
    sorted by (L_bra, L_ket, heavy, count descending, bra, ket); the class
    rows in launch order (longest chain, then most work)."""
    first = plan.pair_start[:-1]
    L = (plan.l1[first].sum(axis=1) + plan.l2[first].sum(axis=1)).astype(np.int64)
    parity = (2 * ((plan.l1[first, 0] + plan.l2[first, 0]) & 1)
              + ((plan.l1[first, 1] + plan.l2[first, 1]) & 1))
    n_prim = np.diff(plan.pair_start).astype(np.int64)
    P, Q = [], []
    for cls in range(4):
        members = np.flatnonzero(parity == cls)
        rows, cols = np.tril_indices(len(members))
        P.append(members[rows])
        Q.append(members[cols])
    P, Q = np.concatenate(P), np.concatenate(Q)
    bra, ket = np.where(L[Q] > L[P], Q, P), np.where(L[Q] > L[P], P, Q)
    count = n_prim[bra] * n_prim[ket]
    threshold = integrals.HEAVY_THRESHOLD
    order = np.lexsort((ket, bra, -count, count > threshold, L[ket], L[bra]))
    bra, ket, count = bra[order], ket[order], count[order]
    l_bra, l_ket = L[bra], L[ket]
    begins = np.flatnonzero(np.r_[True, (l_bra[1:] != l_bra[:-1]) | (l_ket[1:] != l_ket[:-1])])
    ends = np.r_[begins[1:], len(bra)]
    classes, chain, work = [], [], []
    for begin, end in zip(begins, ends):
        split = begin + int(np.sum(count[begin:end] <= threshold))
        ops = sum(integrals.quartet_operations(int(l_bra[begin]), int(l_ket[begin])))
        classes.append((l_bra[begin], l_ket[begin], begin, split, end,
                        n_prim[bra[split:end]].max(initial=0),
                        n_prim[ket[split:end]].max(initial=0)))
        chain.append(ops * max(count[begin] if split > begin else 0,
                               -(-count[split] // 32) if end > split else 0))
        work.append(ops * int(count[begin:end].sum()))
    classes = np.array([classes[k] for k in np.lexsort((-np.array(work), -np.array(chain)))],
                       dtype=np.int32).reshape(-1, 7)
    return np.stack([bra, ket], axis=1).astype(np.int32), classes


@pytest.mark.parametrize("threshold", [0, 16, 10 ** 9])
@pytest.mark.parametrize("symbols,bond,basis", WORK_LIST_SYSTEMS)
def test_work_list_matches_a_sort_of_every_quartet(symbols, bond, basis, threshold,
                                                   monkeypatch):
    """The work list, built class by class and run by run, is the array a
    sort of every quartet gives, bit for bit, classes and all."""
    molecule, _ = _plan(symbols, bond, basis)
    monkeypatch.setattr(integrals, "HEAVY_THRESHOLD", threshold)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    quartets, classes = plan.work_list()
    expected_quartets, expected_classes = _sorted_work_list(plan)
    assert quartets.dtype == np.int32 and quartets.flags.c_contiguous
    np.testing.assert_array_equal(quartets, expected_quartets)
    np.testing.assert_array_equal(classes, expected_classes)


@pytest.mark.parametrize("threshold", [0, 16, 10 ** 9])
@pytest.mark.parametrize("symbols,bond,basis", WORK_LIST_SYSTEMS)
def test_work_list_classes_are_uniform_sorted_and_split(symbols, bond, basis, threshold,
                                                        monkeypatch):
    molecule, _ = _plan(symbols, bond, basis)
    monkeypatch.setattr(integrals, "HEAVY_THRESHOLD", threshold)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    quartets, classes = plan.work_list()
    L, _, _ = _pair_angular_momenta(molecule, plan)
    n_prim = np.diff(plan.pair_start)
    counts = n_prim[quartets[:, 0]] * n_prim[quartets[:, 1]]
    assert classes.dtype == np.int32 and classes.shape[1] == 7
    keys = [(la, lb) for la, lb in classes[:, :2]]
    assert len(set(keys)) == len(keys)
    assert sorted((begin, end) for begin, end in classes[:, [2, 4]].tolist()) == [
        (b, e) for b, e in zip(sorted(classes[:, 2]), sorted(classes[:, 4]))]
    assert classes[:, 4].sum() - classes[:, 2].sum() == len(quartets)
    for la, lb, begin, split, end, max_bra, max_ket in classes:
        assert la >= lb and begin < end and begin <= split <= end
        part = slice(begin, end)
        assert np.all(L[quartets[part, 0]] == la) and np.all(L[quartets[part, 1]] == lb)
        assert np.all(counts[begin:split] <= threshold)              # light
        assert np.all(counts[split:end] > threshold)                 # heavy
        for sorted_part in (slice(begin, split), slice(split, end)):  # largest count first
            assert np.all(np.diff(counts[sorted_part]) <= 0)
        heavy = slice(split, end)
        assert max_bra == n_prim[quartets[heavy, 0]].max(initial=0)
        assert max_ket == n_prim[quartets[heavy, 1]].max(initial=0)


def test_heavy_rows_fit_in_shared_memory_for_every_basis():
    """A heavy quartet's warp stages its bra and ket primitive pairs in
    shared memory.  For each basis of the library K1 and K4 take (lmax <=
    5: all of them), the most primitive pairs of a pair of total angular momentum L over
    all its elements bounds any molecule's rows of that L; every class
    (L_bra, L_ket) at that bound fits a block."""
    worst = 0
    for name, table in BASIS_TABLES.items():
        most = {}   # angular momentum -> most primitives of a shell
        for shells in table.values():
            for letter, primitives in shells:
                l = "SPDFGH".index(letter)
                most[l] = max(most.get(l, 0), len(primitives))
        if max(most) > KERNEL_MAX_LMAX["eri_packed"][1]:
            continue
        pairs = {}  # L -> most primitive pairs of an AO pair
        for l1, n1 in most.items():
            for l2, n2 in most.items():
                pairs[l1 + l2] = max(pairs.get(l1 + l2, 0), n1 * n2)
        classes = np.array([(la, lb, 0, 0, 1, pairs[la], pairs[lb])
                            for la in pairs for lb in pairs if lb <= la])
        need = int(heavy_shared_bytes(classes).max())
        assert need <= SHARED_MEMORY_PER_BLOCK, name
        worst = max(worst, need)
    assert worst == 221648   # (ss|ss) of the ANO bases' 21-primitive s shells


def test_heavy_rows_of_the_most_contracted_basis(monkeypatch):
    """Ar in aug-ANO-pVTZ (s shells of 21 primitives, f shells): the work
    list's heavy parts fit, the largest being (ss|ss) at 441 x 441
    primitive pairs; a block too small for it is refused on the host."""
    _, molecule = _molecules(("AR",), 0.0, "AUG-ANO-PVTZ")
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    assert plan.lmax == 3
    _, classes = plan.work_list()
    need = heavy_shared_bytes(classes)
    worst = classes[int(np.argmax(need))]
    assert worst.tolist()[:2] + worst.tolist()[5:] == [0, 0, 441, 441]
    assert need.max() <= SHARED_MEMORY_PER_BLOCK
    plan._kernel_work_list("cpu")
    monkeypatch.setattr(integrals, "SHARED_MEMORY_PER_BLOCK", int(need.max()) - 1)
    with pytest.raises(NotImplementedError, match=r"class \(0, 0\)"):
        plan._kernel_work_list("cpu")


def _eri_packed_by_class(plan, coords):
    """The quartet kernels' arithmetic in plain torch, unscaled: every class
    of the work list at its own (L_bra, L_ket), Hermite rows cut to L + 1
    orders an axis, Boys of order L_bra + L_ket from its own Taylor table,
    and the Hermite Coulomb sum over v + 2n <= L_bra + L_ket only."""
    t = plan.tensors("cpu")
    lmax = plan.lmax
    A, B = coords[t["atom1"].long()], coords[t["atom2"].long()]
    a, b = t["a"], t["b"]
    p = a + b
    Pz = (a * A[:, 2] + b * B[:, 2]) / p
    E = [gather_E_row(stack_E_table(build_E_table(lmax, lmax, A[:, axis] - B[:, axis], a, b),
                                    lmax, lmax, 2 * lmax),
                      t["l1"][:, axis].long(), t["l2"][:, axis].long())
         for axis in range(3)]
    start = plan.pair_start.astype(np.int64)
    quartets, classes = plan.work_list()
    packed = torch.zeros((plan.n_pairs, plan.n_pairs), dtype=torch.float64)
    for la, lb, begin, _, end, _, _ in classes:
        bra, ket = quartets[begin:end, 0], quartets[begin:end, 1]
        nr, nc = start[bra + 1] - start[bra], start[ket + 1] - start[ket]
        n = nr * nc
        owner = np.repeat(np.arange(len(bra)), n)
        k = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
        r = torch.as_tensor(start[bra][owner] + k // nc[owner])
        c = torch.as_tensor(start[ket][owner] + k % nc[owner])
        nm, nxy = int(la + lb), int(la + lb) // 2
        sign = torch.tensor([(-1.0) ** u for u in range(lb + 1)], dtype=torch.float64)
        g = []
        for axis in range(3):
            prod = E[axis][r, :la + 1, None] * (E[axis][c, :lb + 1] * sign)[:, None, :]
            total = torch.zeros((len(r), nm + 1), dtype=torch.float64)
            for ti in range(la + 1):
                total[:, ti:ti + lb + 1] += prod[:, ti, :]
            g.append(total)
        double_factorial = torch.tensor([_double_factorial(2 * m - 1) for m in range(nxy + 1)],
                                        dtype=torch.float64)
        gx = g[0][:, 0:2 * nxy + 1:2] * double_factorial
        gy = g[1][:, 0:2 * nxy + 1:2] * double_factorial
        axy = torch.zeros((len(r), nxy + 1), dtype=torch.float64)
        for mx in range(nxy + 1):
            axy[:, mx:] += gx[:, mx:mx + 1] * gy[:, :nxy + 1 - mx]
        q = p[c]
        alpha = p[r] * q / (p[r] + q)
        PQz = Pz[r] - Pz[c]
        F = boys.boys_table(nm, alpha * PQz * PQz)
        R = [F * (-2.0 * alpha[:, None]) ** torch.arange(nm + 1, dtype=torch.float64)]
        for v in range(1, nm + 1):   # R[v][:, n] = R^n_{00v}, n <= nm - v
            row = PQz[:, None] * R[v - 1][:, 1:]
            if v > 1:
                row = row + (v - 1) * R[v - 2][:, 1:nm - v + 2]
            R.append(row)
        value = torch.zeros(len(r), dtype=torch.float64)
        for v in range(nm + 1):
            n_top = min(nxy, (nm - v) // 2)
            value += g[2][:, v] * torch.sum(axy[:, :n_top + 1] * R[v][:, :n_top + 1], dim=1)
        value *= (t["coef"][r] * t["coef"][c] * TWO_PI_POW_2_5
                  / (p[r] * q * torch.sqrt(p[r] + q)))
        sums = torch.zeros(len(bra), dtype=torch.float64).index_add_(
            0, torch.as_tensor(owner), value)
        packed[bra, ket] = sums
        packed[ket, bra] = sums
    return packed


def test_class_truncation_is_exact():
    """Cutting each quartet to its own class drops only exact zeros: the
    class-by-class arithmetic equals the plain sweep at the molecule's
    LMAX (HF/6-31G**, lmax 2, classes up to (4, 4)) and tuna_tpu."""
    molecule, plan, _, packed_jax, _ = _reference(("H", "F"), 0.95, "6-31G**")
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    got = _eri_packed_by_class(plan, coords)
    assert len(plan.work_list()[1]) == 15   # every (L_bra, L_ket) up to (4, 4)
    np.testing.assert_allclose(got.numpy(), plan._eri_packed_plain(coords).numpy(),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(got.numpy(), packed_jax, rtol=0, atol=1e-12)


def test_class_truncation_is_exact_to_h_shells():
    """As test_class_truncation_is_exact at lmax 5: an h shell on one H of
    H2/cc-pV6Z and an s shell on the other, classes up to (10, 10) and Boys
    order 20, against the plain sweep at the molecule's LMAX (which
    tests/test_torch_high_l.py holds to tuna_tpu on the same subset)."""
    molecule, plan = _plan(("H", "H"), 0.74, "CC-PV6Z:0h,1s")
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    got = _eri_packed_by_class(plan, coords)
    assert plan.lmax == 5
    assert sorted(map(tuple, plan.work_list()[1][:, :2].tolist())) == [
        (0, 0), (5, 0), (5, 5), (10, 0), (10, 5), (10, 10)]
    np.testing.assert_allclose(got.numpy(), plan._eri_packed_plain(coords).numpy(),
                               rtol=0, atol=1e-13)


# --- the shell quartets of K8b and K8bu (csrc/eri_deriv.cu) -----------------

SHELL_SYSTEMS = SYSTEMS + [(("N", "N"), 1.10, "CC-PVTZ")]
# (shell quartets, their primitive quartets) at N2/cc-pVTZ
N2_CC_PVTZ_SHELL_QUARTETS = (12636, 227388)


def _live_work_list(plan):
    """The work list's AO-pair quartets whose four functions do not all sit
    on one atom, as sorted unordered keys."""
    quartets, _ = plan.work_list()
    first = plan.pair_start[:-1]
    atom = np.where(plan.atom1[first] == plan.atom2[first], plan.atom1[first], -1)
    A, B = quartets[:, 0].astype(np.int64), quartets[:, 1].astype(np.int64)
    live = ~((atom[A] >= 0) & (atom[A] == atom[B]))
    return np.sort(np.maximum(A, B)[live] * plan.n_pairs + np.minimum(A, B)[live]), atom


@pytest.mark.parametrize("symbols,bond,basis", SHELL_SYSTEMS)
def test_shell_quartets_hold_each_live_quartet_once(symbols, bond, basis):
    """IntegralPlan.shell_quartets: every live AO-pair quartet of the work
    list exactly once, none on one atom, each in the shell quartet of its
    two shell pairs with A in the bra, the bra of the larger L; rows sorted
    by class and contiguous over the components."""
    molecule, plan = _plan(symbols, bond, basis)
    components, quartets = plan.shell_quartets()
    shell_pair, shell_prim = plan.shell_pairs()
    assert components.dtype == np.int32 and quartets.dtype == np.int32
    assert quartets.shape[1] == 6
    expected, atom = _live_work_list(plan)
    A, B = components[:, 0].astype(np.int64), components[:, 1].astype(np.int64)
    got = np.sort(np.maximum(A, B) * plan.n_pairs + np.minimum(A, B))
    np.testing.assert_array_equal(got, expected)
    assert not np.any((atom[A] >= 0) & (atom[A] == atom[B]))
    L, _, _ = _pair_angular_momenta(molecule, plan)
    np.testing.assert_array_equal(quartets[:, 4], np.r_[0, quartets[:-1, 5]])
    assert quartets[-1, 5] == len(components)
    for la, lb, sa, sb, begin, end in quartets:
        assert begin < end and la >= lb and (la > lb or sa >= sb)
        assert np.all(shell_pair[A[begin:end]] == sa) and np.all(shell_pair[B[begin:end]] == sb)
        assert np.all(L[A[begin:end]] == la) and np.all(L[B[begin:end]] == lb)
    keys = quartets[:, 2].astype(np.int64) * len(shell_prim) + quartets[:, 3]
    assert len(np.unique(keys)) == len(quartets)
    assert np.all(np.diff(quartets[:, 0] * 16 + quartets[:, 1]) >= 0)
    if basis == "CC-PVTZ":
        prims = shell_prim[quartets[:, 2]] * shell_prim[quartets[:, 3]]
        assert (len(quartets), int(prims.sum())) == N2_CC_PVTZ_SHELL_QUARTETS


@pytest.mark.parametrize("symbols,bond,basis", SHELL_SYSTEMS)
def test_shell_pairs_share_their_primitive_pairs(symbols, bond, basis):
    """Every AO pair of one shell pair has the same count of primitive
    pairs and, pair by pair, the same p and P_z bit for bit; its AOs share
    an atom, L and exponents."""
    molecule, plan = _plan(symbols, bond, basis)
    shell_pair, shell_prim = plan.shell_pairs()
    z = np.asarray(molecule.coordinates)[:, 2]
    p = plan.a + plan.b
    Pz = (plan.a * z[plan.atom1] + plan.b * z[plan.atom2]) / p
    count = np.diff(plan.pair_start)
    _, first = np.unique(shell_pair, return_index=True)
    np.testing.assert_array_equal(count[first], shell_prim)
    for pair in range(plan.n_pairs):
        head = first[shell_pair[pair]]
        own = slice(plan.pair_start[pair], plan.pair_start[pair + 1])
        ref = slice(plan.pair_start[head], plan.pair_start[head + 1])
        assert count[pair] == count[head]
        assert p[own].tobytes() == p[ref].tobytes() and Pz[own].tobytes() == Pz[ref].tobytes()
        assert np.array_equal(plan.atom1[own], plan.atom1[ref])
        assert np.array_equal(plan.atom2[own], plan.atom2[ref])


@pytest.mark.parametrize("ops", [1, 300, 1000, 10 ** 9])
@pytest.mark.parametrize("symbols,bond,basis", SHELL_SYSTEMS)
def test_deriv_schedule_covers_each_item_once(symbols, bond, basis, ops, monkeypatch):
    """IntegralPlan.deriv_schedule at SHELL_TASK_OPS = `ops` (1: runs cut
    into tasks of one component; 10**9: no run cut): a shell quartet's
    primitive quartets in runs of at most SHELL_TASK_THREADS from 0, each
    run's components tiled by its tasks, so every (component, primitive
    quartet) item is one task's; a run in one
    task forms its shared parts there (-1), a run cut into several tasks
    reads them from its row of deriv_tables; a task holds at most `ops`
    operations of own part a thread (one component at least); the class
    rows cover the tasks, each class's tasks contiguous, sorted by the
    items a thread takes, with the most primitive quartets of one."""
    molecule, _ = _plan(symbols, bond, basis)
    monkeypatch.setattr(integrals, "SHELL_TASK_OPS", ops)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    components, quartets = plan.shell_quartets()
    _, shell_prim = plan.shell_pairs()
    tasks, classes = plan.deriv_schedule()
    runs, owner, _ = plan.deriv_tables()
    width = integrals.SHELL_TASK_THREADS
    assert tasks.dtype == np.int32 and tasks.shape[1] == 8 and classes.shape[1] == 5
    begin, end = quartets[:, 4].astype(np.int64), quartets[:, 5].astype(np.int64)
    nc = shell_prim[quartets[:, 3]]
    all_prims = shell_prim[quartets[:, 2]] * nc
    bra0, ket0, t_nc, g0, n, c0, c1, formed = (tasks[:, k].astype(np.int64) for k in range(8))
    sq = np.searchsorted(begin, c0, side="right") - 1
    assert np.all(c0 >= begin[sq]) and np.all(c1 <= end[sq]) and np.all(c0 < c1)
    assert np.all(t_nc == nc[sq])
    assert np.all(bra0 == plan.pair_start[components[begin[sq], 0]])
    assert np.all(ket0 == plan.pair_start[components[begin[sq], 1]])
    assert np.all((g0 % width == 0) & (n == np.minimum(width, all_prims[sq] - g0)) & (n > 0))
    own = np.array([integrals.deriv_quartet_operations(int(la), int(lb))[1]
                    for la, lb in quartets[sq, :2]])
    assert np.all((n * (c1 - c0) * own <= width * ops) | (c1 - c0 == 1))
    if ops == 10 ** 9:
        assert np.all(formed == -1) and len(runs) == 0
    # each (shell quartet, run of primitive quartets): components tiled once
    order = np.lexsort((c0, g0, sq))
    run = sq[order] * (all_prims.max() + 1) + g0[order]
    starts = np.r_[True, run[1:] != run[:-1]]
    ends = np.r_[starts[1:], True]
    assert np.all(c0[order][starts] == begin[sq[order][starts]])
    assert np.all(c1[order][ends] == end[sq[order][ends]])
    assert np.all(c1[order][:-1][~ends[:-1]] == c0[order][1:][~starts[1:]])
    np.testing.assert_array_equal(np.bincount(sq[order][starts], minlength=len(quartets)),
                                  -(-all_prims // width))
    assert np.sum(n * (c1 - c0)) == np.sum(all_prims * (end - begin))
    # a run in one task forms its shared parts; a cut run reads its table
    pieces = np.diff(np.r_[np.flatnonzero(starts), len(run)])
    cut = np.repeat(pieces > 1, pieces)
    assert np.all(formed[order][~cut] == -1)
    assert np.all(np.isin(formed[order][cut], runs[:, 6]))
    head = order[starts][pieces > 1]
    np.testing.assert_array_equal(np.sort(formed[head]), np.sort(runs[:, 6]))
    # each shared part formed once: in its task or in the pass over the runs
    assert np.sum(n[order][starts][pieces == 1]) + len(owner) == np.sum(all_prims)
    # classes: every task once, of the class's (L_bra, L_ket), largest first
    spans = sorted(map(tuple, classes[:, 2:4].tolist()))
    assert spans[0][0] == 0 and spans[-1][1] == len(tasks)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    thread_items = -(-(n * (c1 - c0)) // width)
    for la, lb, first, last, most in classes:
        assert np.all(quartets[sq[first:last], 0] == la)
        assert np.all(quartets[sq[first:last], 1] == lb)
        assert np.all(np.diff(thread_items[first:last]) <= 0)
        assert most == n[first:last].max()
    assert plan.deriv_partial_count() == len(tasks)


@pytest.mark.parametrize("symbols,bond,basis", SHELL_SYSTEMS)
def test_deriv_tables_place_each_cut_run_once(symbols, bond, basis, monkeypatch):
    """IntegralPlan.deriv_tables at SHELL_TASK_OPS = 1, where every run of
    more than one component is cut: a row a run (its shell quartet's first bra and ket primitive
    pairs, nc, L_bra + L_ket, g0, n, the offset of its tables, its first
    primitive quartet in the flat count); the tables tile `doubles`
    without a gap, coulomb_entries(L_bra + L_ket) entries a primitive
    quartet, and owner names each flat primitive quartet's run once."""
    molecule, _ = _plan(symbols, bond, basis)
    monkeypatch.setattr(integrals, "SHELL_TASK_OPS", 1)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    components, quartets = plan.shell_quartets()
    _, shell_prim = plan.shell_pairs()
    runs, owner, doubles = plan.deriv_tables()
    assert runs.dtype == np.int32 and runs.shape[1] == 8
    one_component = quartets[:, 5] - quartets[:, 4] == 1
    prims = shell_prim[quartets[:, 2]] * shell_prim[quartets[:, 3]]
    assert len(owner) == prims[~one_component].sum()
    bra0, ket0, nc, l_sum, g0, n, offset, first = (runs[:, k].astype(np.int64)
                                                   for k in range(8))
    row = {(int(b), int(k), int(g)): i for i, (b, k, g) in enumerate(zip(bra0, ket0, g0))}
    assert len(row) == len(runs)
    start = plan.pair_start[components[quartets[:, 4]]]
    for sq in np.flatnonzero(~one_component):
        for g in range(0, prims[sq], integrals.SHELL_TASK_THREADS):
            i = row[(int(start[sq, 0]), int(start[sq, 1]), g)]
            assert nc[i] == shell_prim[quartets[sq, 3]]
            assert l_sum[i] == quartets[sq, 0] + quartets[sq, 1]
            assert n[i] == min(integrals.SHELL_TASK_THREADS, prims[sq] - g)
    size = n * np.array([integrals.coulomb_entries(int(k)) for k in l_sum])
    np.testing.assert_array_equal(offset, np.cumsum(size) - size)
    np.testing.assert_array_equal(first, np.cumsum(n) - n)
    assert doubles == size.sum()
    np.testing.assert_array_equal(owner, np.repeat(np.arange(len(runs)), n))
    assert [integrals.coulomb_entries(k) for k in (0, 1, 11, 12)] == [2, 3, 48, 56]


def test_deriv_schedule_of_one_atom_is_empty():
    """One atom: every quartet sits on it, so no shell quartet is live, and
    the schedule, the tables and the partials are empty (the sum is 0)."""
    _, plan = _plan(("C",), 0.0, "6-31G")
    components, quartets = plan.shell_quartets()
    tasks, classes = plan.deriv_schedule()
    runs, owner, doubles = plan.deriv_tables()
    assert components.shape == (0, 2) and quartets.shape == (0, 6)
    assert tasks.shape == (0, 8) and classes.shape == (0, 5)
    assert runs.shape == (0, 8) and owner.shape == (0,) and doubles == 0
    assert plan.deriv_partial_count() == 0


def _deriv_weights(plan, components, P_a, P_b, hfx, unrestricted):
    """Each component's weight as csrc/eri_deriv.cu's weight pass forms it:
    the degeneracy times the Coulomb and exchange products (EnergyWeight on
    P = P_a + P_b, or UnrestrictedEnergyWeight)."""
    A, B = components[:, 0], components[:, 1]
    i, j, k, l = plan.pid_i[A], plan.pid_j[A], plan.pid_i[B], plan.pid_j[B]
    degeneracy = (np.where(i != j, 2.0, 1.0) * np.where(k != l, 2.0, 1.0)
                  * np.where(A != B, 2.0, 1.0))
    P = P_a + P_b
    coulomb = 0.5 * P[i, j] * P[k, l]
    if unrestricted:
        ik_jl = P_a[i, k] * P_a[j, l] + P_b[i, k] * P_b[j, l]
        il_jk = P_a[i, l] * P_a[j, k] + P_b[i, l] * P_b[j, k]
        exchange = 0.25 * hfx * (ik_jl + il_jk)
    else:
        exchange = 0.125 * hfx * (P[i, k] * P[j, l] + P[i, l] * P[j, k])
    return degeneracy * (coulomb - exchange)


def _deriv_kernel_order(plan, task_thread_sums):
    """csrc/eri_deriv.cu's order of summation over the thread sums of each
    task (one block of SHELL_TASK_THREADS threads): a fixed-order shuffle a
    warp, the block's warps in turn, the tasks in the classes' launch
    order, then the 256-thread reduction of the partials."""
    _, classes = plan.deriv_schedule()
    partials = []
    for _, _, first, last, _ in classes:
        for idx in range(first, last):
            partial = None
            for v in task_thread_sums(idx).reshape(-1, 32):
                for offset in (16, 8, 4, 2, 1):
                    v = v + np.concatenate([v[offset:], v[32 - offset:]])
                partial = v[0] if partial is None else partial + v[0]
            partials.append(partial)
    red = np.zeros(256)
    for t in range(256):
        for x in partials[t::256]:
            red[t] = red[t] + x
    for s in (128, 64, 32, 16, 8, 4, 2, 1):
        red[:s] = red[:s] + red[s:2 * s]
    return red[0]


@functools.lru_cache(maxsize=None)
def _deriv_inputs(symbols, bond, basis):
    """(molecule, plan, coords, seeded P_a != P_b, the plain sweep's packed
    derivative values) for the weight emulation."""
    molecule, plan = _plan(symbols, bond, basis)
    coords = torch.as_tensor(molecule.coordinates, dtype=torch.float64)
    rng = np.random.default_rng(18)
    C_a, C_b = (rng.standard_normal((plan.n_basis, k)) / np.sqrt(plan.n_basis) for k in (3, 2))
    packed = plan._eri_packed_plain(coords, derivative=True).numpy()
    return molecule, plan, coords, C_a @ C_a.T, C_b @ C_b.T, packed


DERIV_EMULATION_SYSTEMS = [(("H", "H"), 0.74, "STO-3G"), (("C", "O"), 1.13, "6-31G"),
                           (("H", "F"), 0.95, "6-31G**")]


@pytest.mark.parametrize("hfx", [0.0, 0.25])
@pytest.mark.parametrize("unrestricted", [False, True])
@pytest.mark.parametrize("symbols,bond,basis", DERIV_EMULATION_SYSTEMS)
def test_deriv_weights_emulated_match_plain(symbols, bond, basis, unrestricted, hfx):
    """K8b's and K8bu's weights (degeneracies included) on the plain
    sweep's derivative values of each component, summed shell quartet by
    shell quartet in the schedule's order, against the plain versions'
    contraction of the N^4 tangent: 1e-13 relative, Pa != Pb seeded."""
    _, plan, coords, P_a, P_b, packed = _deriv_inputs(symbols, bond, basis)
    components, quartets = plan.shell_quartets()
    tasks, classes = plan.deriv_schedule()
    weights = _deriv_weights(plan, components, P_a, P_b, hfx, unrestricted)
    values = packed[components[:, 0], components[:, 1]] * weights
    seen, total = set(), 0.0
    for _, _, first, last, _ in classes:
        for c0 in tasks[first:last, 5]:
            sq = int(np.searchsorted(quartets[:, 4], c0, side="right") - 1)
            if sq not in seen:
                seen.add(sq)
                part = 0.0
                for v in values[quartets[sq, 4]:quartets[sq, 5]]:
                    part += v
                total += part
    assert len(seen) == len(quartets)
    if unrestricted:
        expected = plan._eri_deriv_energy_unrestricted_plain(
            coords, torch.as_tensor(P_a), torch.as_tensor(P_b), hfx)
    else:
        expected = plan._eri_deriv_energy_plain(coords, torch.as_tensor(P_a + P_b), hfx)
    assert abs(total - float(expected)) <= 1e-13 * abs(float(expected))


@pytest.mark.parametrize("ops", [1, 300, 1000])
@pytest.mark.parametrize("symbols,bond,basis", DERIV_EMULATION_SYSTEMS[:2])
def test_deriv_tasks_emulated_match_plain(symbols, bond, basis, ops, monkeypatch):
    """K8b's items in NumPy: thread t of a task takes items t, t + 128, ...
    (component c0 + i // n, primitive quartet g0 + i % n: bra primitive
    pair g // nc of its A, ket g % nc of its B), each the plain sweep's
    primitive-quartet value times its weight, in csrc/eri_deriv.cu's order
    of summation; against the plain version: 1e-13 relative, at
    SHELL_TASK_OPS 1 (every run of several components cut into tasks of
    one), 300 and 1000 (some runs cut into several tasks)."""
    molecule, _, coords, P_a, P_b, _ = _deriv_inputs(symbols, bond, basis)
    monkeypatch.setattr(integrals, "SHELL_TASK_OPS", ops)
    plan = IntegralPlan(molecule.cartesian_basis_functions, molecule.n_atoms)
    components, quartets = plan.shell_quartets()
    tasks, _ = plan.deriv_schedule()
    weights = _deriv_weights(plan, components, P_a, P_b, 0.25, False)
    _, block_values = plan._plain_sweep(coords, derivative=True)
    start = plan.pair_start.astype(np.int64)
    tables = {}   # shell quartet -> (its primitive-quartet values, bra rows, ket rows)

    def values(sq, rows, cols):
        if sq not in tables:
            begin, end = quartets[sq, 4], quartets[sq, 5]
            bra = np.unique(np.concatenate([np.arange(start[A], start[A + 1])
                                            for A in np.unique(components[begin:end, 0])]))
            ket = np.unique(np.concatenate([np.arange(start[B], start[B + 1])
                                            for B in np.unique(components[begin:end, 1])]))
            tables[sq] = (block_values(torch.as_tensor(bra), torch.as_tensor(ket)).numpy(),
                          bra, ket)
        table, bra, ket = tables[sq]
        return table[np.searchsorted(bra, rows), np.searchsorted(ket, cols)]

    def thread_sums(idx):
        _, _, nc, g0, n, c0, c1, _ = (int(x) for x in tasks[idx])
        i = np.arange(n * (c1 - c0))
        j, g = c0 + i // n, g0 + i % n
        rows = plan.pair_start[components[j, 0]] + g // nc
        cols = plan.pair_start[components[j, 1]] + g % nc
        sq = int(np.searchsorted(quartets[:, 4], c0, side="right") - 1)
        width = integrals.SHELL_TASK_THREADS
        items_ = np.zeros(-(-len(i) // width) * width)
        items_[:len(i)] = weights[j] * values(sq, rows, cols)
        acc = np.zeros(width)
        for row in items_.reshape(-1, width):
            acc = acc + row
        return acc

    got = _deriv_kernel_order(plan, thread_sums)
    expected = float(plan._eri_deriv_energy_plain(coords, torch.as_tensor(P_a + P_b), 0.25))
    assert abs(got - expected) <= 1e-13 * abs(expected)

"""The port's iterative triples and quadruples methods (post/cc_triples.py)
against tuna_tpu.

The residuals and updates take identical seeded numpy inputs in both
packages and agree to 1e-12 relative (the same float64 contractions, summed
in another order).  End to end, at TIGHTSCF, the total energies agree to
1e-10 Ha with equal SCF and CC iteration counts: the port iterates
tuna_tpu's pure-float64 loop (its CPU path), DIIS and damping included.
"""

import contextlib
import functools
import io
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu.cli import run as jax_run
from tuna_tpu.post import cc_triples as jax_triples

from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import run
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.post import cc_triples

torch.set_num_threads(2)

TOLERANCE = 1e-12   # relative, seeded residuals and updates


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)


def _relative_error(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    return np.max(np.abs(got - expected)) / np.max(np.abs(expected))


def _symmetric_chemists(rng, n, scale=0.05):
    """Random (pq|rs) with the 8-fold symmetry of real orbitals."""
    chem = rng.standard_normal((n, n, n, n))
    chem = chem + chem.transpose(1, 0, 2, 3)
    chem = chem + chem.transpose(0, 1, 3, 2)
    return scale * (chem + chem.transpose(2, 3, 0, 1))


def _symmetric(rng, n, scale):
    m = rng.standard_normal((n, n))
    return scale * (m + m.T)


def _pair_symmetric(x):
    """x symmetrised over simultaneous exchange of its index pairs, as
    restricted amplitudes are."""
    if x.ndim == 4:
        return x + x.transpose(1, 0, 3, 2)
    return (x + x.transpose(0, 2, 1, 3, 5, 4) + x.transpose(1, 0, 2, 4, 3, 5)
            + x.transpose(1, 2, 0, 4, 5, 3) + x.transpose(2, 0, 1, 5, 3, 4)
            + x.transpose(2, 1, 0, 5, 4, 3))


def _restricted_inputs(seed, n_core, no, nv, n_ao=None):
    """Seeded AO tensor, core Hamiltonian and orbitals with the correlated
    window's amplitudes and denominators: no occupied orbitals after n_core
    frozen ones, nv virtual ones."""
    rng = np.random.default_rng(seed)
    n = n_core + no + nv
    n_ao = n_ao or n
    C = np.linalg.qr(rng.standard_normal((n_ao, n_ao)))[0][:, :n]
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, n_core + no)),
                          np.sort(rng.uniform(0.2, 3.0, nv))])
    window = eps[n_core:]
    d1 = 1.0 / (window[:no, None] - window[None, no:])
    d2 = 1.0 / (window[:no, None, None, None] + window[None, :no, None, None]
                - window[None, None, no:, None] - window[None, None, None, no:])
    d3 = 1.0 / (window[:no, None, None, None, None, None] + window[None, :no, None, None, None, None]
                + window[None, None, :no, None, None, None]
                - window[None, None, None, no:, None, None]
                - window[None, None, None, None, no:, None]
                - window[None, None, None, None, None, no:])
    return {
        "ERI_AO": _symmetric_chemists(rng, n_ao), "H_core": _symmetric(rng, n_ao, 0.3),
        "C": C, "d1": d1, "d2": d2, "d3": d3,
        "t1": 0.02 * rng.standard_normal((no, nv)),
        "t2": 0.05 * _pair_symmetric(rng.standard_normal((no, no, nv, nv))),
        "t3": 0.01 * _pair_symmetric(rng.standard_normal((no, no, no, nv, nv, nv))),
    }


def _mo_tensors(x):
    """The chemists' MO tensor and core Hamiltonian of _restricted_inputs."""
    G = np.einsum("ap,bq,gr,ds,abgd->pqrs", x["C"], x["C"], x["C"], x["C"], x["ERI_AO"],
                  optimize=True)
    return G, x["C"].T @ x["H_core"] @ x["C"]


# ---------------------------------------------------------------------------
# Seeded residuals and updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["g_mo", "ao_rebuild"])
def test_restricted_ccsdt_residuals_match_tuna_tpu(route):
    """Both branches of the T1 dressing: the loop-invariant MO tensor (no
    frozen core) and the AO rebuild (one frozen core orbital, global
    occupied and virtual slices)."""
    n_core = 0 if route == "g_mo" else 1
    no, nv = 3, 4
    x = _restricted_inputs(11, n_core, no, nv, n_ao=n_core + no + nv + 1)
    o, v = slice(n_core, n_core + no), slice(n_core + no, None)
    extra = ()
    if route == "g_mo":
        extra = _mo_tensors(x)
    args = [x[k] for k in ("t1", "t2", "t3", "ERI_AO", "H_core", "C")]
    expected = jax_triples._restricted_ccsdt_residuals(
        o, v, *[jnp.asarray(a) for a in args + list(extra)])
    got = cc_triples._restricted_ccsdt_residuals(
        o, v, *[_t(a) for a in args], *[_t(a) for a in extra])
    for name, a, b in zip(("r1", "r2", "r3", "g_hat", "F_hat", "u2"), got, expected):
        assert _relative_error(a.numpy(), b) <= TOLERANCE, name


def test_restricted_ccsdt_branches_agree():
    """With no frozen core the two dressing routes give the same residuals."""
    no, nv = 2, 4
    x = _restricted_inputs(12, 0, no, nv)
    o, v = slice(0, no), slice(no, None)
    args = [_t(x[k]) for k in ("t1", "t2", "t3", "ERI_AO", "H_core", "C")]
    rebuilt = cc_triples._restricted_ccsdt_residuals(o, v, *args)
    dressed = cc_triples._restricted_ccsdt_residuals(
        o, v, *args, *[_t(a) for a in _mo_tensors(x)])
    for a, b in zip(rebuilt[:3], dressed[:3]):
        assert _relative_error(a.numpy(), b.numpy()) <= TOLERANCE


def test_restricted_ccsdt_update_matches_tuna_tpu():
    no, nv = 3, 3
    x = _restricted_inputs(13, 0, no, nv)
    o, v = slice(0, no), slice(no, None)
    G_MO, H_MO = _mo_tensors(x)
    names = ("d1", "d2", "d3", "t1", "t2", "t3", "ERI_AO", "H_core", "C")
    expected = jax_triples._restricted_ccsdt_update(
        o, v, *[jnp.asarray(x[k]) for k in names], jnp.asarray(G_MO), jnp.asarray(H_MO))
    got = cc_triples._restricted_ccsdt_update(o, v, *[_t(x[k]) for k in names], _t(G_MO),
                                              _t(H_MO))
    for a, b in zip(got, expected):
        assert _relative_error(a.numpy(), b) <= TOLERANCE


def test_restricted_ccsdtq_update_matches_tuna_tpu():
    no, nv = 2, 3
    x = _restricted_inputs(14, 0, no, nv)
    rng = np.random.default_rng(15)
    t4 = 0.005 * rng.standard_normal((no,) * 4 + (nv,) * 4)
    t4 = np.array(jax_triples._p4(jnp.asarray(t4)))        # pair-symmetric
    window = np.sort(rng.uniform(-2.0, -0.3, no))
    virtual = np.sort(rng.uniform(0.2, 3.0, nv))
    d4 = 1.0 / (window[:, None, None, None, None, None, None, None]
                + window[None, :, None, None, None, None, None, None]
                + window[None, None, :, None, None, None, None, None]
                + window[None, None, None, :, None, None, None, None]
                - virtual[None, None, None, None, :, None, None, None]
                - virtual[None, None, None, None, None, :, None, None]
                - virtual[None, None, None, None, None, None, :, None]
                - virtual[None, None, None, None, None, None, None, :])
    o, v = slice(0, no), slice(no, None)
    G_MO, H_MO = _mo_tensors(x)
    arrays = [x["d1"], x["d2"], x["d3"], d4, x["t1"], x["t2"], x["t3"], t4,
              x["ERI_AO"], x["H_core"], x["C"], G_MO, H_MO]
    expected = jax_triples._restricted_ccsdtq_update(o, v, *map(jnp.asarray, arrays))
    got = cc_triples._restricted_ccsdtq_update(o, v, *map(_t, arrays))
    for a, b in zip(got, expected):
        assert _relative_error(a.numpy(), b) <= TOLERANCE


def _spin_orbital_inputs(seed, no, nv):
    rng = np.random.default_rng(seed)
    n = no + nv
    physicists = _symmetric_chemists(rng, n).transpose(0, 2, 1, 3)
    g = physicists - physicists.transpose(0, 1, 3, 2)
    eps = np.concatenate([np.sort(rng.uniform(-2.0, -0.3, no)),
                          np.sort(rng.uniform(0.2, 3.0, nv))])
    F = np.diag(eps) + 0.01 * _symmetric(rng, n, 1.0)

    def antisymmetric(x):
        axes = x.ndim // 2
        for a in range(axes):
            for b in range(a + 1, axes):
                x = x - x.swapaxes(a, b)
                x = x - x.swapaxes(axes + a, axes + b)
        return x

    o, v = eps[:no], eps[no:]
    d1 = 1.0 / (o[:, None] - v[None, :])
    d2 = 1.0 / (o[:, None, None, None] + o[None, :, None, None] - v[None, None, :, None]
                - v[None, None, None, :])
    d3 = 1.0 / (o[:, None, None, None, None, None] + o[None, :, None, None, None, None]
                + o[None, None, :, None, None, None] - v[None, None, None, :, None, None]
                - v[None, None, None, None, :, None] - v[None, None, None, None, None, :])
    return {"g": g, "F": F, "d1": d1, "d2": d2, "d3": d3,
            "t1": 0.02 * rng.standard_normal((no, nv)),
            "t2": 0.05 * antisymmetric(rng.standard_normal((no, no, nv, nv))),
            "t3": 0.01 * antisymmetric(rng.standard_normal((no, no, no, nv, nv, nv)))}


def test_unrestricted_ccsdt_update_matches_tuna_tpu():
    no, nv = 3, 4
    x = _spin_orbital_inputs(16, no, nv)
    o, v = slice(0, no), slice(no, None)
    names = ("d1", "d2", "d3", "t1", "t2", "t3")
    expected = jax_triples._unrestricted_ccsdt_update(
        jnp.asarray(x["g"]), jnp.asarray(x["F"]), o, v, *[jnp.asarray(x[k]) for k in names])
    got = cc_triples._unrestricted_ccsdt_update(_t(x["g"]), _t(x["F"]), o, v,
                                                *[_t(x[k]) for k in names])
    for a, b in zip(got, expected):
        assert _relative_error(a.numpy(), b) <= TOLERANCE


def test_unrestricted_cisdt_update_matches_tuna_tpu():
    no, nv = 3, 4
    x = _spin_orbital_inputs(17, no, nv)
    o, v = slice(0, no), slice(no, None)
    names = ("d1", "d2", "d3", "t1", "t2", "t3")
    blocks = {}
    for key in ("oooo", "ooov", "oovv", "vovv", "vvvv", "voov", "vooo", "vvov", "vvoo"):
        blocks[key] = x["g"][tuple(o if c == "o" else v for c in key)]
    expected = jax_triples._unrestricted_cisdt_update(
        {k: jnp.asarray(b) for k, b in blocks.items()}, jnp.asarray(x["F"]), o, v,
        *[jnp.asarray(x[k]) for k in names])
    got = cc_triples._unrestricted_cisdt_update(
        {k: _t(b) for k, b in blocks.items()}, _t(x["F"]), o, v, *[_t(x[k]) for k in names])
    for a, b in zip(got, expected):
        assert _relative_error(a.numpy(), b) <= TOLERANCE


@pytest.mark.parametrize("rank", [3, 4])
def test_projections_match_tuna_tpu(rank):
    rng = np.random.default_rng(18 + rank)
    shape = (3,) * rank + (4,) * rank
    t = rng.standard_normal(shape)
    project = {3: "project_triples", 4: "project_quadruples"}[rank]
    symmetrise = {3: "_p3", 4: "_p4"}[rank]
    for name in (project, symmetrise):
        got = getattr(cc_triples, name)(_t(t)).numpy()
        expected = np.asarray(getattr(jax_triples, name)(jnp.asarray(t)))
        assert _relative_error(got, expected) <= TOLERANCE, name


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


@pytest.mark.parametrize("line", [
    "SPE : LI H 1.6 : CCSDT STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : UCISDT STO-3G : NOROTATE TIGHTSCF",
    "SPE : LI H 1.6 : CCSDT 6-31G : FREEZECORE 1 TIGHTSCF",   # the AO-rebuild branch
    "SPE : LI H 1.6 : CCSDTQ STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : UCCSDT STO-3G : NOROTATE TIGHTSCF",
])
def test_triples_methods_match_tuna_tpu(line):
    energy_ref, scf_ref, cc_ref, _ = _tuna_tpu(line)
    scf, _, energy, P = run(line, suppress_output=True, device="cpu")
    assert abs(energy - energy_ref) <= 1e-10
    assert len(scf.iteration_seconds) == scf_ref
    assert cc_ref > 0
    assert len(scf.correlation_iteration_seconds) == cc_ref
    assert bool(torch.all(torch.isfinite(P)))
    assert all(count == 0 for count in _kernels.launches.values())


# The singlet UHF from the rotated guess (no NOROTATE).  That guess mixes
# the HONO and LUNO of the SAD density; their relative sign from eigh is
# arbitrary and flips under a 1e-16 change of that density, so the port
# starts from the other of two symmetry-breaking guesses than tuna_tpu and
# reaches the same energy in another number of SCF cycles.
ROTATED_LINE = "SPE : LI H 1.6 : UCCSDT STO-3G : TIGHTSCF"


def test_rotated_guess_uccsdt_energy_matches_tuna_tpu():
    energy_ref = _tuna_tpu(ROTATED_LINE)[0]
    _, _, energy, _ = run(ROTATED_LINE, suppress_output=True, device="cpu")
    assert abs(energy - energy_ref) <= 1e-10


@pytest.mark.xfail(strict=True, reason="the port's UHF takes 15 SCF cycles from the rotated "
                   "guess, tuna_tpu's 14: the guess's HONO/LUNO sign (ROADMAP queue 3)")
def test_rotated_guess_uccsdt_iterations_match_tuna_tpu():
    _, scf_ref, cc_ref, _ = _tuna_tpu(ROTATED_LINE)
    scf, _, _, _ = run(ROTATED_LINE, suppress_output=True, device="cpu")
    assert (len(scf.iteration_seconds), len(scf.correlation_iteration_seconds)) == (scf_ref,
                                                                                    cc_ref)


def test_triples_printout_matches_tuna_tpu():
    """The iteration table and the contributions print as tuna_tpu's do."""
    line = "SPE : LI H 1.6 : CCSDT STO-3G : TIGHTSCF"
    text_ref = _tuna_tpu(line)[3]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run(line, device="cpu")
    text = out.getvalue()

    def table(t):
        part = t.split("Guess t-amplitude MP2 energy")[1].split("CCSDT correlation energy")[0]
        return re.sub(r"-?\d+\.\d{10}", lambda m: f"{float(m.group()):.8f}", part)

    assert table(text) == table(text_ref)


@pytest.mark.parametrize("line, message", [
    ("SPE : LI H 1.6 : CCSDTQ STO-3G : ML 3 TIGHTSCF", "Unrestricted CCSDTQ"),
    ("SPE : LI H 1.6 : CCSDT STO-3G : DIRECT TIGHTSCF", "DIRECT"),
])
def test_triples_refusals_match_tuna_tpu(line, message):
    with pytest.raises(Exception, match=message):
        jax_run(line)
    with pytest.raises(TunaError, match=message):
        run(line, suppress_output=True, device="cpu")

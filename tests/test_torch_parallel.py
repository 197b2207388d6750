"""The port's batched mean-field SCF (tuna_tpu_torch.parallel, the SCAN
driver and the stencil hooks of OPT and FREQ) against tuna_tpu's and
against the port's own serial loop, on the CPU.

Tolerances:

  * K6b's plain version (vv10_energies_batch) against tuna_tpu's on the
    same seeded densities and grids: 1e-12 relative per element (the same
    float64 pair sums, in another order);
  * the batched loop against the serial one on the same inputs: the same
    SCF iteration counts, energies within 1e-12 Ha (batched BLAS calls sum
    in another order); a point in a batch of four against the same point
    alone: the same count, 1e-10 Ha, P within 1e-8 and orbitals within
    1e-6 (one geometry takes 31 iterations, and its late DIIS systems are
    near-singular, which turns the BLAS order's 1e-16 into more);
  * batched scans against tuna_tpu.parallel on its 8-device CPU mesh, and
    the serial SCAN against tuna_tpu's serial walk, at TIGHTSCF: 1e-10 Ha
    (the two converge from the same guesses to the same criteria), dipoles
    1e-8;
  * the fast paths against the port's serial walks at TIGHTSCF, which start
    from other guesses: energies 1e-9 Ha, a frequency 1e-4 per cm, a
    gradient of energies 5e-5 bohr apart 1e-5.
"""

import time

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tuna_tpu import parallel as jax_parallel
from tuna_tpu.cli import parse_input as jax_parse_input
from tuna_tpu.cli import process_method as jax_process_method
from tuna_tpu.cli import run as jax_run
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.dft import vv10 as jax_vv10

from tuna_tpu_torch import parallel
from tuna_tpu_torch.cli import parse_input, process_method, run
from ported_lines import RELAXED_DH, assert_line_matches_tuna_tpu
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr, bohr_to_angstrom
from tuna_tpu_torch.dft import vv10
from tuna_tpu_torch.drivers import opt
from tuna_tpu_torch.output import TunaError
from tuna_tpu_torch.scf import run_scf_cycles, run_scf_cycles_batched, scf_settings

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _configs(line):
    """(tuna_tpu's Config, the port's Config, atomic symbols) of an input line."""
    ct, ms, basis, symbols, _, params = jax_parse_input(line)
    jax_cfg = JaxConfig(ct, jax_process_method(ms), time.time(), params, basis, symbols,
                        suppress_output=True)
    ct, ms, basis, symbols, _, params = parse_input(line)
    cfg = Config(ct, process_method(ms), time.time(), params, basis, symbols,
                 suppress_output=True)
    return jax_cfg, cfg, symbols


# ---------------------------------------------------------------------------
# K6b's plain version against tuna_tpu's vv10_energies_batch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def h2_grids():
    """H2/STO-3G loose grids at three bond lengths, with a seeded density
    matrix each."""
    _, cfg, symbols = _configs("SPE : H H 0.74 : B3LYP STO-3G : NL LOOSEGRID")
    _, _, _, meta = parallel._batched_inputs(cfg, symbols, [1.2, 1.5, 1.9], CPU)
    grids = [m["grid"] for m in meta]
    rng = np.random.default_rng(21)
    P = []
    for _ in grids:
        C = rng.standard_normal((2, 1))
        P.append(torch.as_tensor(C @ C.T))
    bfs, w, grads, pts = (torch.stack(parts) for parts in zip(*grids))
    return cfg, P, grids, vv10.vv10_energies_batch(P, bfs, grads, w, pts, cfg.functional)


@pytest.mark.parametrize("shared", [False, True], ids=["own grids", "one grid"])
def test_vv10_batch_matches_tuna_tpu(h2_grids, shared):
    cfg, P, grids, got = h2_grids
    bfs, w, grads, pts = (torch.stack(parts) for parts in zip(*grids))
    axes = (0, 0, 0, 0)
    if shared:   # the finite-field batch's form: one grid for every density
        bfs, w, grads, pts = bfs[1], w[1], grads[1], pts[1]
        axes = (None,) * 4
        got = vv10.vv10_energies_batch(P, bfs, grads, w, pts, cfg.functional, grid_axes=axes)
    expected = jax_vv10.vv10_energies_batch(
        np.stack([p.numpy() for p in P]), jnp.asarray(bfs.numpy()),
        jnp.asarray(grads.numpy()), w.numpy(), pts.numpy(), cfg.functional, grid_axes=axes)
    expected = np.asarray(expected)
    assert got.shape == (3,) and np.all(np.abs(expected) > 1e-3)
    assert np.max(np.abs(got.numpy() - expected) / np.abs(expected)) <= 1e-12


def test_vv10_batch_plain_takes_an_empty_element(h2_grids):
    """An element with no active point adds 0; the others keep their
    energies (the ragged batch K6b takes on the card)."""
    cfg, P, grids, full = h2_grids
    bfs, w, grads, pts = zip(*grids)
    P_empty = [P[0], torch.zeros_like(P[1]), P[2]]
    got = vv10.vv10_energies_batch(P_empty, bfs, grads, w, pts, cfg.functional)
    assert float(got[1]) == 0.0
    assert torch.equal(got[::2], full[::2])


# ---------------------------------------------------------------------------
# The batched loop against the serial one
# ---------------------------------------------------------------------------

def _batch(line, bond_lengths):
    _, cfg, symbols = _configs(line)
    molecule, batch, xc_closures, _ = parallel._batched_inputs(
        cfg, symbols, bond_lengths, CPU)
    return cfg, scf_settings(cfg, molecule), batch, xc_closures


def _batched(cfg, settings, batch, xc_closures, points):
    """run_scf_cycles_batched over the given points of a batch."""
    def pick(x):
        return x[points]
    return run_scf_cycles_batched(
        settings, *(pick(batch[k]) for k in ("T", "V", "ERI", "S", "X", "Pa", "Pb")),
        cfg.HFX_prop, cfg.SCF_conv, cfg.damping_factor or 0.0, cfg.max_damping,
        [xc_closures[i] for i in points] if xc_closures else None, cfg.DFX_prop, cfg.DFC_prop)


@pytest.mark.parametrize("line", [
    "SPE : H F 0.9 : HF STO-3G : TIGHTSCF",
    "SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2 TIGHTSCF",
    "SPE : H F 0.9 : B3LYP STO-3G : LOOSEGRID TIGHTSCF",
], ids=["RHF", "UHF", "RKS"])
def test_batch_of_one_matches_serial_loop(line):
    R = angstrom_to_bohr(float(line.split(":")[1].split()[2]))
    cfg, settings, batch, xc_closures = _batch(line, [R])
    serial = run_scf_cycles(
        settings, *(batch[k][0] for k in ("T", "V", "ERI", "S", "X")),
        torch.zeros_like(batch["S"][0]), torch.zeros_like(batch["S"][0]),
        batch["Pa"][0], batch["Pb"][0], 0.0, cfg.HFX_prop, cfg.SCF_conv,
        cfg.damping_factor or 0.0, cfg.max_damping, lambda *args: None,
        xc_closures[0] if xc_closures else None, cfg.DFX_prop, cfg.DFC_prop)
    n_steps, converged, E, P_a, P_b, outs = _batched(cfg, settings, batch, xc_closures, [0])
    assert serial[1] and converged.tolist() == [True]
    assert int(n_steps[0]) == serial[0] > 2
    assert abs(float(E[0]) - float(serial[2])) <= 1e-12
    assert torch.allclose(P_a[0], serial[3], rtol=0, atol=1e-10)
    assert torch.allclose(P_b[0], serial[4], rtol=0, atol=1e-10)
    assert len(outs["iteration_seconds"]) == n_steps[0]


@pytest.fixture(scope="module")
def hf_points():
    """HF/STO-3G at bond lengths whose SCFs converge after different numbers
    of iterations, each solved alone and all in one batch."""
    bonds = [angstrom_to_bohr(r) for r in (0.7, 1.3, 1.8, 2.1)]
    cfg, settings, batch, _ = _batch("SPE : H F 0.9 : HF STO-3G : TIGHTSCF", bonds)
    alone = [_batched(cfg, settings, batch, None, [i]) for i in range(len(bonds))]
    together = _batched(cfg, settings, batch, None, list(range(len(bonds))))
    return alone, together


def test_points_keep_their_own_iteration_counts(hf_points):
    alone, (n_steps, converged, E, P_a, _, outs) = hf_points
    counts = [int(a[0][0]) for a in alone]
    assert len(set(counts)) > 1, counts
    assert n_steps.tolist() == counts and converged.all()
    assert len(outs["iteration_seconds"]) == max(counts)
    for i, a in enumerate(alone):
        assert abs(float(E[i]) - float(a[2][0])) <= 1e-10
        assert torch.allclose(P_a[i], a[3][0], rtol=0, atol=1e-8)


def test_converged_points_keep_their_orbitals(hf_points):
    """A point that converged early keeps the orbitals and eigenvalues of its
    own last iteration (P is sign-free; the MOs handed on are not).  The
    degenerate pi pair may come out as any rotation of itself, so only the
    orbitals of a single eigenvalue are compared, each up to its sign."""
    alone, (_, _, _, _, _, outs) = hf_points
    for i, a in enumerate(alone):
        eps = a[5]["eps_a"][0]
        assert torch.allclose(outs["eps_a"][i], eps, rtol=0, atol=1e-8)
        gaps = torch.diff(eps)
        single = torch.cat([gaps[:1], torch.minimum(gaps[1:], gaps[:-1]), gaps[-1:]]) > 1e-6
        mos, mos_alone = outs["mos_a"][i][:, single], a[5]["mos_a"][0][:, single]
        signs = torch.sign(torch.sum(mos * mos_alone, dim=0))
        assert torch.allclose(mos * signs, mos_alone, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Batched scans against tuna_tpu.parallel on the 8-device CPU mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line, bonds", [
    ("SPE : H H 0.74 : HF STO-3G : TIGHTSCF", (1.2, 1.55, 1.9)),
    ("SPE : H H 0.74 : B3LYP STO-3G : NL LOOSEGRID TIGHTSCF", (1.2, 1.55, 1.9)),
    ("SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2 TIGHTSCF", (2.6, 2.95, 3.3)),
], ids=["HF", "B3LYP NL", "UHF"])
def test_scan_energies_match_tuna_tpu(line, bonds):
    jax_cfg, cfg, symbols = _configs(line)
    assert jax.device_count() >= 8, "conftest provides 8 virtual CPU devices"
    expected, expected_conv = jax_parallel.scan_energies_parallel(
        jax_cfg, symbols, np.array(bonds), jax_parallel.device_mesh(8))
    got, conv = parallel.scan_energies_parallel(cfg, symbols, list(bonds), [CPU])
    assert expected_conv.all() and conv.all()
    assert np.max(np.abs(got - np.asarray(expected))) <= 1e-10


def test_padding_and_trimming():
    """Three points over two devices: padded to four (the last repeated),
    two shards in one lockstep loop, trimmed back to three."""
    _, cfg, symbols = _configs("SPE : H H 0.74 : HF STO-3G : TIGHTSCF")
    bonds = [1.2, 1.55, 1.9]
    E_one, conv_one, dip_one = parallel.scan_points_parallel(cfg, symbols, bonds, [CPU])
    E_two, conv_two, dip_two = parallel.scan_points_parallel(cfg, symbols, bonds, [CPU, CPU])
    assert E_two.shape == conv_two.shape == dip_two.shape == (3,)
    assert conv_one.all() and conv_two.all()
    assert np.max(np.abs(E_two - E_one)) <= 1e-12
    assert np.max(np.abs(dip_two - dip_one)) <= 1e-10


def test_device_mesh_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(parallel, "device_count", lambda: 0)
    with pytest.raises(TunaError, match="CUDA"):
        parallel.device_mesh()
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    assert parallel.devices_like("cpu") == [CPU, CPU]


# ---------------------------------------------------------------------------
# The SCAN driver and the stencil hooks
# ---------------------------------------------------------------------------

SCAN_LINE = "SCAN : H F 0.80 : HF STO-3G : NUM 6 STEP 0.07 TIGHTSCF"


@pytest.fixture(scope="module")
def serial_scan():
    return run(SCAN_LINE, suppress_output=True, device="cpu")


def test_serial_scan_matches_tuna_tpu(serial_scan, monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda: 1)   # tuna_tpu walks serially
    bonds, energies, dipoles = serial_scan
    jax_bonds, jax_energies, jax_dipoles = jax_run(SCAN_LINE, suppress_output=True)
    assert len(energies) == 6
    assert np.max(np.abs(np.array(bonds) - np.array(jax_bonds))) <= 1e-12
    assert np.max(np.abs(np.array(energies) - np.array(jax_energies))) <= 1e-10
    assert np.max(np.abs(np.array(dipoles) - np.array(jax_dipoles))) <= 1e-8
    assert all(abs(d) > 0.1 for d in dipoles)


def _counting(monkeypatch, name):
    calls = []
    original = getattr(parallel, name)

    def counted(*args, **kwargs):
        calls.append(args[2])
        return original(*args, **kwargs)

    monkeypatch.setattr(parallel, name, counted)
    return calls


def test_scan_takes_the_batch_with_two_devices(serial_scan, monkeypatch):
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, "scan_points_parallel")
    bonds, energies, dipoles = run(SCAN_LINE, suppress_output=True, device="cpu")
    assert len(calls) == 1 and len(calls[0]) == 6
    assert np.max(np.abs(np.array(bonds) - np.array(serial_scan[0]))) <= 1e-12
    assert np.max(np.abs(np.array(energies) - np.array(serial_scan[1]))) <= 1e-9
    assert np.max(np.abs(np.array(dipoles) - np.array(serial_scan[2]))) <= 1e-6


def test_vpt_frequency_stencils_take_the_batch(monkeypatch):
    """FREQ with VPT2: the five-point Hessian (four displaced geometries) and
    the four outer VPT energies, two batches, against the serial walk."""
    line = "FREQ : H F 0.92 : HF STO-3G : VPT2 TIGHTSCF"
    serial = run(line, suppress_output=True, device="cpu")
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, "stencil_points_parallel")
    batched = run(line, suppress_output=True, device="cpu")
    assert [len(c) for c in calls] == [4, 4]
    hessian, _, frequency, zpe = batched
    assert abs(hessian - serial[0]) <= 1e-6 * abs(serial[0])
    assert abs(frequency - serial[2]) <= 1e-4
    assert abs(zpe - serial[3]) <= 1e-9


def test_central_difference_gradient_with_nl_takes_the_batch(monkeypatch):
    """OPT's numerical gradient (NL has no analytic one) as one batch of two."""
    line = "OPT : H H 0.74 : B3LYP STO-3G : NL LOOSEGRID TIGHTSCF"
    _, cfg, symbols = _configs(line)
    coords = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, angstrom_to_bohr(0.74)]])
    serial = opt.calculate_gradient(coords, cfg, symbols, silent=True, device="cpu")
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, "stencil_points_parallel")
    batched = opt.calculate_gradient(coords, cfg, symbols, silent=True, device="cpu")
    assert len(calls) == 1 and len(calls[0]) == 2
    assert abs(batched - serial) <= 1e-5


def test_refused_lines_are_refused_through_scan(monkeypatch):
    """What the serial path refuses, SCAN refuses in the same words, with
    one device or two."""
    spe = "SPE : H H 0.74 : R2SCAN0-DH STO-3G : RELAXED"
    with pytest.raises(TunaError) as refused:
        run(spe, suppress_output=True, device="cpu")
    for count in (1, 2):
        monkeypatch.setattr(parallel, "device_count", lambda: count)
        with pytest.raises(TunaError) as through_scan:
            run("SCAN : H H 0.74 : R2SCAN0-DH STO-3G : RELAXED NUM 2 STEP 0.1",
                suppress_output=True, device="cpu")
        assert str(through_scan.value) == str(refused.value)
        assert str(refused.value) == f"\nERROR: {RELAXED_DH}"   # tuna_tpu's words


@pytest.mark.parametrize("entry", ["scan_points_parallel", "scan_energies_parallel",
                                   "stencil_points_parallel"])
def test_batch_refuses_unrestricted_kohn_sham(entry):
    """The batch's XC call is restricted, so each public batch entry refuses
    a UKS line in words rather than returning its energies without the
    spin-resolved XC (the drivers send UKS to the serial walk)."""
    _, cfg, symbols = _configs("SCAN : O O 1.21 : B3LYP STO-3G : ML 3 NUM 2 STEP 0.05")
    with pytest.raises(TunaError, match="Unrestricted Kohn-Sham in the batched SCF is not yet "
                                        "ported"):
        getattr(parallel, entry)(cfg, symbols, [2.28, 2.38], [CPU])


@pytest.mark.parametrize("keywords, message", [
    ("NUM 2", "STEP"), ("STEP 0.1", "NUM"), ("NUM 2 STEP 0.1 STAB", None),
    ("NUM 2 STEP 0.1 SCANPLOT", None)])
def test_scan_keyword_errors(keywords, message, monkeypatch, tmp_path):
    """A scan without NUM or STEP is refused; STAB and SCANPLOT (once
    refused as not ported) run as in tuna_tpu."""
    line = f"SCAN : H H 0.74 : HF STO-3G : {keywords}"
    if message is None:
        monkeypatch.chdir(tmp_path)
        assert_line_matches_tuna_tpu(line)
        return
    with pytest.raises(TunaError, match=message):
        run(line, suppress_output=True, device="cpu")


def test_scan_bond_lengths_step_from_the_start(serial_scan):
    bonds = serial_scan[0]
    assert abs(bohr_to_angstrom(bonds[0]) - 0.80) <= 1e-12
    assert np.allclose(np.diff(bohr_to_angstrom(np.array(bonds))), 0.07, rtol=0, atol=1e-12)

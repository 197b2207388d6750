"""The port's correlated, finite-field and unrestricted Kohn-Sham batches
(tuna_tpu_torch.parallel) against tuna_tpu.parallel on its 8-device CPU
mesh, with the port on two CPU shards, and the drivers that route to them.

Tolerances:

  * a batch against tuna_tpu's batch of the same points: 1e-10 Ha a point
    (the same algorithm from the same core guess: tuna_tpu vmaps one
    while_loop, the port runs each point's SCF in lockstep and each
    point's correlation on its own), dipoles 1e-8 au;
  * a field batch of one against the serial SCF loop with the same field:
    the same SCF iteration count and 1e-12 Ha;
  * a property, gradient or VPT window through a driver with two devices
    against tuna_tpu's run of the same line, which batches on its eight:
    1e-6 relative for a property (a polarisability is a second difference
    at 1e-3 au field), 1e-8 Ha/bohr for a gradient, 1e-10 Ha an energy;
  * a SCAN through the driver against the port's own batch of the same
    points: 1e-12 (the same calls).
"""

import time

import jax
import numpy as np
import pytest
import torch

from tuna_tpu import parallel as jax_parallel
from tuna_tpu.cli import parse_input as jax_parse_input
from tuna_tpu.cli import process_method as jax_process_method
from tuna_tpu.cli import run as jax_run
from tuna_tpu.config import Config as JaxConfig
from tuna_tpu.drivers import opt as jax_opt

from tuna_tpu_torch import parallel
from tuna_tpu_torch.cli import parse_input, process_method, run
from tuna_tpu_torch.config import Config
from tuna_tpu_torch.constants import angstrom_to_bohr
from tuna_tpu_torch.drivers import opt
from tuna_tpu_torch.scf import run_scf_cycles, run_scf_cycles_batched, scf_settings

torch.set_num_threads(2)
CPU = torch.device("cpu")
TWO_SHARDS = [CPU, CPU]


def _configs(line):
    """(tuna_tpu's Config, the port's Config, atomic symbols, coordinates)."""
    ct, ms, basis, symbols, _, params = jax_parse_input(line)
    jax_cfg = JaxConfig(ct, jax_process_method(ms), time.time(), params, basis, symbols,
                        suppress_output=True)
    ct, ms, basis, symbols, coordinates, params = parse_input(line)
    cfg = Config(ct, process_method(ms), time.time(), params, basis, symbols,
                 suppress_output=True)
    return jax_cfg, cfg, symbols, coordinates


def _mesh():
    assert jax.device_count() >= 8, "conftest provides 8 virtual CPU devices"
    return jax_parallel.device_mesh(8)


# ---------------------------------------------------------------------------
# Scan batches against tuna_tpu's
# ---------------------------------------------------------------------------

LIH = (2.8, 3.1, 3.4)   # bohr

SCAN_LINES = [
    ("SPE : LI H 1.6 : MP2 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : SCS-MP2 6-31G : TIGHTSCF FREEZECORE", LIH),
    ("SPE : LI H 1.6 : MP3 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : MP4 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : CCSD 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : CCSD(T) 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : CCSD(T) 6-31G : TIGHTSCF FREEZECORE", LIH),
    ("SPE : LI H 1.6 : QCISD(T) 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : LCCD 6-31G : TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : MP2 6-31G : CH 1 ML 2 TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : CCSD(T) 6-31G : CH 1 ML 2 TIGHTSCF", LIH),
    ("SPE : LI H 1.6 : QCISD(T) 6-31G : CH 1 ML 2 TIGHTSCF", LIH),
    ("SPE : H H 0.74 : B2PLYP STO-3G : TIGHTSCF", (1.3, 1.5, 1.7)),
    ("SPE : H H 0.74 : MP2 CC-PVDZ : EXTRAPOLATE TIGHTSCF", (1.3, 1.5, 1.7)),
]


@pytest.mark.parametrize("line, bonds", SCAN_LINES, ids=[
    "MP2", "SCS-MP2 FREEZECORE", "MP3", "MP4", "CCSD", "CCSD(T)", "CCSD(T) FREEZECORE",
    "QCISD(T)", "LCCD", "UMP2", "UCCSD(T)", "UQCISD(T)", "B2PLYP", "CBS MP2"])
def test_correlated_scan_matches_tuna_tpu(line, bonds):
    jax_cfg, cfg, symbols, _ = _configs(line)
    extrapolate = "EXTRAPOLATE" in line
    name = "cbs_scan_points_parallel" if extrapolate else "scan_points_parallel"
    expected, expected_conv, expected_dip = getattr(jax_parallel, name)(
        jax_cfg, symbols, np.array(bonds), _mesh())
    got, conv, dip = getattr(parallel, name)(cfg, symbols, list(bonds), TWO_SHARDS)
    assert np.asarray(expected_conv).all() and conv.all()
    assert np.max(np.abs(got - np.asarray(expected))) <= 1e-10
    assert np.max(np.abs(dip - np.asarray(expected_dip))) <= 1e-8


O2_LINE = "SCAN : O O 1.21 : MP2 6-31G : ML 3 NUM 3 STEP 0.05 EXTREMESCF"


def test_triplet_o2_batch_reaches_tuna_tpus_higher_state():
    """Every batch starts each point from the core guess; the serial walk
    starts from the previous point's density.  From 1.26 angstrom at 6-31G
    triplet O2's core guess converges to a UHF state about 0.2 Ha above the
    serial walk's, in tuna_tpu's batch as in the port's (ROADMAP.md queue 3
    item 6).  The port's batch is held to tuna_tpu's at every point, and the
    gap to the serial walk at the stretched points is asserted, so that the
    shared defect stays in view: a repair of the batch's guess in both
    packages changes the last assertion.  EXTREMESCF: at TIGHTSCF the
    point at 1.26 angstrom, slow to converge so near the other state,
    stops in an iteration count that rounding decides, 2.0e-10 Ha from
    tuna_tpu's (1e-12 at EXTREMESCF)."""
    jax_cfg, cfg, symbols, coordinates = _configs(O2_LINE)
    start = float(coordinates[1][2])
    bonds = [start + angstrom_to_bohr(0.05) * k for k in range(3)]
    expected, expected_conv, _ = jax_parallel.scan_points_parallel(
        jax_cfg, symbols, np.array(bonds), _mesh())
    got, conv, _ = parallel.scan_points_parallel(cfg, symbols, bonds, TWO_SHARDS)
    assert np.asarray(expected_conv).all() and conv.all()
    assert np.max(np.abs(got - np.asarray(expected))) <= 1e-10
    serial_bonds, serial, _ = run(O2_LINE, suppress_output=True, device="cpu")
    assert np.max(np.abs(np.array(serial_bonds) - np.array(bonds))) <= 1e-12
    gap = got - np.array(serial)
    assert abs(gap[0]) <= 1e-8 and np.all(gap[1:] > 0.1), gap.tolist()


def test_components_split_the_correlation_off():
    """The parts the CBS scan reads: the SCF part is the Hartree-Fock
    batch's energy, the correlation part is what the correlated batch adds,
    and the dispersion part is zero without D2."""
    _, cfg, symbols, _ = _configs("SPE : LI H 1.6 : CCSD(T) 6-31G : TIGHTSCF")
    E_scf, E_corr, E_disp, conv, _, meta = parallel._solve_points_components(
        cfg, symbols, list(LIH[:2]), TWO_SHARDS)
    _, hf, _, _ = _configs("SPE : LI H 1.6 : HF 6-31G : TIGHTSCF")
    E_hf, hf_conv, _ = parallel.scan_points_parallel(hf, symbols, list(LIH[:2]), TWO_SHARDS)
    total, _, _ = parallel.scan_points_parallel(cfg, symbols, list(LIH[:2]), TWO_SHARDS)
    assert conv.all() and hf_conv.all() and not E_disp.any()
    assert np.max(np.abs(E_scf - E_hf)) <= 1e-12
    assert np.all(E_corr < -0.01) and np.max(np.abs(E_scf + E_corr - total)) <= 1e-12
    assert [m["scf_iterations"] > 2 for m in meta] == [True, True]


# ---------------------------------------------------------------------------
# Unrestricted Kohn-Sham in the batch
# ---------------------------------------------------------------------------

UKS_LINE = "SCAN : O O 1.21 : B3LYP STO-3G : ML 3 NUM 3 STEP 0.05 TIGHTSCF"
UKS_BONDS = (2.2, 2.4)


@pytest.fixture(scope="module")
def uks_reference():
    """tuna_tpu's batch of the UKS points: energies, convergence flags,
    total densities and analytic dipole moments."""
    from tuna_tpu import props as jax_props
    jax_cfg, _, symbols, _ = _configs(UKS_LINE)
    energies, converged, P, meta = jax_parallel.stencil_points_parallel(
        jax_cfg, symbols, np.array(UKS_BONDS), _mesh())
    dipoles = [jax_props.calculate_analytical_dipole_moment(
        m["centre_of_mass"], m["charges"], m["coordinates"], P[i], m["D"])[0]
        for i, m in enumerate(meta)]
    return np.asarray(energies), np.asarray(converged), np.asarray(dipoles), np.asarray(P)


@pytest.mark.parametrize("entry", ["scan_points_parallel", "scan_energies_parallel",
                                   "stencil_points_parallel"])
def test_unrestricted_kohn_sham_batch_matches_tuna_tpu(entry, uks_reference):
    expected, expected_conv, expected_dip, expected_P = uks_reference
    _, cfg, symbols, _ = _configs(UKS_LINE)
    assert parallel.mean_field_batchable(cfg, symbols)
    out = getattr(parallel, entry)(cfg, symbols, list(UKS_BONDS), TWO_SHARDS)
    energies, converged = out[0], out[1]
    assert expected_conv.all() and converged.all()
    assert np.max(np.abs(energies - expected)) <= 1e-10
    if entry == "scan_points_parallel":
        assert np.max(np.abs(out[2] - expected_dip)) <= 1e-8
    if entry == "stencil_points_parallel":
        P = np.stack([p.numpy() for p in out[2]])
        assert np.max(np.abs(P - expected_P)) <= 1e-8
        assert all(m["orbitals"][2].shape == m["orbitals"][0].shape for m in out[3])


# ---------------------------------------------------------------------------
# The finite-field batch
# ---------------------------------------------------------------------------

FIELDS = [np.array([0.0, 0.0, 2e-3]), np.array([0.0, 0.0, 1e-3]),
          np.array([0.0, 0.0, -1e-3]), np.array([1e-3, 0.0, 0.0]),
          np.array([0.0, 0.0, 0.0])]
GRADIENTS = [np.zeros(3), np.zeros(3), np.array([0.0, 0.0, 1e-3]), np.zeros(3),
             np.array([1e-3, 0.0, 0.0])]


@pytest.mark.parametrize("line, n", [
    ("SPE : H F 0.9 : HF STO-3G : TIGHTSCF", 5),
    ("SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2 TIGHTSCF", 5),
    ("SPE : H H 0.74 : PBE STO-3G : NL LOOSEGRID TIGHTSCF", 2),
    ("SPE : LI H 1.6 : MP2 STO-3G : TIGHTSCF", 5),
    ("SPE : LI H 1.6 : CCSD(T) STO-3G : TIGHTSCF", 5),
], ids=["HF", "UHF", "PBE NL", "MP2", "CCSD(T)"])
def test_field_batch_matches_tuna_tpu(line, n):
    jax_cfg, cfg, symbols, coordinates = _configs(line)
    expected, expected_conv = jax_parallel.field_energies_parallel(
        jax_cfg, symbols, coordinates, FIELDS[:n], GRADIENTS[:n], _mesh())
    got, conv = parallel.field_energies_parallel(cfg, symbols, coordinates, FIELDS[:n],
                                                 GRADIENTS[:n], TWO_SHARDS)
    assert got.shape == (n,) and np.asarray(expected_conv).all() and conv.all()
    assert np.max(np.abs(got - np.asarray(expected))) <= 1e-10
    assert len(set(np.round(got, 8))) == n     # every field moves the energy


@pytest.mark.parametrize("line", ["SPE : H F 0.9 : HF STO-3G : TIGHTSCF",
                                  "SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2 TIGHTSCF",
                                  "SPE : O O 1.21 : B3LYP STO-3G : ML 3 LOOSEGRID TIGHTSCF"],
                         ids=["RHF", "UHF", "UKS"])
def test_field_batch_of_one_matches_serial_loop(line):
    """Fld and G enter the batched loop's Fock matrix and energy where the
    serial loop puts them: one field point alone, batched and serial."""
    from tuna_tpu_torch.drivers import common
    _, cfg, symbols, coordinates = _configs(line)
    setup = parallel._geometry_inputs(cfg, symbols, np.asarray(coordinates, dtype=float), CPU)
    settings = scf_settings(cfg, setup["molecule"])
    integrals = setup["integrals"]
    Fld = common.apply_electric_field(integrals.D, np.array([0.0, 0.0, 2e-3]))
    G = common.apply_electric_field_gradient(integrals.Q, np.array([0.0, 0.0, 1e-3]))
    args = (integrals.T, integrals.V_NE, integrals.ERI_AO, integrals.S, setup["X"])
    serial = run_scf_cycles(
        settings, *args, Fld, G, setup["P_a"], setup["P_b"], 0.0, cfg.HFX_prop,
        cfg.SCF_conv, cfg.damping_factor or 0.0, cfg.max_damping, lambda *a: None,
        setup["xc_closure"], cfg.DFX_prop, cfg.DFC_prop)
    n_steps, converged, E, P_a, P_b, _ = run_scf_cycles_batched(
        settings, *(x[None] for x in args), setup["P_a"][None], setup["P_b"][None],
        cfg.HFX_prop, cfg.SCF_conv, cfg.damping_factor or 0.0, cfg.max_damping,
        [setup["xc_closure"]] if setup["xc_closure"] else None, cfg.DFX_prop, cfg.DFC_prop,
        Fld=Fld[None], G=G[None])
    assert serial[1] and converged.tolist() == [True]
    assert int(n_steps[0]) == serial[0] > 2
    assert abs(float(E[0]) - float(serial[2])) <= 1e-12
    assert torch.allclose(P_b[0], serial[4], rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# The gates against tuna_tpu's
# ---------------------------------------------------------------------------

GATE_LINES = [
    "SPE : H H 0.74 : HF STO-3G",
    "SPE : LI H 1.6 : UHF STO-3G : CH 1 ML 2",
    "SPE : H H 0.74 : B3LYP STO-3G",
    "SPE : O O 1.21 : B3LYP STO-3G : ML 3",
    "SPE : O O 1.21 : TPSS STO-3G : ML 3",
    "SPE : H H 0.74 : B2PLYP STO-3G",
    "SPE : H H 0.74 : B2PLYP STO-3G : TD",
    "SPE : H H 0.74 : B2PLYP STO-3G : RELAXED",
    "SPE : O O 1.21 : B2PLYP STO-3G : ML 3",
    "SPE : H H 0.74 : MP2 STO-3G",
    "SPE : H H 0.74 : SCS-MP2 STO-3G : FREEZECORE",
    "SPE : LI H 1.6 : MP3 STO-3G : FREEZECORE",
    "SPE : H H 0.74 : MP4(SDQ) STO-3G",
    "SPE : H H 0.74 : IMP2 STO-3G",
    "SPE : H H 0.74 : OMP2 STO-3G",
    "SPE : LI H 1.6 : MP2 STO-3G : CH 1 ML 2",
    "SPE : LI H 1.6 : MP2 STO-3G : CH 1 ML 2 FREEZECORE",
    "SPE : LI H 1.6 : SCS-MP2 STO-3G : CH 1 ML 2",
    "SPE : H H 0.74 : CCSD(T) STO-3G",
    "SPE : H H 0.74 : QCISD[T] STO-3G",
    "SPE : H H 0.74 : CEPA(0) STO-3G",
    "SPE : H H 0.74 : CC2 STO-3G",
    "SPE : H H 0.74 : CCSDT STO-3G",
    "SPE : LI H 1.6 : CCSD(T) STO-3G : CH 1 ML 2",
    "SPE : LI H 1.6 : CISD STO-3G : CH 1 ML 2",
    "SPE : H H 0.74 : CCSD STO-3G : DIRECT",
    "SPE : H H 0.74 : CCSD STO-3G : EZ 0.01",
    "SPE : H H 0.74 : HF STO-3G : EGZ 0.01",
    "SPE : H H 0.74 : MP2 CC-PVDZ : EXTRAPOLATE",
    "SPE : H H 0.74 : HF CC-PVDZ : EXTRAPOLATE",
    "SPE : H H 0.74 : B3LYP CC-PVDZ : EXTRAPOLATE",
    "SPE : H H 0.74 : B3LYP CC-PVDZ : EXTRAPOLATE NL",
    "SPE : LI H 1.6 : CCSD(T) CC-PVDZ : CH 1 ML 2 EXTRAPOLATE",
    "SPE : H H 0.74 : HF STO-3G : EXTRAPOLATE",
    "SPE : H H 0.74 : B3LYP STO-3G : NL",
    # the port's own exclusions (see PORT_ONLY)
    "SPE : H H 0.74 : HF STO-3G : NL",
    "SPE : H H 0.74 : MP2 STO-3G : NL",
    "SPE : H H 0.74 : CCSD STO-3G : READCHK",
    "SPE : H H 0.74 : HF STO-3G : CHKPT",
]
# where the port's gate says False and tuna_tpu's True, with why: the
# serial path adds VV10 to a Hartree-Fock reference, which tuna_tpu's batch
# leaves out, and keeps a checkpoint's stages
PORT_ONLY = {
    "SPE : H H 0.74 : HF STO-3G : NL": {"mean_field_batchable", "mean_field_with_fields"},
    "SPE : H H 0.74 : MP2 STO-3G : NL": {"mp2_scan_batchable"},
    "SPE : H H 0.74 : CCSD STO-3G : READCHK": set(),
    "SPE : H H 0.74 : HF STO-3G : CHKPT": {"mean_field_batchable", "mean_field_with_fields"},
}
GATES = ("mp2_scan_batchable", "dh_scan_batchable", "cc_scan_batchable",
         "ump2_scan_batchable", "ucc_scan_batchable", "cbs_scan_batchable")


def _gate_values(module, cfg, symbols, port):
    args = (cfg, symbols) if port else (cfg,)
    values = {"mean_field_batchable": module.mean_field_batchable(*args),
              "mean_field_with_fields": module.mean_field_batchable(*args, fields_free=False)}
    for gate in GATES:
        values[gate] = getattr(module, gate)(cfg, symbols)
    return {name: bool(value) for name, value in values.items()}


def test_gates_match_tuna_tpu():
    seen = set()
    for line in GATE_LINES:
        jax_cfg, cfg, symbols, _ = _configs(line)
        expected = _gate_values(jax_parallel, jax_cfg, symbols, port=False)
        got = _gate_values(parallel, cfg, symbols, port=True)
        differ = {name for name in expected if expected[name] != got[name]}
        assert differ == PORT_ONLY.get(line, set()), (line, expected, got)
        assert all(expected[name] and not got[name] for name in differ), line
        seen |= {name for name, value in got.items() if value}
    assert seen == {"mean_field_batchable", "mean_field_with_fields", *GATES}


# ---------------------------------------------------------------------------
# The drivers with two devices
# ---------------------------------------------------------------------------

def _counting(monkeypatch, name):
    calls = []
    original = getattr(parallel, name)

    def counted(*args, **kwargs):
        calls.append(args[2])
        return original(*args, **kwargs)

    monkeypatch.setattr(parallel, name, counted)
    return calls


@pytest.mark.parametrize("line, entry", [
    ("SCAN : LI H 1.6 : CCSD(T) 6-31G : NUM 3 STEP 0.1 TIGHTSCF", "scan_points_parallel"),
    ("SCAN : H H 0.74 : MP2 CC-PVDZ : EXTRAPOLATE NUM 3 STEP 0.1 TIGHTSCF",
     "cbs_scan_points_parallel"),
], ids=["CCSD(T)", "CBS"])
def test_correlated_scan_takes_the_batch(line, entry, monkeypatch):
    """SCAN with two devices hands its three points to the batch (which
    test_correlated_scan_matches_tuna_tpu holds to tuna_tpu's) and returns
    what the batch returns."""
    _, cfg, symbols, coordinates = _configs(line)
    bonds_ref = [float(coordinates[1][2])]
    for _ in range(2):      # stepped as the SCAN driver steps them
        bonds_ref.append(bonds_ref[-1] + angstrom_to_bohr(0.1))
    expected = getattr(parallel, entry)(cfg, symbols, bonds_ref, [CPU, CPU])
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, entry)
    bonds, energies, dipoles = run(line, suppress_output=True, device="cpu")
    assert len(calls) == 1 and len(calls[0]) == 3 and expected[1].all()
    assert np.max(np.abs(np.array(bonds) - np.array(bonds_ref))) <= 1e-12
    assert np.max(np.abs(np.array(energies) - expected[0])) <= 1e-12
    assert np.max(np.abs(np.array(dipoles) - expected[2])) <= 1e-12


def test_unconverged_batch_falls_back_to_the_serial_walk(monkeypatch):
    """A batch with an unconverged point hands the scan to the serial walk
    on the same device, which gives the serial numbers."""
    line = "SCAN : LI H 1.6 : MP2 6-31G : NUM 2 STEP 0.1 TIGHTSCF"
    serial = run(line, suppress_output=True, device="cpu")
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    solve = parallel._solve_points_components

    def unconverged(*args, **kwargs):
        out = list(solve(*args, **kwargs))
        out[3] = out[3] & np.array([False] + [True] * (len(out[3]) - 1))
        return tuple(out)

    monkeypatch.setattr(parallel, "_solve_points_components", unconverged)
    calls = _counting(monkeypatch, "scan_points_parallel")
    fallback = run(line, suppress_output=True, device="cpu")
    assert len(calls) == 1
    assert fallback[1] == serial[1] and fallback[0] == serial[0]


@pytest.fixture(scope="module")
def lih_ccsd_t():
    return _configs("FORCE : LI H 1.6 : CCSD(T) 6-31G : TIGHTSCF")


def test_correlated_central_difference_takes_the_batch(lih_ccsd_t, monkeypatch):
    """FORCE's numerical gradient of CCSD(T): both displacements in one
    batch, held to tuna_tpu's batch of the same two."""
    jax_cfg, cfg, symbols, coordinates = lih_ccsd_t
    coords = np.asarray(coordinates, dtype=float)
    expected = jax_opt.calculate_gradient(coords, jax_cfg, symbols, silent=True)
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, "stencil_points_parallel")
    got = opt.calculate_gradient(coords, cfg, symbols, silent=True, device="cpu")
    assert len(calls) == 1 and len(calls[0]) == 2
    assert abs(got - float(expected)) <= 1e-8 and abs(got) > 1e-3


@pytest.mark.parametrize("line", ["FREQ : LI H 1.6 : CCSD(T) 6-31G : VPT2 TIGHTSCF",
                                  "FREQ : LI H 1.6 : MP2 6-31G : CH 1 ML 2 VPT2 TIGHTSCF"],
                         ids=["CCSD(T)", "UMP2"])
def test_vpt_window_takes_the_batch(line, monkeypatch):
    """The VPT window's four outer energies (energies only) batch; the
    five-point Hessian of a correlated method, which hands on densities,
    walks serially."""
    jax_cfg, cfg, symbols, coordinates = _configs(line)
    coords = np.asarray(coordinates, dtype=float)
    h = 0.01
    displacements = [m * h for m in (-4, -3, 3, 4)]
    expected = jax_opt._batched_displaced_energies(coords, jax_cfg, symbols, displacements,
                                                   silent=True, energies_only=True)
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    assert opt._batched_displaced_energies(coords, cfg, symbols, displacements, silent=True,
                                           device="cpu") is None
    got = opt._batched_displaced_energies(coords, cfg, symbols, displacements, silent=True,
                                          energies_only=True, device="cpu")
    assert np.max(np.abs(np.array(got[0]) - np.array(expected[0]))) <= 1e-10
    assert len(got[1]) == len(got[2]) == 4


@pytest.mark.parametrize("line", ["SPE : LI H 1.6 : MP2 STO-3G : DIPOLE QUADRUPOLE POLAR "
                                  "TIGHTSCF"], ids=["MP2"])
def test_property_stencils_take_the_field_batch(line, monkeypatch):
    """POLAR, DIPOLE and QUADRUPOLE with two devices take one field batch a
    stencil, as tuna_tpu does on its eight, and print its properties."""
    from tuna_tpu.drivers import electric as jax_electric
    from tuna_tpu_torch.drivers import electric
    names = ("calculate_polarisability", "calculate_numerical_dipole_moment",
             "calculate_numerical_quadrupole_moment")

    def recording(module, record):
        for name in names:
            original = getattr(module, name)

            def wrapped(*args, _original=original, _name=name, **kwargs):
                record[_name] = _original(*args, **kwargs)
                return record[_name]

            monkeypatch.setattr(module, name, wrapped)

    expected, got = {}, {}
    recording(jax_electric, expected)
    jax_run(line, suppress_output=True)
    recording(electric, got)
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    calls = _counting(monkeypatch, "field_energies_parallel")
    run(line, suppress_output=True, device="cpu")
    assert got.keys() == expected.keys() and len(calls) == len(got)
    for name, value in got.items():
        assert abs(value - float(expected[name])) <= 1e-6 * abs(float(expected[name])), name


def test_field_batch_walks_serially_with_one_device(monkeypatch):
    from tuna_tpu_torch.drivers import electric
    _, cfg, symbols, coordinates = _configs("SPE : H F 0.9 : HF STO-3G")
    monkeypatch.setattr(parallel, "device_count", lambda: 1)
    assert electric._prefetch_field_energies(cfg, symbols, coordinates, fields=FIELDS[:2],
                                             device="cpu") is None
    monkeypatch.setattr(parallel, "device_count", lambda: 2)
    energies = electric._prefetch_field_energies(cfg, symbols, coordinates, fields=FIELDS[:2],
                                                 device="cpu")
    assert len(energies) == 2 and energies[0] != energies[1]

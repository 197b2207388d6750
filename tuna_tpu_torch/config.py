"""Keyword system and the per-run Config object.

Behavioural parity with the reference keyword layer
(/root/reference/TUNA/tuna_calc.py:25-597): the same keyword names, aliases,
defaults and override chains, interpreted into attributes of one Config
object created per run.  The Config lives entirely on the host; jitted
compute kernels receive plain arrays and static Python scalars derived from
it, never the Config itself.
"""

from __future__ import annotations

import numpy as np

from . import constants
from .methods import Method, XC_FUNCTIONALS
from .output import error


class Kw:
    """Declarative keyword spec.

    kind "flag":   presence sets `attr` True.
    kind "value":  keyword must be followed by a value parsed as `typ`.
    kind "both":   presence sets `attr` True; an optional following value is
                   parsed as `typ` into `value_attr`.
    """

    __slots__ = ("names", "attr", "kind", "default", "typ", "value_default", "value_attr", "is_path")

    def __init__(self, names, attr, kind="flag", default=False, typ=None,
                 value_default=None, value_attr=None, is_path=False):
        self.names = (names,) if isinstance(names, str) else tuple(names)
        self.attr = attr
        self.kind = kind
        self.default = default
        self.typ = typ
        self.value_default = value_default
        self.value_attr = value_attr
        self.is_path = is_path


KEYWORDS = [
    # Plain flags
    Kw("P", "additional_print"),
    Kw("T", "terse"),
    Kw("DEBUG", "debug"),
    Kw("DECONTRACT", "decontract"),
    Kw("CARTHARM", "cartesian_harmonics"),
    Kw("EXTRAPOLATE", "extrapolate"),

    Kw("NOROTATE", "no_rotate_guess"),
    Kw("COREGUESS", "core_guess_requested"),
    Kw("SADGUESS", "superposition_guess_requested"),
    Kw("SCFGUESS", "self_consistent_guess_requested"),
    Kw("SLOWCONV", "slow_conv"),
    Kw("VERYSLOWCONV", "very_slow_conv"),
    Kw("NODIIS", "no_DIIS"),
    Kw("NODAMP", "no_damping"),
    Kw("MOREAD", "MO_read_requested"),
    Kw("NOMOREAD", "no_MO_read"),

    Kw("NATORBS", "natural_orbitals"),
    Kw("D2", "D2"),
    Kw("CALCHESS", "calc_hess"),
    Kw("OPTMAX", "opt_max"),
    Kw("NOTRAJ", "no_trajectory"),
    Kw("NOX", "no_DFT_exchange"),
    Kw("NOC", "no_DFT_correlation"),
    Kw("NOSINGLES", "no_singles"),
    Kw("TDA", "tamm_dancoff_approximation"),
    Kw("TD", "time_dependent"),
    Kw("NL", "VV10"),
    Kw("RELAXED", "relaxed_density"),
    Kw(("DIRECT", "DIRECTSCF"), "direct_scf"),
    Kw("UNRELAXED", "unrelaxed_density"),
    Kw("STAB", "stability_analysis"),
    Kw("NOTRIPLETS", "calculate_no_triplets"),
    Kw("NOSINGLETS", "calculate_no_singlets"),
    Kw(("[D]", "(D)"), "do_perturbative_doubles"),

    Kw("SCANPLOT", "scan_plot"),
    Kw("DASH", "plot_dashed_lines"),
    Kw("DOT", "plot_dotted_lines"),
    Kw("ADDPLOT", "add_plot"),
    Kw("DELPLOT", "delete_plot"),
    Kw("DENSPLOT", "plot_density"),
    Kw("SPINDENSPLOT", "plot_spin_density"),
    Kw("PLOTHOMO", "plot_HOMO"),
    Kw("PLOTLUMO", "plot_LUMO"),
    Kw("DIFFDENSPLOT", "plot_difference_density"),
    Kw("DIFFSPINDENSPLOT", "plot_difference_spin_density"),
    Kw("VIBPLOT", "plot_vibrational_wavefunctions"),
    Kw("ABSPLOT", "plot_absorbance_spectrum"),

    Kw("DIPOLE", "dipole"),
    Kw("QUADRUPOLE", "quadrupole"),
    Kw(("POLAR", "POLARISABILITY", "POLARIZABILITY"), "polarisability"),
    Kw(("HYPER", "HYPERPOLARISABILITY", "HYPERPOLARIZABILITY"), "hyperpolarisability"),
    Kw("VERTICAL", "vertical"),
    Kw("VPT2", "second_order_vpt"),
    Kw("VPT1", "first_order_vpt"),
    Kw("NOCP", "no_counterpoise_correction"),
    Kw("ZPE", "do_ZPE_correction"),

    # Value keywords
    Kw(("CH", "CHARGE"), "charge", "value", 0, int),
    Kw(("ML", "MULTIPLICITY"), "multiplicity", "value", 1, int),
    Kw("BASIS", "custom_basis_file", "value", None, str),
    Kw("THREADS", "number_of_threads", "value", 4, int),  # no-op on TPU; kept for CLI parity
    Kw("PRINTLEVEL", "print_level", "value", 2, int),

    Kw("XA", "X_alpha", "value", 2 / 3, float),
    Kw("STHRESH", "S_eigenvalue_threshold", "value", 1e-7, float),
    Kw("MAXITER", "max_iter", "value", 100, int),
    Kw("MAXDAMP", "max_damping", "value", 0.7, float),
    Kw("EX", "electric_field_x", "value", 0, float),
    Kw("EY", "electric_field_y", "value", 0, float),
    Kw("EZ", "electric_field_z", "value", 0, float),
    Kw("EGX", "electric_field_gradient_x", "value", 0, float),
    Kw("EGY", "electric_field_gradient_y", "value", 0, float),
    Kw("EGZ", "electric_field_gradient_z", "value", 0, float),
    Kw("NELEC", "n_electrons_for_ip_or_ea", "value", 1, int),
    Kw(("ROOT", "STATE"), "root", "value", 1, int),
    Kw("EXTHRESH", "excited_state_contribution_threshold", "value", 1, float),
    Kw("NSTATES", "n_states", "value", 10, int),
    Kw("PEAKWIDTH", "peak_width", "value", 3.0, float),

    Kw(("GEOMMAXITER", "MAXGEOMITER"), "geom_max_iter", "value", 30, int),
    Kw("MAXSTEP", "max_step", "value", 0.2, float),
    Kw("DEFAULTHESS", "default_hessian", "value", 0.25, float),
    Kw("M1", "custom_mass_1", "value", None, float),
    Kw("M2", "custom_mass_2", "value", None, float),
    Kw(("TEMP", "TEMPERATURE"), "temperature", "value", None, float),
    Kw(("PRES", "PRESSURE"), "pressure", "value", 101325, float),
    Kw("ANHARMCONV", "anharm_convergence", "value", 0.01, float),
    Kw("STEP", "step", "value", None, float),
    Kw("NUM", "number_of_steps", "value", None, int),

    Kw(("MP3S", "MP3SCALING", "MP3SCAL"), "MP3_scaling", "value", 1 / 4, float),
    Kw("AMPCONV", "amp_conv", "value", 1e-8, float),
    Kw("PRINTAMPS", "print_n_amplitudes", "value", 10, int),
    Kw("MPGRID", "num_laplace_points", "value", 10, int),
    Kw("ECONV", "energy_convergence", "value", 1e-9, float),
    Kw("RMSDP", "rms_density_change_convergence", "value", 1e-9, float),
    Kw("MAXDP", "max_density_change_convergence", "value", 1e-9, float),
    Kw("DIISERR", "commutator_convergence", "value", 1e-9, float),
    Kw("CORRMAXITER", "correlated_max_iter", "value", 100, int),

    # Flag-plus-optional-value keywords
    Kw("ROTATE", "rotate_guess", "both", False, float, 45, "theta"),
    Kw("PRINTMOS", "print_molecular_orbitals", "both", False, int, 10, "n_orbitals_to_print"),
    Kw("DIIS", "DIIS", "both", True, int, 6, "max_DIIS_matrices"),
    Kw("DAMP", "damping", "both", True, float, None, "damping_factor"),
    Kw("FREEZECORE", "freeze_core", "both", False, int, None, "freeze_n_orbitals"),
    Kw("CORRDAMP", "correlated_damping_requested", "both", False, float, 0, "correlated_damping_parameter"),

    Kw("INTACC", "integral_accuracy_requested", "both", False, float, 4, "integral_accuracy"),
    Kw("DFX", "DFX_requested", "both", False, float, 1, "DFX_prop"),
    Kw("DFC", "DFC_requested", "both", False, float, 1, "DFC_prop"),
    Kw("MPC", "MPC_requested", "both", False, float, 0, "MPC_prop"),
    Kw("HFX", "HFX_requested", "both", False, float, 1, "HFX_prop"),
    Kw("SSS", "SSS_requested", "both", False, float, 1 / 3, "same_spin_scaling"),
    Kw("OSS", "OSS_requested", "both", False, float, 6 / 5, "opposite_spin_scaling"),

    Kw("TRAJ", "trajectory", "both", False, str, "tuna-trajectory.xyz", "trajectory_path"),
    # Checkpoint/restart (TPU-build upgrade; no reference equivalent): CHKPT
    # writes densities and CC amplitudes after each converged stage, READCHK
    # warm-starts from them.
    Kw("CHKPT", "checkpoint", "both", False, str, "tuna-tpu.chk.npz", "checkpoint_path"),
    Kw("READCHK", "read_checkpoint", "both", False, str, "tuna-tpu.chk.npz", "read_checkpoint_path"),
    Kw("SAVEPLOT", "save_plot", "both", False, str, "tuna-plot.pdf", "save_plot_filepath", is_path=True),
    Kw("PLOTMO", "plot_molecular_orbital", "both", False, int, 1, "molecular_orbital_to_plot"),
    Kw("PLOTNO", "plot_natural_orbital", "both", False, int, 1, "natural_orbital_to_plot"),
    Kw(("COLOUR", "COLOR"), "colour_requested", "both", False, str, "BLACK", "plot_colour"),
]

_ALIAS_TABLE = {name: kw for kw in KEYWORDS for name in kw.names}

_COLOUR_MAP = {
    "RED": "r", "GREEN": "g", "BLUE": "b", "CYAN": "c",
    "MAGENTA": "m", "YELLOW": "y", "BLACK": "k", "WHITE": "w",
}

_PLOT_EXTENSIONS = (".png", ".jpg", ".pdf", ".svg", ".jpeg", ".tif", ".tiff",
                    ".bmp", ".raw", ".eps", ".ps")


def _apply_keywords(config: "Config", params: list[str]) -> None:
    for kw in KEYWORDS:
        setattr(config, kw.attr, kw.default)
        if kw.kind == "both":
            setattr(config, kw.value_attr, kw.value_default)

    i = 0
    while i < len(params):
        kw = _ALIAS_TABLE.get(params[i])
        if kw is None:
            i += 1
            continue
        if kw.kind == "flag":
            setattr(config, kw.attr, True)
            i += 1
            continue

        has_value = i + 1 < len(params) and params[i + 1] not in _ALIAS_TABLE
        if not has_value:
            if kw.kind == "value":
                error(f'Parameter "{params[i]}" requested but no value specified!')
            setattr(config, kw.attr, True)
            i += 1
            continue

        raw_tokens = getattr(params, "raw", params)
        raw = raw_tokens[i + 1] if kw.typ is str and i + 1 < len(raw_tokens) else params[i + 1]
        try:
            value = kw.typ(raw)
        except ValueError:
            error(f'Parameter "{params[i]}" must be of type {kw.typ.__name__}!')
        if kw.is_path and not str(value).lower().endswith(_PLOT_EXTENSIONS):
            error(f'Unsupported plot file extension in "{value}"!')

        if kw.kind == "value":
            setattr(config, kw.attr, value)
        else:
            setattr(config, kw.attr, True)
            setattr(config, kw.value_attr, value)
        i += 2


def _derive_settings(cfg: "Config") -> None:
    """Resolve interacting keywords; mirrors tuna_calc.py:357-521."""
    params = cfg.params

    cfg.MO_read = not cfg.no_MO_read
    cfg.DIIS = False if cfg.no_DIIS else cfg.DIIS
    cfg.damping = False if cfg.no_damping else cfg.damping

    cfg.default_multiplicity = not any(p in ("ML", "MULTIPLICITY") for p in params)

    if cfg.very_slow_conv:
        cfg.damping_factor = 0.85
    elif cfg.slow_conv:
        cfg.damping_factor = 0.5

    if cfg.temperature is None:
        cfg.temperature = 0 if cfg.calculation_type == "MD" else 298.15

    # CEPA(0) is linearised CCSD
    name = cfg.method.name
    if name.startswith("U"):
        cfg.method.name = "U" + ("LCCSD" if "CEPA" in name[1:] else name[1:])
    else:
        cfg.method.name = "LCCSD" if "CEPA" in name else name

    cfg.ghost_atom_present = any("X" in s for s in cfg.atomic_symbols)
    cfg.monatomic = len(cfg.atomic_symbols) == 1 or cfg.ghost_atom_present
    cfg.diatomic = not cfg.monatomic

    guess = "scf"
    if cfg.core_guess_requested or cfg.monatomic:
        guess = "core"
    if cfg.superposition_guess_requested:
        guess = "superposition"
    if cfg.self_consistent_guess_requested:
        guess = "scf"
    cfg.core_guess = guess == "core"
    cfg.superposition_guess = guess == "superposition"
    cfg.self_consistent_guess = guess == "scf"

    cfg.electric_field = np.array([cfg.electric_field_x, cfg.electric_field_y, cfg.electric_field_z])
    cfg.electric_field_gradient = np.array([
        cfg.electric_field_gradient_x, cfg.electric_field_gradient_y, cfg.electric_field_gradient_z])

    cfg.scan_plot_colour = next((code for n, code in _COLOUR_MAP.items() if n in params), "black")
    if cfg.colour_requested:
        cfg.scan_plot_colour = cfg.plot_colour

    cfg.plot_something = (
        cfg.plot_density or cfg.plot_spin_density or cfg.plot_HOMO or cfg.plot_LUMO
        or cfg.plot_difference_density or cfg.plot_difference_spin_density
        or cfg.plot_molecular_orbital or cfg.plot_natural_orbital
    )

    # Hartree theory = HF without exchange
    if cfg.method.name in ("H", "UH") and not cfg.HFX_requested:
        cfg.HFX_requested, cfg.HFX_prop = False, 0

    if cfg.number_of_steps is None and cfg.calculation_type == "MD":
        cfg.number_of_steps = 30

    if cfg.DFT_calculation:
        f = cfg.functional
        if not cfg.HFX_requested:
            cfg.HFX_prop = f.HFX
        if not cfg.DFX_requested:
            cfg.DFX_prop = f.DFX
        if not cfg.DFC_requested:
            cfg.DFC_prop = f.DFC
        if not cfg.MPC_requested:
            cfg.MPC_prop = f.MPC
        if not cfg.SSS_requested:
            cfg.same_spin_scaling = f.same_spin_scaling
        if not cfg.OSS_requested:
            cfg.opposite_spin_scaling = f.opposite_spin_scaling

    if cfg.no_DFT_exchange:
        cfg.DFX_prop = 0
    if cfg.no_DFT_correlation:
        cfg.DFC_prop = 0

    # Derivative levels drive the convergence-tier defaults
    cfg.third_derivative_requested = cfg.second_order_vpt or cfg.hyperpolarisability
    cfg.second_derivative_requested = (
        cfg.calculation_type in ("FREQ", "OPTFREQ", "ANHARM")
        or cfg.polarisability or cfg.do_ZPE_correction or cfg.third_derivative_requested
    )
    cfg.first_derivative_requested = (
        cfg.calculation_type in ("OPT", "IP", "EA", "BDE", "MD")
        or cfg.dipole or cfg.quadrupole or cfg.second_derivative_requested
    )

    scf_tiers = constants.SCF_CONVERGENCE
    cfg.SCF_conv = dict(scf_tiers["medium"])
    if cfg.first_derivative_requested:
        cfg.SCF_conv = dict(scf_tiers["tight"])
    if cfg.second_derivative_requested:
        cfg.SCF_conv = dict(scf_tiers["extreme"])
    for tier in ("loose", "medium", "tight", "extreme"):
        if tier.upper() in params or f"{tier.upper()}SCF" in params:
            cfg.SCF_conv = dict(scf_tiers[tier])
    if "ECONV" in params:
        cfg.SCF_conv["delta_E"] = cfg.energy_convergence
    if "MAXDP" in params:
        cfg.SCF_conv["max_DP"] = cfg.max_density_change_convergence
    if "RMSDP" in params:
        cfg.SCF_conv["RMS_DP"] = cfg.rms_density_change_convergence
    if "DIISERR" in params:
        cfg.SCF_conv["commutator"] = cfg.commutator_convergence

    opt_tiers = constants.OPT_CONVERGENCE
    cfg.geom_conv = dict(opt_tiers["medium"])
    if cfg.second_derivative_requested:
        cfg.geom_conv = dict(opt_tiers["tight"])
    for tier in ("loose", "medium", "tight", "extreme"):
        if f"{tier.upper()}OPT" in params:
            cfg.geom_conv = dict(opt_tiers[tier])

    grid_tiers = constants.GRID_TIERS
    cfg.grid_conv = dict(grid_tiers["medium"])
    for tier in ("loose", "medium", "tight", "extreme"):
        if f"{tier.upper()}GRID" in params:
            cfg.grid_conv = dict(grid_tiers[tier])

    if "ECONV" not in params:
        cfg.energy_convergence = cfg.SCF_conv["delta_E"]


class Config:
    """All user-controllable settings for one TUNA-TPU run.

    Host-side object; the compute core never sees it.  Created once per run
    (and copied/adjusted by composite drivers, e.g. for charged states).
    """

    def __init__(self, calculation_type: str, method: Method, start_time: float,
                 params: list[str], basis: str, atomic_symbols: list[str],
                 suppress_output: bool = False):
        self.calculation_type = calculation_type
        self.method = method
        self.start_time = start_time
        self.params = params
        self.basis = basis
        self.original_basis = basis
        self.atomic_symbols = atomic_symbols
        self.suppress_output = suppress_output
        self.reference = "Undefined"

        self.functional = XC_FUNCTIONALS.get(method.name, XC_FUNCTIONALS["HF"])
        self.DFT_calculation = method.density_functional_method

        _apply_keywords(self, params)
        _derive_settings(self)

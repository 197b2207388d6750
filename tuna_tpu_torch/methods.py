"""Registries: calculation types, electronic-structure methods, XC functionals,
and basis-set name aliases.

Capability parity with the reference registries
(/root/reference/TUNA/tuna_util.py:1282-1665).  Functional exchange /
correlation entries are string keys resolved against tuna_tpu.dft.xc at run
time rather than bound callables, keeping this module import-light.
"""

from __future__ import annotations

from dataclasses import dataclass, field


CALCULATION_TYPES = {
    "SPE": "Single point energy",
    "OPT": "Geometry optimisation",
    "FREQ": "Harmonic frequency",
    "OPTFREQ": "Optimisation and harmonic frequency",
    "SCAN": "Coordinate scan",
    "MD": "Ab initio molecular dynamics",
    "FORCE": "Force",
    "ANHARM": "Anharmonic frequency",
    "IP": "Ionisation potential",
    "EA": "Electron affinity",
    "BDE": "Bond dissociation energy",
}


@dataclass
class Method:
    """An electronic structure method (name as typed, minus any "U" prefix)."""

    name: str
    generic_name: str
    unrestricted_available: bool = True
    restricted_available: bool = True
    method_base: str = "HF"
    excited_state_method: bool = False
    unrestricted: bool = False

    @property
    def long_name(self) -> str:
        return ("unrestricted " if self.unrestricted else "") + self.generic_name

    @property
    def perturbative_method(self) -> bool:
        return self.method_base in ("MP2", "MP3", "MP4")

    @property
    def coupled_cluster_method(self) -> bool:
        return self.method_base == "CC"

    @property
    def correlated_method(self) -> bool:
        return self.coupled_cluster_method or self.perturbative_method

    @property
    def density_functional_method(self) -> bool:
        return self.method_base == "DFT"


def _m(name, generic, **kw):
    return Method(name, generic, **kw)


def _build_method_registry() -> list[Method]:
    methods = [
        _m("H", "Hartree theory"),
        _m("HF", "Hartree-Fock theory"),
        _m("RHF", "Hartree-Fock theory"),
    ]

    # Moller-Plesset family
    methods += [
        _m("MP2", "MP2 theory", method_base="MP2"),
        _m("OMP2", "orbital-optimised MP2 theory", method_base="MP2"),
        _m("IMP2", "iterative MP2 theory", unrestricted_available=False, method_base="MP2"),
        _m("LMP2", "Laplace transform MP2 theory", unrestricted_available=False, method_base="MP2"),
        _m("AO-MP2", "Laplace transform MP2 theory", unrestricted_available=False, method_base="MP2"),
        _m("SCS-MP2", "spin-component-scaled MP2 theory", method_base="MP2"),
        _m("MP3", "MP3 theory", method_base="MP3"),
        _m("SCS-MP3", "spin-component-scaled MP3 theory", method_base="MP3"),
    ]
    for tag, desc in (
        ("SDTQ", "MP4 theory"),
        ("SDQ", "MP4 theory with singles, doubles and quadruples"),
        ("DQ", "MP4 theory with doubles and quadruples"),
    ):
        methods += [
            _m(f"MP4[{tag}]", desc, unrestricted_available=False, method_base="MP4"),
            _m(f"MP4({tag})", desc, unrestricted_available=False, method_base="MP4"),
        ]
    methods.append(_m("MP4", "MP4 theory", unrestricted_available=False, method_base="MP4"))

    # Configuration interaction / excited states
    methods += [
        _m("CIS", "configuration interaction singles", excited_state_method=True),
        _m("CIS[D]", "configuration interaction singles with perturbative doubles", excited_state_method=True),
        _m("CIS(D)", "configuration interaction singles with perturbative doubles", excited_state_method=True),
        _m("CID", "configuration interaction doubles", method_base="CC"),
        _m("CISD", "configuration interaction singles and doubles", method_base="CC"),
        _m("CISDT", "configuration interaction singles, doubles and triples", method_base="CC", restricted_available=False),
        _m("TDHF", "time-dependent Hartree-Fock theory", excited_state_method=True),
        _m("RPA", "random phase approximation", excited_state_method=True),
    ]

    # Coupled cluster family
    cepa = "coupled electron pair approximation"
    methods += [
        _m("CCD", "coupled cluster doubles", method_base="CC"),
        _m("CEPA", cepa, method_base="CC"),
        _m("CEPA0", cepa, method_base="CC"),
        _m("CEPA[0]", cepa, method_base="CC"),
        _m("CEPA(0)", cepa, method_base="CC"),
        _m("LCCD", "linearised coupled cluster doubles", method_base="CC"),
        _m("LCCSD", "linearised coupled cluster singles and doubles", method_base="CC"),
        _m("QCISD", "quadratic configuration interaction singles and doubles", method_base="CC"),
        _m("QCISD[T]", "quadratic configuration interaction singles, doubles and perturbative triples", method_base="CC"),
        _m("QCISD(T)", "quadratic configuration interaction singles, doubles and perturbative triples", method_base="CC"),
        _m("CC2", "approximate coupled cluster singles and doubles", unrestricted_available=False, method_base="CC"),
        _m("CC3", "approximate coupled cluster singles, doubles and triples", unrestricted_available=False, method_base="CC"),
        _m("CCSD", "coupled cluster singles and doubles", method_base="CC"),
        _m("CCSD[T]", "coupled cluster singles, doubles and perturbative triples", method_base="CC"),
        _m("CCSD(T)", "coupled cluster singles, doubles and perturbative triples", method_base="CC"),
        _m("CCSDT", "coupled cluster singles, doubles and triples", method_base="CC"),
        _m("CCSDT[Q]", "coupled cluster singles, doubles, triples and perturbative quadruples", unrestricted_available=False, method_base="CC"),
        _m("CCSDT(Q)", "coupled cluster singles, doubles, triples and perturbative quadruples", unrestricted_available=False, method_base="CC"),
        _m("CCSDTQ", "coupled cluster singles, doubles, triples and quadruples", unrestricted_available=False, method_base="CC"),
    ]

    # Density functional methods -- generic names are derived from the
    # functional composition table below.
    dft_descriptions = {
        "HFS": "Hartree-Fock theory with Slater exchange",
        "LDA": "density functional theory via local density approximation",
        "LSDA": "density functional theory via local spin density approximation",
        "SVWN": "density functional theory with Slater exchange and VWN correlation",
        "SVWN3": "density functional theory with Slater exchange and VWN-III correlation",
        "SVWN5": "density functional theory with Slater exchange and VWN-V correlation",
        "SPW": "density functional theory with Slater exchange and Perdew-Wang correlation",
        "HFB": "Hartree-Fock theory with Becke exchange",
        "BVWN": "density functional theory with Becke exchange and VWN correlation",
        "BVWN3": "density functional theory with Becke exchange and VWN-III correlation",
        "BVWN5": "density functional theory with Becke exchange and VWN-V correlation",
        "PBE": "density functional theory with PBE exchange and correlation",
        "RPBE": "density functional theory with modified PBE exchange and PBE correlation",
        "REVPBE": "density functional theory with revised PBE exchange and PBE correlation",
        "BLYP": "density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "SLYP": "density functional theory with Slater exchange and Lee-Yang-Parr correlation",
        "PWP": "density functional theory with Perdew-Wang exchange and Perdew 1986 correlation",
        "MPWPW": "density functional theory with modified Perdew-Wang exchange and Perdew-Wang correlation",
        "MPWLYP": "density functional theory with modified Perdew-Wang exchange and Lee-Yang-Parr correlation",
        "BP86": "density functional theory with Becke exchange and Perdew 1986 correlation",
        "TPSS": "density functional theory with TPSS exchange and correlation",
        "REVTPSS": "density functional theory with revised TPSS exchange and correlation",
        "SCAN": "density functional theory with SCAN exchange and correlation",
        "RSCAN": "density functional theory with regularised SCAN exchange and correlation",
        "R2SCAN": "density functional theory with regularised and restored SCAN exchange and correlation",
        "B97M-V": "density functional theory with B97M-V exchange and correlation",
        "PBE0": "hybrid density functional theory with PBE exchange and correlation",
        "REVPBE0": "hybrid density functional theory with revised PBE exchange and correlation",
        "REVPBE38": "hybrid density functional theory with revised PBE exchange and correlation",
        "B1P86": "hybrid density functional theory with Becke exchange and Perdew 1986 correlation",
        "BHLYP": "hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B1LYP": "hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B3LYP": "hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B3LYP/G": "hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "MPW1LYP": "hybrid density functional theory with modified Perdew-Wang exchange and Lee-Yang-Parr correlation",
        "PW1PW": "hybrid density functional theory with Perdew-Wang exchange and Perdew-Wang correlation",
        "MPW1PW": "hybrid density functional theory with modified Perdew-Wang exchange and Perdew-Wang correlation",
        "B3PW91": "hybrid density functional theory with Becke exchange and Perdew-Wang correlation",
        "B3P86": "hybrid density functional theory with Becke exchange and Perdew 1986 correlation",
        "TPSSH": "hybrid density functional theory with TPSS exchange and correlation",
        "TPSS0": "hybrid density functional theory with TPSS exchange and correlation",
        "SCAN0": "hybrid density functional theory with SCAN exchange and correlation",
        "R2SCANH": "hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "R2SCAN0": "hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "R2SCAN50": "hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "B97": "hybrid density functional theory with Becke exchange and correlation",
        "B97-D": "hybrid density functional theory with Becke exchange and correlation",
        "PBE0-DH": "double-hybrid density functional theory with PBE exchange and correlation",
        "PBE-QIDH": "double-hybrid density functional theory with PBE exchange and correlation",
        "PBE0-2": "double-hybrid density functional theory with PBE exchange and correlation",
        "B2PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "DSD-BLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B2-PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B2K-PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B2T-PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B2G-PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "B2NC-PLYP": "double-hybrid density functional theory with Becke exchange and Lee-Yang-Parr correlation",
        "MPW2PLYP": "double-hybrid density functional theory with modified Perdew-Wang exchange and Lee-Yang-Parr correlation",
        "R2SCAN0-DH": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "R2SCAN-CIDH": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "R2SCAN-QIDH": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "R2SCAN0-2": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "PR2SCAN50": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
        "PR2SCAN69": "double-hybrid density functional theory with regularised and restored SCAN exchange and correlation",
    }
    methods += [_m(name, desc, method_base="DFT") for name, desc in dft_descriptions.items()]

    return methods


ELECTRONIC_STRUCTURE_METHODS = _build_method_registry()
METHODS_BY_NAME = {m.name: m for m in ELECTRONIC_STRUCTURE_METHODS}


def lookup_method(method_string: str):
    """Resolve a method string (possibly with a "U" prefix) to a Method.

    Returns a fresh Method instance so callers can set .unrestricted freely.
    """
    from dataclasses import replace

    unrestricted = method_string.startswith("U") and method_string not in METHODS_BY_NAME
    base = method_string[1:] if unrestricted else method_string
    template = METHODS_BY_NAME.get(base)
    if template is None:
        return None
    method = replace(template)
    if unrestricted and not method.unrestricted_available:
        return "restricted_only"
    method.unrestricted = unrestricted
    return method


@dataclass
class Functional:
    """Composition of an exchange-correlation functional."""

    x_name: str | None
    c_name: str | None
    DFX: float = 1.0
    HFX: float = 0.0
    DFC: float = 1.0
    MPC: float = 0.0
    same_spin_scaling: float = 1.0
    opposite_spin_scaling: float = 1.0
    functional_class: str = "LDA"
    time_dependent_available: bool = False
    D2_S6: float = 1.2
    VV10_b: float = 3.9
    VV10_C: float = 0.0093
    VV10_scaling: float = 1.0

    @property
    def functional_type(self) -> str:
        if self.MPC != 0:
            if self.same_spin_scaling != 1 and self.opposite_spin_scaling != 1:
                return "spin-scaled double-hybrid"
            return "double-hybrid"
        if self.HFX != 0:
            return "hybrid"
        return "pure"


_CBRT2 = 2 ** (1 / 3)
_CBRT3 = 3 ** (1 / 3)
_CBRT6 = 6 ** (1 / 3)


def _f(x, c, **kw):
    return Functional(x, c, **kw)


XC_FUNCTIONALS = {
    "HF": _f(None, None, DFC=0, time_dependent_available=True),
    "HFS": _f("S", None, DFC=0, time_dependent_available=True),
    "SVWN": _f("S", "VWN5", time_dependent_available=True),
    "LSDA": _f("S", "VWN5", time_dependent_available=True),
    "LDA": _f("S", "VWN5", time_dependent_available=True),
    "SVWN3": _f("S", "VWN3", time_dependent_available=True),
    "SVWN5": _f("S", "VWN5", time_dependent_available=True),
    "SPW": _f("S", "PW", time_dependent_available=True),
    "PBE": _f("PBE", "PBE", functional_class="GGA", D2_S6=0.75, VV10_b=6.4),
    "RPBE": _f("RPBE", "PBE", functional_class="GGA", VV10_b=4.0),
    "REVPBE": _f("REVPBE", "PBE", functional_class="GGA", VV10_b=3.7),
    "PBE0": _f("PBE", "PBE", DFX=0.75, HFX=0.25, functional_class="GGA", VV10_b=6.9),
    "REVPBE0": _f("REVPBE", "PBE", DFX=0.75, HFX=0.25, functional_class="GGA", VV10_b=4.3),
    "REVPBE38": _f("REVPBE", "PBE", DFX=0.625, HFX=0.375, functional_class="GGA", VV10_b=4.7),
    "PBE0-DH": _f("PBE", "PBE", DFX=0.50, HFX=0.50, DFC=0.875, MPC=0.125, functional_class="GGA"),
    "PBE-QIDH": _f("PBE", "PBE", DFX=0.31, HFX=0.69, DFC=0.67, MPC=0.33, functional_class="GGA"),
    "PBE0-2": _f("PBE", "PBE", DFX=1 - 1 / _CBRT2, HFX=1 / _CBRT2, DFC=0.50, MPC=0.50, functional_class="GGA"),
    "HFB": _f("B", None, DFC=0, functional_class="GGA"),
    "BVWN": _f("B", "VWN5", functional_class="GGA"),
    "BVWN3": _f("B", "VWN3", functional_class="GGA"),
    "BVWN5": _f("B", "VWN5", functional_class="GGA"),
    "BLYP": _f("B", "LYP", functional_class="GGA", D2_S6=1.2, VV10_b=4.0),
    "BHLYP": _f("B", "LYP", DFX=0.50, HFX=0.50, functional_class="GGA"),
    "B1LYP": _f("B", "LYP", DFX=0.75, HFX=0.25, functional_class="GGA"),
    "PWP": _f("PW", "P86", functional_class="GGA"),
    "SLYP": _f("S", "LYP", functional_class="GGA"),
    "B3LYP": _f("B3", "3P", DFX=0.80, HFX=0.20, functional_class="GGA", D2_S6=1.05, VV10_b=4.8),
    "B3LYP/G": _f("B3", "3P", DFX=0.80, HFX=0.20, functional_class="GGA", D2_S6=1.05, VV10_b=4.8),
    "B2PLYP": _f("B", "LYP", DFX=0.47, HFX=0.53, DFC=0.73, MPC=0.27, functional_class="GGA", D2_S6=0.55, VV10_b=7.8),
    "B2-PLYP": _f("B", "LYP", DFX=0.47, HFX=0.53, DFC=0.73, MPC=0.27, functional_class="GGA", D2_S6=0.55, VV10_b=7.8),
    "B2K-PLYP": _f("B", "LYP", DFX=0.28, HFX=0.72, DFC=0.58, MPC=0.42, functional_class="GGA"),
    "B2T-PLYP": _f("B", "LYP", DFX=0.40, HFX=0.60, DFC=0.69, MPC=0.31, functional_class="GGA"),
    "B2G-PLYP": _f("B", "LYP", DFX=0.35, HFX=0.65, DFC=0.64, MPC=0.36, functional_class="GGA"),
    "B2NC-PLYP": _f("B", "LYP", DFX=0.19, HFX=0.81, DFC=0.45, MPC=0.55, functional_class="GGA"),
    "DSD-BLYP": _f("B", "LYP", DFX=0.25, HFX=0.75, DFC=0.53, MPC=1, same_spin_scaling=0.60,
                   opposite_spin_scaling=0.46, functional_class="GGA", VV10_b=12.0),
    "BP86": _f("B", "P86", functional_class="GGA", D2_S6=1.05, VV10_b=4.4),
    "B1P86": _f("B", "P86", DFX=0.75, HFX=0.25, functional_class="GGA"),
    "UB1P86": _f("B", "UP86", DFX=0.75, HFX=0.25, functional_class="GGA"),
    "TPSS": _f("TPSS", "TPSS", functional_class="meta-GGA", D2_S6=1.0, VV10_b=5.0),
    "REVTPSS": _f("REVTPSS", "REVTPSS", functional_class="meta-GGA"),
    "SCAN": _f("SCAN", "SCAN", functional_class="meta-GGA", VV10_b=6.4),
    "RSCAN": _f("RSCAN", "RSCAN", functional_class="meta-GGA", VV10_b=10.8),
    "R2SCAN": _f("R2SCAN", "R2SCAN", functional_class="meta-GGA", VV10_b=12.3),
    "TPSSH": _f("TPSS", "TPSS", DFX=0.90, HFX=0.10, functional_class="meta-GGA", VV10_b=5.2),
    "TPSS0": _f("TPSS", "TPSS", DFX=0.75, HFX=0.25, functional_class="meta-GGA", VV10_b=5.5),
    "SCAN0": _f("SCAN", "SCAN", DFX=0.75, HFX=0.25, functional_class="meta-GGA"),
    "R2SCANH": _f("R2SCAN", "R2SCAN", DFX=0.90, HFX=0.10, functional_class="meta-GGA", VV10_b=11.9),
    "R2SCAN0": _f("R2SCAN", "R2SCAN", DFX=0.75, HFX=0.25, functional_class="meta-GGA", VV10_b=11.4),
    "R2SCAN50": _f("R2SCAN", "R2SCAN", DFX=0.5, HFX=0.5, functional_class="meta-GGA", VV10_b=10.8),
    "MPWLYP": _f("MPW", "LYP", functional_class="GGA"),
    "MPW1LYP": _f("MPW", "LYP", DFX=0.75, HFX=0.25, functional_class="GGA"),
    "MPW2PLYP": _f("MPW", "LYP", DFX=0.45, HFX=0.55, DFC=0.75, MPC=0.25, functional_class="GGA", D2_S6=0.4),
    "MPWPW": _f("MPW", "PW91", functional_class="GGA"),
    "PW1PW": _f("PW", "PW91", DFX=0.75, HFX=0.25, functional_class="GGA", VV10_b=7.7),
    "MPW1PW": _f("MPW", "PW91", DFX=0.75, HFX=0.25, functional_class="GGA"),
    "B3PW91": _f("B3", "3P", DFX=0.80, HFX=0.20, functional_class="GGA", VV10_b=4.5),
    "B3P86": _f("B3", "3P", DFX=0.80, HFX=0.20, functional_class="GGA", VV10_b=5.3),
    "R2SCAN0-DH": _f("R2SCAN", "R2SCAN", DFX=0.50, HFX=0.50, DFC=0.875, MPC=0.125,
                     same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA"),
    "R2SCAN-CIDH": _f("R2SCAN", "R2SCAN", DFX=1 - 1 / _CBRT6, HFX=1 / _CBRT6, DFC=5 / 6, MPC=1 / 6,
                      same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA"),
    "R2SCAN-QIDH": _f("R2SCAN", "R2SCAN", DFX=1 - 1 / _CBRT3, HFX=1 / _CBRT3, DFC=2 / 3, MPC=1 / 3,
                      same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA"),
    "R2SCAN0-2": _f("R2SCAN", "R2SCAN", DFX=1 - 1 / _CBRT2, HFX=1 / _CBRT2, DFC=0.5, MPC=0.5,
                    same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA"),
    "PR2SCAN50": _f("R2SCAN", "R2SCAN", DFX=0.5, HFX=0.5, DFC=0.75, MPC=0.25,
                    same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA",
                    VV10_b=10.9207, VV10_scaling=0.75),
    "PR2SCAN69": _f("R2SCAN", "R2SCAN", DFX=1 - 1 / _CBRT3, HFX=1 / _CBRT3, DFC=5 / 9, MPC=4 / 9,
                    same_spin_scaling=0, opposite_spin_scaling=4 / 3, functional_class="meta-GGA",
                    VV10_b=9.0691, VV10_scaling=0.5556),
    "B97": _f("B97", "B97", HFX=0.1943, functional_class="GGA"),
    "B97-D": _f("B97", "B97", functional_class="GGA", D2_S6=1.25),
    "B97M-V": _f("B97M", "B97M", functional_class="meta-GGA", VV10_b=6, VV10_C=0.01),
}


def _build_basis_aliases() -> dict[str, str]:
    """Canonical basis names keyed by the upper-case form the user types."""
    names = [
        "custom",
        *[f"STO-{n}G" for n in range(2, 7)],
        "3-21G", "4-31G",
        "6-31G", "6-31+G", "6-31++G", "6-311G", "6-311+G", "6-311++G",
        "6-31G*", "6-31G**", "6-311G*", "6-311G**",
        "6-31+G*", "6-311+G*", "6-31+G**", "6-311+G**",
        "6-31++G*", "6-311++G*", "6-31++G**", "6-311++G**",
        *[f"cc-pV{z}Z" for z in "DTQ56"],
        "def2-SVP", "def2-SVPD", "def2-TZVP", "def2-TZVPD", "def2-TZVPP",
        "def2-TZVPPD", "def2-QZVP", "def2-QZVPD", "def2-QZVPP", "def2-QZVPPD",
        *[f"pc-{n}" for n in range(5)],
        *[f"aug-pc-{n}" for n in range(5)],
        *[f"pcseg-{n}" for n in range(5)],
        *[f"aug-pcseg-{n}" for n in range(5)],
        *[f"aug-cc-pV{z}Z" for z in "DTQ56"],
        *[f"d-aug-cc-pV{z}Z" for z in "DTQ56"],
        *[f"t-aug-cc-pV{z}Z" for z in "DTQ56"],
        *[f"cc-pCV{z}Z" for z in "DTQ5"],
        *[f"aug-cc-pCV{z}Z" for z in "DTQ5"],
        *[f"cc-pwCV{z}Z" for z in "DTQ5"],
        *[f"aug-cc-pwCV{z}Z" for z in "DTQ5"],
        *[f"ano-pV{z}Z" for z in "DTQ5"],
        *[f"aug-ano-pV{z}Z" for z in "DTQ5"],
    ]
    aliases = {name.upper(): name for name in names}

    # Pople polarisation-alias spellings: both [..] and (..) map onto the
    # canonical parenthesised name.
    pol = {
        "6-31G(D)": "6-31G(d)",
        "6-31+G(D)": "6-31+G(d,p)",
        "6-31++G(D)": "6-31++G(d,p)",
        "6-311G(D)": "6-311G(d,p)",
        "6-311+G(D)": "6-311+G(d,p)",
        "6-311++G(D)": "6-311++G(d,p)",
        "6-31G(D,P)": "6-31G(d,p)",
        "6-31+G(D,P)": "6-31+G(d,p)",
        "6-31++G(D,P)": "6-31++G(d,p)",
        "6-311G(D,P)": "6-311G(d,p)",
        "6-311+G(D,P)": "6-311+G(d,p)",
        "6-311++G(D,P)": "6-311++G(d,p)",
        "6-31G(2DF,P)": "6-31G(2df,p)",
        "6-31G(3DF,3PD)": "6-31G(3df,3pd)",
        "6-311G(2DF,2PD)": "6-311G(2df,2pd)",
        "6-311+G(2D,P)": "6-311+G(2d,p)",
        "6-311++G(2D,2P)": "6-311++G(2d,2p)",
        "6-311++G(3DF,3PD)": "6-311++G(3df,3pd)",
    }
    for typed, canonical in pol.items():
        aliases[typed] = canonical
        aliases[typed.replace("(", "[").replace(")", "]")] = canonical
    return aliases


BASIS_ALIASES = _build_basis_aliases()

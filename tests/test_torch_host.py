"""The port's host layer and imports.

The framework-free modules of tuna_tpu are copied into tuna_tpu_torch
(importing them from tuna_tpu would import jax); these tests keep the copies
from drifting, and check that the port imports without jax, triton or nvcc.
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tuna_tpu
import tuna_tpu.basis
import tuna_tpu.config
import tuna_tpu.constants
import tuna_tpu.methods
import tuna_tpu.periodic

import tuna_tpu_torch
import tuna_tpu_torch.basis
import tuna_tpu_torch.config
import tuna_tpu_torch.constants
import tuna_tpu_torch.methods
import tuna_tpu_torch.periodic
from tuna_tpu_torch import _kernels
from tuna_tpu_torch.cli import parse_input, process_method

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
COPIED = ["constants.py", "methods.py", "output.py", "periodic.py", "spherical.py",
          "system.py", "config.py", "props.py", "basis/__init__.py", "stencils.py",
          "drivers/thermo.py", "checkpoint.py"]
SLICE_LINE = "SPE : N N 1.1 : CCSD[T] 6-311G : TIGHTSCF"


def _without_data_path(source: str) -> str:
    """AST dump of a module with its `_DATA = ...` assignment removed (the
    copies read tuna_tpu's data files by path)."""
    tree = ast.parse(source)
    tree.body = [node for node in tree.body
                 if not (isinstance(node, ast.Assign)
                         and any(getattr(t, "id", None) == "_DATA" for t in node.targets))]
    return ast.dump(tree)


@pytest.mark.parametrize("relative", COPIED)
def test_host_copies_match_tuna_tpu_source(relative):
    original = (REPO / "tuna_tpu" / relative).read_text()
    copy = (REPO / "tuna_tpu_torch" / relative).read_text()
    assert _without_data_path(copy) == _without_data_path(original)


class _DeviceStripper(ast.NodeTransformer):
    """Drops every `device` parameter (with its default) and `device=`
    keyword, and empties the bodies of the functions named in `emptied`;
    `passed` collects what each dropped keyword passed."""

    def __init__(self, emptied=()):
        self.emptied = set(emptied)
        self.passed = []

    def visit_FunctionDef(self, node):
        self.generic_visit(node)
        arguments = node.args
        if arguments.args and arguments.args[-1].arg == "device":
            arguments.args.pop()
            arguments.defaults.pop()
        if node.name in self.emptied:
            node.body = [ast.Pass()]
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        self.passed += [ast.dump(k.value) for k in node.keywords if k.arg == "device"]
        node.keywords = [k for k in node.keywords if k.arg != "device"]
        return node


def _without_device(source, emptied=()):
    """AST dump of a driver module without its docstring, `device`
    parameters and keywords, and the bodies of the functions `emptied`;
    every `device=` keyword must pass the caller's own `device` on."""
    tree = ast.parse(source)
    assert isinstance(tree.body[0], ast.Expr)
    tree.body = tree.body[1:]
    stripper = _DeviceStripper(emptied)
    dump = ast.dump(stripper.visit(tree))
    assert set(stripper.passed) <= {ast.dump(ast.Name("device", ast.Load()))}
    return dump


@pytest.mark.parametrize("relative, emptied", [
    ("drivers/electric.py", ("_prefetch_field_energies",)),
    ("drivers/composite.py", ()),
])
def test_driver_copies_match_tuna_tpu_source(relative, emptied):
    """electric.py and composite.py use no JAX: the port's copies differ only
    in their docstrings, in passing `device` down, and (electric.py) in the
    field batch, which the port does not have yet, so its
    _prefetch_field_energies returns None (every stencil walks serially)."""
    original = (REPO / "tuna_tpu" / relative).read_text()
    copy = (REPO / "tuna_tpu_torch" / relative).read_text()
    assert _without_device(copy, emptied) == _without_device(original, emptied)
    tree = ast.parse(copy)
    for function in emptied:
        body = next(node for node in tree.body
                    if isinstance(node, ast.FunctionDef) and node.name == function).body
        assert ast.dump(body[-1]) == ast.dump(ast.parse("return None").body[0])


def test_plotting_copy_matches_tuna_tpu_source():
    """plotting.py is tuna_tpu's but for its docstring and the body of
    show_two_dimensional_plot, which evaluates the plane's AOs and densities
    through dft.grid (K7a and K7b on the card)."""
    emptied = ("show_two_dimensional_plot",)
    original = (REPO / "tuna_tpu" / "plotting.py").read_text()
    copy = (REPO / "tuna_tpu_torch" / "plotting.py").read_text()
    assert _without_device(copy, emptied) == _without_device(original, emptied)
    body = next(node for node in ast.parse(copy).body
                if isinstance(node, ast.FunctionDef)
                and node.name == "show_two_dimensional_plot").body
    source = ast.unparse(body)
    assert "basis_on_grid" in source and "density_on_grid" in source


def test_uccsdt_term_table_matches_tuna_tpu():
    """post/_uccsdt_terms.py is tuna_tpu's term table; only the module
    docstring differs (it names the evaluator's einsum)."""
    def without_docstring(relative):
        tree = ast.parse((REPO / relative / "post" / "_uccsdt_terms.py").read_text())
        assert isinstance(tree.body[0], ast.Expr)
        tree.body = tree.body[1:]
        return ast.dump(tree)

    assert without_docstring("tuna_tpu_torch") == without_docstring("tuna_tpu")
    from tuna_tpu_torch.post import _uccsdt_terms
    assert len(_uccsdt_terms.TERMS_T1) == 15


def test_copies_read_tuna_tpu_data_files():
    assert tuna_tpu_torch.periodic._DATA.resolve() == tuna_tpu.periodic._DATA.resolve()
    assert tuna_tpu_torch.basis._DATA.resolve() == tuna_tpu.basis._DATA.resolve()


def _plain(value):
    """A comparable form of host-layer values across the two packages."""
    if dataclasses.is_dataclass(value):
        return _plain(dataclasses.asdict(value))
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value


def test_host_tables_match_tuna_tpu():
    for name in ("ELECTRONIC_STRUCTURE_METHODS", "BASIS_ALIASES", "CALCULATION_TYPES"):
        assert _plain(getattr(tuna_tpu_torch.methods, name)) == _plain(
            getattr(tuna_tpu.methods, name)), name
    assert tuna_tpu_torch.basis.BASIS_TABLES == tuna_tpu.basis.BASIS_TABLES
    assert _plain(tuna_tpu_torch.periodic.ATOMIC_PROPERTIES) == _plain(
        tuna_tpu.periodic.ATOMIC_PROPERTIES)
    numbers = {k: v for k, v in vars(tuna_tpu.constants).items()
               if isinstance(v, (int, float, dict)) and not k.startswith("_")}
    assert numbers
    for key, value in numbers.items():
        assert getattr(tuna_tpu_torch.constants, key) == value, key


def test_slice_config_matches_tuna_tpu():
    from tuna_tpu.cli import parse_input as jax_parse_input, process_method as jax_process

    parsed, jax_parsed = parse_input(SLICE_LINE), jax_parse_input(SLICE_LINE)
    assert _plain(parsed[:5]) == _plain(jax_parsed[:5])
    assert list(parsed[5]) == list(jax_parsed[5])
    cfg = tuna_tpu_torch.config.Config(parsed[0], process_method(parsed[1]), 0.0,
                                       parsed[5], parsed[2], parsed[3])
    jax_cfg = tuna_tpu.config.Config(jax_parsed[0], jax_process(jax_parsed[1]), 0.0,
                                     jax_parsed[5], jax_parsed[2], jax_parsed[3])
    settings = {k: _plain(v) for k, v in vars(cfg).items() if k != "params"}
    jax_settings = {k: _plain(v) for k, v in vars(jax_cfg).items() if k != "params"}
    assert settings == jax_settings
    assert cfg.SCF_conv["name"].upper().startswith("TIGHT")


def test_package_imports_without_jax_triton_or_nvcc(tmp_path):
    """Every module of tuna_tpu_torch imports with triton unimportable and
    no nvcc, and importing it loads neither jax nor tuna_tpu."""
    script = f"""
import importlib, json, pkgutil, sys
sys.modules["triton"] = None          # any "import triton" now raises
sys.path.insert(0, {str(REPO)!r})
import tuna_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tuna_tpu_torch.__path__, "tuna_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
print(json.dumps({{"modules": names,
                   "loaded": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "tuna_tpu"))}}))
"""
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": str(tmp_path / "no-cuda"),
           "HOME": str(tmp_path), "PYTHONPATH": ""}
    result = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                            env=env, cwd=tmp_path, timeout=120, check=True)
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert "tuna_tpu_torch.post.cc" in report["modules"]
    assert "tuna_tpu_torch.ops.integrals" in report["modules"]
    assert report["loaded"] == []


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.build()
    assert set(_kernels.SIGNATURES) == {"tuna_eri_packed", "tuna_one_electron",
                                        "tuna_ccsd_t_energy", "tuna_uccsd_t_energy",
                                        "tuna_ao_on_grid",
                                        "tuna_density_on_grid", "tuna_vv10_energy",
                                        "tuna_vv10_energy_batch", "tuna_fock_direct", "tuna_mo_half_transform",
                                        "tuna_one_electron_deriv", "tuna_eri_deriv_energy",
                                        "tuna_density_deriv_on_grid", "tuna_ccsdt_q_energy",
                                        "tuna_eri_deriv_energy_unrestricted",
                                        "tuna_density_deriv_on_grid_spin",
                                        "tuna_density_tau_on_grid",
                                        "tuna_density_tau_deriv_on_grid",
                                        "tuna_density_tau_deriv_on_grid_spin"}
    assert set(_kernels.launches) == {"eri_packed", "one_electron", "ccsd_t_energy",
                                      "uccsd_t_energy", "ao_on_grid", "density_on_grid", "vv10_energy",
                                      "vv10_energy_batch", "fock_direct", "mo_half_transform", "one_electron_deriv",
                                      "eri_deriv_energy", "density_deriv_on_grid",
                                      "ccsdt_q_energy", "eri_deriv_energy_unrestricted",
                                      "density_deriv_on_grid_spin", "density_tau_on_grid",
                                      "density_tau_deriv_on_grid",
                                      "density_tau_deriv_on_grid_spin"}

"""Build, load and launch the hand-written CUDA kernels in `csrc/`.

The kernels are compiled by `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with ctypes.  The library is built
at first use into `build/tuna_tpu_torch/` beside the package, named by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once.  Nothing here runs at import: the CPU-only tests import
every module of the package on a machine with no `nvcc` and no GPU.

Each C entry point launches on the stream it is given, allocates nothing and
returns the `cudaError_t` of its launch; `launch()` raises on a non-zero
code.  `launches` counts, per kernel, the launches of the CUDA path only
(the wrappers in ops/, post/ and dft/ call `launch`, never on the CPU path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "tuna_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# C entry points: argument types in order, the stream last.
SIGNATURES = {
    # lmax, n_pairs, n_prim_pairs, coords, a, b, coef, l1, l2, atom1, atom2,
    # pair_start, quartets, n_classes, classes (host), boys tables, rows
    # (scratch), packed (out)
    "tuna_eri_packed": [_I, _I, _I] + [_P] * 10 + [_I] + [_P] * 4 + [_P],
    # lmax, n_atoms, n_basis, n_pairs, coords, charges, a, b, coef, l1, l2,
    # atom1, atom2, ao_i, ao_j, pair_start, boys_table, dipole_origin_z, out
    "tuna_one_electron": [_I, _I, _I, _I] + [_P] * 13 + [_D, _P] + [_P],
    # no, nv, n_batches, batches (host), slots, multisets, orbits, g_oovv,
    # g_ovvv, g_oovo, t1, t2, eps_o, eps_v, v_scale, workspace, partial
    "tuna_ccsd_t_energy": [_I, _I, _I] + [_P] * 11 + [_D, _P, _P] + [_P],
    # no, nv, n_batches, batches (host), triples, pairs, orbits, g_oovv,
    # g_vovv, g_ovoo, t1, t2, eps_o, eps_v, v_scale, workspace, partial
    "tuna_uccsd_t_energy": [_I, _I, _I] + [_P] * 11 + [_D, _P, _P] + [_P],
    # n_ao, n_points, with_gradients, points, origin, lmn, prim_start, exps,
    # coefs, values (out), gradients (out)
    "tuna_ao_on_grid": [_I, _I, _I] + [_P] * 8 + [_P],
    # n_ao, n_points, with_gradients, P, phi, grads, density, gradient
    "tuna_density_on_grid": [_I, _I, _I] + [_P] * 5 + [_P],
    # n_points, n_tiles, points, omega, kappa, weighted density, beta,
    # partial
    "tuna_vv10_energy": [_I, _I] + [_P] * 4 + [_D, _P] + [_P],
    # lmax, n_pairs, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2,
    # atom1, atom2, pair_start, pid_i, pid_j, quartets, n_classes, classes
    # (host), boys tables, P, rows (scratch), J_pair (scratch), J, K
    "tuna_fock_direct": [_I, _I, _I, _I] + [_P] * 12 + [_I] + [_P] * 7 + [_P],
    # n_rows, n_ao, n_mo, panel, row_stride, col_stride, M, pair_index, W, out
    "tuna_mo_half_transform": [_I, _I, _I, _I, _L, _L] + [_P] * 4 + [_P],
    # lmax, n_atoms, n_basis, n_pairs, coords, charges, a, b, coef, l1, l2,
    # atom1, atom2, ao_i, ao_j, pair_start, boys_table, dipole_origin_z,
    # origin_rate, out
    "tuna_one_electron_deriv": [_I, _I, _I, _I] + [_P] * 13 + [_D, _D, _P] + [_P],
    # lmax, n_prim_pairs, n_basis, coords, a, b, coef, l1, l2, atom1, atom2,
    # pair_start, pid_i, pid_j, quartets, n_classes, classes (host), boys
    # tables, P, hfx, rows (scratch), n_partials, partials (scratch), out
    "tuna_eri_deriv_energy": [_I, _I, _I] + [_P] * 12 + [_I] + [_P] * 3
                             + [_D, _P, _I, _P, _P] + [_P],
    # n_ao, n_points, first_moving, with_gradients, points, origin, ao_moves,
    # lmn, prim_start, exps, coefs, P, density, gradient, d_density,
    # d_gradient
    "tuna_density_deriv_on_grid": [_I, _I, _I, _I] + [_P] * 12 + [_P],
}

# Launches of each kernel's CUDA path since the last reset.
launches = {"eri_packed": 0, "one_electron": 0, "ccsd_t_energy": 0, "uccsd_t_energy": 0,
            "ao_on_grid": 0, "density_on_grid": 0, "vv10_energy": 0,
            "fock_direct": 0, "mo_half_transform": 0, "one_electron_deriv": 0,
            "eri_deriv_energy": 0, "density_deriv_on_grid": 0}

_lock = threading.Lock()
_library = None


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libtuna_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of tuna_tpu_torch "
                           "need the CUDA toolkit (set CUDA_HOME)")
    return found


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source, all started together, then one link.

    The compiler's report (ptxas registers, shared memory, spills) is kept
    beside the library as `<name>.log`."""
    target = library_path()
    if target.exists():
        return target
    nvcc = _nvcc()
    work = BUILD_DIR / f"{target.stem}.{os.getpid()}.objects"
    work.mkdir(parents=True, exist_ok=True)
    units = sorted(CSRC.glob("*.cu"))
    objects = [work / f"{unit.stem}.o" for unit in units]
    compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(unit)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for unit, obj in zip(units, objects)]
    reports = [(unit, process.communicate()[0], process.returncode)
               for unit, process in zip(units, compiles)]
    log = "".join(f"== {unit.name}\n{report}" for unit, report, _ in reports)
    failed = [unit.name for unit, _, code in reports if code != 0]
    partial = target.with_name(f"{target.stem}.{os.getpid()}.partial.so")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(partial), *map(str, objects)],
                              capture_output=True, text=True, check=False)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    target.with_suffix(".log").write_text(log)
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        partial.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log[-8000:]}")
    os.replace(partial, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.tuna_error_string.argtypes = [ctypes.c_int]
            lib.tuna_error_string.restype = ctypes.c_char_p
            _library = lib
    return _library


def check_tensor(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
                 device: torch.device) -> None:
    """Raise unless t has exactly the shape, dtype and device a kernel takes
    and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call one C entry point on the current stream of `device`, count it
    under `kernel`, and raise if its launch failed."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(*args, stream)
    if code != 0:
        message = lib.tuna_error_string(code).decode()
        raise RuntimeError(f"{entry}: CUDA error {code} ({message})")
    launches[kernel] += 1

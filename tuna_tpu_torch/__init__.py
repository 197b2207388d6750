"""TUNA on PyTorch and CUDA: the port of `tuna_tpu` to one NVIDIA Hopper GPU.

Same CLI grammar (`CALC : A B R : METHOD BASIS : KEYWORDS`), printed output
and energies as `tuna_tpu`, with plain PyTorch for the dense linear algebra
and hand-written CUDA kernels (`csrc/`) for the ERI sweep, the one-electron
integrals and the (T) triples energy.  Every tensor is float64 and lives on
the device the caller names; importing the package sets no global state.
"""

__version__ = "0.2.0"

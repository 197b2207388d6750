"""Result containers shared across the framework, holding torch tensors.

Twins of `tuna_tpu.containers.Integrals` and `Output`.  Tensors stay on the
device they were computed on; `Output.host_view()` hands the host-side
printing code (`props.py`, numpy) a copy with every tensor on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch


@dataclass
class Integrals:
    S: Any
    T: Any
    V_NE: Any
    D: Any          # (3, N, N) dipole
    Q: Any          # (3, N, N) diagonal quadrupole (xx, yy, zz)
    ERI_AO: Any
    F: Any = None   # electric-field one-electron contribution
    G: Any = None   # electric-field-gradient contribution

    @property
    def H_core(self):
        H = self.T + self.V_NE
        if self.F is not None:
            H = H + self.F
        return H

    @property
    def n_basis(self):
        return self.S.shape[0]


@dataclass
class Output:
    energy: float

    kinetic_energy: float
    nuclear_electron_energy: float
    coulomb_energy: float
    exchange_energy: float
    correlation_energy: float
    electric_field_energy: float
    electric_field_gradient_energy: float

    P: Any
    P_alpha: Any
    P_beta: Any
    S: Any
    X: Any

    molecular_orbitals: Any
    molecular_orbitals_alpha: Any
    molecular_orbitals_beta: Any

    epsilons: Any
    epsilons_alpha: Any
    epsilons_beta: Any

    density: Any
    alpha_density: Any
    beta_density: Any

    F_alpha: Any
    F_beta: Any
    T: Any
    V_NE: Any

    integrals: Integrals

    dispersion_energy: float = 0.0
    D: Any = None
    Q: Any = None

    # Host wall seconds of each SCF iteration and of each correlated
    # iteration; every entry ends in a device synchronisation.
    iteration_seconds: list = field(default_factory=list)
    correlation_iteration_seconds: list = field(default_factory=list)

    @property
    def epsilons_combined(self):
        return np.append(to_numpy(self.epsilons_alpha), to_numpy(self.epsilons_beta))

    @property
    def F(self):
        return self.F_alpha + self.F_beta

    @property
    def exchange_correlation_energy(self):
        return self.exchange_energy + self.correlation_energy

    def set_dispersion_energy(self, dispersion_energy: float) -> None:
        self.dispersion_energy = dispersion_energy

    def host_view(self) -> "Output":
        """A shallow copy with every tensor field moved to a numpy array."""
        return dataclasses.replace(self, **{
            f.name: to_numpy(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def to_numpy(x):
    """numpy copy of a tensor on any device; other values pass through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x

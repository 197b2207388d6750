"""Cartesian-harmonic -> real-spherical-harmonic transformation.

The reference hardcodes per-shell transformation blocks
(/root/reference/TUNA/tuna_kernel.py:540-649).  Here the blocks are generated
for any angular momentum from the real solid-harmonic recursions (Helgaker,
Jorgensen & Olsen, "Molecular Electronic-Structure Theory", eqs. 6.4.70-73),
expressed in the basis of *normalised* Cartesian Gaussians and renormalised
so each spherical function has unit self-overlap.  The within-shell ordering
of spherical components matches the reference convention:

  s: [0]   p: [x, y, z] = [+1, -1, 0]   d: [-2, +1, -1, +2, 0]
  f and higher: [-l, ..., +l]

Cartesian components are ordered x-major: (lx,ly,lz) for lx = L..0,
ly = L-lx..0 (tuna_molecule.py:596-624).
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np


def cartesian_components(l: int) -> list[tuple[int, int, int]]:
    """x-major ordering of Cartesian monomials of total degree l."""
    return [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]


def n_cartesian(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def n_spherical(l: int) -> int:
    return 2 * l + 1


def double_factorial(n: int) -> float:
    result = 1.0
    while n > 1:
        result *= n
        n -= 2
    return result


def _monomial_self_overlap(lmn: tuple[int, int, int]) -> float:
    """<x^a y^b z^c e^-r2/2 | x^a y^b z^c e^-r2/2> up to an l-constant factor.

    With unit exponents, the Gaussian prefactor cancels in normalisation
    ratios within one shell, so only the double-factorial angular part
    matters: (2a-1)!!(2b-1)!!(2c-1)!!.
    """
    a, b, c = lmn
    return double_factorial(2 * a - 1) * double_factorial(2 * b - 1) * double_factorial(2 * c - 1)


class _Poly(dict):
    """Sparse polynomial {(lx,ly,lz): coeff} with + and scalar *."""

    def __add__(self, other):
        out = _Poly(self)
        for k, v in other.items():
            out[k] = out.get(k, 0.0) + v
        return out

    def scale(self, s):
        return _Poly({k: v * s for k, v in self.items()})

    def mul_axis(self, axis, power=1):
        out = _Poly()
        for (a, b, c), v in self.items():
            key = list((a, b, c))
            key[axis] += power
            out[tuple(key)] = out.get(tuple(key), 0.0) + v
        return out

    def mul_r2(self):
        return self.mul_axis(0, 2) + self.mul_axis(1, 2) + self.mul_axis(2, 2)


@lru_cache(maxsize=None)
def _solid_harmonics(l: int) -> dict[int, _Poly]:
    """Real solid harmonics S_{l,m} as monomial polynomials, m = -l..l."""
    if l == 0:
        return {0: _Poly({(0, 0, 0): 1.0})}
    prev = _solid_harmonics(l - 1)
    lm1 = l - 1
    out: dict[int, _Poly] = {}

    # Diagonal recursion (6.4.70-71); the 1+delta factor handles m=0 -> m=1
    factor = sqrt((2 * lm1 + 1) / (2 * lm1 + 2) * (2.0 if lm1 == 0 else 1.0))
    s_top = prev[lm1]
    # The sine-type partner S_{l-1,-(l-1)} vanishes identically at l-1 = 0
    s_bot = prev[-lm1] if lm1 > 0 else _Poly()
    out[l] = (s_top.mul_axis(0) + s_bot.mul_axis(1).scale(-1)).scale(factor)
    out[-l] = (s_bot.mul_axis(0) + s_top.mul_axis(1)).scale(factor)

    # Vertical recursion (6.4.73)
    prev2 = _solid_harmonics(l - 2) if l >= 2 else {}
    for m in range(-(l - 1), l):
        denominator = sqrt((l + m) * (l - m))
        term = prev[m].mul_axis(2).scale(2 * lm1 + 1)
        if abs(m) <= l - 2:
            term = term + prev2[m].mul_r2().scale(-sqrt((lm1 + m) * (lm1 - m)))
        out[m] = term.scale(1.0 / denominator)
    return out


# Within-shell spherical ordering used by the reference output format
def spherical_m_order(l: int) -> list[int]:
    if l == 0:
        return [0]
    if l == 1:
        return [1, -1, 0]
    if l == 2:
        return [-2, 1, -1, 2, 0]
    return list(range(-l, l + 1))


@lru_cache(maxsize=None)
def shell_transform(l: int) -> np.ndarray:
    """(2l+1, n_cart) block mapping normalised Cartesians -> spherical AOs."""
    carts = cartesian_components(l)
    cart_norms = np.array([sqrt(_monomial_self_overlap(c)) for c in carts])

    rows = []
    harmonics = _solid_harmonics(l)
    for m in spherical_m_order(l):
        poly = harmonics[m]
        row = np.zeros(len(carts))
        for idx, c in enumerate(carts):
            row[idx] = poly.get(c, 0.0)
        # Express in normalised-Cartesian basis
        row = row * cart_norms
        # Renormalise: <row|S_cart|row> = 1 with S_cart the normalised-Cartesian
        # overlap, whose angular part is a ratio of double factorials.
        S_cart = np.zeros((len(carts), len(carts)))
        for i, ci in enumerate(carts):
            for j, cj in enumerate(carts):
                s = tuple(a + b for a, b in zip(ci, cj))
                if all(v % 2 == 0 for v in s):
                    S_cart[i, j] = _monomial_self_overlap(tuple(v // 2 for v in s)) / (
                        cart_norms[i] * cart_norms[j])
        norm = sqrt(row @ S_cart @ row)
        rows.append(row / norm)
    return np.array(rows)


def build_transformation_matrix(shell_ls: list[int]) -> np.ndarray:
    """Block-diagonal (n_sph_total, n_cart_total) map for a list of shells."""
    blocks = [shell_transform(l) for l in shell_ls]
    n_sph = sum(b.shape[0] for b in blocks)
    n_cart = sum(b.shape[1] for b in blocks)
    U = np.zeros((n_sph, n_cart))
    r = c = 0
    for b in blocks:
        U[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return U

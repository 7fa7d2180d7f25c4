"""J1 Bessel function for the analytic ellipse Fourier transform.

The same Abramowitz & Stegun 9.4.4-9.4.6 rational/asymptotic fits as
``metalens_tpu/solver/special.py`` (|abs error| < ~1e-8 below 8, < ~1e-7
above), so the port agrees with the JAX package to float64 rounding.
``torch.special.bessel_j1`` is a different (exact) function and would break
that parity.
"""

from __future__ import annotations

import torch

_P1 = (72362614232.0, -7895059235.0, 242396853.1, -2972611.439,
       15704.48260, -30.16036606)
_Q1 = (144725228442.0, 2300535178.0, 18583304.74, 99447.43394,
       376.9991397, 1.0)
_PA = (1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5, -0.240337019e-6)
_QA = (0.04687499995, -0.2002690873e-3, 0.8449199096e-5,
       -0.88228987e-6, 0.105787412e-6)


def _poly(coeffs, x):
    acc = torch.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def j1(x: torch.Tensor) -> torch.Tensor:
    """Bessel function of the first kind, order 1, for real input."""
    ax = torch.abs(x)
    y = x * x
    small = x * _poly(_P1, y) / _poly(_Q1, y)
    z = 8.0 / torch.clamp(ax, min=1e-30)
    y2 = z * z
    xx = ax - 2.356194491  # 3*pi/4
    big = torch.sqrt(0.636619772 / torch.clamp(ax, min=1e-30)) * (
        torch.cos(xx) * _poly(_PA, y2) - z * torch.sin(xx) * _poly(_QA, y2)
    ) * torch.sign(x)
    return torch.where(ax < 8.0, small, big)


def j1_over_x(x: torch.Tensor) -> torch.Tensor:
    """J1(x)/x with the limit 1/2 at x = 0 (a quadratic Taylor branch below
    |x| = 1e-6, so the gradient stays clean there)."""
    small = torch.abs(x) < 1e-6
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 16.0, j1(safe) / safe)


def j1_small(x: torch.Tensor) -> torch.Tensor:
    """J1 for |x| < 8 only (the rational fit; the caller guarantees the
    range)."""
    y = x * x
    return x * _poly(_P1, y) / _poly(_Q1, y)


def j1_over_x_from_sq(x2: torch.Tensor,
                      small_arg_only: bool = False) -> torch.Tensor:
    """J1(sqrt(x2))/sqrt(x2) as a function of the squared argument, with
    the limit 1/2 at 0 (a quadratic Taylor branch below 1e-12, so the
    gradient stays finite on every Toeplitz diagonal)."""
    small = x2 < 1e-12
    x = torch.sqrt(torch.where(small, torch.ones_like(x2), x2))
    taylor = 0.5 - x2 / 16.0
    j1x = j1_small(x) if small_arg_only else j1(x)
    return torch.where(small, taylor, j1x / x)

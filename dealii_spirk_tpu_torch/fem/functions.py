"""Manufactured solution and forcing of the heat-equation benchmark.

Port of ``dealii_spirk_tpu/fem/functions.py`` (reference
``main.cc:3495-3602``, ``const_wave = true``):

    u(x, t)  = prod_k sin(a pi x_k) * (1 + sin(pi c_t t)) * exp(-a_t t)
    f(x, t)  = prod_k sin(a pi x_k) * g(t)
    g(t)     = [pi c_t cos(pi c_t t) - a_t (1 + sin(pi c_t t))
                + dim a^2 pi^2 (1 + sin(pi c_t t))] * exp(-a_t t)

``t`` is a tensor (per-stage times); the result keeps its dtype/device.
"""

from __future__ import annotations

import math

import torch

A_T = 0.5
C_T = 1.0
WAVE = 2.0  # const_wave => a_x = a_y = a_z = 2 (reference main.cc:3502-3504)
PI = math.pi


def solution_time_factor(t: torch.Tensor) -> torch.Tensor:
    """Time factor of the analytical solution."""
    return (1.0 + torch.sin(PI * C_T * t)) * torch.exp(-A_T * t)


def rhs_time_factor(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Time factor g(t) of the separable forcing f = S(x) g(t)."""
    s = torch.sin(PI * C_T * t)
    return (
        PI * C_T * torch.cos(PI * C_T * t)
        - A_T * (1.0 + s)
        + dim * WAVE**2 * PI**2 * (1.0 + s)
    ) * torch.exp(-A_T * t)

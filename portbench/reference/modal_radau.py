"""Plain reference of a Radau IIA time step of the heat equation
M u' = F(t) - K u on the tensor-product grid, solved exactly.

The stage system of one step, M k_i + tau sum_j a_ij K k_j = R_i with
R_i = F(t + (c_i - 1) tau) - K u (t the new time), is diagonal in the
eigenbasis of the 1D pencil (K1, M1): with K1 V = M1 V diag(lam) and
V^T M1 V = I, the d-fold product S of V gives S^T M S = I and
S^T K S = diag(Lam), Lam the sum of one lam per axis.  In that basis, per
mode, the step is u_hat += tau b^T (I + tau Lam A)^-1 (g F_hat - Lam u_hat 1),
and with A = P diag(sigma) P^-1 the q x q solve is q complex divisions.
The field is S u_hat.  Nothing is iterated, so the answer is the step's
exact solution up to rounding.

The manufactured problem (reference main.cc:3495-3602, const_wave): the
forcing is sin(2 pi x) in every direction times g(t).

``precision="f64"`` is the reference.  ``precision="tf32"`` is the control
of the f32 port (which keeps TF32 off): the same computation in float32
with every transform a TF32 matrix product (on a CUDA device TF32 itself,
on the CPU its operands rounded to TF32's 10-bit mantissa).
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Iterator

import numpy as np
import torch

from .fem1d import WAVE, Interval
from .radau import radau_iia

A_T, C_T = 0.5, 1.0  # time factor (1 + sin(pi c_t t)) exp(-a_t t)


def forcing_factor(t: float, dim: int) -> float:
    s = math.sin(math.pi * C_T * t)
    return (math.pi * C_T * math.cos(math.pi * C_T * t) - A_T * (1.0 + s)
            + dim * WAVE**2 * math.pi**2 * (1.0 + s)) * math.exp(-A_T * t)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits, ties
    to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def tf32_matmul(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class ModalRadau:
    def __init__(self, params: dict, device, precision: str = "f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.device = torch.device(device)
        self.real = torch.float64 if precision == "f64" else torch.float32
        self.dim = int(params.get("Dim", 3))
        self.tau = float(params["TimeStepSize"])
        line = Interval(int(params["FEDegree"]), int(params["NRefinements"]))
        Lc = np.linalg.cholesky(line.M)
        Li = np.linalg.inv(Lc)
        lam, Q = np.linalg.eigh(Li @ line.K @ Li.T)
        V = Li.T @ Q  # V^T M1 V = I, V^T K1 V = diag(lam)

        def t(a, dtype=self.real):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.device)

        self.V, self.VtM = t(V), t(V.T @ line.M)
        lam_t = t(lam)
        self.Lam = sum(lam_t.reshape((-1,) + (1,) * (self.dim - 1 - ax))
                       for ax in range(self.dim))
        f_hat = t(V.T @ line.f)
        self.F_hat = f_hat
        for _ in range(self.dim - 1):
            self.F_hat = torch.tensordot(self.F_hat, f_hat, dims=0)
        A, b, c = radau_iia(int(params["IRKStages"]))
        sigma, P = np.linalg.eig(A)
        self.c = c
        self.sigma = sigma
        self.beta = b @ P
        self.P_inv = np.linalg.inv(P)
        self.complex = torch.complex128 if precision == "f64" else torch.complex64

    def transform(self, mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """mat applied along every axis of u."""
        tf32 = self.precision == "tf32"
        emulate = tf32 and self.device.type != "cuda"
        if emulate:
            mat = round_tf32(mat)
        with tf32_matmul(tf32):
            for ax in range(u.ndim):
                if emulate:
                    u = round_tf32(u)
                u = torch.movedim(torch.tensordot(mat, u, dims=([1], [ax])), 0, ax)
        return u

    def step(self, u_hat: torch.Tensor, t_new: float) -> torch.Tensor:
        tau = self.tau
        g = np.array([forcing_factor(t_new + (ci - 1.0) * tau, self.dim) for ci in self.c])
        gam_g, gam_1 = self.P_inv @ g, self.P_inv @ np.ones(len(g))
        acc = torch.zeros_like(u_hat)
        lam_u = self.Lam * u_hat
        for k, sig in enumerate(self.sigma):
            num = complex(gam_g[k]) * self.F_hat - complex(gam_1[k]) * lam_u
            term = num.to(self.complex) / (1.0 + (tau * complex(sig)) * self.Lam)
            acc += (complex(self.beta[k]) * term).real
        return u_hat + tau * acc

    def run(self, u0: torch.Tensor, steps: int) -> Iterator[torch.Tensor]:
        """The field after each of ``steps`` steps from ``u0`` at t = 0."""
        u_hat = self.transform(self.VtM, u0.to(self.device, self.real))
        for n in range(1, steps + 1):
            u_hat = self.step(u_hat, n * self.tau)
            yield self.transform(self.V, u_hat)


def run(params: dict, u0: torch.Tensor, steps: int, device, precision: str = "f64"):
    """Entry the harness calls: the fields after each step."""
    return ModalRadau(params, device, precision).run(u0, steps)


def stiffness(params: dict, device):
    """The d-dimensional stiffness matrix K (sum over the axes of K1 on
    one axis and M1 on the others) as a function of a float64 field."""
    line = Interval(int(params["FEDegree"]), int(params["NRefinements"]))
    M1 = torch.as_tensor(line.M, dtype=torch.float64, device=device)
    K1 = torch.as_tensor(line.K, dtype=torch.float64, device=device)

    def apply(u: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(u)
        for k_axis in range(u.ndim):
            v = u
            for ax in range(u.ndim):
                mat = K1 if ax == k_axis else M1
                v = torch.movedim(torch.tensordot(mat, v, dims=([1], [ax])), 0, ax)
            out += v
        return out

    return apply

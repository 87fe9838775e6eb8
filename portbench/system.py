"""The system under test: the port's public entry, driven as
``runner.run_config`` drives it, step by step.

The only module of the benchmark that imports ``dealii_spirk_tpu_torch``.
It takes from the port the problem and scheme objects, the step and its
error, and the port's own counters and spans: ``scheme.n_outer``,
``scheme.n_inner``, ``ops/cuda/stencil.py::LAUNCHES``, the phase timers
(``utils/timer.py``) and the arguments of each kernel wrapper's calls.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch

from dealii_spirk_tpu_torch.config import Parameters
from dealii_spirk_tpu_torch.ops.cuda import stencil
from dealii_spirk_tpu_torch.problem import HeatProblem
from dealii_spirk_tpu_torch.schemes import make_scheme


class System:
    def __init__(self, params: dict, device):
        """``params``: the configuration's parameters, keys as in the
        port's JSON files."""
        self.params = Parameters.from_dict(params)
        self.problem = HeatProblem(self.params, device)
        self.scheme = make_scheme(self.problem, self.params, kernels=True)
        self.dtype = self.problem.dtype
        self.device = self.problem.device
        self.steps_taken = 0

    def step(self, u: torch.Tensor, t: float, tau: float) -> tuple[torch.Tensor, float]:
        """One timestep to time ``t`` and the L2 error the port reports
        for it (read on the host, so the step has ended on the device)."""
        self.steps_taken += 1
        u = self.scheme.solve_step(u, self.steps_taken, t, tau)
        return u, self.problem.errors(u, t)[0]

    def counters(self) -> dict:
        return {
            "n_outer": float(self.scheme.n_outer),
            "n_inner": float(self.scheme.n_inner),
            "launches": dict(stencil.LAUNCHES),
        }

    @contextmanager
    def spans(self):
        """Within the block the port's phase timers also time the system
        vmult and the preconditioner's basis changes and block solves in
        place (``PhaseTimers.inner``); yields a dict that holds, after
        the block, the summed seconds per phase (None: not timed)."""
        timers = self.scheme.timers
        timers.clear()
        timers.inner = True
        out: dict = {}
        try:
            yield out
        finally:
            timers.inner = False
            out.update(timers.seconds)
            timers.clear()

    @contextmanager
    def launch_shapes(self):
        """Within the block each call of a kernel wrapper of
        ``ops/cuda/stencil.py`` (one per ``LAUNCHES`` key) is recorded, in
        order, as {"kernel", "lanes", "m", "p"}: its level's m and p and
        the lanes of its first stage block; yields the list."""
        dim = self.params.dim
        shapes: list[dict] = []
        originals = {k: getattr(stencil, k) for k in stencil.LAUNCHES
                     if callable(getattr(stencil, k, None))}

        def recording(name, fn):
            @functools.wraps(fn)
            def call(ops, *args, **kwargs):
                block = next((a for a in args if isinstance(a, torch.Tensor) and a.ndim == dim + 1),
                             None)
                shapes.append({"kernel": name, "lanes": None if block is None else block.shape[0],
                               "m": getattr(ops, "m", None), "p": getattr(ops, "p", None)})
                return fn(ops, *args, **kwargs)

            return call

        for name, fn in originals.items():
            setattr(stencil, name, recording(name, fn))
        try:
            yield shapes
        finally:
            for name, fn in originals.items():
                setattr(stencil, name, fn)

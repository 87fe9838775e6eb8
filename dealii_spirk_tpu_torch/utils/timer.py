"""Named-phase timers.

Port of ``dealii_spirk_tpu/utils/timer.py`` (the reference's phase
counters ``time_total``, ``time_rhs``, ..., ``main.cc:754-760``; cleared
after the first timestep so preconditioner setup is excluded,
``main.cc:971-973``).  On a CUDA device a phase is a pair of CUDA events
on the current stream, read (with a synchronise) only when the durations
are asked for; on the CPU it is the host clock.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class PhaseTimers:
    PHASES = (
        "total",
        "rhs",
        "outer_solver",
        "solution_update",
        "system_vmult",
        "preconditioner_bc",
        "preconditioner_solver",
    )

    def __init__(self, device="cpu") -> None:
        self.cuda = torch.device(device).type == "cuda"
        self._spans: dict[str, list] = {p: [] for p in self.PHASES}

    @contextmanager
    def phase(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._spans[name].append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._spans[name].append(time.perf_counter() - t0)

    def durations(self, name: str) -> list[float]:
        """Seconds of every recorded span of ``name``, in order."""
        if not self.cuda:
            return list(self._spans[name])
        out = []
        for start, end in self._spans[name]:
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        return out

    @property
    def seconds(self) -> dict[str, float | None]:
        """Summed seconds per phase; None for a phase with no span."""
        return {p: sum(self.durations(p)) if self._spans[p] else None for p in self.PHASES}

    def clear(self) -> None:
        for spans in self._spans.values():
            spans.clear()

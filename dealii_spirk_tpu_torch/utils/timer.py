"""Named-phase timers.

Port of ``dealii_spirk_tpu/utils/timer.py`` (the reference's phase
counters ``time_total``, ``time_rhs``, ..., ``main.cc:754-760``; cleared
after the first timestep so preconditioner setup is excluded,
``main.cc:971-973``).  On a CUDA device a phase is a pair of CUDA events
on the current stream, read (with a synchronise) only when the durations
are asked for; on the CPU, and for the ``HOST`` phases everywhere, it is
the host clock.

The phases below the step's four (``INNER``) are timed in place, around
each call, as the reference does in its loops (``main.cc:998-1173``),
when the timers are made with ``inner=True``; otherwise their spans are
not recorded and read None.  They nest as

    total > rhs, outer_solver, solution_update
    outer_solver > system_vmult, preconditioner_bc, preconditioner_solver,
                   krylov_vectors, krylov_host
    preconditioner_solver > mg_smooth, mg_transfer
    errors (the step's L2/Linf error, after the step)

``krylov_vectors`` is GMRES's own device vector work (Gram–Schmidt,
normalisation, the Hessenberg column and its host read, the cycle's
update, the restart residual), ``krylov_host`` its numpy arithmetic
between a host read and the next launch (the device is idle then),
``mg_smooth`` / ``mg_transfer`` each V-cycle level's smoothing and its
residual and grid transfers (``ost``, which has no preconditioner phase,
nests them in ``outer_solver``).  Recording an event does not wait for the
device, so a span adds no host synchronisation to a step.

While a ``torch.profiler`` session records, every phase, recorded or not,
also opens a ``record_function`` range named ``spirk.<phase>`` (NVTX under
``torch.autograd.profiler.emit_nvtx``), so the program's phases lie on the
trace's clock beside the device's operations.  With no profiler and the
inner phases off, entering an inner phase costs a flag read.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import torch
from torch.autograd import profiler as _profiler

RANGE_PREFIX = "spirk."
OFF = nullcontext()


def no_phase(name: str):
    """The phase callable of an untimed solve: enters nothing."""
    return OFF


class PhaseTimers:
    PHASES = (
        "total",
        "rhs",
        "outer_solver",
        "solution_update",
        "system_vmult",
        "preconditioner_bc",
        "preconditioner_solver",
        "krylov_vectors",
        "krylov_host",
        "mg_smooth",
        "mg_transfer",
        "errors",
    )
    INNER = frozenset(PHASES[4:])
    HOST = frozenset(("krylov_host",))

    def __init__(self, device="cpu", inner: bool = False) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.inner = inner
        self._spans: dict[str, list] = {p: [] for p in self.PHASES}

    def phase(self, name: str):
        """A context manager that times the block as phase ``name``."""
        profiling = _profiler._is_profiler_enabled
        if not self.inner and name in self.INNER:
            return _profiler.record_function(RANGE_PREFIX + name) if profiling else OFF
        return self._span(name, profiling)

    @contextmanager
    def _span(self, name: str, profiling: bool):
        with _profiler.record_function(RANGE_PREFIX + name) if profiling else OFF:
            if self.cuda and name not in self.HOST:
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
        if not self.cuda or name in self.HOST:
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

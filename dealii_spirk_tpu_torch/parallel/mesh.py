"""Mesh construction: the (stage, space) processor grid on device slots.

Port of ``dealii_spirk_tpu/parallel/mesh.py`` (the reference's
``create_rectangular_comm`` / ``create_row_comm`` / ``create_column_comm``,
``main.cc:277-446``, wired in ``main()`` at ``main.cc:3645-3698``): given D
slots and a stage-axis extent s (q for spirk, ceil(q/2) for complex_spirk,
1 otherwise — reference ``main.cc:3660-3666``), build a grid of shape
(s, D // s).  Slots that would not fit a full rectangle are dropped,
mirroring the reference's rectangular-communicator trimming
(``main.cc:365-405``).

Like the JAX package, the port is single-controller: one process holds the
whole grid and launches every slot's work.  A *slot* is one entry of the
``devices`` list, a ``torch.device`` that may appear several times: on one
card every slot is that card (the slots share its current stream), in the
CPU tests every slot is ``cpu``, and on a machine with several cards the
slots name them and the exchanges of ``ShardedBlock`` become peer copies.
Where the JAX package reads ``jax.devices()``, the caller here gives the
list (``[device] * n_slots``).

``do_row_major`` controls which axis varies fastest in slot order — the
analog of the reference's virtual-topology placement (``lex_to_pair``,
``main.cc:281-293``): row-major puts consecutive slots along the stage
axis, so each stage group occupies consecutive entries of the list.

``padding`` is the reference's node-boundary padding (``main.cc:3681-3685``):
slots are grouped into "nodes" of ``padding`` entries and only the first
``(padding // s) * s`` of each node are used, so a stage group never
straddles a node boundary.  ``-1`` = no padding (node size = s, keeps
everything), ``0`` = one node holding every slot of the list (this process
is one host), ``> 0`` = explicit node size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def stage_space_shape(n_devices: int, stage_size: int, max_ranks: int = 0) -> tuple[int, int]:
    if max_ranks:
        n_devices = min(n_devices, max_ranks)  # reference main.cc:3647-3658
    if n_devices < stage_size:
        raise ValueError(
            f"{n_devices} devices cannot host a stage axis of {stage_size} "
            f"(reference asserts the same, main.cc:3668-3669)"
        )
    return stage_size, n_devices // stage_size


def pad_devices(devices, stage_size: int, padding: int):
    """Apply the reference's rank-padding selection
    (``create_rectangular_comm``, main.cc:365-405): within each node of
    ``padding`` entries keep the first ``(padding // s) * s``."""
    s = stage_size
    if padding == -1:
        pad = s
    elif padding == 0:
        pad = len(devices)
    else:
        pad = padding
    if pad < s:
        # reference asserts the same (main.cc:3674-3679)
        raise ValueError(
            f"Padding ({pad}) has to be at least as large as the number of stages ({s})"
        )
    keep_per_node = (pad // s) * s
    return [d for i, d in enumerate(devices) if (i % pad) < keep_per_node]


@dataclass(frozen=True)
class SlotMesh:
    """A (stage, space) grid of slots: ``slot_ids[i, j]`` is the index in
    the caller's ``devices`` list of the slot at stage row i, space column
    j, ``devices[i][j]`` its ``torch.device``."""

    slot_ids: np.ndarray  # (n_stage, n_space) int
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"stage": self.slot_ids.shape[0], "space": self.slot_ids.shape[1]}

    @property
    def n_stage(self) -> int:
        return self.slot_ids.shape[0]

    @property
    def n_space(self) -> int:
        return self.slot_ids.shape[1]

    def device(self, i: int, j: int) -> torch.device:
        return self.devices[i][j]

    def first_space_column(self) -> "SlotMesh":
        """The (stage, 1) mesh of each stage row's first slot."""
        return SlotMesh(self.slot_ids[:, :1], tuple(row[:1] for row in self.devices))


def make_mesh(
    stage_size: int,
    *,
    devices,
    max_ranks: int = 0,
    do_row_major: bool = True,
    padding: int = -1,
) -> SlotMesh:
    devices = [torch.device(d) for d in devices]
    slots = list(range(len(devices)))
    if max_ranks:
        slots = slots[:max_ranks]  # reference trim_comm main.cc:343-361
    slots = pad_devices(slots, stage_size, padding)
    s, c = stage_space_shape(len(slots), stage_size)
    used = np.asarray(slots[: s * c], dtype=np.int64)
    if do_row_major:
        grid = used.reshape(c, s).T  # consecutive slots along stage
    else:
        grid = used.reshape(s, c)
    return SlotMesh(
        slot_ids=grid.copy(),
        devices=tuple(tuple(devices[k] for k in row) for row in grid),
    )

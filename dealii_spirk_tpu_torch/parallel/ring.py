"""Stage mixing over the slot mesh.

Port of ``dealii_spirk_tpu/parallel/ring.py`` (the reference's
``matrix_vector_rol_operation``, ``main.cc:1443-1534``): the dense q x q
stage coupling ``out_i = sum_j mat[i, j] W_j`` on a stage-sharded block,
by the reference's two strategies:

* ``UseSharedMemory = false`` -> ``ring_stage_mix``: q - 1 neighbour copies
  around the stage axis with rotate-and-accumulate (the reference's
  ``MPI_Sendrecv_replace`` ring); needs one stage per stage row;
* ``UseSharedMemory = true`` (or several stages per row) ->
  ``allgather_stage_mix``: every stage row takes the other rows' blocks of
  its space column and contracts locally (reading peer stage data from a
  shared-memory window, reference ``main.cc:1506-1533``).

Both are copies and axpys in torch — the JAX package computes them outside
any Pallas kernel — and both stay inside a space column: a slot only
exchanges with the slots that hold the same z slab.  ``mat`` lives on the
host (a CPU tensor of the run's dtype); its entries enter as Python
numbers, so no slot waits for another device.
"""

from __future__ import annotations

import torch

from .sharding import ShardedBlock, send


def ring_stage_mix(mat: torch.Tensor, W: ShardedBlock) -> ShardedBlock:
    """out_i = sum_j mat[i, j] W_j by ring rotation; the stage axis extent
    must equal q (one stage per row, like the reference's rank groups)."""
    mesh, q = W.mesh, W.q
    if mesh.n_stage != q or mat.shape != (q, q):
        raise ValueError(f"ring mixing needs stage axis == q ({mesh.n_stage} != {q})")
    coef = mat.tolist()
    parts = [[None] * mesh.n_space for _ in range(q)]
    for j in range(mesh.n_space):
        cur = [W.parts[i][j] for i in range(q)]
        acc = [torch.zeros_like(t) for t in cur]
        for step in range(q):
            # row i holds the block of row (i - step) mod q
            acc = [acc[i] + coef[i][(i - step) % q] * cur[i] for i in range(q)]
            if step < q - 1:
                cur = [send(cur[(i - 1) % q], mesh.device(i, j), "mix") for i in range(q)]
        for i in range(q):
            parts[i][j] = acc[i]
    return ShardedBlock(mesh, parts, W.one_lane)


def allgather_stage_mix(mat: torch.Tensor, W: ShardedBlock) -> ShardedBlock:
    """out_i = sum_j mat[i, j] W_j with every stage row reading the other
    rows' blocks; any number of stages per row."""
    mesh, q, ql = W.mesh, W.q, W.q_loc
    if mat.shape != (q, q):
        raise ValueError(f"the mix of a {q}-stage block takes a ({q}, {q}) matrix")
    coef = mat.tolist()
    parts = [[None] * mesh.n_space for _ in range(mesh.n_stage)]
    for j in range(mesh.n_space):
        for i in range(mesh.n_stage):
            dev = mesh.device(i, j)
            blocks = [
                W.parts[k][j] if k == i else send(W.parts[k][j], dev, "mix")
                for k in range(mesh.n_stage)
            ]
            stages = [b[s] for b in blocks for s in range(ql)]
            out = []
            for row in coef[i * ql : (i + 1) * ql]:
                acc = row[0] * stages[0]
                for c, t in zip(row[1:], stages[1:]):
                    acc = acc + c * t
                out.append(acc)
            parts[i][j] = torch.stack(out)
    return ShardedBlock(mesh, parts, W.one_lane)

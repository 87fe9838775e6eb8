"""The (stage, space) slot mesh: construction, sharded stage blocks and
the stage-mixing strategies (port of ``dealii_spirk_tpu/parallel``)."""

from .mesh import SlotMesh, make_mesh, pad_devices, stage_space_shape
from .ring import allgather_stage_mix, ring_stage_mix
from .sharding import ShardedBlock, canon_shardable, gather, scatter, z_partition

__all__ = [
    "SlotMesh",
    "make_mesh",
    "pad_devices",
    "stage_space_shape",
    "ring_stage_mix",
    "allgather_stage_mix",
    "ShardedBlock",
    "canon_shardable",
    "z_partition",
    "scatter",
    "gather",
]

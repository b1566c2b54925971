"""ray_tpu_torch.parallel — meshes and logical sharding on
``torch.distributed`` (port of ``ray_tpu/parallel``).

A named ``DeviceMesh`` over the process group's ranks, logical-axis
sharding rules, and helpers that place trees of tensors onto the mesh as
DTensors. DTensor inserts the collectives (NCCL on the GPU, gloo on the
CPU).
"""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    best_effort_mesh,
    get_abstract_mesh,
    make_mesh,
    mesh_shape_for,
    stage_device_slices,
)
from ray_tpu_torch.parallel.sharding import (
    LOGICAL_AXES,
    ShardingRules,
    logical_sharding,
    logical_spec,
    shard_pytree,
    with_logical_constraint,
)

__all__ = [
    "MeshConfig",
    "ShardingRules",
    "LOGICAL_AXES",
    "best_effort_mesh",
    "get_abstract_mesh",
    "logical_sharding",
    "logical_spec",
    "make_mesh",
    "mesh_shape_for",
    "stage_device_slices",
    "shard_pytree",
    "with_logical_constraint",
]

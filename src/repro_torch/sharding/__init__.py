from repro_torch.sharding.rules import (
    MeshContext,
    current_mesh_context,
    maybe_shard,
    partition_params,
    set_mesh_context,
)

__all__ = [
    "MeshContext",
    "current_mesh_context",
    "maybe_shard",
    "partition_params",
    "set_mesh_context",
]

"""The parallel layer (port of ``parallel/``): meshes, sharding rules, the
explicit collectives of the sharded forward, multi-process start-up, and
rank launching."""
from .mesh import best_mesh_shape, make_mesh
from .sharding import ShardingRules, logical_to_spec, shard_pytree

__all__ = ["make_mesh", "best_mesh_shape", "ShardingRules", "logical_to_spec", "shard_pytree"]

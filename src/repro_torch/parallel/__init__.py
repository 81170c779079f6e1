from .sharding import Mesh, P, ShardingRules, to_placements

__all__ = ["Mesh", "P", "ShardingRules", "to_placements"]

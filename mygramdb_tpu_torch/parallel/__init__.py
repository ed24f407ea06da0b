from .mesh import (make_mesh, shard_index_arrays, sharded_query_step,
                   sharded_update_step, ShardedQueryEngine)

__all__ = ["make_mesh", "shard_index_arrays", "sharded_query_step",
           "sharded_update_step", "ShardedQueryEngine"]

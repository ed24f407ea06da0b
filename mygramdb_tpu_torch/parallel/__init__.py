from .._overlay import extend_path

__path__ = extend_path(__path__, __name__)

from .mesh import (make_mesh, shard_index_arrays, sharded_query_step,  # noqa: E402
                   sharded_update_step, ShardedQueryEngine)

__all__ = ["make_mesh", "shard_index_arrays", "sharded_query_step",
           "sharded_update_step", "ShardedQueryEngine"]

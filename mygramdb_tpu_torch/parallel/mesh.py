"""Placeholder for ``mygramdb_tpu.parallel.mesh`` (multi-device sharded
programs): ROADMAP Queue 1, item 13. Every name raises
NotImplementedError."""

from .._not_ported import not_ported, placeholder_getattr

make_mesh = not_ported(__name__, "make_mesh", "13")
shard_index_arrays = not_ported(__name__, "shard_index_arrays", "13")
sharded_query_step = not_ported(__name__, "sharded_query_step", "13")
sharded_update_step = not_ported(__name__, "sharded_update_step", "13")
ShardedQueryEngine = not_ported(__name__, "ShardedQueryEngine", "13")
__getattr__ = placeholder_getattr(__name__, "13")

"""MySQL/MariaDB GTID binlog replication (host control plane).

The reference's largest subsystem (src/mysql/, ~11.3k LoC C++; SURVEY.md
§2.6). This package implements the same capability natively in the TPU
framework's host layer: raw wire-protocol client (no libmysqlclient),
binlog event parsing, GTID tracking, and a reader pipeline that applies
row events to the TableContext write path (which lands them in the host
delta segment and, on compaction, in HBM).
"""

from .gtid import Gtid, GtidSet, MariadbGtid, parse_gtid_set

__all__ = ["Gtid", "GtidSet", "MariadbGtid", "parse_gtid_set"]

"""Configuration schema (reference config/config.h:466 + config-schema.json).

Typed dataclasses for every section the reference supports, plus a
TPU-specific ``device`` section controlling the HBM index layout (dense-term
bitmap threshold, block sizes, micro-batching) — the TPU-native analog of the
reference's posting/roaring tuning knobs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.errors import ConfigError

FILTER_TYPES = {"int", "uint", "bigint", "float", "double", "string", "bool",
                "datetime", "date", "time", "timestamp", "tinyint", "smallint"}

FILTER_OPS = {"=", "!=", "<", ">", "<=", ">=", "IS NULL", "IS NOT NULL"}


@dataclass
class MysqlConfig:
    host: str = "127.0.0.1"
    port: int = 3306
    user: str = ""
    password: str = ""
    database: str = ""
    use_gtid: bool = True
    binlog_format: str = "ROW"
    binlog_row_image: str = "FULL"
    connect_timeout_ms: int = 3000
    session_timeout_sec: int = 3600
    datetime_timezone: str = "+00:00"
    ssl_enable: bool = False
    ssl_ca: str = ""
    ssl_cert: str = ""
    ssl_key: str = ""
    ssl_verify_server_cert: bool = True
    flavor: str = "auto"  # auto|mysql|mariadb


@dataclass
class TextSource:
    column: str = ""
    concat: List[str] = field(default_factory=list)
    delimiter: str = " "

    def columns(self) -> List[str]:
        return self.concat if self.concat else ([self.column] if self.column else [])


@dataclass
class RequiredFilterConfig:
    name: str = ""
    type: str = "int"
    op: str = "="
    value: Any = None
    bitmap_index: bool = False


@dataclass
class FilterConfig:
    name: str = ""
    type: str = "string"
    dict_compress: bool = False
    bitmap_index: bool = False
    bucket: str = ""  # "", "minute", "hour", "day" (datetime bucketing)


@dataclass
class PostingConfig:
    block_size: int = 128
    freq_bits: int = 0
    use_roaring: str = "auto"  # kept for config parity; maps to bitmap promotion


@dataclass
class SynonymConfig:
    enable: bool = False
    file: str = ""


@dataclass
class TableConfig:
    name: str = ""
    primary_key: str = "id"
    text_source: TextSource = field(default_factory=TextSource)
    required_filters: List[RequiredFilterConfig] = field(default_factory=list)
    filters: List[FilterConfig] = field(default_factory=list)
    ngram_size: int = 2
    kanji_ngram_size: int = 1
    # TPU-native extension (no reference analog): CJK positions ALSO
    # emit this gram size (0/1 = off). Default 2: a 2-char CJK term
    # becomes one exact covering gram (verify_text is a coverage no-op)
    # and longer CJK terms AND overlapping bigrams — the fused verify's
    # candidate sets shrink ~10x for ~+40% postings at ja-heavy corpora.
    # Index and queries must agree; dumps carry the emission signature
    # and restores adopt the dump's value.
    kanji_extra_ngram: int = 2
    cross_boundary_ngrams: bool = True
    posting: PostingConfig = field(default_factory=PostingConfig)
    synonyms: SynonymConfig = field(default_factory=SynonymConfig)
    database: str = ""  # optional db qualification (reference v1.7.0)

    def qualified_name(self) -> str:
        return f"{self.database}.{self.name}" if self.database else self.name


@dataclass
class BuildConfig:
    mode: str = "select_snapshot"
    batch_size: int = 5000
    parallelism: int = 2
    throttle_ms: int = 0


@dataclass
class ReplicationConfig:
    enable: bool = True
    auto_initial_snapshot: bool = False
    server_id: int = 83917
    start_from: str = "snapshot"  # snapshot|latest|gtid=<uuid:txn>
    queue_size: int = 10000
    reconnect_backoff_min_ms: int = 500
    reconnect_backoff_max_ms: int = 10000


@dataclass
class NormalizeConfig:
    nfkc: bool = True
    width: str = "narrow"  # keep|narrow|wide
    lower: bool = False


@dataclass
class MemoryConfig:
    hard_limit_mb: int = 8192
    soft_target_mb: int = 4096
    arena_chunk_mb: int = 64
    roaring_threshold: float = 0.18
    minute_epoch: bool = True
    normalize: NormalizeConfig = field(default_factory=NormalizeConfig)
    verify_text: str = "off"  # off|ascii|all


@dataclass
class DumpConfig:
    dir: str = "/var/lib/mygramdb/dumps"
    default_filename: str = "mygramdb.dmp"
    interval_sec: int = 0
    retain: int = 3


@dataclass
class TcpConfig:
    bind: str = "127.0.0.1"
    port: int = 11016
    max_connections: int = 10000


@dataclass
class UnixSocketConfig:
    path: str = ""


@dataclass
class HttpConfig:
    enable: bool = False
    bind: str = "127.0.0.1"
    port: int = 8080
    enable_cors: bool = False
    cors_allow_origin: str = ""
    max_body_bytes: int = 1 << 20


@dataclass
class RateLimitConfig:
    enable: bool = False
    capacity: int = 100
    refill_rate: int = 10
    max_clients: int = 10000


@dataclass
class ApiConfig:
    tcp: TcpConfig = field(default_factory=TcpConfig)
    unix_socket: UnixSocketConfig = field(default_factory=UnixSocketConfig)
    http: HttpConfig = field(default_factory=HttpConfig)
    default_limit: int = 100
    max_query_length: int = 128
    rate_limiting: RateLimitConfig = field(default_factory=RateLimitConfig)


@dataclass
class NetworkConfig:
    allow_cidrs: List[str] = field(default_factory=list)


@dataclass
class LoggingConfig:
    level: str = "info"
    format: str = "json"
    file: str = ""


@dataclass
class InvalidationConfig:
    batch_size: int = 1000
    max_delay_ms: int = 100


@dataclass
class CacheConfig:
    enabled: bool = True
    max_memory_mb: int = 32
    min_query_cost_ms: float = 10.0
    ttl_seconds: int = 3600
    invalidation_strategy: str = "ngram"  # ngram|table
    compression_enabled: bool = True
    eviction_batch_size: int = 10
    invalidation: InvalidationConfig = field(default_factory=InvalidationConfig)


@dataclass
class Bm25Config:
    k1: float = 1.2
    b: float = 0.75


@dataclass
class DeviceConfig:
    """TPU data-plane layout knobs (no reference analog; TPU-native design).

    dense_df_ratio: terms with df/N >= ratio get a dedicated HBM bitmap row
      (analog of the reference's roaring promotion at memory.roaring_threshold,
      but tuned for bitmap-AND kernels rather than compressed set ops).
    doc_block: documents are padded to a multiple of this (bitmap word
      alignment; 1024 docs = 32 u32 words = one VPU-friendly chunk).
    candidate_buckets: padded candidate-set sizes for the sparse probe kernel
      (queries are bucketed to one of these to keep shapes static under jit).
    max_query_terms: static upper bound of n-gram terms per query kernel.
    microbatch_size / microbatch_window_us: server-side query micro-batching.
    """
    enable: bool = True
    platform: str = "auto"  # auto|tpu|cpu
    mesh_shards: int = 1    # >1: shard the doc axis over this many chips
    # build (and dump/restore) the positional occurrence index at bulk
    # load/SYNC (index/positional.py). r5: it no longer routes SERVING
    # queries — the anchored-probe engine lost its 1.1M A/B against the
    # text-window verify 5x (749 vs 3,589 QPS) with 83% no_bucket
    # coverage, so the pipeline always uses the fused text path; the
    # built index remains addressable via search_verified_positional for
    # benches/experiments and survives the dump lifecycle
    positional_verify: bool = False
    dense_df_ratio: float = 0.01
    max_dense_terms: int = 8192
    doc_block: int = 1024
    candidate_buckets: List[int] = field(
        default_factory=lambda: [2048, 8192, 32768, 65536])
    max_query_terms: int = 16
    microbatch_size: int = 64
    microbatch_window_us: int = 200


@dataclass
class Config:
    mysql: MysqlConfig = field(default_factory=MysqlConfig)
    tables: List[TableConfig] = field(default_factory=list)
    build: BuildConfig = field(default_factory=BuildConfig)
    replication: ReplicationConfig = field(default_factory=ReplicationConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    dump: DumpConfig = field(default_factory=DumpConfig)
    api: ApiConfig = field(default_factory=ApiConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    bm25: Bm25Config = field(default_factory=Bm25Config)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    def table(self, name: str) -> Optional[TableConfig]:
        # exact match first (incl. database-qualified), reference CHANGELOG:26
        for t in self.tables:
            if t.qualified_name() == name or t.name == name:
                return t
        return None

    def validate(self) -> None:
        if not self.tables:
            raise ConfigError("at least one table must be configured")
        seen = set()
        for t in self.tables:
            if not t.name:
                raise ConfigError("table name must not be empty")
            if t.qualified_name() in seen:
                raise ConfigError(f"duplicate table: {t.qualified_name()}")
            seen.add(t.qualified_name())
            if not t.text_source.columns():
                raise ConfigError(
                    f"table {t.name}: text_source requires column or concat")
            if t.text_source.column and t.text_source.concat:
                raise ConfigError(
                    f"table {t.name}: text_source column and concat are exclusive")
            if t.ngram_size < 0 or t.ngram_size > 8:
                raise ConfigError(f"table {t.name}: ngram_size out of range")
            if t.kanji_ngram_size < 0 or t.kanji_ngram_size > 8:
                raise ConfigError(f"table {t.name}: kanji_ngram_size out of range")
            if t.kanji_extra_ngram < 0 or t.kanji_extra_ngram > 8:
                raise ConfigError(
                    f"table {t.name}: kanji_extra_ngram out of range")
            for f in t.filters:
                if f.type not in FILTER_TYPES:
                    raise ConfigError(
                        f"table {t.name}: unknown filter type '{f.type}'")
                if f.bucket not in ("", "minute", "hour", "day"):
                    raise ConfigError(
                        f"table {t.name}: invalid bucket '{f.bucket}'")
            for rf in t.required_filters:
                if rf.op not in FILTER_OPS:
                    raise ConfigError(
                        f"table {t.name}: invalid required_filter op '{rf.op}'")
                if rf.type not in FILTER_TYPES:
                    raise ConfigError(
                        f"table {t.name}: unknown required_filter type '{rf.type}'")
        if self.memory.normalize.width not in ("keep", "narrow", "wide"):
            raise ConfigError("memory.normalize.width must be keep|narrow|wide")
        if self.memory.verify_text not in ("off", "ascii", "all"):
            raise ConfigError("memory.verify_text must be off|ascii|all")
        if self.replication.start_from not in ("snapshot", "latest") and \
                not self.replication.start_from.startswith("gtid="):
            raise ConfigError(
                "replication.start_from must be snapshot|latest|gtid=<gtid>")
        if not (5 <= self.api.default_limit <= 1000):
            raise ConfigError("api.default_limit must be in range 5-1000")
        if self.cache.invalidation_strategy not in ("ngram", "table"):
            raise ConfigError("cache.invalidation_strategy must be ngram|table")
        if self.logging.level not in ("debug", "info", "warn", "error"):
            raise ConfigError("logging.level must be debug|info|warn|error")
        if self.logging.format not in ("json", "text"):
            raise ConfigError("logging.format must be json|text")
        if self.device.doc_block % 1024 != 0:
            raise ConfigError("device.doc_block must be a multiple of 1024")

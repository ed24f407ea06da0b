from .schema import (
    Config, MysqlConfig, TableConfig, TextSource, FilterConfig,
    RequiredFilterConfig, PostingConfig, BuildConfig, ReplicationConfig,
    MemoryConfig, NormalizeConfig, DumpConfig, ApiConfig, TcpConfig,
    HttpConfig, UnixSocketConfig, RateLimitConfig, NetworkConfig,
    LoggingConfig, CacheConfig, InvalidationConfig, Bm25Config,
    SynonymConfig, DeviceConfig,
)
from .loader import load_config, load_config_from_dict, config_to_dict
from .runtime_vars import RuntimeVariableManager

__all__ = [
    "Config", "MysqlConfig", "TableConfig", "TextSource", "FilterConfig",
    "RequiredFilterConfig", "PostingConfig", "BuildConfig",
    "ReplicationConfig", "MemoryConfig", "NormalizeConfig", "DumpConfig",
    "ApiConfig", "TcpConfig", "HttpConfig", "UnixSocketConfig",
    "RateLimitConfig", "NetworkConfig", "LoggingConfig", "CacheConfig",
    "InvalidationConfig", "Bm25Config", "SynonymConfig", "DeviceConfig",
    "load_config", "load_config_from_dict", "config_to_dict",
    "RuntimeVariableManager",
]

from .query_cache import QueryCache, CacheStats
from .cache_manager import CacheManager
from .invalidation import InvalidationManager, InvalidationQueue

__all__ = ["QueryCache", "CacheStats", "CacheManager",
           "InvalidationManager", "InvalidationQueue"]

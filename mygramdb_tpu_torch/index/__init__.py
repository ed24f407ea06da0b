from .term_dict import TermDict
from .builder import IndexBuilder, BuiltIndex
from .device_index import DeviceIndex, SearchOptions
from .delta import DeltaSegment, MutableIndex

__all__ = ["TermDict", "IndexBuilder", "BuiltIndex", "DeviceIndex",
           "DeltaSegment", "MutableIndex", "SearchOptions"]

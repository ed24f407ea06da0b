from .._overlay import extend_path

__path__ = extend_path(__path__, __name__)

from .term_dict import TermDict  # noqa: E402
from .builder import IndexBuilder, BuiltIndex  # noqa: E402
from .device_index import DeviceIndex, SearchOptions  # noqa: E402
from .delta import DeltaSegment, MutableIndex  # noqa: E402

__all__ = ["TermDict", "IndexBuilder", "BuiltIndex", "DeviceIndex",
           "DeltaSegment", "MutableIndex", "SearchOptions"]

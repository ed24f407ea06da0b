from .._overlay import extend_path

__path__ = extend_path(__path__, __name__)

from .document_store import DocumentStore, Document, FilterValue, TimeValue  # noqa: E402
from .filter_index import FilterIndex  # noqa: E402

__all__ = ["DocumentStore", "Document", "FilterValue", "TimeValue",
           "FilterIndex"]

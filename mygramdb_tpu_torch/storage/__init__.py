from .document_store import DocumentStore, Document, FilterValue, TimeValue
from .filter_index import FilterIndex

__all__ = ["DocumentStore", "Document", "FilterValue", "TimeValue",
           "FilterIndex"]

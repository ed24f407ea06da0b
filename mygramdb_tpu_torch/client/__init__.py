from .client import MygramClient, SearchResult, MygramClientError
from .expression import SearchExpression

__all__ = ["MygramClient", "SearchResult", "MygramClientError",
           "SearchExpression"]

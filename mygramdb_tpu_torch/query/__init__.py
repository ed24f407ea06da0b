from .parser import (QueryParser, Query, QueryType, FilterCondition, FilterOp,
                     SortOrder, OrderByClause, HighlightOptions)
from .ast import QueryASTParser, QueryNode, NodeType, contains_boolean_syntax
from .normalizer import QueryNormalizer
from .sorter import ResultSorter
from .highlighter import Highlighter
from .synonyms import SynonymDictionary
from .bm25 import BM25Scorer, BM25Stats

__all__ = [
    "QueryParser", "Query", "QueryType", "FilterCondition", "FilterOp",
    "SortOrder", "OrderByClause", "HighlightOptions", "QueryASTParser",
    "QueryNode", "NodeType", "contains_boolean_syntax", "QueryNormalizer",
    "ResultSorter", "Highlighter", "SynonymDictionary", "BM25Scorer",
    "BM25Stats",
]

from .tracing import trace_span
from .tree import tree_leaves, tree_map

__all__ = ["trace_span", "tree_leaves", "tree_map"]

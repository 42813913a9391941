from .checkpoint import dumps_pytree, load_pytree, loads_pytree, save_pytree
from .ownership import ThreadOwned
from .tracing import enable_tracing, get_logger, trace_span
from .tree import tree_leaves, tree_map

__all__ = [
    "ThreadOwned",
    "dumps_pytree",
    "enable_tracing",
    "get_logger",
    "load_pytree",
    "loads_pytree",
    "save_pytree",
    "trace_span",
    "tree_leaves",
    "tree_map",
]

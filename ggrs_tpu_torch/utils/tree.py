"""Minimal pytree helpers over dicts, lists and tuples of tensors.

Leaf order is ``jax.tree_util``'s: dict keys SORTED, sequences in order.
``torch.utils._pytree`` keeps dict insertion order instead, under which
BoxGame's ``{"pos", "vel", "rot"}`` would flatten as pos, vel, rot rather
than pos, rot, vel and every digest would differ from the JAX package's."""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``),
    rebuilding the structure; dict keys come back in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)

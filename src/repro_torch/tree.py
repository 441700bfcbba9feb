"""Parameter trees of the port: nested dicts and lists of tensors.

The reference walks its pytrees with ``jax.tree``; the port's trees hold
the layer stack as a list of groups, so these two helpers walk dicts and
lists together and leave every other value (tensors, ``None``, bools) as
a leaf.  A leaf's path joins its keys and list indices with "/", as the
reference's ``_keystr`` does (``layers/0/blk0/attn/wq/w``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]

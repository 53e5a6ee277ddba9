"""Nested containers of tensors (dicts, lists, tuples), walked in a fixed
order: dict insertion order, then list order."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def is_leaf(t) -> bool:
    return not isinstance(t, (dict, list, tuple))


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the matching leaves of the
    trees in ``rest`` (which may hold anything where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs; a path reads like ``layers/0/mlp/wg/w``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_structure(tree) -> str:
    """A string naming the containers and the leaf paths, for a
    checkpoint's manifest."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{tree_structure(v)}"
                              for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(tree_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def tree_unflatten_like(like, leaves: list):
    """A tree shaped like ``like`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out

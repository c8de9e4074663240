"""Nested dicts of tensors (the port's parameter and optimizer trees).

The reference keeps params as JAX pytrees of dicts; ``jax.tree.leaves``
walks dict keys in sorted order.  These helpers walk the port's trees in
the same order, so leaves line up one for one with the reference's and a
leaf's path ("blocks/attn/wq") is the key the reference's checkpoints use.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order; paths join keys with "/"."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(like: Any, flat: list) -> Any:
    """A tree of ``like``'s structure whose leaves are ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)

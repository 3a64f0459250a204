"""Nested dicts, lists and tuples of tensors, the port's pytrees, walked
in the order ``jax.tree`` walks the JAX package's: dict keys sorted,
list and tuple items in order. Sums over the leaves (``optim.clip``)
then round as the JAX package's do, and a leaf's path names it as
``jax.tree_util`` names it (``("conv", 0, "w")``)."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf: a path is the tuple of dict keys
    and list indices from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *leaves of rest)`` over trees of one structure,
    the result in that structure (dicts with their keys sorted, as
    ``jax.tree.map`` builds them), ``fn`` called in :func:`leaves`
    order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], *(r[k] for r in rest),
                                 path=path + (k,))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)

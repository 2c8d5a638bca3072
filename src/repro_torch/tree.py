"""Nested dicts and lists of tensors, walked in the reference's leaf order.

JAX flattens a pytree with each dict's keys sorted and lists in order; the
optimizer's sums and the checkpoint's keys follow that order, so a
checkpoint or a gradient norm means the same in both packages.
"""

from __future__ import annotations

from typing import Any, Iterator


def walk(tree, *others) -> Iterator[tuple]:
    """(path, leaf, the others' subtrees at that path) for each leaf of
    `tree`, dict keys sorted; `others` share `tree`'s structure down to its
    leaves (where they may hold a subtree, as an int8 moment's {'q', 's'})."""
    yield from _walk((), tree, others)


def _walk(path, tree, others):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(path + (k,), tree[k], tuple(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(path + (i,), t, tuple(o[i] for o in others))
    else:
        yield (path, tree) + others


def leaves(tree) -> list:
    return [leaf for _, leaf in walk(tree)]


def key(path: tuple) -> str:
    """The reference checkpoint's key of a path: its parts joined by '/'."""
    return "/".join(str(p) for p in path)


def unflatten(tree, new_leaves) -> Any:
    """`tree`'s nesting with its leaves replaced, in `walk`'s order, by
    `new_leaves` (dicts come back with their keys sorted)."""
    it = iter(new_leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return next(it)

    return fill(tree)


def map_leaves(fn, tree) -> Any:
    """`tree` with each leaf replaced by fn(leaf), the nesting kept."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)

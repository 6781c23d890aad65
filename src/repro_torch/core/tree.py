"""Nested dicts and lists of tensors (the port's parameter and train-state
trees), walked in the JAX package's leaf order: a dict's keys sorted, a
list's items in order.  Checkpoint paths, manifests and the optimizer's
sums follow that order, so both packages write and read the same bytes.
"""
from __future__ import annotations

from typing import Callable, Iterator


def leaves_with_path(tree, path: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(path, leaf) of every leaf in order; a path holds dict keys and list
    indices."""
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


def unflatten(like, flat) -> object:
    """A tree of ``like``'s structure whose leaves are ``flat``, in the
    order ``leaves(like)`` gives."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> object:
    """``fn`` over corresponding leaves of trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if len({len(f) for f in flat}) > 1:
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def path_str(path: tuple) -> str:
    """A path as the JAX package's checkpoints spell it: "params/tail/0/ln1"."""
    return "/".join(str(p) for p in path)

"""Nested containers of tensors: the port's parameter, gradient and
optimizer-state trees.

A tree is a dict, list or tuple of trees, or a leaf (anything else).
Leaves are walked in container order: dict insertion order and list
index order.  (``jax.tree`` walks dict keys sorted and keeps per-layer
leaves stacked, so the two packages order their leaves differently;
``weights.params_to_jax`` maps the port's layout back.)
"""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped trees, in a tree of the
    first one's shape."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves_with_paths(tree, prefix: str = ""):
    """``[(path, leaf)]`` in walk order; a path joins dict keys and list
    indices with ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def leaves(tree) -> list:
    """The leaves in walk order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves):
    """A tree of ``template``'s shape holding ``new_leaves`` in walk
    order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out

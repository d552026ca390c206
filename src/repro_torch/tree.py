"""Nested dicts of tensors, walked in sorted-key order: the order JAX
flattens dicts in, so leaf i here is leaf i of the reference's pytree."""
from __future__ import annotations


def leaves_with_path(tree, is_leaf=None, prefix=()):
    """(path, leaf) pairs; a dict for which ``is_leaf`` is true is a leaf."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], is_leaf, prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree, is_leaf=None):
    for _, leaf in leaves_with_path(tree, is_leaf):
        yield leaf


def unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves are taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def with_empty(like, tree):
    """``tree`` (nested dicts) with the empty dicts of ``like`` (a tree of
    the same keys that has them: a block without weights) put back, keyed
    in sorted order."""
    return {k: with_empty(like[k], tree.get(k, {}))
            if isinstance(like[k], dict) else tree[k] for k in sorted(like)}

"""Pytree leaves in ``jax.tree.flatten``'s order.

``torch.utils._pytree`` flattens a dict in insertion order, while JAX
sorts its keys.  Where the order of the leaves decides which random bits a
leaf draws (``fold_in(key, i)``, ``split(key, n)``), the port walks its
trees in JAX's order: named tuples by field, dicts by sorted key,
sequences by index; ``None`` holds no leaf.
"""

from __future__ import annotations


def _children(tree):
    """The (sub)trees of a node in JAX's order, or None for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [getattr(tree, f) for f in tree._fields]
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return None


def leaves(tree) -> list:
    """Every leaf of ``tree`` in ``jax.tree.flatten``'s order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def _build(tree, it):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_build(getattr(tree, f), it)
                            for f in tree._fields])
    if isinstance(tree, dict):
        new = {k: _build(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_build(v, it) for v in tree)
    return next(it)


def unflatten(template, new_leaves):
    """``template`` with its leaves replaced by ``new_leaves`` (given in
    ``leaves``' order); dicts keep the template's insertion order.  (A
    module-level walk: a self-recursive closure would hold ``new_leaves``
    in a reference cycle until the garbage collector ran.)"""
    return _build(template, iter(new_leaves))

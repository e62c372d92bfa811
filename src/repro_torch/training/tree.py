"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

Parameters, optimizer state and checkpoints are nested dicts whose leaves
are tensors (or numpy arrays and scalars).  Leaves are visited in JAX's
flatten order for dicts, sorted keys, so a leaf's index means the same in
both packages (checkpoints name leaves by index).
"""
from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` (in
    `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of the same
    structure, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree.flatten(tree)[1])`` prints it for a
    nested dict: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"

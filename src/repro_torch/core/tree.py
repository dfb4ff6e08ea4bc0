"""Minimal pytree helpers for nested dicts / tuples / lists of tensors.

Dicts flatten in SORTED key order, as JAX flattens them, so leaf order —
and with it the packed ``(N, W)`` row layout of ``core.packing`` — is the
same in both packages.  A node class joins in by defining
``__tree_children__()`` (its children in flatten order) and
``__tree_rebuild__(children)`` (``packing.Packed`` does).
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(tree)
    return tree.__tree_children__()


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), children))
    if isinstance(tree, (tuple, list)):
        return type(tree)(children)
    return tree.__tree_rebuild__(children)


def is_node(x) -> bool:
    return isinstance(x, (dict, tuple, list)) or hasattr(x, "__tree_children__")


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves in flatten order (None subtrees contribute nothing)."""
    if tree is None:
        return []
    if (is_leaf is not None and is_leaf(tree)) or not is_node(tree):
        return [tree]
    out = []
    for c in _children(tree):
        out.extend(tree_leaves(c, is_leaf))
    return out


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """[(key path, leaf)] in flatten order, the keys joined with ``/``: dict
    keys and sequence indices, as JAX's ``tree_flatten_with_path`` gives
    them (the checkpoint manifest's key paths)."""
    if tree is None:
        return []
    if not is_node(tree):
        return [(prefix, tree)]
    kids = _children(tree)
    keys = sorted(tree) if isinstance(tree, dict) else range(len(kids))
    out = []
    for k, c in zip(keys, kids):
        out.extend(tree_leaves_with_path(c, f"{prefix}/{k}" if prefix
                                         else str(k)))
    return out


def tree_map(fn, tree, *rest, is_leaf=None):
    """Apply ``fn`` leafwise over ``tree`` (and same-structured ``rest``)."""
    if tree is None:
        return None
    if (is_leaf is not None and is_leaf(tree)) or not is_node(tree):
        return fn(tree, *rest)
    kids = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, c, *(k[i] for k in kids), is_leaf=is_leaf)
        for i, c in enumerate(_children(tree))])


def tree_unflatten_like(tree, leaves, is_leaf=None):
    """Rebuild ``tree``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)


def tree_flatten_up_to(template, tree, is_leaf=None) -> list:
    """The subtrees of ``tree`` at ``template``'s leaf positions, in flatten
    order (``treedef.flatten_up_to``): e.g. the per-leaf ``{"m", "v"}``
    dicts of an optimizer state whose structure extends a parameter
    tree's."""
    if template is None:
        return []
    if (is_leaf is not None and is_leaf(template)) or not is_node(template):
        return [tree]
    out = []
    for t, c in zip(_children(template), _children(tree)):
        out.extend(tree_flatten_up_to(t, c, is_leaf))
    return out

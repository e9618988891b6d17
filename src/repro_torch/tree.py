"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, walked in
the order ``jax.tree_util`` walks them (dict keys sorted), so a sum over
the leaves adds in the reference's order and a leaf's path string is the
reference's ``jax.tree_util.keystr``: ``['blocks'][0]['attn']['wq']`` for
dicts and lists, ``.m`` for a NamedTuple field.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path piece, child) pairs of a node, or [] for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in the reference's order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for piece, child in _children(tree):
        out.extend(flatten_with_path(child, prefix + piece))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _rebuild(tree, children):
    if isinstance(tree, dict):           # keeps the tree's own key order
        by_key = dict(zip(sorted(tree), children))
        return {k: by_key[k] for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*children)
    return type(tree)(children)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``; each tree of ``rest`` is cut at
    ``tree``'s leaves, so a whole subtree of it (an optimizer's
    :class:`~repro_torch.optim.QTensor`) reaches ``fn`` at a leaf of
    ``tree``, as ``treedef.flatten_up_to`` gives it."""
    if not _is_node(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    if isinstance(tree, dict):
        rest_kids = [[r[k] for k in sorted(tree)] for r in rest]
    else:
        rest_kids = [list(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, child, *(rk[i] for rk in rest_kids))
        for i, (_, child) in enumerate(kids)])


def unflatten_like(tree, new_leaves: List[Any]):
    """``tree`` with its leaves replaced, in order, by ``new_leaves``."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

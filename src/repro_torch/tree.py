"""Trees of tensors: nested tuples, lists and dicts (``Params.tree()``,
an optimizer state, a checkpointed carry), flattened in the reference's
leaf order (dict keys sorted, as ``jax.tree_util`` orders them; ``None``
holds no leaf) and rebuilt with the same structure.  The optimizers, the
training step and the checkpoint share them."""
from __future__ import annotations

from typing import Callable


def flatten_with_paths(tree, prefix=()) -> list:
    """[(key, leaf)] in the reference's leaf order; ``key`` is the path's
    indices and dict keys joined by ``/`` (the reference checkpoint's
    format)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, sub in items:
        out += flatten_with_paths(sub, prefix + (k,))
    return out


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, flat):
    """``like``'s structure over the leaves of ``flat`` (in ``leaves``
    order)."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the matching leaves of ``tree`` and of each of
    ``rest`` (trees of the same structure)."""
    flat = [leaves(t) for t in (tree, *rest)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])

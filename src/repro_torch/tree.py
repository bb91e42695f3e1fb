"""Trees of tensors: flatten / unflatten / map in the JAX pytree order.

A tree is a tensor (a leaf) or a dict, list or tuple of trees.  Dict keys
are visited in sorted order, exactly as ``jax.tree.flatten`` visits the
reference's parameter dicts, so the port's gradient leaves come in the
same order with the same shapes: the bucket plan, the per-leaf offsets
and the per-leaf scales all depend on that order.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "unflatten", "tree_map", "leaves"]


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)`` of ``tree``."""
    out: list = []

    def walk(node):
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, len(node),
                    tuple(walk(c) for c in node))
        out.append(node)
        return None

    return out, walk(tree)


def unflatten(treedef: Any, leaves_: list) -> Any:
    """Inverse of :func:`flatten`."""
    it = iter(leaves_)

    def build(d):
        if d is None:
            return next(it)
        kind, meta, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(meta, built))
        return tuple(built) if kind == "tuple" else built

    tree = build(treedef)
    rest = list(it)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over after unflatten")
    return tree


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    ls, td = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(td, [fn(*xs) for xs in zip(ls, *others)])

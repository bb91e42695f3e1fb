"""The cell's weights, made on the device from the seed.

The tree is the model file's (``models/<model>.py``: ``leaf_specs(config)``
gives each leaf's path, shape, dtype and scale), with the port's keys and
shapes.  One ``torch.randn`` call per dtype fills a flat buffer, and every
leaf is a view of it scaled in place (a leaf of scale 0 starts at zero);
the program takes a copy and the plain reference reads the same tree.
The same seed gives the same tree on every card of a kind, so every rank
makes its own.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_params", "tree_leaves", "n_elements"]


def n_elements(specs: dict) -> int:
    """Elements of every leaf of ``specs``: the parameter count as the
    tree holds it."""
    return sum(math.prod(s) for s, _, _ in specs.values())


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_params(specs: dict, seed: int, device) -> dict:
    """The parameter tree of ``specs`` from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    tree: dict = {}
    by_dtype: dict = {}
    for path, (shape, dtype, scale) in specs.items():
        if scale == 0.0:
            _set(tree, path, torch.zeros(shape, dtype=dtype, device=device))
        else:
            by_dtype.setdefault(dtype, []).append((path, shape, scale))
    for dtype, leaves in by_dtype.items():
        total = sum(math.prod(s) for _, s, _ in leaves)
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        off = 0
        for path, shape, scale in leaves:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            leaf.mul_(scale)
            _set(tree, path, leaf)
            off += n
    return tree


def tree_leaves(tree: dict) -> list[tuple[tuple, torch.Tensor]]:
    """``(path, leaf)`` in sorted-key order (the port's leaf order)."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            out += [((key,) + p, t) for p, t in tree_leaves(v)]
        else:
            out.append(((key,), v))
    return out

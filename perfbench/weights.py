"""The cell's weights, made on the device from the seed.

One ``torch.randn`` call per dtype fills a flat buffer, and every leaf is
a view of it scaled in place: the embedding at 0.02, each projection
(an untied head's too) at ``1 / sqrt(fan-in)`` (the second-to-last dim),
the norms at 0 (a scale of 1, as ``rms_norm`` multiplies by ``1 +
scale``).  The tree has the port's keys and shapes (``{"embedding",
"final_norm", ["lm_head",] "stack": {"sub0": ...}}``,
every layer's leaf stacked on a leading dim); the program takes a copy
and the plain reference reads the same tree.  The same seed gives the
same tree on every card of a kind, so every rank makes its own.
"""

from __future__ import annotations

import math

import torch

__all__ = ["leaf_specs", "make_params", "tree_leaves", "n_elements"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(config: dict) -> dict:
    """``{path: (shape, dtype, scale)}`` of the parameter tree, paths as
    tuples of keys, ``scale`` 0 for a leaf that starts at zero."""
    L, D, V = config["num_layers"], config["d_model"], config["vocab_size"]
    H, K, hd = config["num_heads"], config["num_kv_heads"], \
        config["head_dim"]
    wd = _DTYPES[config["dtype"]]
    f32 = torch.float32
    fan = lambda shape: 1.0 / math.sqrt(shape[-2])  # noqa: E731
    specs = {
        ("embedding",): ((V, D), wd, 0.02),
        ("final_norm",): ((D,), f32, 0.0),
        ("stack", "sub0", "norm1"): ((L, D), f32, 0.0),
        ("stack", "sub0", "norm2"): ((L, D), f32, 0.0),
    }
    if not config["tie_embeddings"]:
        specs[("lm_head",)] = ((D, V), wd, fan((D, V)))
    for name, shape in (("w_q", (L, D, H * hd)), ("w_k", (L, D, K * hd)),
                        ("w_v", (L, D, K * hd)), ("w_o", (L, H * hd, D))):
        specs["stack", "sub0", "mixer", name] = (shape, wd, fan(shape))

    def glu(prefix, F):
        for name, shape in (("w_gate", (L, D, F)), ("w_up", (L, D, F)),
                            ("w_down", (L, F, D))):
            specs[prefix + (name,)] = (shape, wd, fan(shape))

    ffn = ("stack", "sub0", "ffn")
    if config["ffn"] == "dense":
        glu(ffn, config["d_ff"])
    else:
        m = config["moe"]
        E, Fe = m["num_experts"], m["d_expert"]
        specs[ffn + ("w_router",)] = ((L, D, E), f32, 1.0 / math.sqrt(D))
        for name, shape in (("we_gate", (L, E, D, Fe)),
                            ("we_up", (L, E, D, Fe)),
                            ("we_down", (L, E, Fe, D))):
            specs[ffn + (name,)] = (shape, wd, fan(shape))
        if m["num_shared_experts"]:
            glu(ffn + ("shared",), m["num_shared_experts"] * Fe)
    return dict(sorted(specs.items()))


def n_elements(config: dict) -> int:
    """Elements of every leaf: the parameter count as the tree holds it."""
    return sum(math.prod(s) for s, _, _ in leaf_specs(config).values())


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_params(config: dict, seed: int, device) -> dict:
    """The parameter tree of ``config`` from ``seed`` on ``device``."""
    device = torch.device(device)
    specs = leaf_specs(config)
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

"""Sharding policy: parameter specs by leaf path, and where activations go.

The port of ``repro/models/sharding.py``.  One mesh axis can mean
different things per layer (Megatron TP for attention / MLP, expert
parallelism for MoE, sequence sharding for long decode); the policy owns
those decisions.  Param specs are derived from the *leaf path names* of
the parameter tree; axes that do not divide a dimension are dropped.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names.  A one-axis tuple is written as the
name, the canonical form of the reference's ``PartitionSpec``, so a spec
here equals ``tuple()`` of the reference's.  The mesh is read only through
``axis_names`` and ``devices.shape`` (:class:`repro_torch.launch.mesh.Mesh`).

This module holds the spec logic only.  Nothing runs sharded yet: with a
mesh, :meth:`ShardingPolicy.act`, :meth:`~ShardingPolicy.constrain` and
:meth:`~ShardingPolicy.shard_params` raise ``NotImplementedError``; with
``mesh=None`` they are the identity.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["ShardingPolicy", "REPLICATED"]

REPLICATED: tuple = ()

_NOT_YET = ("executing a sharding policy on a mesh (FSDP x TP layout, "
            "expert parallelism) is a later slice of the port")


def _spec(*entries) -> tuple:
    """A spec with one-axis tuples written as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axis_size(mesh, axes) -> int:
    if mesh is None or axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return math.prod(sizes[a] for a in axes)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How to lay out params / activations on the mesh.

    mesh=None disables all constraints (single-device runs).
    """

    mesh: object | None = None
    dp_axes: tuple[str, ...] = ()       # batch axes ("pod","data")
    tp_axis: str | None = None          # tensor/expert-parallel axis
    fsdp_axes: tuple[str, ...] = ()     # parameter sharding axes (ZeRO-3)
    seq_parallel: bool = False          # shard activations' seq dim on tp
    # "train": FSDP x TP (batch over dp).  "serve2d": inference layout —
    # weights/experts/KV sharded over (model x data) jointly, batch
    # replicated.
    mode: str = "train"

    # ---- helpers ----------------------------------------------------------

    def _fit(self, shape: tuple[int, ...], spec: tuple) -> tuple:
        """Drop axes that don't divide their dim; trim to rank."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        return _spec(*(
            ax if ax is not None and dim % _axis_size(self.mesh, ax) == 0
            else None
            for dim, ax in zip(shape, entries)
        ))

    def constrain(self, x, spec: tuple):
        if self.mesh is None:
            return x
        raise NotImplementedError(_NOT_YET)

    @property
    def dp(self):
        return self.dp_axes if self.dp_axes else None

    @property
    def tp_size(self) -> int:
        return _axis_size(self.mesh, self.tp_axis)

    @property
    def dp_size(self) -> int:
        return _axis_size(self.mesh, self.dp_axes)

    # ---- parameter specs by leaf path -------------------------------------

    def spec_for(self, path: str, shape: tuple[int, ...]) -> tuple:
        """The spec of a parameter leaf, from its tree path.

        Leading stacked (layer) dims are auto-detected: rules match on the
        trailing dims; leading extra dims get None.
        """
        if self.mesh is None:
            return REPLICATED
        tp, fs = self.tp_axis, self.fsdp_axes or None
        name = path.split("/")[-1]

        def tail(spec_tail: tuple) -> tuple:
            lead = len(shape) - len(spec_tail)
            return self._fit(shape, (None,) * lead + tuple(spec_tail))

        def best(dim: int, *candidates):
            """First candidate axis-set that divides ``dim``."""
            for cand in candidates:
                if cand is None:
                    continue
                axes = cand if isinstance(cand, tuple) else (cand,)
                if dim % _axis_size(self.mesh, axes) == 0:
                    return cand
            return None

        if self.mode == "serve2d":
            joint = ((tp,) if tp else ()) + tuple(self.fsdp_axes or ())
            joint = joint if len(joint) > 1 else (tp or None)
            d_out = shape[-1]
            d_in = shape[-2] if len(shape) >= 2 else shape[-1]
            # experts: EP on E, F over the data axes
            if name in ("we_gate", "we_up"):
                return tail((tp, None, best(d_out, fs)))
            if name == "we_down":
                return tail((tp, best(d_in, fs), None))
            # attention stays TP-only (head math); MLP/mamba go 2D
            if name in ("w_q", "w_k", "w_v"):
                return tail((None, tp))
            if name in ("b_q", "b_k", "b_v"):
                return tail((tp,))
            if name == "w_o":
                return tail((tp, None))
            if name in ("w_gate", "w_up", "w_in", "w_dt"):
                return tail((None, best(d_out, joint, tp, fs)))
            if name in ("w_down", "w_out"):
                return tail((best(d_in, joint, tp, fs), None))
            if name == "embedding":
                return tail((tp, best(d_out, fs)))
            if name == "lm_head":
                return tail((best(d_in, fs), tp))
            if name in ("conv_w", "A_log", "x_proj"):
                lead_dim = shape[-2] if len(shape) > 1 else shape[-1]
                ax = best(lead_dim, joint, tp)
                return tail((ax, None)) if len(shape) > 1 else tail((ax,))
            if name in ("conv_b", "D", "dt_bias"):
                return tail((best(shape[-1], joint, tp),))
            if name == "w_router":
                return tail((None, None))
            return REPLICATED

        # experts stacked (E, D, F)/(E, F, D): EP on E, FSDP on the reduce dim
        if name in ("we_gate", "we_up"):
            return tail((tp, fs, None))
        if name == "we_down":
            return tail((tp, None, fs))
        # column-parallel (out-features on tp)
        if name in ("w_q", "w_k", "w_v", "w_gate", "w_up", "w_in", "w_dt"):
            return tail((fs, tp))
        if name in ("b_q", "b_k", "b_v"):
            return tail((tp,))
        # row-parallel (in-features on tp)
        if name in ("w_o", "w_down", "w_out"):
            return tail((tp, fs))
        # embeddings / lm head: vocab on tp (Megatron vocab-parallel)
        if name == "embedding":
            return tail((tp, fs))
        if name == "lm_head":
            return tail((fs, tp))
        # router: small, replicate out-features
        if name == "w_router":
            return tail((fs, None))
        # mamba internals: channel dim on tp
        if name in ("conv_w", "A_log", "x_proj"):
            return tail((tp, None)) if len(shape) > 1 else tail((tp,))
        if name in ("conv_b", "D", "dt_bias"):
            return tail((tp,))
        # rwkv time-mix / decay loras and norms: replicated (small)
        return REPLICATED

    def param_specs(self, params) -> dict:
        """Mirror tree of specs for a parameter tree (leaves need only a
        ``shape``: ``meta`` tensors will do)."""

        def walk(node, prefix):
            if isinstance(node, dict):
                return {
                    k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()
                }
            return self.spec_for(prefix, tuple(node.shape))

        return walk(params, "")

    def shard_params(self, params):
        if self.mesh is None:
            return params
        raise NotImplementedError(_NOT_YET)

    # ---- activation constraints -------------------------------------------

    def act(self, x, *, kind: str):
        """Constrain an activation tensor (hidden, logits, heads, kv,
        cache, tokens)."""
        if self.mesh is None:
            return x
        raise NotImplementedError(_NOT_YET)

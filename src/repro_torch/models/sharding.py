"""Sharding policy: parameter specs by leaf path, and where activations go.

The port of ``repro/models/sharding.py``.  One mesh axis can mean
different things per layer (Megatron TP for attention / MLP, expert
parallelism for MoE, sequence sharding for long decode); the policy owns
those decisions.  Param specs are derived from the *leaf path names* of
the parameter tree; axes that do not divide a dimension are dropped.

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names.  A one-axis tuple is written as the
name, the canonical form of the reference's ``PartitionSpec``, so a spec
here equals ``tuple()`` of the reference's.  Specs read the mesh only through
``axis_names`` and ``devices.shape`` (:class:`repro_torch.launch.mesh.Mesh`).

On a mesh the layout runs on DTensor, which follows GSPMD's semantics one
to one: a spec becomes a list of placements, one per mesh axis
(:func:`placements`: the axis's tensor dimension as ``Shard(dim)``,
``Replicate()`` for an axis the spec does not name; several axes on one
dimension shard it major to minor, as ``PartitionSpec`` does);
:meth:`~ShardingPolicy.shard_params` is ``distribute_tensor`` and
:meth:`~ShardingPolicy.act` / :meth:`~ShardingPolicy.constrain` are
``redistribute`` to the fitted spec (a plain tensor is taken as replicated
first).  Axes that do not divide a dimension are dropped by ``_fit``, so
DTensor never sees a ragged shard.  The placements live on the mesh's
:meth:`~repro_torch.launch.mesh.Mesh.device_mesh` on the policy's
``device`` (``cuda`` unless asked otherwise).  With ``mesh=None`` every
method is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

__all__ = ["ShardingPolicy", "REPLICATED", "placements", "is_dtensor",
           "spec_leaves", "replicated_scope"]

REPLICATED: tuple = ()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


_SCOPE_DEPTH = [0]


@contextlib.contextmanager
def replicated_scope():
    """Plain tensors met beside DTensors count as replicated (DTensor's
    ``implicit_replication``, made to nest)."""
    # DTensor's implicit_replication is not reentrant (its exit turns the
    # switch off): only the outermost scope enters and leaves it
    if _SCOPE_DEPTH[0]:
        _SCOPE_DEPTH[0] += 1
        try:
            yield
        finally:
            _SCOPE_DEPTH[0] -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _SCOPE_DEPTH[0] = 1
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE_DEPTH[0] = 0


def spec_leaves(specs) -> list:
    """The specs of a spec tree (``param_specs``) in the order
    :func:`repro_torch.tree.flatten` lists the parameters (sorted keys); a
    spec tuple is one leaf."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [tuple(specs)]


def placements(mesh, spec: tuple) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis.
    An axis named on dimension ``d`` gives ``Shard(d)``; the axes of one
    dimension must come in mesh order (DTensor shards major to minor in
    mesh order, which is ``PartitionSpec``'s order then)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.axis_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {spec}")
            out[i] = Shard(dim)
    return out


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
    # where the placements live: cuda unless asked otherwise
    device: str | None = None

    # ---- helpers ----------------------------------------------------------

    def _fit(self, shape: tuple[int, ...], spec: tuple) -> tuple:
        """Drop axes that don't divide their dim; trim to rank."""
        entries = list(spec) + [None] * (len(shape) - len(spec))
        return _spec(*(
            ax if ax is not None and dim % _axis_size(self.mesh, ax) == 0
            else None
            for dim, ax in zip(shape, entries)
        ))

    def scope(self):
        """The scope of a pass under this policy: on a mesh, plain tensors
        met beside DTensors (positions, masks, constants) count as
        replicated; without one, nothing.  Scopes nest."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return replicated_scope()

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` the placements live on."""
        return self.mesh.device_mesh(self.device)

    def constrain(self, x, spec: tuple):
        """``x`` laid out by ``spec`` (fitted to its shape): a DTensor
        redistributed, a plain tensor (the whole value on every rank) taken
        as replicated first.  The identity without a mesh."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import Replicate, distribute_tensor

        dm = self.device_mesh
        want = placements(self.mesh, self._fit(tuple(x.shape), spec))
        if not is_dtensor(x):
            x = distribute_tensor(x, dm, [Replicate()] * dm.ndim,
                                  src_data_rank=None)
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(dm, want)

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
        """Every leaf of a whole parameter tree (the same numbers on every
        rank) as a DTensor laid out by :meth:`param_specs`; each rank keeps
        its own shard and nothing moves between ranks."""
        if self.mesh is None:
            return params
        from torch.distributed.tensor import distribute_tensor

        dm = self.device_mesh

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return distribute_tensor(node.detach(), dm,
                                     placements(self.mesh, spec),
                                     src_data_rank=None)

        return walk(params, self.param_specs(params))

    # ---- activation constraints -------------------------------------------

    def act(self, x, *, kind: str):
        """Constrain an activation tensor. kinds:
        hidden   (B, S, D)   — batch on dp (+ seq on tp if seq_parallel)
        logits   (B, S, V)   — vocab on tp
        heads    (B, S, H, hd) — heads on tp
        kv       (B, S, K, hd) — kv heads on tp if divisible, else
                                 replicated over tp
        cache    (B, K, S, hd) — kv heads on tp if divisible, else seq
        tokens   (B, S)
        """
        if self.mesh is None:
            return x
        dp, tp = self.dp, self.tp_axis
        if self.mode == "serve2d":
            joint = ((tp,) if tp else ()) + tuple(self.fsdp_axes or ())
            if kind == "cache":  # (B, K, S, hd): sequence over the grid
                if x.shape[2] % _axis_size(self.mesh, joint) == 0:
                    return self.constrain(x, (None, None, joint, None))
                return self.constrain(x, (None, None, tp, None))
            if kind == "logits":
                return self.constrain(x, (None, None, tp))
            return x  # activations replicated (tiny at decode)
        if kind == "hidden":
            seq = tp if self.seq_parallel else None
            return self.constrain(x, (dp, seq, None))
        if kind == "tokens":
            return self.constrain(x, (dp, None))
        if kind == "logits":
            return self.constrain(x, (dp, None, tp))
        if kind == "heads":
            return self.constrain(x, (dp, None, tp, None))
        if kind == "kv":
            if tp and x.shape[2] % self.tp_size == 0:
                return self.constrain(x, (dp, None, tp, None))
            # kv heads that do not divide over tp are replicated over it
            return self.constrain(x, (dp, None, None, None))
        if kind == "cache":
            if tp and x.shape[1] % self.tp_size == 0:
                return self.constrain(x, (dp, tp, None, None))
            return self.constrain(x, (dp, None, tp, None))
        raise ValueError(kind)


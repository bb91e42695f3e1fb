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

``serve2d``'s joint axis is model-major (``("model", "data")`` on a
``("data", "model")`` mesh, as ``PartitionSpec(("model", "data"))`` lays
it out): its policy places on a ``DeviceMesh`` whose dimensions come in
the joint axis's order (:attr:`ShardingPolicy.axis_order`), over the same
rank -> coordinate map, so rank ``r`` holds the shard of the reference's
device ``r`` (DTensor's strided sharding would do the same through a
private placement).

The decode cache is laid out by :meth:`ShardingPolicy.cache_spec` (the
reference's ``_cache_spec``, both modes; :meth:`~ShardingPolicy.
shard_cache`) and written in place through :func:`assign`.  Code that
runs on each rank's blocks with explicit collectives (the MoE routes, the
shard_map regions of the reference) enters with :func:`local_block` and
leaves with :func:`from_block`, which carry shard_map's gradient rule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

__all__ = ["ShardingPolicy", "REPLICATED", "placements", "is_dtensor",
           "spec_leaves", "replicated_scope", "assign", "local_block",
           "from_block", "block_index", "settle", "split_dim",
           "on_blocks", "grad_in_layout"]

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


def placements(mesh, spec: tuple, order=None) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis,
    in ``order`` (the ``DeviceMesh``'s dimension order; the mesh's own by
    default).  An axis named on dimension ``d`` gives ``Shard(d)``; the
    axes of one dimension must come in that order (DTensor shards major to
    minor in its mesh order, which is ``PartitionSpec``'s order then)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(order) if order is not None else tuple(mesh.axis_names)
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
    def axis_order(self) -> tuple[str, ...]:
        """The dimension order of :attr:`device_mesh`: the mesh's own, or
        in ``serve2d`` the joint axis's (the model axis first, then the
        others in mesh order), so its joint specs shard model-major."""
        names = tuple(self.mesh.axis_names)
        if self.mode == "serve2d" and self.tp_axis in names:
            return (self.tp_axis,) + tuple(a for a in names
                                           if a != self.tp_axis)
        return names

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` the placements live on."""
        return self.mesh.device_mesh(self.device, order=self.axis_order)

    def placements(self, spec: tuple) -> list:
        """The placements of ``spec`` on :attr:`device_mesh`."""
        return placements(self.mesh, spec, self.axis_order)

    def constrain(self, x, spec: tuple):
        """``x`` laid out by ``spec`` (fitted to its shape): a DTensor
        redistributed, a plain tensor (the whole value on every rank) taken
        as replicated first.  The identity without a mesh."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import Replicate, distribute_tensor

        dm = self.device_mesh
        want = self.placements(self._fit(tuple(x.shape), spec))
        if is_dtensor(x) and x.device_mesh != dm:
            # placed on another dimension order: the whole value, replicated
            from torch.distributed.tensor import DTensor

            x = DTensor.from_local(x.full_tensor(), dm,
                                   [Replicate()] * dm.ndim, run_check=False)
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
                                     self.placements(spec),
                                     src_data_rank=None)

        return walk(params, self.param_specs(params))

    # ---- the decode cache -------------------------------------------------

    def cache_spec(self, name: str, shape: tuple[int, ...]) -> tuple:
        """The layout of one decode-cache leaf (the reference's
        ``_cache_spec``), fitted to ``shape``.  The port's cache keeps one
        ``index`` and one ring ``pos`` row a batch row: in train mode they
        go over the DP axes as every other batch-row leaf does; in
        ``serve2d`` the batch is replicated, and so are they."""
        if self.mesh is None:
            return REPLICATED
        dp, tp = self.dp, self.tp_axis
        ok = lambda dim, axes: dim % _axis_size(self.mesh, axes) == 0  # noqa
        if self.mode == "serve2d":
            joint = ((tp,) if tp else ()) + tuple(self.fsdp_axes or ())
            joint = joint or None
            if name in ("k", "v"):  # (n_super, B, KV, S, hd): S over the grid
                ax = joint if ok(shape[3], joint) else (
                    tp if tp and ok(shape[3], tp) else None)
                spec = (None, None, None, ax, None)
            elif name == "state":  # mamba (n,B,d_in,N) / rwkv (n,B,H,hd,hd)
                ax = joint if ok(shape[2], joint) else (
                    tp if tp and ok(shape[2], tp) else None)
                spec = (None, None, ax)
            elif name == "conv":  # (n, B, k, d_in)
                spec = (None, None, None,
                        joint if ok(shape[3], joint) else None)
            else:  # x_prev, cm_x_prev, enc_out, index, pos
                spec = REPLICATED
            return self._fit(shape, _spec(*spec))
        rows = lambda dim: dp if ok(dim, dp) else None  # noqa: E731
        if name in ("k", "v"):  # (n_super, B, KV, size, hd)
            _, B, KV, size, _ = shape
            if tp and KV % self.tp_size == 0 and ok(B, dp):
                spec = (None, dp, tp, None, None)
            elif tp and size % self.tp_size == 0:
                spec = (None, rows(B), None, tp, None)
            else:
                spec = (None, rows(B), None, None, None)
        elif name == "state":  # mamba (n,B,d_in,N) / rwkv (n,B,H,hd,hd)
            spec = (None, rows(shape[1]))
            if tp and shape[2] % self.tp_size == 0:
                spec += (tp,)
        elif name in ("conv", "x_prev", "cm_x_prev", "pos"):
            spec = (None, rows(shape[1]), None)
        elif name == "enc_out":
            spec = (rows(shape[0]), None, None)
        elif name == "index":
            spec = (rows(shape[0]),)
        else:
            spec = REPLICATED
        return self._fit(shape, spec)

    def cache_specs(self, cache) -> dict:
        """Mirror tree of :meth:`cache_spec` for a decode cache (leaves need
        only a ``shape``)."""

        def walk(node, name):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            return self.cache_spec(name, tuple(node.shape))

        return walk(cache, "")

    def shard_cache(self, cache):
        """A whole decode cache (the same numbers on every rank) laid out by
        :meth:`cache_specs`, each rank keeping its shards (the reference's
        ``_attach_cache_shardings``).  The identity without a mesh."""
        if self.mesh is None:
            return cache
        from torch.distributed.tensor import distribute_tensor

        dm = self.device_mesh

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return distribute_tensor(node, dm, self.placements(spec),
                                     src_data_rank=None)

        return walk(cache, self.cache_specs(cache))

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



# ---------------------------------------------------------------------------
# in-place writes and per-rank regions on a mesh
# ---------------------------------------------------------------------------


def assign(dst, src) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor (a cache leaf):
    ``src`` is laid out as ``dst`` first (a plain tensor counts as
    replicated), then each rank copies its own block in place."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    from torch.distributed.tensor import Replicate, distribute_tensor

    dm = dst.device_mesh
    if not is_dtensor(src):
        src = distribute_tensor(src, dm, [Replicate()] * dm.ndim,
                                src_data_rank=None)
    if tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dm, dst.placements)
    dst.to_local().copy_(src.to_local())


class _ScaleGrad(torch.autograd.Function):
    """Identity forward, gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def local_block(x, want):
    """The local block of DTensor ``x`` laid out by the placements ``want``
    (redistributed first), to enter a region that runs on each rank's
    block with explicit collectives, as the reference's ``shard_map``.
    Its gradient is taken, as ``shard_map`` takes it, as this rank's part
    of a sum over the mesh axes ``want`` replicates."""
    from torch.distributed.tensor import Partial, Replicate

    if tuple(x.placements) != tuple(want):
        x = x.redistribute(x.device_mesh, want)
    grad = [Partial() if isinstance(p, Replicate) else p for p in want]
    return x.to_local(grad_placements=grad)


def from_block(y, device_mesh, where):
    """Leave a per-rank region: ``y`` (this rank's block) as a DTensor laid
    out by the placements ``where``.  As ``shard_map`` does, the gradient
    that reaches ``y`` is divided by the number of ranks that hold the same
    block (the sizes of the axes ``where`` replicates), each of which
    passes its share back through :func:`local_block`."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = math.prod(device_mesh.size(i) for i, p in enumerate(where)
                    if isinstance(p, Replicate))
    if rep > 1 and y.requires_grad:
        y = _ScaleGrad.apply(y, 1.0 / rep)
    return DTensor.from_local(y, device_mesh, list(where), run_check=False)


def on_blocks(policy, fn, args, like=0):
    """``fn`` on each rank's blocks: ``args`` are ``(tensor, spec)`` pairs,
    each laid out by its spec (fitted to its shape) and handed to ``fn`` as
    this rank's block (:func:`local_block`); ``fn``'s result, this rank's
    block of a tensor laid out as argument ``like`` (a tuple of results
    with ``like`` a tuple of argument indices), comes back as DTensors
    (:func:`from_block`).  For work independent per block (a recurrence per
    row and channel): it runs on local tensors, with no DTensor dispatch
    per op.  Without a mesh, ``fn`` on the tensors."""
    if policy.mesh is None:
        return fn(*(t for t, _ in args))
    placed = [policy.constrain(t, spec) for t, spec in args]
    out = fn(*(local_block(t, list(t.placements)) for t in placed))
    back = lambda y, i: from_block(  # noqa: E731
        y, placed[i].device_mesh, list(placed[i].placements))
    if isinstance(like, tuple):
        return tuple(back(y, i) for y, i in zip(out, like))
    return back(out, like)


class _GradInLayout(torch.autograd.Function):
    """Identity forward; the gradient redistributed to the input's
    layout."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_in_layout(x):
    """``x``, whose gradient comes back in ``x``'s own layout (a DTensor
    used at several sites sums gradients that all arrive so); anything
    but a DTensor needing a gradient as it is."""
    if not is_dtensor(x) or not x.requires_grad \
            or not torch.is_grad_enabled():
        return x
    return _GradInLayout.apply(x)


def settle(x):
    """``x`` with the partial sums of a DTensor reduced (its ``Partial``
    mesh dimensions made ``Replicate``); anything else as it is.  A
    partial sum met beside a sharded operand needs DTensor's Shard ->
    Partial, which the card's torch 2.11 lacks."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  A
    DTensor whose ``dim`` is sharded over ranks that do not divide
    ``sizes[0]`` has that dimension gathered first: DTensor views no
    uneven shard, where GSPMD pads one (36 heads over 16 ranks)."""
    dim = dim % x.dim()
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        dm = x.device_mesh
        ranks = math.prod(dm.size(i) for i, p in enumerate(x.placements)
                          if p.is_shard(dim))
        if sizes[0] % ranks:
            x = x.redistribute(dm, [Replicate() if p.is_shard(dim) else p
                                    for p in x.placements])
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes)
                     + tuple(x.shape[dim + 1:]))


def block_index(device_mesh, dims) -> int:
    """This rank's block of a dimension that the mesh dimensions ``dims``
    shard (in mesh order, major to minor)."""
    block = 0
    for i in dims:
        block = block * device_mesh.size(i) + device_mesh.get_local_rank(i)
    return block

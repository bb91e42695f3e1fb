"""Gradient synchronisation: bucket-scheduled collectives of a tensor tree.

The port of the replicated-sync half of ``repro/core/grad_sync.py``:

* the **planner** (:func:`repro_torch.core.bucketing.plan_buckets`) packs
  the gradient leaves into size-targeted, dtype-pure buckets, each with its
  engine and pipeline depth pinned;
* the **executor** (:func:`sync_with_context`) issues the buckets in
  reverse-leaf order through the :class:`~repro_torch.core.comm.CommContext`.

With ``compress_bits`` set, every float bucket rides the quantised
node-aware transport on the fused transport kernels
(:mod:`repro_torch.kernels.transport`): exact f32 intra-node reduce-scatter
pre-combine, one quantize-pack pass into ``g`` wire blocks, packed
inter-node ``all_to_all`` + unpack + f32 fold (the RS half), requantize of
the fold at its measured per-leaf scale, packed inter-node allgather +
unpack (the AG half), intra-node allgather.  Each hop quantizes at the
measured per-leaf absmax of what goes on the wire, agreed over the wire
group with one max-allreduce.  On a single rank the quantize round trip is
kept, so the compression semantics (and the error-feedback residuals) are
the same at every grid size — and the card launches both kernels once per
bucket.

**Error feedback** (``sync_with_context(..., ef_state=...)``): each bucket
syncs ``g + r`` and every rank keeps, as its new residual, its exact share
of the rounding error measured at the two compression points.

The sharded route (:func:`sync_grads_sharded`): every leaf is
reduce-scattered instead of allreduced and each rank keeps its 1-D shard,
``ceil(ceil(e/ppn)/n)`` elements in the MLA stripe-block layout, at half
the allreduce's inter-node bytes; :func:`unshard_grads` allgathers back.
With ``compress_bits``, float leaves ride the packed transport's RS half
(:func:`_compressed_reduce_scatter`) after one fused max-allreduce agrees
every leaf's scale.

On a mesh: :func:`sync_grads_local` syncs this rank's local gradients over
named DP axes, and :func:`make_grad_sync` gives a callable over DTensor
gradients (the reference's ``shard_map``-ed sync over global arrays):
every rank syncs its local shards through :func:`sync_with_context` over
the mesh's DP topology at its own index of the other axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import bucketing, comm
from .collectives import (
    _all_gather, _all_reduce, _all_to_all, _reduce_scatter, nap_allreduce,
)
from .. import tree as tree_util
from ..kernels import ref, transport
from ..trace_regions import span

__all__ = [
    "GradSyncConfig",
    "sync_with_context",
    "sync_grads_sharded",
    "unshard_grads",
    "plan_for_tree",
    "sync_grads_local",
    "make_grad_sync",
    "compressed_transport_dtype",
]


@dataclasses.dataclass(frozen=True)
class GradSyncConfig(comm.CommPolicy):
    """Deprecated alias of :class:`repro_torch.core.comm.CommPolicy`:
    constructing one warns once and it behaves exactly like a
    ``CommPolicy``.  New code: ``CommContext(topology,
    CommPolicy(...)).sync_grads(grads)``."""

    def __post_init__(self):
        comm.warn_deprecated_once(
            "grad_sync.GradSyncConfig",
            "comm.CommPolicy with comm.CommContext",
        )
        super().__post_init__()


def compressed_transport_dtype(group: int, bits: int) -> torch.dtype:
    """Narrowest integer dtype that holds a ``group``-way sum of
    ``bits``-bit quantised values: the sum is bounded by ``group * qmax``
    with ``qmax = 2**(bits-1) - 1``, so int8 for one rank, int16 up to
    257-way groups at 8 bits, int32 beyond, then int64 (which torch
    honours; the reference raises there, as jax degrades int64 to int32
    without x64)."""
    peak = max(1, int(group)) * (2 ** (bits - 1) - 1)
    for dt in (torch.int8, torch.int16, torch.int32):
        if peak <= torch.iinfo(dt).max:
            return dt
    return torch.int64


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an IEEE division on every device (a Python scalar
    divisor would become a reciprocal multiply on CUDA)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# per-payload reduction primitives
# ---------------------------------------------------------------------------


def _wire_split(topo: comm.Topology):
    """(pre_group, wire_group, pre, g): the f32 pre-combine domain and the
    packed-wire exchange domain of the compressed transport.

    With a slow domain the node is the pre-combine (exact f32 reduce-scatter
    over ``ppn`` lanes) and the wire crosses nodes.  Degenerate grids
    collapse a level: single-lane nodes wire over the nodes alone,
    single-node grids wire over the lanes.  Always ``pre * g == group``.
    """
    groups = topo.require_groups()
    if topo.n_nodes > 1 and topo.ppn > 1:
        return groups.intra, groups.inter, topo.ppn, topo.n_nodes
    if topo.n_nodes > 1:
        return comm.Group.alone(), groups.inter, 1, topo.n_nodes
    return comm.Group.alone(), groups.intra, 1, topo.ppn


def _leaf_offsets(parts) -> tuple[int, ...]:
    offs, off = [], 0
    for p in parts:
        offs.append(off)
        off += int(p.numel())
    return tuple(offs)


def _wire_scale(x, offsets, sizes, base, wire, qmax):
    """Agreed (L,) per-leaf wire scale for the window ``[base, base+|x|)``
    of the fused flat payload: per-leaf absmax of ``x`` inside the window,
    maxed over the wire group, divided by ``qmax``.  Leaves outside the
    window get the 1e-30 floor — they carry no data on this hop."""
    flat = x.reshape(-1)
    end = base + flat.numel()
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    m = []
    for o, n in zip(offsets, sizes):
        lo, hi = max(o, base), min(o + n, end)
        m.append(flat[lo - base : hi - base].abs().amax() if hi > lo else zero)
    m = torch.stack(m)
    if wire is not None:
        m = _all_reduce(m, wire, "max")
    return torch.clamp_min(_div(m, qmax), 1e-30)


def _compressed_fused_allreduce(
    parts, ctx: comm.CommContext, group, with_err=False
):
    """Quantised allreduce of one or more fused parts with *per-leaf*
    scales, on the fused transport kernels.

    Launches per bucket: one quantize-pack and one unpack-dequantize on a
    single rank; two of each on more ranks, with error feedback or
    without: ``with_err``'s two decodes of this rank's own wire bytes run
    the plain version (:func:`repro_torch.kernels.ref.unpack_dequantize_ref`).

    Returns ``(outs, scales, err)``: per-leaf float32 *sums* in ``parts``
    order, the (L,) hop-1 wire scales, and the flat (E,) per-rank error
    (``None`` unless ``with_err``).
    """
    bits = ctx.policy.compress_bits
    impl = ctx.policy.transport_impl
    qmax = float(2 ** (bits - 1) - 1)
    offsets = _leaf_offsets(parts)
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    flat = flat.to(torch.float32)
    E = int(flat.numel())
    sizes = tuple(int(p.numel()) for p in parts)

    def split(full):
        return [full[o : o + n] for o, n in zip(offsets, sizes)]

    if group <= 1:
        # single rank: no wire — but keep the quantize round trip so the
        # compression semantics (and EF residuals) match any grid size
        scales = _wire_scale(flat, offsets, sizes, 0, None, qmax)
        w = transport.quantize_pack(
            flat.reshape(1, E), scales, offsets=offsets, bits=bits, impl=impl,
            donate_input=not with_err,
        )
        full = transport.unpack_dequantize(
            w, scales, offsets=offsets, bits=bits, cols=E, impl=impl,
            donate_input=True,
        ).reshape(-1)
        return split(full), scales, (flat - full if with_err else None)

    pre_g, wire_g, pre, g = _wire_split(ctx.topology)
    # ---- level 1: exact f32 pre-combine, striping the payload ----------
    if pre > 1:
        S = -(-E // pre)
        if pre * S != E:
            flat = torch.cat([flat, flat.new_zeros(pre * S - E)])
        stripe = _reduce_scatter(flat.reshape(pre, S), pre_g)
        base_stripe = pre_g.index * S
    else:
        S = E
        stripe = flat
        base_stripe = 0
    # ---- one-pass quantize-pack of the stripe into g wire blocks -------
    B = -(-S // g)
    if g * B != S:
        stripe = torch.cat([stripe, stripe.new_zeros(g * B - S)])
    s1 = _wire_scale(stripe, offsets, sizes, base_stripe, wire_g, qmax)
    # the stripe is donated only without error feedback, whose path reads
    # it again (the SPMD lint's alias-donation rule proves it)
    w = transport.quantize_pack(
        stripe.reshape(g, B), s1, offsets=offsets, bits=bits,
        base=base_stripe, row_stride=B, impl=impl, donate_input=not with_err,
    )
    # ---- RS half: packed all_to_all; every row lands on the same block
    # window (base + t*B, row_stride=0), unpack + exact f32 fold --------
    recv = _all_to_all(w, wire_g)
    block_base = base_stripe + wire_g.index * B
    blk = transport.unpack_dequantize(
        recv, s1, offsets=offsets, bits=bits, cols=B,
        base=block_base, row_stride=0, impl=impl, donate_input=True,
    ).sum(dim=0)
    # ---- requantize the reduced fold at its measured bound; AG half ----
    s2 = _wire_scale(blk, offsets, sizes, block_base, wire_g, qmax)
    w2 = transport.quantize_pack(
        blk.reshape(1, B), s2, offsets=offsets, bits=bits,
        base=block_base, row_stride=0, impl=impl, donate_input=not with_err,
    )
    gathered = _all_gather(w2[0], wire_g)
    stripe_sum = transport.unpack_dequantize(
        gathered, s2, offsets=offsets, bits=bits, cols=B,
        base=base_stripe, row_stride=B, impl=impl, donate_input=True,
    ).reshape(-1)[:S]
    # ---- level 1 inverse: rebuild the flat sum inside the node ---------
    full = stripe_sum
    if pre > 1:
        full = _all_gather(stripe_sum, pre_g).reshape(-1)
    err = None
    if with_err:
        # this rank's share of the rounding error: the stripe it quantised
        # on hop 1 and the block it requantised on hop 2 (the block lies
        # inside the stripe, so the two add)
        # The decodes take the plain version directly, outside the
        # kernel's region: error feedback adds no launch and no transport
        # region (the reference pins ``impl="xla"`` here).  The kernel is
        # bit-identical to it, so the residual is the same either way.
        vhat = ref.unpack_dequantize_ref(
            w, s1, offsets=offsets, bits=bits, base=base_stripe,
            row_stride=B,
        )[:, :B].reshape(-1)
        e1 = (stripe - vhat)[:S]
        blkhat = ref.unpack_dequantize_ref(
            w2, s2, offsets=offsets, bits=bits, base=block_base,
            row_stride=0,
        )[0, :B]
        # padded scratch: the last stripe's block window may run past
        # pre*S (block g*B > S); the overhang is all-zero padding
        P = (pre - 1) * S + g * B
        err = flat.new_zeros(P)
        err[base_stripe : base_stripe + S] = e1
        err[block_base : block_base + B] += blk - blkhat
        err = err[:E]
    return split(full[:E]), s1, err


def _reduce_leaf(g, ctx: comm.CommContext, group):
    """Exact allreduce of one payload with mean/dtype semantics (compressed
    float buckets go through :func:`_compressed_fused_allreduce`)."""
    dtype = g.dtype
    is_float = dtype.is_floating_point
    red = ctx.allreduce(g)
    if ctx.policy.mean and group > 1:
        if is_float:
            red = _div(red, float(group))
        else:
            red = torch.round(_div(red.to(torch.float32), float(group)))
    return red.to(dtype)


# ---------------------------------------------------------------------------
# planner interface
# ---------------------------------------------------------------------------


def _leaf_specs(leaves, policy: comm.CommPolicy):
    def transport_itemsize(dt, fusible):
        if policy.compress_bits and fusible:
            # the *packed* wire width: the planner budgets the bytes the
            # fused kernels move
            return transport.wire_itemsize(policy.compress_bits)
        return None

    return bucketing.leaf_specs_for(
        leaves, transport_itemsize_fn=transport_itemsize
    )


def _plan(leaves, policy: comm.CommPolicy, topology: comm.Topology):
    return bucketing.plan_buckets(
        _leaf_specs(leaves, policy),
        topology,
        algorithm=policy.algorithm,
        small_threshold_bytes=policy.small_threshold_bytes,
        pipeline_chunks=policy.pipeline_chunks,
        bucket_bytes=policy.bucket_bytes,
        fuse=policy.fuse_small_buckets,
    )


def plan_for_tree(
    tree: Any,
    *,
    cfg: comm.CommPolicy,
    topology: comm.Topology,
) -> bucketing.BucketPlan:
    """Bucket plan for a gradient tree of tensors (``meta`` tensors will
    do): the trainer plans once from the parameter shapes and hands the
    plan to every step."""
    return _plan(tree_util.leaves(tree), cfg, topology)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _bucket_ctx(ctx: comm.CommContext, bucket) -> comm.CommContext:
    """The per-bucket context: the planner's decision, pinned."""
    return comm.CommContext(
        ctx.topology,
        dataclasses.replace(
            ctx.policy,
            algorithm=bucket.algorithm,
            pipeline_chunks=bucket.chunks,
            small_threshold_bytes=None,
        ),
    )


def _execute_plan(leaves, plan, ctx: comm.CommContext, ef=None):
    """Issue every bucket's collective in plan (reverse-leaf) order.

    ``ef`` (optional) is the flat list of this rank's error-feedback
    residuals: compressed float buckets sync ``c = g + r`` and each rank's
    new residual is its share of the transport's rounding error.  Returns
    ``(out, new_ef)``.
    """
    group = ctx.topology.group
    bits = ctx.policy.compress_bits
    out = [None] * len(leaves)
    new_ef = None if ef is None else list(ef)
    for bucket in plan.buckets:
        bctx = _bucket_ctx(ctx, bucket)
        idxs = bucket.leaves
        if bits and leaves[idxs[0]].dtype.is_floating_point:
            parts = []
            for i in idxs:
                p = leaves[i].reshape(-1).to(torch.float32)
                if ef is not None:
                    p = p + ef[i].reshape(-1)
                parts.append(p)
            segs, _, err = _compressed_fused_allreduce(
                parts, bctx, group, with_err=ef is not None
            )
            offs = _leaf_offsets(parts)
            for k, i in enumerate(idxs):
                g = leaves[i]
                if ef is not None:
                    new_ef[i] = err[offs[k] : offs[k] + g.numel()].reshape(
                        g.shape
                    )
                seg = segs[k]
                if ctx.policy.mean and group > 1:
                    seg = _div(seg, float(group))
                out[i] = seg.reshape(g.shape).to(g.dtype)
            continue
        if len(idxs) == 1:
            i = idxs[0]
            out[i] = _reduce_leaf(leaves[i], bctx, group)
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        red = _reduce_leaf(flat, bctx, group)
        off = 0
        for i in idxs:
            g = leaves[i]
            out[i] = red[off : off + g.numel()].reshape(g.shape)
            off += g.numel()
    return out, new_ef


def sync_with_context(
    grads: Any,
    ctx: comm.CommContext,
    *,
    plan: bucketing.BucketPlan | None = None,
    ef_state: Any | None = None,
) -> Any:
    """Bucket-scheduled allreduce sync under a :class:`comm.CommContext`.

    ``plan`` (optional) is a precomputed :func:`plan_for_tree` result; its
    leaf signature must match ``grads``.  ``ef_state`` (optional) is this
    rank's residual tree matching ``grads`` leaf for leaf; when given the
    call returns ``(synced, new_ef)``.  Requires compressed transport.
    """
    ctx.topology.require_groups()
    leaves, treedef = tree_util.flatten(grads)
    if not leaves:
        return grads if ef_state is None else (grads, ef_state)
    ef_leaves = None
    if ef_state is not None:
        if not ctx.policy.compress_bits:
            raise ValueError(
                "ef_state given but compress_bits is None — error "
                "feedback only applies to quantised transport"
            )
        ef_leaves, ef_def = tree_util.flatten(ef_state)
        if len(ef_leaves) != len(leaves):
            raise ValueError(
                f"error-feedback state has {len(ef_leaves)} leaves for "
                f"{len(leaves)} gradient leaves"
            )
    if plan is None:
        plan = _plan(leaves, ctx.policy, ctx.topology)
    else:
        sig = tuple(
            (int(g.numel()), bucketing.dtype_name(g.dtype)) for g in leaves
        )
        if sig != plan.signature:
            raise ValueError(
                "bucket plan does not match the gradient tree "
                f"(plan for {plan.signature}, got {sig})"
            )
    with span("grad_sync"):
        out, new_ef = _execute_plan(leaves, plan, ctx, ef=ef_leaves)
    synced = tree_util.unflatten(treedef, out)
    if ef_state is None:
        return synced
    return synced, tree_util.unflatten(ef_def, new_ef)


# ---------------------------------------------------------------------------
# sharded route
# ---------------------------------------------------------------------------


def _agreed_absmax(parts, ctx: comm.CommContext) -> torch.Tensor:
    """Per-part max-abs values agreed over the whole grid in ONE fused
    max-allreduce of an (L,) float32 vector: NAP where the grid has nodes
    of two or more lanes, the native allreduce otherwise (the reference
    calls NAP on single-lane grids too, where its schedule builder raises:
    NAP needs two lanes)."""
    topo = ctx.topology
    groups = topo.require_groups()
    absmax = torch.stack(
        [p.abs().amax().to(torch.float32) for p in parts]
    )
    if topo.n_nodes > 1 and topo.ppn > 1:
        return nap_allreduce(absmax, topology=topo, op="max")
    return _all_reduce(absmax, groups.world, "max")


def _compressed_reduce_scatter(flat, scale, ctx: comm.CommContext):
    """RS half of the packed transport for one f32 leaf: exact f32 intra
    reduce-scatter, one quantize-pack of the (n, B) stripe
    (``row_stride=B``, ``base = lane * S``), the packed inter-node
    ``all_to_all`` of uint8 / int8 wire rows, one unpack-dequantize of
    the n received copies of this rank's block (``row_stride=0``,
    ``cols=B``) and an f32 fold.  Returns this rank's f32 shard of the
    *sum*, ``ceil(ceil(e/ppn)/n)`` elements of the MLA stripe-block
    layout.  ``scale`` is agreed over the grid before the scatter; the
    stripe is a sum of ``ppn`` ranks, so hop 1 quantizes at ``ppn``
    times it.  With one node there is no wire: the stripe is returned
    before the kernels."""
    bits = ctx.policy.compress_bits
    impl = ctx.policy.transport_impl
    topo = ctx.topology
    groups = topo.require_groups()
    n, ppn = topo.n_nodes, topo.ppn
    scales = scale.reshape(1)
    offsets = (0,)
    e = int(flat.numel())
    S = -(-e // ppn)
    if ppn > 1:
        if ppn * S != e:
            flat = torch.cat([flat, flat.new_zeros(ppn * S - e)])
        stripe = _reduce_scatter(flat.reshape(ppn, S), groups.intra)
        base = groups.intra.index * S
        s1 = scales * float(ppn)
    else:
        stripe = flat
        base = 0
        s1 = scales
    if n <= 1:
        return stripe
    B = -(-S // n)
    if n * B != S:
        stripe = torch.cat([stripe, stripe.new_zeros(n * B - S)])
    w = transport.quantize_pack(
        stripe.reshape(n, B), s1, offsets=offsets, bits=bits, base=base,
        row_stride=B, impl=impl, donate_input=True,
    )
    recv = _all_to_all(w, groups.inter)
    block_base = base + groups.inter.index * B
    return transport.unpack_dequantize(
        recv, s1, offsets=offsets, bits=bits, cols=B, base=block_base,
        row_stride=0, impl=impl, donate_input=True,
    ).sum(dim=0)


def sync_grads_sharded(grads: Any, *, ctx: comm.CommContext) -> Any:
    """Sharded gradient sync: every leaf is reduce-scattered (dispatched
    by :meth:`comm.CommContext.reduce_scatter`) and this rank keeps its
    1-D shard of the reduced, optionally averaged, gradient: leaf ``i``
    gives ``ceil(ceil(e_i/ppn)/n)`` elements.  :func:`unshard_grads`
    inverts.

    With ``compress_bits``, float leaves take
    :func:`_compressed_reduce_scatter`, their scales agreed in one fused
    max-allreduce first (:func:`_agreed_absmax`); integer leaves stay
    exact.  The mean of an integer leaf is ``round(sum / group)``, half to
    even."""
    ctx.topology.require_groups()
    group = ctx.topology.group
    leaves, treedef = tree_util.flatten(grads)
    bits = ctx.policy.compress_bits
    compressed = [
        i for i, g in enumerate(leaves)
        if bits and g.dtype.is_floating_point
    ]
    scales = {}
    if compressed and group > 1:
        qmax = float(2 ** (bits - 1) - 1)
        agreed = _agreed_absmax(
            [leaves[i].reshape(-1) for i in compressed], ctx
        )
        scales = {
            i: torch.clamp_min(_div(agreed[k], qmax), 1e-30)
            for k, i in enumerate(compressed)
        }
    out = []
    for i, g in enumerate(leaves):
        dtype = g.dtype
        if i in scales:
            red = _compressed_reduce_scatter(
                g.reshape(-1).to(torch.float32), scales[i], ctx
            )
        else:
            red = ctx.reduce_scatter(g.reshape(-1), op="sum")
        if ctx.policy.mean and group > 1:
            if dtype.is_floating_point:
                red = _div(red, float(group))
            else:
                red = torch.round(_div(red.to(torch.float32), float(group)))
        out.append(red.to(dtype))
    return tree_util.unflatten(treedef, out)


def unshard_grads(shards: Any, like: Any, *, ctx: comm.CommContext) -> Any:
    """Allgather a :func:`sync_grads_sharded` result back to full leaves.
    ``like`` is a tree of tensors (``meta`` ones will do) giving the
    original leaf shapes and types."""
    shard_leaves, treedef = tree_util.flatten(shards)
    like_leaves = tree_util.leaves(like)
    out = []
    for s, g in zip(shard_leaves, like_leaves):
        full = ctx.allgather(s, elems=int(g.numel()))
        out.append(full.reshape(g.shape).to(g.dtype))
    return tree_util.unflatten(treedef, out)


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------


def sync_grads_local(grads: Any, *, cfg: comm.CommPolicy, inter_axes,
                     intra_axes, mesh,
                     plan: bucketing.BucketPlan | None = None) -> Any:
    """Synchronise this rank's local gradient tree over the named DP axes
    of ``mesh`` (the reference's ``shard_map``-side entry point, which reads
    the axes from its traced context; the port takes the mesh): the
    :class:`comm.Topology` of those axes, a :class:`comm.CommContext` of
    ``cfg``, then :func:`sync_with_context`."""
    topo = comm.Topology.from_axes(inter_axes, intra_axes, mesh=mesh)
    return sync_with_context(grads, comm.CommContext(topo, cfg), plan=plan)


def make_grad_sync(cfg: comm.CommPolicy, mesh, *, data_axes, grad_specs,
                   device=None):
    """A gradient sync over DTensors: ``sync(grads) -> grads``.

    ``grad_specs`` is a dict tree of specs like the gradients (each
    leaf's layout on ``mesh``); leaves must not be sharded along
    ``data_axes`` dims other than the stacked per-replica leading dim of
    data parallelism.  Every rank syncs its local shards over
    ``data_axes`` (``pod`` the slow domain, the rest the lanes) through
    :func:`sync_with_context`, and the result keeps each leaf's layout.
    The DTensors live on ``device`` (``cuda`` unless asked otherwise).
    ``sync.plan`` is the bucket plan of the last call's local leaves,
    ``sync.context`` the context it ran under."""
    from torch.distributed.tensor import DTensor

    from ..launch.mesh import POD_AXIS
    from ..models.sharding import is_dtensor, placements, spec_leaves

    device_mesh = mesh.device_mesh(device)
    inter = tuple(a for a in data_axes if a == POD_AXIS)
    intra = tuple(a for a in data_axes if a != POD_AXIS)
    ctx = comm.CommContext(
        comm.Topology.from_axes(inter, intra, mesh=mesh), cfg)
    layouts = [placements(mesh, spec) for spec in spec_leaves(grad_specs)]

    def sync(grads):
        leaves, treedef = tree_util.flatten(grads)
        if len(leaves) != len(layouts):
            raise ValueError(f"{len(leaves)} gradient leaves for "
                             f"{len(layouts)} specs")
        local = [g.to_local() if is_dtensor(g) else g for g in leaves]
        sync.plan = _plan(local, cfg, ctx.topology)
        out = tree_util.leaves(sync_with_context(
            tree_util.unflatten(treedef, local), ctx, plan=sync.plan))
        return tree_util.unflatten(treedef, [
            DTensor.from_local(t, device_mesh, pl, run_check=False,
                               shape=g.shape, stride=g.stride())
            for t, pl, g in zip(out, layouts, leaves)
        ])

    sync.plan = None
    sync.context = ctx
    return sync

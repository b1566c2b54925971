"""Ring attention — sequence/context parallelism over the ``sp`` mesh axis
(port of ``ray_tpu/ops/ring_attention.py``).

Each rank holds a contiguous sequence chunk of q/k/v. K/V chunks rotate
around the ring (:class:`_Rotate`, one ``batch_isend_irecv`` a step to
rank ``(r+1) % n`` from ``(r-1) % n``); each step runs the local flash
attention against the visiting chunk and folds the partial result in with
a numerically stable log-sum-exp merge. Causality is enforced at chunk
granularity (visiting chunk strictly past → full attend, self → causal,
future → skip), a branch on the host by the rank, so each rank does only
the work its rows need.

Differentiability comes from autograd: the merge is plain torch, the local
attention is the joint (out, lse) primitive of :mod:`ray_tpu_torch.ops.attention`
(kernels K1 and ``flash_bwd_kernel`` on the card, with the lse cotangent
entering delta), and the rotation's backward sends the cotangent the other
way round the ring, as JAX's transpose of ``ppermute`` does. A skipped
chunk still takes part in the graph (:class:`_Skip`, zero cotangents, the
counterpart of ``lax.cond``'s skip branch), so that every rank runs every
rotation's backward in the same order.

Also provides the Ulysses form (all-to-all seq↔heads exchange, one
autograd all-to-all each way) as the lower-latency alternative when
heads % sp == 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (NEG_INF, flash_attention,
                                         flash_attention_with_lse)


def _merge(o1, lse1, o2, lse2):
    """Combine two normalized partial attentions (o_i, lse_i) → (o, lse)."""
    m = torch.maximum(lse1, lse2)
    m = m.clamp(min=NEG_INF)  # both empty → stay finite
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    l = w1 + w2
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    # (B, H, S) stats vs (B, S, H, D) outputs: move heads axis.
    w1o = (w1 / l_safe).transpose(1, 2)[..., None]
    w2o = (w2 / l_safe).transpose(1, 2)[..., None]
    o = o1 * w1o + o2 * w2o
    return o, m + torch.log(l_safe)


def _ring_peers(group):
    """(next, prev) global ranks of this rank on ``group``'s ring."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    return (dist.get_global_rank(group, (r + 1) % n),
            dist.get_global_rank(group, (r - 1) % n))


def _send_recv(tensors, to, frm, group):
    """Send ``tensors`` to rank ``to`` and receive as many of their shapes
    from rank ``frm`` (global ranks), in one batch."""
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, to, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, frm, group) for o in outs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """k, v → the chunks of rank ``(r-1) % n``, with ours sent to
    ``(r+1) % n``; the backward sends the cotangents the other way."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        nxt, prev = _ring_peers(group)
        return tuple(_send_recv([k, v], nxt, prev, group))

    @staticmethod
    def backward(ctx, dk, dv):
        nxt, prev = _ring_peers(ctx.group)
        dk, dv = (torch.zeros_like(g) if g is None else g for g in (dk, dv))
        gk, gv = _send_recv([dk, dv], prev, nxt, ctx.group)
        return gk, gv, None


class _Skip(torch.autograd.Function):
    """A future chunk under causality: an empty partial attention (zero
    output, ``NEG_INF`` lse), with zero cotangents for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(x.shape, x.dtype, x.device) for x in (q, k, v)]
        b, s, h, _ = q.shape
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full((b, h, s), NEG_INF, dtype=torch.float32,
                           device=q.device))

    @staticmethod
    def backward(ctx, do, dlse):
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.like)


def ring_attention_local(q, k, v, group=None, causal: bool = True,
                         scale: Optional[float] = None, block: int = 512):
    """Per-rank body: q/k/v are this rank's (B, S_local, H, D) chunks of a
    sequence split over ``group``'s ranks in rank order."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    n = dist.get_world_size(group) if group is not None else 1
    my = dist.get_rank(group) if group is not None else 0

    o32 = lse = None
    for step in range(n):
        if step > 0:
            k, v = _Rotate.apply(k, v, group)
        if step == 0:
            o_s, lse_s = flash_attention_with_lse(
                q, k, v, causal=causal, scale=scale, block=block)
            o32, lse = o_s.float(), lse_s
            continue
        src = (my - step) % n  # origin of the visiting kv chunk
        if causal and not src < my:
            o_s, lse_s = _Skip.apply(q, k, v)
        else:
            o_s, lse_s = flash_attention_with_lse(
                q, k, v, causal=False, scale=scale, block=block)
            o_s = o_s.float()
        o32, lse = _merge(o32, lse, o_s, lse_s)
    return o32.to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """The tiled all-to-all of ``lax.all_to_all``: split ``split_axis``
    into n chunks, send chunk j to rank j, and concatenate what arrives
    along ``concat_axis`` in rank order. Its backward is the same exchange
    with the axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis: int, concat_axis: int):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g, ctx.group, concat_axis, split_axis), None, \
            None, None


def _all_to_all(x, group, split_axis: int, concat_axis: int):
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all-to-all: axis {split_axis} of {tuple(x.shape)} is not "
            f"divisible by {n}")
    # chunks of the split axis, one a destination rank, stacked in front
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def ulysses_attention_local(q, k, v, group=None, causal: bool = True,
                            scale: Optional[float] = None, block: int = 512):
    """All-to-all SP: exchange seq↔heads so each rank sees the full
    sequence for H/sp heads, run dense-local flash, exchange back.
    Requires heads (incl. kv heads) divisible by the group's size."""
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block=block)

    def seq_to_heads(x):
        # (B, S/n, H, D) → (B, S, H/n, D)
        return _AllToAll.apply(x, group, 2, 1)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    o = flash_attention(qg, kg, vg, causal=causal, scale=scale, block=block)
    return _AllToAll.apply(o, group, 1, 2)


def ring_attention(q, k, v, mesh, causal: bool = True,
                   scale: Optional[float] = None,
                   sp_axis: str = "sp", heads_axis: Optional[str] = "tp",
                   batch_axes: Union[str, Sequence[str]] = ("dp", "fsdp"),
                   block: int = 512, mode: str = "ring"):
    """Sequence-parallel attention on ``mesh``.

    q/k/v are this rank's local (B/batch, S/sp, H/tp, D) shards, or
    DTensors of the global (B, S, H, D) arrays; the output comes in the
    same form. DTensors are laid out as (batch_axes, sp_axis, heads_axis,
    None) first; the local attention runs on the local shards (never
    through DTensor's dispatch, which has no rule for the kernels).
    ``mode``: "ring" (a rotation a step) or "ulysses" (all-to-all).
    """
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.sharding import spec_placements

    local = (ring_attention_local if mode == "ring"
             else ulysses_attention_local)
    group = mesh.get_group(sp_axis)
    if not isinstance(q, DTensor):
        return local(q, k, v, group=group, causal=causal, scale=scale,
                     block=block)
    placements = spec_placements((batch_axes, sp_axis, heads_axis, None),
                                 mesh)
    dmesh = q.device_mesh
    ql, kl, vl = (x.redistribute(dmesh, placements).to_local()
                  for x in (q, k, v))
    out = local(ql, kl, vl, group=group, causal=causal, scale=scale,
                block=block)
    return DTensor.from_local(out, dmesh, placements,
                              shape=q.shape, stride=q.stride())

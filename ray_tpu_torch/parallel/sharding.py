"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Model code annotates tensors with *logical* axis names ("embed", "heads",
"batch", …); a :class:`ShardingRules` table maps those to mesh axes.
Swapping the table re-lays-out the whole model (fsdp vs tp vs both)
without touching model code.

A spec here is a tuple with one entry per tensor dim — a mesh axis, a
tuple of mesh axes, or None — in the role of a ``PartitionSpec``; a
sharding is the DTensor placements of that spec on a mesh, one
``Shard(d)`` or ``Replicate()`` per mesh dim. Leaves are placed with
``distribute_tensor`` and constrained with ``redistribute``.

DTensors live on the mesh's dims of size more than one
(:func:`compute_mesh`): a dim of size 1 splits nothing, and DTensor's
sharding propagation enumerates its strategies over every mesh dim, at a
cost that grows exponentially with their number (the five named dims of
``make_mesh`` made each op's first call seconds long on the CPU).

The JAX package's ``_ensure_partitionable_rng`` has no counterpart: it
aligns ``jax.random`` streams of sharded and unsharded inits, and the
port never draws the same weights twice — weights cross by conversion
(:mod:`ray_tpu_torch.models.convert`) or are drawn once and placed.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import sys
from typing import Optional, Sequence, Tuple, Union

LOGICAL_AXES = (
    "batch",      # global batch            → dp + fsdp
    "seq",        # sequence (activations)  → sp
    "embed",      # model dim
    "heads",      # attention heads         → tp
    "kv_heads",   # kv heads (GQA)
    "head_dim",
    "mlp",        # ffn hidden              → tp
    "vocab",      # logits vocab            → tp
    "embed_vocab",  # embedding-table vocab dim (gather axis) → replicated
    "layers",     # stacked-layers leading axis (never sharded)
    "expert",     # MoE experts             → ep (fsdp, sp)
    "tokens",     # flattened batch·seq (MoE routing) → dp + fsdp + sp
    "kv_seq",     # kv-cache sequence dim
    None,
)

Axis = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis → mesh axis (or tuple of mesh axes, or None=replicate)."""

    batch: Axis = ("dp", "fsdp")
    seq: Axis = "sp"
    embed: Axis = None
    embed_fsdp: Axis = "fsdp"   # weight-matrix embed dim: sharded for ZeRO-3
    heads: Axis = "tp"
    kv_heads: Axis = "tp"
    head_dim: Axis = None
    mlp: Axis = "tp"
    vocab: Axis = "tp"
    embed_vocab: Axis = None
    layers: Axis = None
    expert: Axis = ("fsdp", "sp")
    # flattened (batch·seq) token dim: the merge of the batch and seq
    # layouts, so reshape (B,S,…)→(T,…) preserves the sharding exactly
    tokens: Axis = ("dp", "fsdp", "sp")
    kv_seq: Axis = None

    def mesh_axes(self, logical_axes: Sequence[Optional[str]]):
        out = []
        used = set()
        for ax in logical_axes:
            m = getattr(self, ax) if ax is not None else None
            # A mesh axis may appear at most once in a spec; later
            # occurrences replicate (e.g. embed_fsdp when tp==fsdp axis reuse).
            if m is not None:
                flat = (m,) if isinstance(m, str) else tuple(m)
                flat = tuple(a for a in flat if a not in used)
                used.update(flat)
                m = None if not flat else (flat[0] if len(flat) == 1 else flat)
            out.append(m)
        return tuple(out)


# Default rule tables for common regimes.
FSDP_RULES = ShardingRules(heads=None, kv_heads=None, mlp="fsdp", vocab=None,
                           embed_fsdp="fsdp")
TP_RULES = ShardingRules(embed_fsdp=None)
FSDP_TP_RULES = ShardingRules()

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_active_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Context manager activating ``mesh`` for :func:`with_logical_constraint`
    (the counterpart of ``jax.set_mesh``). The active mesh is per thread."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def get_active_mesh():
    """The mesh of the innermost :func:`set_mesh`, or None."""
    return _ACTIVE_MESH.get()


def logical_spec(logical_axes: Sequence[Optional[str]],
                 rules: ShardingRules) -> tuple:
    """The spec of ``logical_axes``: per tensor dim, a mesh axis, a tuple
    of mesh axes, or None."""
    return tuple(rules.mesh_axes(logical_axes))


def compute_mesh(mesh):
    """The submesh of ``mesh``'s dims of size more than one (its last dim
    when none is), on which DTensors are placed; the same object for the
    same mesh."""
    sub = getattr(mesh, "_compute_mesh", None)
    if sub is not None:
        return sub
    names = tuple(mesh.mesh_dim_names)
    kept = tuple(n for n, size in zip(names, mesh.shape) if size > 1)
    kept = kept or names[-1:]
    sub = mesh if kept == names else mesh[kept]
    mesh._compute_mesh = sub
    sub._compute_mesh = sub
    return sub


def _flat(ax) -> tuple:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def spec_placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``compute_mesh(mesh)``:
    ``Shard(d)`` on each mesh dim that splits tensor dim d,
    ``Replicate()`` on the others. A tensor dim split over several mesh
    axes (``batch`` over ("dp", "fsdp")) takes ``Shard(d)`` on each of
    them, in mesh order; an axis of size 1 splits nothing."""
    from torch.distributed.tensor import Replicate, Shard

    all_names = tuple(mesh.mesh_dim_names)
    names = tuple(compute_mesh(mesh).mesh_dim_names)
    placements = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        for a in _flat(ax):
            if a not in all_names:
                raise ValueError(
                    f"mesh axis {a!r} of spec {tuple(spec)} is not an axis "
                    f"of the mesh {all_names}")
            if a in names:
                placements[names.index(a)] = Shard(d)
    return tuple(placements)


def logical_sharding(logical_axes, mesh, rules: ShardingRules) -> tuple:
    """The DTensor placements of ``logical_spec(logical_axes, rules)`` on
    ``mesh``: one ``Shard(d)`` or ``Replicate()`` per dim of
    ``compute_mesh(mesh)``."""
    return spec_placements(logical_spec(logical_axes, rules), mesh)


def kept_placements(spec: Sequence, mesh) -> tuple:
    """:func:`spec_placements` with the mesh axes ``mesh`` lacks dropped
    from ``spec`` (the rule of :func:`with_logical_constraint`)."""
    names = set(mesh.mesh_dim_names)
    return spec_placements(tuple(
        tuple(a for a in _flat(ax) if a in names) or None for ax in spec),
        mesh)


def with_logical_constraint(x, logical_axes, rules: ShardingRules):
    """Lay ``x`` out by logical axis names on the active mesh.

    No-op when no mesh is active (single-device use), and mesh axes the
    active mesh doesn't have are dropped — the same model code runs
    unsharded, dp-only, or fully fsdp+tp+sp without edits. A DTensor is
    redistributed (differentiably); a plain tensor is taken as the whole
    value, the same on every rank, and distributed."""
    from torch.distributed.tensor import distribute_tensor

    mesh = get_active_mesh()
    if mesh is None:
        return x
    placements = kept_placements(rules.mesh_axes(logical_axes), mesh)
    if is_dtensor(x):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)
    return distribute_tensor(x, compute_mesh(mesh), placements)


def is_dtensor(x) -> bool:
    # a DTensor exists only once its module is loaded: code that never
    # shards never imports it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over ``trees``, walking ``axes_tree``'s
    structure with its tuples of logical axis names (or None) as leaves."""
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    if isinstance(axes_tree, list):
        return [map_axes(fn, a, *leaves)
                for a, *leaves in zip(axes_tree, *trees)]
    return fn(axes_tree, *trees)


def place_leaf(axes, x, mesh, rules: ShardingRules):
    """``x``, the whole value on every rank, as a DTensor holding this
    rank's shard by its logical ``axes`` (``distribute_tensor``); a
    DTensor is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    pl = logical_sharding(axes or (None,) * x.dim(), mesh, rules)
    if is_dtensor(x):
        return x.detach().redistribute(compute_mesh(mesh), pl)
    return distribute_tensor(x.detach(), compute_mesh(mesh), pl)


def shard_pytree(tree, axes_tree, mesh, rules: ShardingRules):
    """Place every leaf of ``tree`` per its logical axes in ``axes_tree``
    (:func:`place_leaf`).

    ``axes_tree`` has the same structure with tuples of logical axis names
    (or None leaves = fully replicated)."""
    return map_axes(lambda axes, x: place_leaf(axes, x, mesh, rules),
                    axes_tree, tree)

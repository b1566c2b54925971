"""Training step construction (port of ``ray_tpu/models/training.py``).

The optimizer is an own copy of the JAX package's optax chain
``chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine_decay_schedule))``
(``training.py:49-54``), written out from optax 0.2.6's source:

- the schedule's count starts at 0, so with warmup from 0 the first step's
  learning rate is 0;
- Adam's bias correction uses t = count + 1;
- the moments are held in each parameter's dtype (optax's
  ``mu_dtype=None``), and weight decay applies to every leaf (no mask).

The step updates parameters and moments in place — the counterpart of the
JAX step's ``donate_argnums`` — so a step holds one extra copy of the
gradients and nothing else.

With a mesh (:mod:`ray_tpu_torch.parallel`) the parameters are DTensors
placed by logical axes, the moments take their parameter's placements
(:func:`state_shardings`, :func:`_overlay_param_shaped`: ZeRO-style, with
fsdp rules Adam's moments are sharded exactly like the weights), the step
counts are plain ints on every rank (replicated), and the batch is laid
out as ("batch", "seq"). The update is elementwise on each rank's local
shards; only the global gradient norm reduces across ranks. Without a
mesh the functions run on one device as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.parallel.sharding import (ShardingRules, is_dtensor,
                                             logical_sharding, map_axes,
                                             place_leaf, set_mesh,
                                             with_logical_constraint)

Pytree = Any


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage itself under ``no_grad``);
    a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _sq_norm(g: torch.Tensor) -> torch.Tensor:
    """sum(g²) in f32; for a DTensor over the whole tensor, the same on
    every rank."""
    s = g.float().square().sum()
    return s.full_tensor() if is_dtensor(s) else s


def tree_leaves(tree: Pytree) -> List[torch.Tensor]:
    """Tensors of a nested dict/list tree in a fixed order (sorted keys,
    as ``jax.tree`` flattens dicts)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Pytree) -> Pytree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def schedule(self) -> Callable[[int], float]:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup,
        max(decay, warmup + 1), lr * min_lr_ratio)``: linear warmup from 0
        over ``warmup_steps``, then cosine decay to the end value over the
        remaining steps, held there after. Values are float32, as optax
        computes them."""
        peak = self.learning_rate
        warmup = self.warmup_steps
        decay = max(self.decay_steps, self.warmup_steps + 1) - warmup
        end = peak * self.min_lr_ratio
        alpha = 0.0 if peak == 0.0 else end / peak

        def lr(count: int) -> float:
            f32 = torch.float32
            if count < warmup:
                frac = 1 - torch.tensor(count, dtype=f32) / warmup
                return float((0.0 - peak) * frac + peak)
            t = torch.tensor(min(count - warmup, decay), dtype=f32)
            cosine = 0.5 * (1 + torch.cos(math.pi * t / decay))
            return float(peak * ((1 - alpha) * cosine + alpha))

        return lr

    def make(self) -> "AdamW":
        return AdamW(self)


@dataclasses.dataclass
class AdamWState:
    """optax's chain state: Adam's count and moments, and the schedule's
    count (the clip and weight-decay stages hold none)."""

    adam_count: int
    mu: Pytree
    nu: Pytree
    schedule_count: int


class AdamW:
    """``clip_by_global_norm`` then AdamW with a learning-rate schedule,
    updating in place."""

    def __init__(self, config: OptimizerConfig):
        self.config = config
        self.lr = config.schedule()

    def init(self, params: Pytree) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)  # noqa
        return AdamWState(adam_count=0, mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params), schedule_count=0)

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: AdamWState,
                params: Pytree) -> torch.Tensor:
        """Apply one step to ``params`` and ``state`` in place; ``grads``
        are in ``tree_leaves(params)`` order. Returns the global gradient
        norm (before clipping), accumulated in f32."""
        c = self.config
        leaves = [_local(p) for p in tree_leaves(params)]
        mus = [_local(m) for m in tree_leaves(state.mu)]
        nus = [_local(n) for n in tree_leaves(state.nu)]
        g_norm = torch.sqrt(sum(_sq_norm(g) for g in grads))
        grads = [_local(g) for g in grads]
        # clip_by_global_norm: unchanged when the norm is below the limit,
        # else scaled by max_norm / g_norm (in the gradient's dtype)
        clip = g_norm >= c.grad_clip
        count = state.adam_count + 1
        bc1 = 1 - torch.tensor(c.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(c.b2, dtype=torch.float32) ** count
        step = -self.lr(state.schedule_count)
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            g = torch.where(clip, g / g_norm.to(g.dtype) * c.grad_clip, g)
            mu.mul_(c.b1).add_((1 - c.b1) * g)
            nu.mul_(c.b2).add_(g.square().mul_(1 - c.b2))
            u = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + c.eps)
            u = u + c.weight_decay * p
            p.add_(torch.tensor(step, dtype=u.dtype, device=u.device) * u)
        state.adam_count = count
        state.schedule_count += 1
        return g_norm


@dataclasses.dataclass
class TrainState:
    step: int
    params: Pytree
    opt_state: AdamWState


def state_shardings(state_shape: TrainState, param_axes: Pytree, mesh,
                    rules: ShardingRules) -> TrainState:
    """The tree of DTensor placements for a TrainState, derived from the
    parameters' logical axes.

    Optimizer-state leaves whose tree and shapes match the parameters take
    the parameters' placements (Adam's mu and nu); the counts replicate."""
    param_shard = map_axes(lambda axes: logical_sharding(axes, mesh, rules),
                           param_axes)
    replicated = logical_sharding((), mesh, rules)
    opt_shard = _map_leaves(lambda leaf: replicated, state_shape.opt_state)
    # Overlay param-shaped subtrees (Adam mu/nu) with the param placements.
    opt_shard = _overlay_param_shaped(
        state_shape.opt_state, opt_shard, state_shape.params, param_shard)
    return TrainState(step=replicated, params=param_shard,
                      opt_state=opt_shard)


def _map_leaves(fn: Callable, tree: Pytree) -> Pytree:
    """``fn`` over the leaves of dicts, lists, tuples and dataclasses."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _map_leaves(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (dict, list, tuple)):
        return tree_map(lambda leaf: _map_leaves(fn, leaf), tree)
    return fn(tree)


def _structure(tree: Pytree):
    """A comparable description of a tree's nesting (dict keys, sequence
    lengths, dataclass types), leaves left out."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple(
            (f.name, _structure(getattr(tree, f.name)))
            for f in dataclasses.fields(tree)))
    return "*"


def _shapes(tree: Pytree) -> list:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [s for f in dataclasses.fields(tree)
                for s in _shapes(getattr(tree, f.name))]
    return [tuple(getattr(leaf, "shape", ())) if isinstance(
        leaf, torch.Tensor) else None for leaf in tree_leaves(tree)]


def _overlay_param_shaped(opt_shape, opt_shard, params_shape, param_shard):
    """Replace the subtrees of ``opt_shard`` whose structure and shapes
    match the parameter tree with the parameter placements (Adam's mu,
    nu, …)."""
    params_def = _structure(params_shape)
    params_shapes = _shapes(params_shape)

    def rec(shape_node, shard_node):
        if (_structure(shape_node) == params_def
                and _shapes(shape_node) == params_shapes):
            return param_shard
        if isinstance(shape_node, (list, tuple)):
            out = [rec(s, h) for s, h in zip(shape_node, shard_node)]
            return type(shape_node)(out) if not hasattr(
                shape_node, "_fields") else type(shape_node)(*out)
        if isinstance(shape_node, dict):
            return {k: rec(shape_node[k], shard_node[k]) for k in shape_node}
        if dataclasses.is_dataclass(shape_node):
            return type(shape_node)(**{
                f.name: rec(getattr(shape_node, f.name),
                            getattr(shard_node, f.name))
                for f in dataclasses.fields(shape_node)})
        return shard_node

    return rec(opt_shape, opt_shard)


def make_train_step(loss_fn: Callable[[Pytree, Dict[str, torch.Tensor]],
                                      Tuple[torch.Tensor, Dict]],
                    optimizer: AdamW, mesh=None,
                    rules: Optional[ShardingRules] = None) -> Callable:
    """Build the train step ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (loss, metrics)``. Gradients come from one
    backward pass; the parameters and the optimizer moments are updated in
    place (the JAX step donates its state instead), and the same state
    object is returned with ``step`` advanced. ``metrics`` adds
    ``grad_norm`` (before clipping) and ``lr_step`` (the step the update
    was taken at), as the JAX step does.

    The batch's 2-D tensors are laid out as ("batch", "seq") — data
    parallel over dp+fsdp, sequence over sp — which does nothing when no
    mesh is active. With ``mesh``, the step runs under it (the batch may
    be the whole batch, the same on every rank, or DTensors), and each
    gradient of a DTensor parameter is brought to its parameter's
    placements before the update."""
    rules = rules or ShardingRules()

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            batch = {k: with_logical_constraint(v, ("batch", "seq"), rules)
                     if v.dim() == 2 else v for k, v in batch.items()}
            leaves = tree_leaves(state.params)
            loss, metrics = loss_fn(state.params, batch)
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if is_dtensor(p) else g
                     for p, g in zip(leaves, torch.autograd.grad(loss,
                                                                 leaves))]
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
            metrics["grad_norm"] = optimizer.update_(grads, state.opt_state,
                                                     state.params)
        metrics["lr_step"] = state.step
        state.step += 1
        return state, metrics

    return step


def init_train_state(init_params_fn: Callable[[torch.Generator], Pytree],
                     optimizer: AdamW, generator: torch.Generator,
                     device=None, *, param_axes: Optional[Pytree] = None,
                     mesh=None, rules: Optional[ShardingRules] = None):
    """Parameters from ``init_params_fn(generator)``, placed on ``device``
    (CUDA unless the caller asks otherwise) and marked as leaves that take
    gradients, with zero moments beside them.

    With ``mesh`` (and ``param_axes``, the model's logical axes), the
    state is sharded: each leaf of ``init_params_fn``'s tree is placed by
    ``rules`` in turn — a DTensor (``shard_pytree``'s) as it is, so nothing
    whole is made here; a whole tensor is distributed and its entry in the
    tree replaced by this rank's shard, which frees the whole leaf unless
    the caller holds it — and the moments are made as zeros of each
    parameter's local shard. Returns ``(state, shardings)``, the placements
    tree of :func:`state_shardings`, as the JAX function does; without a
    mesh, the state alone."""
    if mesh is None:
        dev = resolve_device(device)
        params = tree_map(lambda t: t.to(dev).requires_grad_(True),
                          init_params_fn(generator))
        return TrainState(step=0, params=params,
                          opt_state=optimizer.init(params))
    if param_axes is None:
        raise ValueError("init_train_state on a mesh needs param_axes")
    rules = rules or ShardingRules()
    params = init_params_fn(generator)
    _place_(params, param_axes, mesh, rules)
    state = TrainState(step=0, params=params,
                       opt_state=optimizer.init(params))
    shardings = state_shardings(state, param_axes, mesh, rules)
    return state, shardings


def _place_(tree: dict, axes: dict, mesh, rules: ShardingRules) -> None:
    """Replace each leaf of ``tree`` (dicts, in place) by its DTensor on
    ``mesh``, one leaf at a time, taking gradients."""
    for k in list(tree):
        if isinstance(tree[k], dict):
            _place_(tree[k], axes[k], mesh, rules)
        else:
            tree[k] = place_leaf(axes[k], tree[k], mesh,
                                 rules).requires_grad_(True)

"""Training step construction (port of ``ray_tpu/models/training.py``) on
one device.

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
gradients and nothing else. The mesh, sharding rules, ``state_shardings``
and ``_overlay_param_shaped`` belong to the parallel slice (ROADMAP item
12) and are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from ray_tpu_torch import resolve_device

Pytree = Any


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
        leaves = tree_leaves(params)
        mus, nus = tree_leaves(state.mu), tree_leaves(state.nu)
        g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
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


def make_train_step(loss_fn: Callable[[Pytree, Dict[str, torch.Tensor]],
                                      Tuple[torch.Tensor, Dict]],
                    optimizer: AdamW) -> Callable:
    """Build the train step ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (loss, metrics)``. Gradients come from one
    backward pass; the parameters and the optimizer moments are updated in
    place (the JAX step donates its state instead), and the same state
    object is returned with ``step`` advanced. ``metrics`` adds
    ``grad_norm`` (before clipping) and ``lr_step`` (the step the update
    was taken at), as the JAX step does."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        loss, metrics = loss_fn(state.params, batch)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.update_(list(grads),
                                                 state.opt_state,
                                                 state.params)
        metrics["lr_step"] = state.step
        state.step += 1
        return state, metrics

    return step


def init_train_state(init_params_fn: Callable[[torch.Generator], Pytree],
                     optimizer: AdamW, generator: torch.Generator,
                     device=None) -> TrainState:
    """Parameters from ``init_params_fn(generator)``, placed on ``device``
    (CUDA unless the caller asks otherwise) and marked as leaves that take
    gradients, with zero moments beside them."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev).requires_grad_(True),
                      init_params_fn(generator))
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))

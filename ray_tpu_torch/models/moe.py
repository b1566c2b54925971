"""Mixture-of-Experts decoder, Mixtral-style (port of
``ray_tpu/models/moe.py``).

The Llama backbone (:mod:`ray_tpu_torch.models.llama`: attention, norms,
RoPE, the head) with each layer's MLP replaced by ``n_experts`` stacked
expert FFNs, top-k softmax gating and GShard static capacity: every shape
is fixed by the token count, and a token over an expert's capacity rides
the residual stream untouched. The Switch load-balancing loss and the
router z-loss are averaged over the layers and added to the cross entropy
by :func:`loss_fn`, whose contract is ``llama.loss_fn``'s, so
``training.make_train_step`` takes it unchanged.

Dispatch ``tec,th->ech`` and combine ``tec,ech->th`` are matrix products
over the flattened (token, expert·slot) axes, and the expert FFN
``ech,ehm->ecm`` a ``torch.bmm`` over the stacked (E, H, M) weights, as the
JAX package computes them outside any Pallas kernel.

Expert parallelism: on DTensor parameters
(:func:`ray_tpu_torch.parallel.sharding.shard_pytree`, the stacked experts
on the ``expert`` logical axis, which the rule tables map to fsdp × sp),
``forward`` and ``loss_fn`` lay activations out at the JAX package's
``with_logical_constraint`` points and DTensor inserts the collectives:
the flattened tokens at ("tokens", "embed"), dispatch and combine at
("tokens", None, None), the expert inputs and outputs at ("expert", None,
"embed"), so the dispatch product ends in a reduce-scatter onto each
rank's experts and the expert products run on each rank's own experts.
Routing needs every token's logits in token order (capacity is claimed
in that order), so the (T, E) router logits are gathered to every rank
and the routing runs on that local copy, the same on each rank; the
dispatch and combine tensors it gives enter DTensor as replicated values.
Attention is llama's sharded path (with ``sp_axis`` its ring), whose
kernels see local shards only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import llama
from ray_tpu_torch.models.remat import remat
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import rope_frequencies
from ray_tpu_torch.parallel.sharding import (ShardingRules, is_dtensor,
                                             with_logical_constraint)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    base: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.CONFIGS["tiny"])
    n_experts: int = 8
    top_k: int = 2
    # per-expert slots = ceil(top_k * tokens / n_experts * capacity_factor)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_z_coef: float = 1e-3

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(
            self.top_k * tokens * self.capacity_factor / self.n_experts))

    def _dense_params(self) -> int:
        return llama.LlamaConfig.num_params(
            dataclasses.replace(self.base, mlp_dim=0))

    def num_params(self) -> int:
        c = self.base
        experts = self.n_experts * 3 * c.hidden * c.mlp_dim * c.n_layers
        router = c.hidden * self.n_experts * c.n_layers
        return self._dense_params() + experts + router

    def active_params(self) -> int:
        """Params touched per token (what FLOPs scale with)."""
        c = self.base
        experts = self.top_k * 3 * c.hidden * c.mlp_dim * c.n_layers
        router = c.hidden * self.n_experts * c.n_layers
        return self._dense_params() + experts + router

    def flops_per_token(self, seq: Optional[int] = None) -> float:
        c = self.base
        seq = c.max_seq if seq is None else seq
        return 6.0 * self.active_params() + 6.0 * c.n_layers * seq * c.q_dim


CONFIGS: Dict[str, MoEConfig] = {
    "debug": MoEConfig(base=llama.CONFIGS["debug"], n_experts=4, top_k=2),
    "tiny": MoEConfig(base=llama.CONFIGS["tiny"], n_experts=8, top_k=2),
    # Mixtral-8x7B-ish shapes on the Llama-8B backbone
    "8x7b": MoEConfig(base=dataclasses.replace(
        llama.CONFIGS["8b"], hidden=4096, n_layers=32, mlp_dim=14336),
        n_experts=8, top_k=2),
}


def param_logical_axes(config: MoEConfig) -> Params:
    axes = llama.param_logical_axes(config.base)
    layer_axes = dict(axes["layers"])
    for name in ("w_gate", "w_up", "w_down"):
        layer_axes.pop(name)
    layer_axes.update({
        "router": ("layers", "embed", None),
        "we_gate": ("layers", "expert", "embed_fsdp", "mlp"),
        "we_up": ("layers", "expert", "embed_fsdp", "mlp"),
        "we_down": ("layers", "expert", "mlp", "embed_fsdp"),
    })
    axes["layers"] = layer_axes
    return axes


def init_params(config: MoEConfig, generator: torch.Generator,
                device=None) -> Params:
    """The Llama backbone's weights without its dense MLP, and per layer an
    f32 router (H, E) and the stacked experts (E, H, M), (E, M, H), drawn
    by the JAX package's rules (truncated normal, the down projection
    scaled by ``(2 L)^-1/2``; the router rounded to the model's dtype, then
    held in f32: gate order is precision-sensitive). As in
    ``llama.init_params``, draws come from ``generator`` on ``device``."""
    c = config.base
    dev = torch.device(device) if device is not None else generator.device
    params = llama.init_params(dataclasses.replace(c, mlp_dim=0), generator,
                               dev)
    layers = params["layers"]
    for name in ("w_gate", "w_up", "w_down"):
        layers.pop(name)
    std = c.hidden ** -0.5
    out_std = std / (2 * c.n_layers) ** 0.5
    L, E, H, M = c.n_layers, config.n_experts, c.hidden, c.mlp_dim

    def tn(shape, s):
        return llama.trunc_normal(shape, s, c.dtype, dev, generator, True)

    layers["router"] = tn((L, H, E), std).float()
    layers["we_gate"] = tn((L, E, H, M), std)
    layers["we_up"] = tn((L, E, H, M), std)
    layers["we_down"] = tn((L, E, M, H), out_std)
    return params


def _route(xt: torch.Tensor, router: torch.Tensor, config: MoEConfig):
    """Top-k routing of the (T, H) tokens with static capacity C: returns
    the f32 router logits (T, E), and what :func:`_route_logits` gives
    for them."""
    logits = xt.float() @ router
    return (logits, *_route_logits(logits, config))


def _route_logits(logits: torch.Tensor, config: MoEConfig):
    """Top-k routing of the f32 router logits (T, E) with static capacity
    C: returns the probabilities, the k-choices' gate weights and experts
    (T, K), the 0/1 dispatch and the gate-weighted combine tensors
    (T, E, C) in f32, and each expert's share of all top-k assignments
    (E,).

    The k-th choices claim capacity after the (k-1)-th, each in token
    order (GShard). Ties go to the lower expert index, as in
    ``jax.lax.top_k``: a stable descending sort. A token over capacity gets
    an all-zero slot row (``jax.nn.one_hot`` of an index past C), built by
    comparison since ``F.one_hot`` refuses such indices."""
    T = logits.shape[0]
    E, K = config.n_experts, config.top_k
    C = config.capacity(T)
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :K], top_idx[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)

    slots = torch.arange(C, device=dev)
    dispatch = combine = torch.zeros((T, E, C), dtype=torch.float32,
                                     device=dev)
    counts = torch.zeros((E,), dtype=torch.long, device=dev)
    frac = torch.zeros((E,), dtype=torch.float32, device=dev)
    for k in range(K):
        mask = F.one_hot(top_idx[:, k], E)                        # (T, E)
        pos = counts[None, :] + torch.cumsum(mask, dim=0) - mask
        pos_t = (pos * mask).sum(-1)                              # (T,)
        kept = (pos_t < C) & (mask.sum(-1) > 0)
        counts = counts + mask.sum(0)
        slot = ((pos_t[:, None] == slots[None, :]) & kept[:, None]).float()
        maskf = mask.float()[:, :, None]
        dispatch = dispatch + maskf * slot[:, None, :]
        combine = combine + maskf * (slot * top_w[:, k, None])[:, None, :]
        frac = frac + mask.sum(0) / T
    return probs, top_w, top_idx, dispatch, combine, frac


def _router_metrics(logits, probs, frac, dropped, config: MoEConfig):
    """The Switch aux loss, E Σ_e (share of top-k assignments)_e · mean
    prob_e, minimised by uniform routing (the share counts assignments
    before any drop); the router z-loss; and ``dropped``, the share of
    (token, k) slots dropped at capacity. Taken after the expert
    products, as in the JAX package: a recomputing backward then stops
    at the combine product's input."""
    E, K = config.n_experts, config.top_k
    aux = E * ((frac / K) * probs.mean(0)).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return {"aux": aux, "router_z": z, "dropped": dropped}


def _experts(expert_in, layer: Params, dtype):
    """The expert FFN ``ech,ehm->ecm``, silu-gated, and ``ecm,emh->ech``:
    (E, C, H) → (E, C, H)."""
    g = torch.bmm(expert_in, layer["we_gate"].to(dtype))
    u = torch.bmm(expert_in, layer["we_up"].to(dtype))
    return torch.bmm(F.silu(g) * u, layer["we_down"].to(dtype))


def _moe_mlp(x: torch.Tensor, layer: Params, config: MoEConfig,
             rules: Optional[ShardingRules] = None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Top-k routed expert FFN with static capacity: x (B, S, H) → (B, S,
    H), and the router's aux, z and dropped metrics. Dispatch and combine
    are built in f32 and rounded to the activation dtype before their
    products, as in the JAX package, so bf16 gate weights are rounded."""
    if is_dtensor(x):
        return _moe_mlp_sharded(x, layer, config, rules or ShardingRules())
    B, S, H = x.shape
    T, E, K = B * S, config.n_experts, config.top_k
    xt = x.reshape(T, H)
    logits, probs, _, _, dispatch, combine, frac = _route(
        xt, layer["router"], config)
    C = dispatch.shape[-1]
    # the dropped share reads the f32 dispatch; only the rounded copies of
    # the (T, E, C) tensors live on to the products
    dropped = 1.0 - dispatch.sum() / (T * K)
    dispatch_x = dispatch.to(x.dtype).reshape(T, E * C)
    del dispatch
    combine_x = combine.to(x.dtype).reshape(T, E * C)
    del combine
    expert_in = (dispatch_x.T @ xt).reshape(E, C, H)             # tec,th
    y = _experts(expert_in, layer, x.dtype)                       # (E, C, H)
    out = combine_x @ y.reshape(E * C, H)                         # tec,ech
    return out.reshape(B, S, H), _router_metrics(logits, probs, frac,
                                                 dropped, config)


def _moe_mlp_sharded(x, layer: Params, config: MoEConfig,
                     rules: ShardingRules):
    """:func:`_moe_mlp` on DTensor activations and parameters. The router
    logits of the token shards are gathered to every rank, where the
    routing and the router metrics run on that local copy (plain tensors,
    the same on each rank); dispatch and combine re-enter DTensor as
    replicated values laid out at ("tokens", None, None), so every product
    and its collectives is DTensor's."""
    from torch.distributed.tensor import Replicate

    from ray_tpu_torch.models.llama import _from_local

    B, S, H = x.shape
    T, E, K = B * S, config.n_experts, config.top_k
    dmesh = x.device_mesh
    # the flattened token layout, the merge of the batch and seq
    # shardings (the JAX package's constraint at this point)
    xt = with_logical_constraint(x.reshape(T, H), ("tokens", "embed"), rules)
    replicated = [Replicate()] * dmesh.ndim
    logits = (xt.float() @ layer["router"]).redistribute(
        dmesh, replicated).to_local()
    probs, _, _, dispatch, combine, frac = _route_logits(logits, config)
    C = dispatch.shape[-1]
    dropped = 1.0 - dispatch.sum() / (T * K)

    def placed(t):
        t = _from_local(t.to(x.dtype), dmesh, replicated, (T, E, C))
        return with_logical_constraint(t, ("tokens", None, None),
                                       rules).reshape(T, E * C)

    dispatch_x, combine_x = placed(dispatch), placed(combine)
    del dispatch, combine
    expert_in = (dispatch_x.T @ xt).reshape(E, C, H)             # tec,th
    expert_in = with_logical_constraint(expert_in, ("expert", None, "embed"),
                                        rules)
    y = _experts(expert_in, layer, x.dtype)
    y = with_logical_constraint(y, ("expert", None, "embed"), rules)
    out = combine_x @ y.reshape(E * C, H)                         # tec,ech
    return out.reshape(B, S, H), _router_metrics(logits, probs, frac,
                                                 dropped, config)


def forward(params: Params, tokens: torch.Tensor, config: MoEConfig,
            rules: Optional[ShardingRules] = None,
            positions: Optional[torch.Tensor] = None, mesh=None):
    """tokens (B, S) integer → (logits (B, S, V) f32, the router metrics
    averaged over the layers).

    On DTensor parameters the logits are a DTensor at ("batch", "seq",
    "vocab") under ``rules`` and the metrics plain tensors, the same on
    every rank; ``mesh`` is needed for the sequence-parallel (ring
    attention) path only, and ``sp_axis`` refuses without it."""
    c = config.base
    rules = rules or ShardingRules()
    llama.check_sp_axis(c, mesh)
    with llama._mesh_context(params):
        x = llama._embed(params, tokens.long(), c, rules)
        cos, sin = rope_frequencies(
            c.head_dim, c.max_seq, c.rope_theta,
            device=(x.to_local() if is_dtensor(x) else x).device)

        def block(x, layer):
            x = x + llama._attention(
                rmsnorm(x, layer["attn_norm"], c.norm_eps), layer, cos, sin,
                c, rules, mesh, positions)
            x = llama._constrain(x, ("batch", "seq", "embed"), rules)
            h, metrics = _moe_mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps),
                                  layer, config, rules)
            x = llama._constrain(x + h, ("batch", "seq", "embed"), rules)
            return x, metrics

        if c.remat:
            block = remat(block, c.remat_policy)
        names = list(params["layers"])
        per_layer = []
        for ws in zip(*(params["layers"][n].unbind(0) for n in names)):
            x, metrics = block(x, dict(zip(names, ws)))
            per_layer.append(metrics)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        head = params["embed"].T if c.tie_embeddings else params["lm_head"]
        logits = llama._head(x, head, rules)
    return logits, {k: torch.stack([m[k] for m in per_layer]).mean()
                    for k in per_layer[0]}


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: MoEConfig, rules: Optional[ShardingRules] = None,
            mesh=None):
    """Next-token cross entropy plus the router's auxiliary losses; the
    batch and the result as in ``llama.loss_fn`` (plain tensors also on
    DTensor parameters), with the metrics ``ce``, ``aux_loss``,
    ``router_z`` and ``dropped_frac`` besides."""
    rules = rules or ShardingRules()
    with llama._mesh_context(params):
        tokens = with_logical_constraint(batch["tokens"].long(),
                                         ("batch", "seq"), rules)
        logits, moe = forward(params, tokens, config, rules, mesh=mesh)
        nll, correct, denom = llama._summed_terms(
            logits, tokens, batch.get("mask"), rules)
    denom = denom.clamp(min=1.0)
    ce = nll / denom
    loss = (ce + config.aux_loss_coef * moe["aux"]
            + config.router_z_coef * moe["router_z"])
    return loss, {"loss": loss, "ce": ce, "accuracy": correct / denom,
                  "tokens": denom, "aux_loss": moe["aux"],
                  "router_z": moe["router_z"],
                  "dropped_frac": moe["dropped"]}

"""Llama-family decoder-only transformer: configuration and parameters
(port of ``ray_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the JAX package's layout — layer
weights stacked on a leading ``layers`` axis (``wq`` is (L, E, H, D), …) —
so weights converted from the JAX pytree (:mod:`ray_tpu_torch.models.convert`)
load 1:1. ``forward`` and ``loss_fn`` are the training path: a Python loop
over the layers (the counterpart of ``lax.scan``), each layer under
``torch.utils.checkpoint`` with ``remat_policy`` when ``remat`` is set
(:mod:`ray_tpu_torch.models.remat`), attention through
:func:`ray_tpu_torch.ops.attention.flash_attention` (kernels K1, K2a, K2b on
the card). The MoE and ViT families (:mod:`~ray_tpu_torch.models.moe`,
:mod:`~ray_tpu_torch.models.vit`) reuse its attention, head and init.
Serving runs its own prefill and decode step
(:mod:`ray_tpu_torch.models.paged_cache`, :mod:`ray_tpu_torch.models.decoding`).

Sharded training: when the parameters are DTensors
(:func:`ray_tpu_torch.parallel.sharding.shard_pytree`), ``forward`` and
``loss_fn`` lay activations out by logical axes with ``rules``, as the JAX
package's ``with_logical_constraint`` calls do, and DTensor inserts the
collectives. What has no DTensor rule runs on local shards between
``to_local`` and ``from_local``: the embedding gather (from a replicated
table view), RoPE and attention (K1 and ``flash_bwd_kernel`` on the card),
the f32 head and the loss's per-row terms. With ``sp_axis`` set and a
``mesh`` given, attention is :func:`ray_tpu_torch.ops.ring_attention.ring_attention`
over the sequence chunks of ``sp_axis``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.models.remat import remat
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel.sharding import (ShardingRules, get_active_mesh,
                                             is_dtensor, kept_placements,
                                             set_mesh,
                                             with_logical_constraint)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    max_seq: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16   # activation / weight dtype
    remat: bool = True              # checkpoint each layer
    # "nothing" (recompute the whole layer in the backward) or "dots" (keep
    # the outputs of the weight products): models/remat.py
    remat_policy: str = "nothing"
    attn_block: int = 512           # tile of the plain flash backward
    # Ring/sequence-parallel attention over this mesh axis; needs the
    # mesh passed to forward/loss_fn.
    sp_axis: Optional[str] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    def flops_per_token(self, seq: Optional[int] = None) -> float:
        """Training FLOPs/token: 6·N (fwd+bwd matmuls) + causal attention
        (per layer fwd: QKᵀ and P·V are 4·S·d, halved by causality → 2·S·d;
        ×3 for fwd+bwd → 6·L·S·d). The single source of truth for MFU."""
        seq = self.max_seq if seq is None else seq
        return (6.0 * self.num_params()
                + 6.0 * self.n_layers * seq * self.q_dim)

    def num_params(self) -> int:
        p = self.vocab_size * self.hidden                        # embed
        per_layer = (
            self.hidden * self.q_dim                             # wq
            + 2 * self.hidden * self.n_kv_heads * self.head_dim  # wk, wv
            + self.q_dim * self.hidden                           # wo
            + 3 * self.hidden * self.mlp_dim                     # gate/up/down
            + 2 * self.hidden                                    # norms
        )
        p += self.n_layers * per_layer + self.hidden             # final norm
        if not self.tie_embeddings:
            p += self.hidden * self.vocab_size                   # lm head
        return p


# Named configs, the same names and shapes as the JAX package's.
CONFIGS: Dict[str, LlamaConfig] = {
    "debug": LlamaConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, head_dim=16, mlp_dim=128, max_seq=128,
                         dtype=torch.float32, remat=False),
    "tiny": LlamaConfig(vocab_size=32000, hidden=512, n_layers=4, n_heads=8,
                        n_kv_heads=4, head_dim=64, mlp_dim=1408, max_seq=2048),
    "1b": LlamaConfig(vocab_size=128256, hidden=2048, n_layers=16, n_heads=32,
                      n_kv_heads=8, head_dim=64, mlp_dim=8192, max_seq=8192),
    "8b": LlamaConfig(),  # Llama-3-8B shapes
    "70b": LlamaConfig(hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       head_dim=128, mlp_dim=28672),
}


def param_logical_axes(config: LlamaConfig) -> Params:
    """The tree of :func:`init_params` with a tuple of logical axis names
    for each leaf, as the JAX package names them (``llama.py:100``), read
    by :mod:`ray_tpu_torch.parallel.sharding`'s rules."""
    axes = {
        "embed": ("embed_vocab", "embed_fsdp"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed_fsdp", "heads", "head_dim"),
            "wk": ("layers", "embed_fsdp", "kv_heads", "head_dim"),
            "wv": ("layers", "embed_fsdp", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed_fsdp"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed_fsdp", "mlp"),
            "w_up": ("layers", "embed_fsdp", "mlp"),
            "w_down": ("layers", "mlp", "embed_fsdp"),
        },
        "final_norm": ("embed",),
    }
    if not config.tie_embeddings:
        axes["lm_head"] = ("embed_fsdp", "vocab")
    return axes


def trunc_normal(shape, std: float, dtype: torch.dtype, device,
                 generator: torch.Generator,
                 stacked: bool = False) -> torch.Tensor:
    """A (±3σ) truncated normal of ``std``, drawn in f32 and rounded to
    ``dtype`` (the JAX package's ``tn``). With ``stacked`` the draw is
    made one slice of the leading axis at a time, so that at most one
    layer's f32 draw is held beside the result."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in (out if stacked else [out]):
        tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0,
                                    generator=generator)
        part.copy_(tmp.mul_(std))
    return out


def init_params(config: LlamaConfig, generator: torch.Generator,
                device=None) -> Params:
    """Truncated-normal init (±3σ) with scaled residual projections, zero
    norms — the JAX package's rules. Draws come from ``generator``, which
    must live on ``device``; tensors are made there one layer at a time,
    so an 8b init never passes through the CPU and holds at most one
    layer's f32 draw beside the weights. ``jax.random`` streams cannot be
    reproduced here: to run both packages on the same weights, convert
    the JAX tree (:func:`ray_tpu_torch.models.convert.params_from_jax`)."""
    c = config
    dev = torch.device(device) if device is not None else generator.device
    dt = c.dtype
    L = c.n_layers
    std = c.hidden ** -0.5
    out_std = std / (2 * c.n_layers) ** 0.5

    def tn(shape, s, stacked=False):
        return trunc_normal(shape, s, dt, dev, generator, stacked)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    params: Params = {
        "embed": tn((c.vocab_size, c.hidden), std),
        "layers": {
            "attn_norm": zeros((L, c.hidden)),
            "wq": tn((L, c.hidden, c.n_heads, c.head_dim), std, True),
            "wk": tn((L, c.hidden, c.n_kv_heads, c.head_dim), std, True),
            "wv": tn((L, c.hidden, c.n_kv_heads, c.head_dim), std, True),
            "wo": tn((L, c.n_heads, c.head_dim, c.hidden), out_std, True),
            "mlp_norm": zeros((L, c.hidden)),
            "w_gate": tn((L, c.hidden, c.mlp_dim), std, True),
            "w_up": tn((L, c.hidden, c.mlp_dim), std, True),
            "w_down": tn((L, c.mlp_dim, c.hidden), out_std, True),
        },
        "final_norm": zeros((c.hidden,)),
    }
    if not c.tie_embeddings:
        params["lm_head"] = tn((c.hidden, c.vocab_size), std)
    return params


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s weights, as views into the stacked ``layers`` dict
    (the torch counterpart of one ``scan`` step's slice)."""
    return {name: w[i] for name, w in params["layers"].items()}


def _proj(x: torch.Tensor, w: torch.Tensor, k_dims: int) -> torch.Tensor:
    """Contract the last ``k_dims`` dims of ``x`` with the first of ``w``
    as one matrix product over row-major views (``torch.einsum`` would
    copy the (E, H, D) weights into another layout on every call). bf16
    operands give a bf16 result, as the JAX einsums do."""
    k = 1
    for n in w.shape[:k_dims]:
        k *= n
    lead, tail = x.shape[:x.dim() - k_dims], w.shape[k_dims:]
    y = x.reshape(-1, k) @ w.to(x.dtype).reshape(k, -1)
    return y.reshape(*lead, *tail)


def _qkv(h: torch.Tensor, layer: Params):
    """(B, S, E) → q (B, S, H, D), k and v (B, S, KV, D) — the JAX
    package's ``bse,ehd->bshd`` einsums."""
    return (_proj(h, layer["wq"], 1), _proj(h, layer["wk"], 1),
            _proj(h, layer["wv"], 1))


def _attn_out(out: torch.Tensor, layer: Params) -> torch.Tensor:
    """``bshd,hde->bse``."""
    return _proj(out, layer["wo"], 2)


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    g = _proj(x, layer["w_gate"], 1)
    u = _proj(x, layer["w_up"], 1)
    return _proj(torch.nn.functional.silu(g) * u, layer["w_down"], 1)


def head_f32(params: Params, config: LlamaConfig) -> torch.Tensor:
    """The (E, vocab) output head in f32. Decode and prefill logits are
    f32 × f32, as in the JAX package; serving makes this copy once per
    engine (2.1 GB at 8b) rather than casting the head every step."""
    head = (params["embed"].T if config.tie_embeddings
            else params["lm_head"])
    return head.float()


# ------------------------------------------------------------ training path

class _HeadF32(torch.autograd.Function):
    """logits = x @ head with bf16 operands and f32 results on the card
    (``torch.mm(..., out_dtype=torch.float32)``, which has no autograd
    formula of its own). The backward rounds the f32 cotangent to bf16 and
    takes both products in bf16 with f32 accumulation, as the TPU does for
    the f32 × bf16 products of the JAX transpose at default precision."""

    @staticmethod
    def forward(ctx, x, head):
        ctx.save_for_backward(x, head)
        return torch.mm(x, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, head = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ head.T, x.T @ g


def _head_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(B, S, E) × (E, vocab) → f32 logits: the JAX package's bf16 operands
    with f32 accumulation (``llama.py:244``). On the CPU, and for f32
    models, the operands are taken in f32, which gives the same products
    (a bf16 value is exact in f32)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.bfloat16 and x.device.type == "cuda":
        logits = _HeadF32.apply(x2, head.to(x.dtype))
    else:
        logits = x2.float() @ head.float()
    return logits.reshape(*lead, -1)


def _attention(x, layer, cos, sin, config: LlamaConfig,
               rules: Optional[ShardingRules] = None, mesh=None,
               positions=None):
    """Causal self-attention of one layer; ``positions`` (B, S) places
    RoPE at those positions instead of 0..S-1 (unsharded activations
    only)."""
    if is_dtensor(x):
        if positions is not None:
            raise NotImplementedError(
                "positions= on sharded activations is not ported: RoPE "
                "takes each sequence chunk's own offsets there")
        return _attention_sharded(x, layer, cos, sin, config, rules, mesh)
    q, k, v = _qkv(x, layer)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    out = flash_attention(q, k, v, causal=True, block=config.attn_block)
    return _attn_out(out, layer)


def check_sp_axis(config: LlamaConfig, mesh=None) -> None:
    """Ring attention over ``config.sp_axis`` needs the mesh whose axis
    that is: without one, ``sp_axis`` refuses."""
    if config.sp_axis is not None and mesh is None:
        raise NotImplementedError(
            f"sp_axis={config.sp_axis!r} (ring attention) needs a mesh: "
            f"pass mesh= with parameters placed by shard_pytree")


def make_block(config: LlamaConfig, cos, sin,
               rules: Optional[ShardingRules] = None, mesh=None):
    """The transformer block ``block(x, layer) -> x`` (the JAX package's
    scanned block). With ``remat`` the layer runs under
    ``torch.utils.checkpoint`` with ``remat_policy``
    (:func:`ray_tpu_torch.models.remat.remat`): "nothing" keeps only its
    input and recomputes the layer, flash forward included; "dots" also
    keeps the outputs of its weight products. On DTensors the residual
    stream is held at ("batch", "seq", "embed") under ``rules``."""
    c = config
    check_sp_axis(c, mesh)
    rules = rules or ShardingRules()

    def block(x, layer):
        x = x + _attention(rmsnorm(x, layer["attn_norm"], c.norm_eps), layer,
                           cos, sin, c, rules, mesh)
        x = _constrain(x, ("batch", "seq", "embed"), rules)
        x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
        return _constrain(x, ("batch", "seq", "embed"), rules)

    return remat(block, c.remat_policy) if c.remat else block


# ------------------------------------------------------------ sharded path

def _constrain(x, axes, rules: ShardingRules):
    return with_logical_constraint(x, axes, rules) if is_dtensor(x) else x


def _logical(mesh, rules: ShardingRules, axes) -> tuple:
    return kept_placements(rules.mesh_axes(axes), mesh)


def _local_in(x, out_placements):
    """``x``'s local shard for a computation on local shards whose result
    takes ``out_placements``: on a mesh dim where ``x`` is replicated but
    the result is split, each rank's gradient is a partial sum."""
    from torch.distributed.tensor import Partial

    grad = [Partial() if p.is_replicate() and o.is_shard() else p
            for p, o in zip(x.placements, out_placements)]
    return x.to_local(grad_placements=grad)


def _from_local(t, mesh, placements, shape):
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, shape=torch.Size(shape),
                              stride=stride)


def _attention_sharded(x, layer, cos, sin, c: LlamaConfig,
                       rules: ShardingRules, mesh):
    """Attention on DTensor activations: q/k/v laid out as ("batch", seq,
    heads, head_dim), seq split over ``sp_axis`` for ring attention and
    whole otherwise; RoPE (at each chunk's positions) and the attention
    itself run on the local shards."""
    dmesh = x.device_mesh
    q, k, v = _qkv(x, layer)
    seq = c.sp_axis
    q_pl = kept_placements((rules.batch, seq, rules.heads, None), dmesh)
    kv_pl = kept_placements((rules.batch, seq, rules.kv_heads, None), dmesh)
    ql = q.redistribute(dmesh, q_pl).to_local()
    kl = k.redistribute(dmesh, kv_pl).to_local()
    vl = v.redistribute(dmesh, kv_pl).to_local()
    s_local = ql.shape[1]
    off = 0
    if seq is not None and seq in dmesh.mesh_dim_names:
        off = dmesh.get_local_rank(seq) * s_local
    cs, sn = cos[off:off + s_local], sin[off:off + s_local]
    ql, kl = apply_rope(ql, cs, sn), apply_rope(kl, cs, sn)
    if seq is not None:
        from ray_tpu_torch.ops.ring_attention import ring_attention

        out = ring_attention(ql, kl, vl, mesh, causal=True, sp_axis=seq,
                             heads_axis=rules.heads, batch_axes=rules.batch,
                             block=c.attn_block)
    else:
        out = flash_attention(ql, kl, vl, causal=True, block=c.attn_block)
    # the attention's (B, S, H, D) view of its (B, H, S, D) result: DTensor
    # reshapes its local shard as a view, so the shard must be contiguous
    out = _from_local(out.contiguous(), dmesh, q_pl, q.shape)
    return _attn_out(out, layer)


def _embed(params: Params, tokens, c: LlamaConfig, rules: ShardingRules):
    """The embedding gather. On a DTensor table: from a replicated view of
    the table (the JAX package's ``("embed_vocab", "embed")``
    constraint), on local tokens."""
    table = params["embed"]
    if not is_dtensor(table):
        return table.to(c.dtype)[tokens]
    dmesh = table.device_mesh
    table = table.redistribute(dmesh, _logical(dmesh, rules,
                                               ("embed_vocab", "embed")))
    x_pl = _logical(dmesh, rules, ("batch", "seq", "embed"))
    tok = with_logical_constraint(tokens, ("batch", "seq"),
                                  rules).to_local()
    x = _local_in(table, x_pl).to(c.dtype)[tok]
    return _from_local(x, dmesh, x_pl,
                       (*tokens.shape, table.shape[-1]))


def _head(x, head, rules: ShardingRules):
    """f32 logits (B, S, vocab). On DTensors: at ("batch", "seq",
    "vocab"), from the head gathered over its embed dim, on local
    shards."""
    if not is_dtensor(x):
        return _head_logits(x, head)
    dmesh = x.device_mesh
    out_pl = _logical(dmesh, rules, ("batch", "seq", "vocab"))
    head = head.redistribute(dmesh, _logical(dmesh, rules,
                                             ("embed", "vocab")))
    x = with_logical_constraint(x, ("batch", "seq", "embed"), rules)
    logits = _head_logits(_local_in(x, out_pl), _local_in(head, out_pl))
    return _from_local(logits, dmesh, out_pl,
                       (*x.shape[:-1], head.shape[-1]))


def _mesh_context(params: Params):
    """On DTensor parameters, their mesh made active unless one already
    is."""
    if not is_dtensor(params["embed"]) or get_active_mesh() is not None:
        return contextlib.nullcontext()
    return set_mesh(params["embed"].device_mesh)


def forward(params: Params, tokens: torch.Tensor, config: LlamaConfig,
            rules: Optional[ShardingRules] = None, *,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) integer → logits (B, S, vocab) float32.

    On DTensor parameters the logits are a DTensor at ("batch", "seq",
    "vocab") under ``rules``; ``mesh`` is needed for the sequence-parallel
    (ring attention) path only."""
    c = config
    rules = rules or ShardingRules()
    with _mesh_context(params):
        x = _embed(params, tokens.long(), c, rules)
        cos, sin = rope_frequencies(
            c.head_dim, c.max_seq, c.rope_theta,
            device=(x.to_local() if is_dtensor(x) else x).device)
        block = make_block(c, cos, sin, rules, mesh)
        # One unbind per stacked weight, as scan slices its xs: its
        # backward stacks the layers' gradients once, where indexing each
        # layer would scatter every layer's gradient into a zeroed
        # full-size copy and sum n_layers of them.
        names = list(params["layers"])
        for ws in zip(*(params["layers"][n].unbind(0) for n in names)):
            x = block(x, dict(zip(names, ws)))
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        head = params["embed"].T if c.tie_embeddings else params["lm_head"]
        return _head(x, head, rules)


def _token_terms(logits, tokens, mask):
    """Per-row sums of the loss: (nll · mask, correct · mask, mask) over
    the next-token predictions of (B, S) rows."""
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    mask = (torch.ones_like(targets, dtype=torch.float32) if mask is None
            else mask[:, :-1].float())
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return ((nll * mask).sum(), ((logits.argmax(-1) == targets) * mask).sum(),
            mask.sum())


def _summed_terms(logits, tokens, mask, rules: ShardingRules):
    """:func:`_token_terms` of the whole batch. On DTensor logits each
    rank takes the terms of its rows (whole sequences, whole vocab) and
    the sums are reduced over the batch's mesh axes into plain tensors,
    the same on every rank."""
    if not is_dtensor(logits):
        return _token_terms(logits, tokens, mask)
    from torch.distributed.tensor import Partial, Replicate

    dmesh = logits.device_mesh
    rows = _logical(dmesh, rules, ("batch", None, None))
    local = lambda t, axes: with_logical_constraint(  # noqa: E731
        t, ("batch", "seq"), rules).redistribute(
        dmesh, _logical(dmesh, rules, axes)).to_local()
    if mask is not None:
        mask = local(mask, ("batch", None))
    terms = _token_terms(logits.redistribute(dmesh, rows).to_local(),
                         local(tokens, ("batch", None)), mask)
    summed = [Partial() if p.is_shard() else Replicate() for p in rows]
    return (_from_local(t.reshape(1), dmesh, summed, (1,)).full_tensor()[0]
            for t in terms)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig, rules: Optional[ShardingRules] = None, *,
            mesh=None):
    """Next-token cross entropy.

    ``batch``: {"tokens": (B, S) integer, optional "mask": (B, S) 0/1 —
    mask[i] gates the loss at step i, predicting token i+1; the last
    position's mask is unused}. Returns (loss, {"loss", "accuracy",
    "tokens"}), plain tensors also on DTensor parameters."""
    rules = rules or ShardingRules()
    with _mesh_context(params):
        tokens = with_logical_constraint(batch["tokens"].long(),
                                         ("batch", "seq"), rules)
        nll, correct, denom = _summed_terms(
            forward(params, tokens, config, rules, mesh=mesh), tokens,
            batch.get("mask"), rules)
    denom = denom.clamp(min=1.0)
    loss = nll / denom
    return loss, {"loss": loss, "accuracy": correct / denom,
                  "tokens": denom}

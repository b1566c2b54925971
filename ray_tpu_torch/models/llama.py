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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.models.remat import remat
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

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
    # Ring/sequence-parallel attention needs a process group (ROADMAP item
    # 12); None here.
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
    for each leaf, as the JAX package names them (``llama.py:100``); the
    sharding rules that read them belong to ROADMAP item 12."""
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


def _attention(x, layer, cos, sin, config: LlamaConfig):
    q, k, v = _qkv(x, layer)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, causal=True, block=config.attn_block)
    return _attn_out(out, layer)


def check_sp_axis(config: LlamaConfig) -> None:
    if config.sp_axis is not None:
        raise NotImplementedError(
            "sp_axis (ring attention) is not ported: it needs a process "
            "group, ROADMAP item 12")


def make_block(config: LlamaConfig, cos, sin):
    """The transformer block ``block(x, layer) -> x`` (the JAX package's
    scanned block). With ``remat`` the layer runs under
    ``torch.utils.checkpoint`` with ``remat_policy``
    (:func:`ray_tpu_torch.models.remat.remat`): "nothing" keeps only its
    input and recomputes the layer, flash forward included; "dots" also
    keeps the outputs of its weight products."""
    c = config
    check_sp_axis(c)

    def block(x, layer):
        x = x + _attention(rmsnorm(x, layer["attn_norm"], c.norm_eps), layer,
                           cos, sin, c)
        return x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)

    return remat(block, c.remat_policy) if c.remat else block


def forward(params: Params, tokens: torch.Tensor,
            config: LlamaConfig) -> torch.Tensor:
    """tokens (B, S) integer → logits (B, S, vocab) float32."""
    c = config
    tokens = tokens.long()
    x = params["embed"].to(c.dtype)[tokens]
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=x.device)
    block = make_block(c, cos, sin)
    # One unbind per stacked weight, as scan slices its xs: its backward
    # stacks the layers' gradients once, where indexing each layer would
    # scatter every layer's gradient into a zeroed full-size copy and sum
    # n_layers of them.
    names = list(params["layers"])
    for ws in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = block(x, dict(zip(names, ws)))
    x = rmsnorm(x, params["final_norm"], c.norm_eps)
    head = params["embed"].T if c.tie_embeddings else params["lm_head"]
    return _head_logits(x, head)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: LlamaConfig):
    """Next-token cross entropy.

    ``batch``: {"tokens": (B, S) integer, optional "mask": (B, S) 0/1 —
    mask[i] gates the loss at step i, predicting token i+1; the last
    position's mask is unused}. Returns (loss, {"loss", "accuracy",
    "tokens"})."""
    tokens = batch["tokens"].long()
    logits = forward(params, tokens, config)[:, :-1]
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = (torch.ones_like(targets, dtype=torch.float32) if mask is None
            else mask[:, :-1].float())
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}

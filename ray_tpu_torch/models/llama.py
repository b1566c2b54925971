"""Llama-family decoder-only transformer: configuration and parameters
(port of ``ray_tpu/models/llama.py``).

Parameters are a plain dict of tensors in the JAX package's layout — layer
weights stacked on a leading ``layers`` axis (``wq`` is (L, E, H, D), …) —
so weights converted from the JAX pytree (:mod:`ray_tpu_torch.models.convert`)
load 1:1. ``forward`` and ``loss_fn`` belong to the training path and are not
ported yet; serving runs its own prefill and decode step
(:mod:`ray_tpu_torch.models.paged_cache`, :mod:`ray_tpu_torch.models.decoding`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

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
    # remat, remat_policy, attn_block and sp_axis of the JAX config shape
    # training only, and arrive with the training slice

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

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
                         dtype=torch.float32),
    "tiny": LlamaConfig(vocab_size=32000, hidden=512, n_layers=4, n_heads=8,
                        n_kv_heads=4, head_dim=64, mlp_dim=1408, max_seq=2048),
    "1b": LlamaConfig(vocab_size=128256, hidden=2048, n_layers=16, n_heads=32,
                      n_kv_heads=8, head_dim=64, mlp_dim=8192, max_seq=8192),
    "8b": LlamaConfig(),  # Llama-3-8B shapes
    "70b": LlamaConfig(hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                       head_dim=128, mlp_dim=28672),
}


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
        out = torch.empty(shape, dtype=dt, device=dev)
        parts = out if stacked else [out]
        for part in parts:
            tmp = torch.empty(part.shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0,
                                        generator=generator)
            part.copy_(tmp.mul_(s))
        return out

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

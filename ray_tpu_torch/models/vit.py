"""Vision Transformer (port of ``ray_tpu/models/vit.py``): the encoder
family, on the non-causal attention path.

- Patchify is reshapes only, and the patch embedding one matrix product
  ``(patches, P²·C) @ (P²·C, hidden)``.
- Pre-norm blocks (layernorm, attention, layernorm, tanh-GELU MLP with
  biases), looped over the stacked layer weights, each under
  :func:`ray_tpu_torch.models.remat.remat` ("nothing") when ``remat`` is
  set.
- Attention is :func:`ray_tpu_torch.ops.attention.flash_attention` with
  ``causal=False`` over the patches and the [CLS] token (S = 197 at 224²,
  patch 16): the flash kernels take the ragged tail themselves.
- The logits are the [CLS] row's bf16 × bf16 product with f32 results,
  plus an f32 bias, through the Llama head path (``llama._head_logits``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import _head_logits, _proj, trunc_normal
from ray_tpu_torch.models.remat import remat
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import layernorm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    hidden: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_block: int = 512           # tile of the plain flash backward

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    def num_params(self) -> int:
        per_layer = (4 * self.hidden * self.hidden        # qkv + proj
                     + 2 * self.hidden * self.mlp_dim     # mlp in/out
                     + self.mlp_dim + self.hidden         # mlp biases
                     + 4 * self.hidden)                   # 2 LN (w, b)
        return (self.patch_dim * self.hidden                     # patch embed
                + self.seq_len * self.hidden + self.hidden       # pos + cls
                + self.n_layers * per_layer
                + 2 * self.hidden                                # final LN
                + self.hidden * self.num_classes + self.num_classes)

    def flops_per_image(self) -> float:
        """Training FLOPs per image: each of the seq_len tokens passes
        through all N parameters (6·N·s), plus non-causal attention
        (12·L·s²·hidden, forward and backward). The MFU numerator."""
        s = self.seq_len
        return s * (6.0 * self.num_params()
                    + 12.0 * self.n_layers * s * self.hidden)


CONFIGS: Dict[str, ViTConfig] = {
    "debug": ViTConfig(image_size=32, patch_size=8, hidden=64, n_layers=2,
                       n_heads=4, mlp_dim=128, num_classes=10,
                       dtype=torch.float32, remat=False),
    "S16": ViTConfig(hidden=384, n_layers=12, n_heads=6, mlp_dim=1536),
    "B16": ViTConfig(),  # ViT-Base/16
    "L16": ViTConfig(hidden=1024, n_layers=24, n_heads=16, mlp_dim=4096),
}


def param_logical_axes(config: ViTConfig) -> Params:
    """The JAX package's logical axis names for each leaf (the Llama
    family's vocabulary)."""
    del config
    return {
        "patch_embed": ("embed_vocab", "embed_fsdp"),
        "cls_token": ("embed",),
        "pos_embed": (None, "embed"),
        "layers": {
            "ln1_w": ("layers", "embed"), "ln1_b": ("layers", "embed"),
            "wq": ("layers", "embed_fsdp", "heads", "head_dim"),
            "wk": ("layers", "embed_fsdp", "heads", "head_dim"),
            "wv": ("layers", "embed_fsdp", "heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed_fsdp"),
            "ln2_w": ("layers", "embed"), "ln2_b": ("layers", "embed"),
            "w_in": ("layers", "embed_fsdp", "mlp"),
            "b_in": ("layers", "mlp"),
            "w_out": ("layers", "mlp", "embed_fsdp"),
            "b_out": ("layers", "embed"),
        },
        "final_ln_w": ("embed",), "final_ln_b": ("embed",),
        "head_w": ("embed_fsdp", "vocab"), "head_b": ("vocab",),
    }


def init_params(config: ViTConfig, generator: torch.Generator,
                device=None) -> Params:
    """The JAX package's init rules (truncated normal, residual outputs
    scaled by ``(2 L)^-1/2``, unit layernorms, zero biases, [CLS] and head);
    draws come from ``generator`` on ``device``."""
    c = config
    dev = torch.device(device) if device is not None else generator.device
    dt = c.dtype
    std = c.hidden ** -0.5
    out_std = std / (2 * c.n_layers) ** 0.5
    L, H, D = c.n_layers, c.n_heads, c.head_dim

    def tn(shape, s, stacked=False):
        return trunc_normal(shape, s, dt, dev, generator, stacked)

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "patch_embed": tn((c.patch_dim, c.hidden), c.patch_dim ** -0.5),
        "cls_token": full((c.hidden,), 0.0),
        "pos_embed": tn((c.seq_len, c.hidden), 0.02),
        "layers": {
            "ln1_w": full((L, c.hidden), 1.0),
            "ln1_b": full((L, c.hidden), 0.0),
            "wq": tn((L, c.hidden, H, D), std, True),
            "wk": tn((L, c.hidden, H, D), std, True),
            "wv": tn((L, c.hidden, H, D), std, True),
            "wo": tn((L, H, D, c.hidden), out_std, True),
            "ln2_w": full((L, c.hidden), 1.0),
            "ln2_b": full((L, c.hidden), 0.0),
            "w_in": tn((L, c.hidden, c.mlp_dim), std, True),
            "b_in": full((L, c.mlp_dim), 0.0),
            "w_out": tn((L, c.mlp_dim, c.hidden), out_std, True),
            "b_out": full((L, c.hidden), 0.0),
        },
        "final_ln_w": full((c.hidden,), 1.0),
        "final_ln_b": full((c.hidden,), 0.0),
        "head_w": full((c.hidden, c.num_classes), 0.0),
        "head_b": full((c.num_classes,), 0.0),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) → (B, num_patches, P²·C) by reshapes only."""
    b, h, w, ch = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * ch)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``'s
    default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def forward(params: Params, images: torch.Tensor,
            config: ViTConfig) -> torch.Tensor:
    """images (B, H, W, C) float in [0, 1] → logits (B, num_classes) f32."""
    c = config
    x = _proj(patchify(images.to(c.dtype), c.patch_size),
              params["patch_embed"], 1)
    cls = params["cls_token"].to(c.dtype).expand(x.shape[0], 1, c.hidden)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(c.dtype)[None]

    def block(x, layer):
        h = layernorm(x, layer["ln1_w"], layer["ln1_b"], c.norm_eps)
        q, k, v = (_proj(h, layer[n], 1) for n in ("wq", "wk", "wv"))
        a = flash_attention(q, k, v, causal=False, block=c.attn_block)
        x = x + _proj(a, layer["wo"], 2)
        h = layernorm(x, layer["ln2_w"], layer["ln2_b"], c.norm_eps)
        h = gelu(_proj(h, layer["w_in"], 1) + layer["b_in"].to(x.dtype))
        return x + (_proj(h, layer["w_out"], 1) + layer["b_out"].to(x.dtype))

    if c.remat:
        block = remat(block, "nothing")
    names = list(params["layers"])
    for ws in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = block(x, dict(zip(names, ws)))
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"], c.norm_eps)
    return _head_logits(x[:, 0], params["head_w"]) + params["head_b"].float()


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            config: ViTConfig):
    """Cross entropy over ``{"images": (B, H, W, C), "labels": (B,)}``;
    returns (loss, {"loss", "accuracy"})."""
    logits = forward(params, batch["images"], config)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}

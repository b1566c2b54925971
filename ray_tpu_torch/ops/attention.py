"""Attention frontend (port of ``ray_tpu/ops/attention.py``).

``flash_attention`` and ``flash_attention_with_lse`` take (B, S, H, D)
activations and run the joint (out, lse) primitive :class:`_FlashLSE`, a
``torch.autograd.Function`` (the counterpart of the JAX ``custom_vjp``
``_flash_lse``): its forward is the flash forward (kernel K1 on a CUDA
tensor), its backward computes ``delta = rowsum(dO * O) - dlse`` in torch,
as the JAX package does in XLA, and calls the flash backward (kernels K2a
and K2b on a CUDA tensor). On CPU tensors the forward is the fused plain
version and the backward the blockwise plain version over ``block`` rows,
the JAX package's off-TPU paths. ``mha_reference`` stays for serving
prefill.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                               flash_attention_fwd)

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S²)-memory attention in the (B, S, H, D) layout: f32
    scores, GQA by repeating kv heads, causal mask at ``NEG_INF``."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = s.shape[-2], s.shape[-1]
        row = torch.arange(sq, device=s.device)[:, None]
        col = torch.arange(skv, device=s.device)[None, :]
        s = torch.where(row >= col, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class _FlashLSE(torch.autograd.Function):
    """Joint (out, lse) primitive in the (B, H, S, D) layout, so that a
    consumer of lse stays differentiable: the backward folds the dlse
    cotangent into delta."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block: int):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block = causal, scale, block
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = (dout.float() * out.float()).sum(dim=-1) - dlse.float()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, lse, delta, dout.contiguous(), causal=ctx.causal,
            scale=ctx.scale, block=ctx.block)
        return dq, dk, dv, None, None, None


def _bhsd(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None,
                    block: int = 512) -> torch.Tensor:
    """Differentiable flash attention, (B, S, H, D) layout (GQA-aware)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, _ = _FlashLSE.apply(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                             block)
    return out.transpose(1, 2)


def flash_attention_with_lse(q, k, v, causal: bool = True,
                             scale: Optional[float] = None,
                             block: int = 512):
    """Differentiable variant returning (out, lse) in (B, S, H, D) /
    (B, H, S) layouts; the building block of ring attention."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, lse = _FlashLSE.apply(_bhsd(q), _bhsd(k), _bhsd(v), causal, scale,
                               block)
    return out.transpose(1, 2), lse

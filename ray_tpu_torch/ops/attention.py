"""Attention frontend (port of ``ray_tpu/ops/attention.py``).

Only ``mha_reference`` is ported: serving prefill attends with it in both
cache modes. ``flash_attention`` and its custom backward belong to the
training path (TPU kernels K1/K2) and are not part of this package yet.
"""

from __future__ import annotations

from typing import Optional

import torch

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

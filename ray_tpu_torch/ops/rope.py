"""Rotary position embeddings (port of ``ray_tpu/ops/rope.py``):
non-interleaved half-split ("neox") layout, computed in f32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 500000.0,
                     dtype=torch.float32, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max_seq, head_dim/2) cos/sin tables."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim). cos/sin: (max_seq, head_dim/2).

    ``positions``: optional (..., seq) integer tensor indexing the tables
    (decode steps, where each slot sits at its own position)."""
    if positions is None:
        seq = x.shape[-3]
        c = cos[:seq][:, None, :]
        s = sin[:seq][:, None, :]
    else:
        c = cos[positions][..., :, None, :]
        s = sin[positions][..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)

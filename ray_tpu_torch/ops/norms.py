"""Normalization ops (port of ``ray_tpu/ops/norms.py``).

Plain torch: both are memory-bound elementwise passes around the decode
step's matmuls; the JAX package left them to XLA fusion, and they hold no
TPU kernel to port.
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32 whatever the input dtype, scaled by
    ``(1 + weight)`` (zero-initialised norms are the identity scale) — not
    ``torch.nn.RMSNorm``, which scales by ``weight``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * (var + eps) ** -0.5
    return (y * weight.float() + bias.float()).to(dtype)

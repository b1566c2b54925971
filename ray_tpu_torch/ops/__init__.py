"""Tensor ops of the port: norms, RoPE, attention and the decode-attention
kernels (CUDA on the card, plain torch on the CPU)."""

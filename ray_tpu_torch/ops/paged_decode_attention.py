"""Paged flash-decoding attention (port of
``ray_tpu/ops/pallas/paged_decode_attention.py``): one new query token per
slot against that slot's KV cache stored in non-contiguous fixed-size
blocks of a shared pool.

Layout contract:
    q        (B, 1, H, D)    new-token queries
    k_pool   (NB, bs, KV, D) paged key pool (one layer)
    v_pool   (NB, bs, KV, D)
    tables   (B, MBS) int32  physical block id per logical block; entries
                             past the valid prefix must name a real block
                             (conventionally the reserved null block 0)
    lengths  (B,) int32      valid tokens per slot (incl. the new token)

On a CUDA tensor :func:`paged_decode_attention` launches the hand-written
split-KV kernel ``paged_decode_attention_kernel`` of
``ray_tpu_torch/csrc/decode_attention.cu`` (one kernel a call; each split
of :data:`SPLIT_ROWS` rows writes a partial to the workspace kept per device
that the slot kernel shares, and the last split of a slot and kv head to
finish combines them); on a CPU tensor it computes the plain version
:func:`paged_attention_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.decode_attention import (SPLIT_ROWS, check_operands,
                                                check_supported,
                                                raise_on_error, workspace)

NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tensors (q, pools, tables, lengths, out, partials, arrivals); B, H, KV, D,
# block size, MBS, blocks per split; scale, dtype, stream
ARGTYPES = {"paged_decode_attention_launch":
            [_P] * 8 + [_I] * 7 + [_F, _I, _P]}


def paged_attention_reference(q, k_pool, v_pool, tables, lengths, *,
                              scale: float):
    """Plain version: gather each slot's cache through its block table,
    then grouped-einsum attention in f32 (``paged_attention_reference`` of
    the JAX package). A slot of length 0 gets 0, as in the TPU kernel and
    this package's kernel (the JAX gather oracle averages V there)."""
    B, _, H, D = q.shape
    bs, KV = k_pool.shape[1], k_pool.shape[2]
    MBS = tables.shape[1]
    group = H // KV
    S = MBS * bs
    idx = tables.to(q.device).long()
    k = k_pool[idx].reshape(B, S, KV, D)
    v = v_pool[idx].reshape(B, S, KV, D)
    qg = q.float().reshape(B, KV, group, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    lens = lengths.to(q.device)
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    out = torch.where((lens > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, 1, H, D).to(q.dtype)


def blocks_per_split(block_size: int) -> int:
    return max(1, SPLIT_ROWS // block_size)


def paged_decode_attention(q, k_pool, v_pool, tables, lengths, *,
                           scale: float):
    """q (B,1,H,D); k/v_pool (NB,bs,KV,D); tables (B,MBS) int32;
    lengths (B,) int32. Returns (B, 1, H, D) in q.dtype."""
    B, _, H, D = q.shape
    NB, bs, KV = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MBS = tables.shape[1]
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: unsupported device {q.device}")
    dtype = check_operands(q, k_pool, v_pool, (tables, lengths), D)
    if k_pool.shape != (NB, bs, KV, D) or v_pool.shape != k_pool.shape \
            or tables.shape != (B, MBS) or lengths.shape != (B,):
        raise ValueError("paged_decode_attention: shapes do not match the "
                         "layout contract")
    check_supported(D, H // KV, "paged_decode_attention_kernel")
    bps = blocks_per_split(bs)
    arrivals, partials = workspace(q.device, B, H, KV, D, -(-MBS // bps))
    out = torch.empty_like(q)
    fn = _build.load("decode_attention").paged_decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES["paged_decode_attention_launch"]
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            partials.data_ptr(), arrivals.data_ptr(), B, H, KV, D, bs, MBS,
            bps, float(scale), dtype,
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(rc, "paged_decode_attention_kernel")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

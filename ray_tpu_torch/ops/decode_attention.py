"""Flash-decoding attention over a contiguous slot cache (port of
``ray_tpu/ops/pallas/decode_attention.py``).

Layout contract: q (B, 1, H, D); k/v cache (B, S, KV, D); lengths (B,)
int32, the valid prefix per slot including the new token. Returns
(B, 1, H, D) in q's dtype.

On a CUDA tensor :func:`decode_attention` launches the hand-written
split-KV kernel ``decode_attention_kernel`` of
``ray_tpu_torch/csrc/decode_attention.cu`` (the paged kernel's body over
contiguous rows; it raises on what the kernel does not take); on a CPU
tensor it computes the plain version :func:`decode_attention_reference`.
Unlike the TPU kernel, S is not padded to a block multiple: the kernel
reads ``min(length, S)`` rows of each slot, in splits of
:data:`SPLIT_ROWS` rows. Both decode kernels write their splits' partials
to one workspace kept per device (:func:`workspace`), so calls on one
device must run in stream order.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)      # the decode kernels' instantiations
GROUPS = (1, 2, 4, 8)
SPLIT_ROWS = 128                   # rows of one split (paged: whole blocks)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tensors (q, caches, lengths, out, partials, arrivals); B, H, KV, D, S,
# rows a split; scale, dtype, stream
ARGTYPES = {"decode_attention_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _P]}


def decode_attention_reference(q, k_cache, v_cache, lengths, *,
                               scale: float):
    """Plain version: the grouped einsum of ``_attend_cached``
    (``ray_tpu/models/decoding.py``) in f32 — the cache is never
    head-repeated. A slot of length 0 gets 0, as in the kernel."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    group = H // KV
    qg = q.float().reshape(B, KV, group, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = torch.where((lengths.to(q.device) > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, 1, H, D).to(q.dtype)


def check_operands(q, k, v, index_tensors, D: int) -> int:
    """Validate the operands of a decode-attention kernel launch; returns
    the kernel's dtype code."""
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    for t in (q, k, v, *index_tensors):
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("decode attention kernels need contiguous "
                             "operands")
    for t in index_tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"index operand dtype {t.dtype}, want int32")
    if (D * q.element_size()) % 16:
        raise ValueError(f"head_dim {D} x {q.element_size()} bytes is not "
                         "a multiple of 16 bytes")
    for t in (k, v):
        if t.data_ptr() % 16:
            raise ValueError("k/v storage is not 16-byte aligned")
    return _DTYPES[q.dtype]


def check_supported(D: int, group: int, kernel: str) -> None:
    """Raise ValueError unless ``kernel`` has an instantiation for head dim
    ``D`` and ``group`` query heads a kv head."""
    if D not in HEAD_DIMS or group not in GROUPS:
        raise ValueError(f"{kernel} takes head_dim in {HEAD_DIMS} and groups "
                         f"in {GROUPS}, got {D}, {group}")


def slot_splits(S: int) -> int:
    """Splits a slot of a contiguous S-row cache spans."""
    return -(-S // SPLIT_ROWS)


# device -> (arrivals, partials): the decode kernels' int32 tickets, which
# hold zeros between calls (the last split resets its own), and their f32
# partials; grown as needed, shared by the calls on a device (both
# kernels), which run in stream order
_scratch = {}


def workspace(device, B: int, H: int, KV: int, D: int, splits: int):
    """The workspace of a call over B slots with ``splits`` splits a slot:
    arrival tickets (at least B·KV int32, zeros) and partials (at least
    B·H·splits·(D+2) f32: each split's accumulator, max and sum per q
    head)."""
    n_arrivals, n_partials = B * KV, B * H * splits * (D + 2)
    arrivals, partials = _scratch.get(device, (None, None))
    if arrivals is None or arrivals.numel() < n_arrivals:
        arrivals = torch.zeros(n_arrivals, dtype=torch.int32, device=device)
    if partials is None or partials.numel() < n_partials:
        partials = torch.empty(n_partials, dtype=torch.float32, device=device)
    _scratch[device] = arrivals, partials
    return arrivals, partials


def raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float):
    """q (B,1,H,D); k/v_cache (B,S,KV,D); lengths (B,) int32 →
    (B,1,H,D) in q.dtype."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if H % KV:
        raise ValueError(f"q heads {H} not a multiple of kv heads {KV}")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    dtype = check_operands(q, k_cache, v_cache, (lengths,), D)
    if k_cache.shape != (B, S, KV, D) or v_cache.shape != k_cache.shape \
            or lengths.shape != (B,):
        raise ValueError("decode_attention: shapes do not match the "
                         "(B,1,H,D) / (B,S,KV,D) / (B,) contract")
    check_supported(D, H // KV, "decode_attention_kernel")
    arrivals, partials = workspace(q.device, B, H, KV, D, slot_splits(S))
    out = torch.empty_like(q)
    fn = _build.load("decode_attention").decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES["decode_attention_launch"]
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), partials.data_ptr(),
            arrivals.data_ptr(), B, H, KV, D, S, SPLIT_ROWS, float(scale),
            dtype, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(rc, "decode_attention_kernel")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

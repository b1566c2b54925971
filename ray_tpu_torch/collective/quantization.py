"""Block-wise int8 affine quantization for collective payloads (port of
``ray_tpu/collective/quantization.py``).

EQuARX-style (PAPERS.md "EQuARX: Efficient Quantized AllReduce in XLA"):
a float tensor is flattened and cut into fixed-size blocks; each block is
encoded as uint8 codes plus a per-block ``(scale, offset)`` pair::

    scale  = (max(block) - min(block)) / 255        (1.0 when constant)
    offset = min(block)
    code   = round((x - offset) / scale)  in [0, 255]
    x~     = code * scale + offset

Per-element error of one encode/decode round trip is at most ``scale/2``
(nearest-rounding), and a constant block reconstructs exactly.

A quantized **allreduce** runs two phases (the reduce-scatter/all-gather
decomposition): every member quantizes its vector, chunks travel
quantized, each member dequantizes and sums its chunk (dequant-reduce),
requantizes the partial sum, and the reduced chunks travel quantized once
more before the final dequantize.  The absolute error of element j in
chunk c is therefore bounded by::

    sum_r scale_r[block(j)] / 2     (phase 1: one rounding per member)
  + scale2[block(j)] / 2            (phase 2: one rounding of the sum)

:func:`allreduce_error_bound` computes exactly that bound from the same
inputs, so parity tests assert ``|quantized - exact| <= bound``
elementwise instead of an arbitrary rtol.

Everything here is transport-agnostic: the numpy path serves the KV
backend and the test oracles; the torch path (:func:`quantize_blocks_torch`,
:func:`dequantize_blocks_torch`) runs the same math on tensors of any
device, for ``collective/xla_group.py``'s quantized NCCL collectives and
the KV backend's tensor payloads. Both round half to even, as ``np.rint``
and the JAX package's ``jnp.round`` do.

Wire cost per element drops from ``itemsize`` bytes to ``1 + 2 *
scale_itemsize / block`` bytes; for float32 at the default block of 256
that is a 3.87x reduction (:func:`wire_bytes`).
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

DEFAULT_BLOCK = 256
# codes span [0, QMAX]
QMAX = 255


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def padded_size(n: int, block: int = DEFAULT_BLOCK) -> int:
    return _ceil_div(max(n, 1), block) * block


def wire_bytes(n: int, itemsize: int, block: int = DEFAULT_BLOCK,
               quantized: bool = True) -> int:
    """Payload bytes for one member's n-element vector on the wire.

    Quantized: one uint8 code per (padded) element plus a (scale, offset)
    pair per block, carried at the source dtype's width.
    """
    if not quantized:
        return n * itemsize
    npad = padded_size(n, block)
    return npad * 1 + (npad // block) * 2 * itemsize


# --------------------------------------------------------------- numpy path

def quantize_blocks_np(arr: np.ndarray, block: int = DEFAULT_BLOCK
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flatten + pad ``arr`` and encode per block.

    Returns ``(codes, scale, offset)``: codes ``(nblocks, block)`` uint8,
    scale/offset ``(nblocks,)`` in the input dtype.  Zero-padding the tail
    block widens its range (the bound still holds — it is computed from
    the padded block's scale); the pad lanes are dropped on decode.
    """
    flat = np.ascontiguousarray(arr).reshape(-1)
    if not np.issubdtype(flat.dtype, np.floating):
        raise TypeError(f"quantize needs a float dtype, got {flat.dtype}")
    npad = padded_size(flat.size, block)
    if npad != flat.size:
        flat = np.pad(flat, (0, npad - flat.size))
    blocks = flat.reshape(-1, block)
    lo = blocks.min(axis=1)
    hi = blocks.max(axis=1)
    scale = (hi - lo) / QMAX
    scale = np.where(scale == 0, np.ones_like(scale), scale)
    codes = np.clip(np.rint((blocks - lo[:, None]) / scale[:, None]),
                    0, QMAX).astype(np.uint8)
    return codes, scale, lo


def dequantize_blocks_np(codes: np.ndarray, scale: np.ndarray,
                         offset: np.ndarray, n: int,
                         shape=None) -> np.ndarray:
    """Decode ``quantize_blocks_np`` output back to ``n`` elements."""
    flat = (codes.astype(scale.dtype) * scale[:, None]
            + offset[:, None]).reshape(-1)[:n]
    return flat.reshape(shape) if shape is not None else flat


def simulate_quantized_allreduce_np(members, block: int = DEFAULT_BLOCK
                                    ) -> np.ndarray:
    """Numpy oracle of the two-phase quantized allreduce.

    ``members``: list of equal-shaped float arrays (one per rank).
    Mirrors the XLA lowering exactly — quantize each member, dequant-sum,
    requantize the partial sums, final dequant — so parity tests can
    check the compiled path against deterministic host math.
    """
    members = [np.asarray(m) for m in members]
    shape, n = members[0].shape, members[0].size
    acc = None
    for m in members:
        codes, scale, lo = quantize_blocks_np(m, block)
        deq = dequantize_blocks_np(codes, scale, lo, padded_size(n, block))
        acc = deq if acc is None else acc + deq
    codes2, scale2, lo2 = quantize_blocks_np(acc, block)
    return dequantize_blocks_np(codes2, scale2, lo2, n, shape)


def allreduce_error_bound(members, block: int = DEFAULT_BLOCK
                          ) -> np.ndarray:
    """Elementwise bound on |quantized_allreduce - exact_sum|."""
    members = [np.asarray(m) for m in members]
    n = members[0].size
    npad = padded_size(n, block)
    per_block = np.zeros(npad // block, dtype=np.float64)
    acc = np.zeros(npad, dtype=np.float64)
    for m in members:
        codes, scale, lo = quantize_blocks_np(m, block)
        per_block += np.asarray(scale, dtype=np.float64) / 2
        acc += np.asarray(
            dequantize_blocks_np(codes, scale, lo, npad), dtype=np.float64)
    _, scale2, _ = quantize_blocks_np(acc, block)
    per_block += np.asarray(scale2, dtype=np.float64) / 2
    bound = np.repeat(per_block, block)[:n]
    return bound.reshape(members[0].shape)


def encode_payload(arr, block: int = DEFAULT_BLOCK) -> dict:
    """Wire-dict encoding for byte-transport backends (KV group). A numpy
    array is encoded by the numpy path; a ``torch.Tensor`` by the torch
    path on its own device, its codes, scales and offsets then staged to
    the host as CPU tensors (its dtype travels by torch's name)."""
    if _is_tensor(arr):
        flat = arr.detach().reshape(-1)
        npad = padded_size(flat.numel(), block)
        if npad != flat.numel():
            flat = _torch().nn.functional.pad(flat, (0, npad - flat.numel()))
        codes, scale, offset = quantize_blocks_torch(flat.reshape(-1, block))
        return {"rtq1": True, "codes": codes.cpu(), "scale": scale.cpu(),
                "offset": offset.cpu(), "n": arr.numel(),
                "shape": tuple(arr.shape), "dtype": str(arr.dtype)}
    arr = np.asarray(arr)
    codes, scale, offset = quantize_blocks_np(arr, block)
    return {"rtq1": True, "codes": codes, "scale": scale, "offset": offset,
            "n": arr.size, "shape": arr.shape, "dtype": str(arr.dtype)}


def decode_payload(msg: dict):
    """The value :func:`encode_payload` encoded, decoded: numpy for numpy,
    a CPU tensor for a tensor."""
    if _is_tensor(msg["codes"]):
        flat = dequantize_blocks_torch(msg["codes"], msg["scale"],
                                       msg["offset"], msg["scale"].dtype)
        return flat.reshape(-1)[:msg["n"]].reshape(msg["shape"])
    out = dequantize_blocks_np(msg["codes"], msg["scale"], msg["offset"],
                               msg["n"], msg["shape"])
    return out.astype(np.dtype(msg["dtype"]), copy=False)


def is_quantized_payload(value) -> bool:
    return isinstance(value, dict) and value.get("rtq1") is True


# --------------------------------------------------------------- torch path

def _torch():
    import torch

    return torch


def _is_tensor(value) -> bool:
    torch = sys.modules.get("torch")  # a tensor exists only once it loaded
    return torch is not None and isinstance(value, torch.Tensor)


def quantize_blocks_torch(blocks):
    """Encode per block on the tensor's device (the JAX package's
    ``quantize_blocks_jnp``): ``blocks`` is ``(..., block)``; returns
    ``(codes uint8, scale, offset)`` with keepdims scale/offset so the
    decode is a broadcast multiply-add. ``torch.round`` rounds half to
    even, as ``jnp.round`` does; a constant block has scale 1.0."""
    torch = _torch()
    lo = blocks.amin(dim=-1, keepdim=True)
    hi = blocks.amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which can round apart from the CPU's division
    scale = (hi - lo) / torch.full_like(hi, QMAX)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round((blocks - lo) / scale), 0, QMAX
                        ).to(torch.uint8)
    return codes, scale, lo


def dequantize_blocks_torch(codes, scale, offset, dtype):
    """The JAX package's ``dequantize_blocks_jnp``."""
    return codes.to(dtype) * scale + offset

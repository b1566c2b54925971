"""Paged KV cache: block-table paging for serving (port of
``ray_tpu/models/paged_cache.py``).

A shared pool of fixed-size token blocks replaces the slot model's
per-slot ``max_seq`` reservation:

    pool      (layers, num_blocks, block_size, KV, D)   on the device
    tables    (slots, max_blocks_per_seq) int32          host-owned
    lengths   (slots,) int32                             on the device

The block allocator is host-side Python (a free list over block ids).
Block 0 is reserved as the null block: table entries past a slot's valid
prefix point at it, and writes for inactive slots and prefill padding land
in it.

Where the JAX package's jitted steps take the cache and return a new one
(donated, so XLA updates it in place), these steps write **in place into
the preallocated pool tensors** and return the same cache dict. The decode
attention is :func:`ray_tpu_torch.ops.paged_decode_attention.paged_decode_attention`:
the CUDA kernel on the card, its plain version on the CPU.

Beside prefill and decode: the chunked prefill (one fixed-size chunk per
call, from any start position, which also prefills a radix prefix hit's
suffix), KV injection and extraction (the PD handoff and the legacy
prefix cache) and the block copy behind copy-on-write.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import host_array, tensor_from_host
from ray_tpu_torch.models.decoding import chunk_attention
from ray_tpu_torch.models.llama import (LlamaConfig, Params, _attn_out, _mlp,
                                        _qkv, head_f32, layer_params)
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.paged_decode_attention import paged_decode_attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

PagedCache = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Static pool geometry. ``num_blocks`` includes the reserved null
    block 0, so usable KV capacity is (num_blocks - 1) * block_size
    tokens shared by all slots."""

    num_blocks: int
    block_size: int = 64
    max_seq: int = 2048           # longest single sequence admitted

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq // self.block_size)

    def tokens_capacity(self) -> int:
        return (self.num_blocks - 1) * self.block_size


def init_paged_cache(config: LlamaConfig, page: PagedConfig,
                     num_slots: int, dtype=None, device=None) -> PagedCache:
    c = config
    dt = dtype or c.dtype
    shape = (c.n_layers, page.num_blocks, page.block_size,
             c.n_kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": torch.zeros((num_slots,), dtype=torch.int32,
                              device=device),
    }


class BlockAllocator:
    """Host-side free-list allocator + block tables. Not thread-safe:
    owned by the single engine loop, like the rest of the engine state.

    Blocks are ref-counted so a prefix cache can share one physical block
    between itself and any number of slot tables: ``ensure`` hands out
    private blocks at refcount 1, ``adopt`` aliases already-populated
    shared blocks into a slot's table (incref), and ``release`` only
    returns a block to the free list when its last reference drops.
    A block on the free list always has refcount 0."""

    def __init__(self, page: PagedConfig, num_slots: int, device=None):
        self.page = page
        self.num_slots = num_slots
        self.device = device
        self._free: List[int] = list(range(page.num_blocks - 1, 0, -1))
        self.tables = np.zeros((num_slots, page.max_blocks_per_seq),
                               np.int32)
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        self._ref = np.zeros(page.num_blocks, np.int32)
        self._ref[0] = 1             # null block: pinned forever
        self._device_tables = None   # cache: re-upload only after changes

    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.page.block_size)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``tokens`` cached tokens.
        Returns False (allocating nothing) if the pool can't cover it."""
        need = self.blocks_for(tokens) - len(self._owned[slot])
        if need <= 0:
            return True
        if need > len(self._free) or self.blocks_for(tokens) > \
                self.page.max_blocks_per_seq:
            return False
        for _ in range(need):
            b = self._free.pop()
            self._ref[b] = 1
            self.tables[slot, len(self._owned[slot])] = b
            self._owned[slot].append(b)
        self._device_tables = None
        return True

    def adopt(self, slot: int, blocks: List[int]) -> None:
        """Alias already-populated shared blocks (a cached prefix) into
        the next table positions of ``slot``, bumping each refcount."""
        base = len(self._owned[slot])
        if base + len(blocks) > self.page.max_blocks_per_seq:
            raise ValueError("adopt exceeds max_blocks_per_seq")
        for i, b in enumerate(blocks):
            self._ref[b] += 1
            self.tables[slot, base + i] = b
            self._owned[slot].append(b)
        self._device_tables = None

    def cow(self, slot: int, idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: swap the shared block at table position
        ``idx`` of ``slot`` for a fresh private block. Returns
        (src, dst) so the caller can device-copy the cached rows, or
        None when the pool has no free block."""
        if not self._free:
            return None
        src = self._owned[slot][idx]
        dst = self._free.pop()
        self._ref[dst] = 1
        self._ref[src] -= 1
        self._owned[slot][idx] = dst
        self.tables[slot, idx] = dst
        self._device_tables = None
        return src, dst

    def ref_blocks(self, blocks: List[int]) -> None:
        """External holder (a prefix cache) takes a reference."""
        for b in blocks:
            self._ref[b] += 1

    def unref_blocks(self, blocks: List[int]) -> List[int]:
        """Drop external references; blocks whose last reference dropped
        go back on the free list (returned for accounting)."""
        freed: List[int] = []
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def release(self, slot: int) -> None:
        for b in reversed(self._owned[slot]):
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)
        self._owned[slot] = []
        self.tables[slot, :] = 0
        self._device_tables = None

    def check_invariants(self) -> None:
        """Debug oracle: a block is on the free list iff its refcount is
        0; no block is freed while any table still references it."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate blocks on free list"
        assert 0 not in free, "null block leaked onto free list"
        for b in free:
            assert self._ref[b] == 0, f"free block {b} has refcount " \
                f"{int(self._ref[b])}"
        for b in range(1, self.page.num_blocks):
            if self._ref[b] == 0:
                assert b in free, f"refcount-0 block {b} not on free list"
        for slot, owned in enumerate(self._owned):
            for b in owned:
                assert self._ref[b] > 0, f"slot {slot} references " \
                    f"refcount-0 block {b}"

    def device_tables(self) -> torch.Tensor:
        """Device copy of the tables, re-uploaded only after an
        ensure/release changed them: steady-state decode reuses the cached
        tensor instead of a host→device copy per generated token."""
        if self._device_tables is None:
            self._device_tables = torch.as_tensor(self.tables,
                                                  device=self.device)
        return self._device_tables


def _attend_paged(q, k_pool, v_pool, tables, lengths, scale):
    """q (B,1,H,D); pools (NB,bs,KV,D); tables (B,MBS); lengths (B,)."""
    return paged_decode_attention(q, k_pool, v_pool, tables, lengths,
                                  scale=scale)


def make_paged_decode_step(params: Params, config: LlamaConfig,
                           page: PagedConfig,
                           head: Optional[torch.Tensor] = None):
    """step(cache, tables (B,MBS) i32, tokens (B,) i32, active (B,) bool)
    → (cache, logits (B, vocab) f32). Each active slot's table must
    already cover position ``length`` (the engine allocates between
    steps); inactive slots write into the null block. The pool and the
    lengths are updated in place. ``head``: the f32 output head, made
    once by the caller (default: made here)."""
    c = config
    bs = page.block_size
    MBS = page.max_blocks_per_seq
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head
    scale = c.head_dim ** -0.5

    def step(cache: PagedCache, tables, tokens, active):
        lengths = cache["length"]
        tokens = torch.as_tensor(tokens, device=dev).long()
        active = torch.as_tensor(active, device=dev)
        B = tokens.shape[0]
        x = params["embed"].to(c.dtype)[tokens][:, None, :]      # (B,1,E)
        rows = torch.arange(B, device=dev)
        # physical write target of the new token per slot; a stale slot
        # (length == max_seq) would index column MBS: clamp, then send
        # every inactive slot to the null block
        col = (lengths // bs).long().clamp(max=MBS - 1)
        blk = torch.where(active, tables[rows, col].long(),
                          torch.zeros_like(col))
        off = (lengths % bs).long()
        positions = lengths.long().clamp(max=cos.shape[0] - 1)[:, None]
        att_len = lengths + 1
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            kc, vc = cache["k"][i], cache["v"][i]         # (NB, bs, KV, D)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            kc.index_put_((blk, off), k[:, 0].to(kc.dtype))
            vc.index_put_((blk, off), v[:, 0].to(vc.dtype))
            out = _attend_paged(q, kc, vc, tables, att_len, scale)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        logits = x[:, 0].float() @ head
        lengths += active.to(lengths.dtype)      # only active slots advance
        return cache, logits

    return step


def make_paged_prefill(params: Params, config: LlamaConfig,
                       page: PagedConfig,
                       head: Optional[torch.Tensor] = None):
    """prefill(cache, table_row (MBS,) i32, tokens (1,P) padded, true_len,
    slot) → (cache, last_logits (vocab,) f32). P must be a multiple of
    block_size; prompt KV lands in place in the blocks the table row
    names, padding rows (zeroed) in the null block."""
    c = config
    bs = page.block_size
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head

    def prefill(cache: PagedCache, table_row, tokens, true_len: int,
                slot: int):
        tokens = torch.as_tensor(tokens, device=dev).long()
        pad_len = tokens.shape[1]
        if pad_len % bs:
            raise ValueError(f"padded prompt {pad_len} not a multiple of "
                             f"block_size {bs}")
        nblk = pad_len // bs
        x = params["embed"].to(c.dtype)[tokens]               # (1, P, E)
        pos = torch.arange(pad_len, device=dev)
        valid = (pos < true_len)[:, None, None]                # (P, 1, 1)
        positions = pos.clamp(max=cos.shape[0] - 1)[None, :]
        # rows past true_len write into the null block
        row = torch.as_tensor(np.asarray(table_row)[:nblk], device=dev)
        dest = torch.where(torch.arange(nblk, device=dev) * bs < true_len,
                           row.long(), torch.zeros_like(row, dtype=torch.long))
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            out = mha_reference(q, k, v, causal=True)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
            kc, vc = cache["k"][i], cache["v"][i]
            kb = torch.where(valid, k[0], torch.zeros_like(k[0]))
            vb = torch.where(valid, v[0], torch.zeros_like(v[0]))
            kc[dest] = kb.reshape(nblk, bs, c.n_kv_heads,
                                  c.head_dim).to(kc.dtype)
            vc[dest] = vb.reshape(nblk, bs, c.n_kv_heads,
                                  c.head_dim).to(vc.dtype)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        last = x[0, max(int(true_len) - 1, 0)]
        logits = last.float() @ head
        cache["length"][slot] = int(true_len)
        return cache, logits

    return prefill


def make_chunked_paged_prefill(params: Params, config: LlamaConfig,
                               page: PagedConfig,
                               head: Optional[torch.Tensor] = None):
    """Chunked prefill over the paged pool: one fixed-size chunk per call;
    the chunk's k/v scatter into the blocks the table row names, and
    attention runs over the slot's full prefix + chunk rows gathered
    through the table.

    chunk(cache, table_row (MBS,), tokens (1, C), true_len-in-chunk,
          start_pos, slot) → (cache, last_logits (vocab,) f32)

    C must be a multiple of block_size. ``start_pos`` may be any position
    (the scatter is row by row), which lets a radix prefix hit resume
    mid-block after a copy-on-write of the divergence block: rows before
    ``start_pos`` stay untouched, each new row lands at its exact (block,
    offset), padding rows in the null block. The block budget of the
    whole prompt is ensured at admission, so chunking splits the compute,
    never the allocation. Scores and softmax are f32 over the slot's
    ``MBS * block_size`` gathered rows, read back from the pool after the
    write; the pool is written in place, and the slot's length becomes
    ``start_pos + true_len``."""
    c = config
    bs = page.block_size
    MBS = page.max_blocks_per_seq
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head
    scale = c.head_dim ** -0.5

    def chunk(cache: PagedCache, table_row, tokens, true_len: int,
              start_pos: int, slot: int):
        tokens = torch.as_tensor(tokens, device=dev).long()
        pad_len = tokens.shape[1]
        if pad_len % bs:
            raise ValueError(f"chunk length {pad_len} must be a multiple "
                             f"of block_size {bs}")
        true_len, start_pos = int(true_len), int(start_pos)
        row = torch.as_tensor(np.asarray(table_row), device=dev).long()
        x = params["embed"].to(c.dtype)[tokens]               # (1, C, E)
        rel = torch.arange(pad_len, device=dev)
        row_abs = start_pos + rel
        valid = rel < true_len
        # a padding row past the table's end would index column MBS:
        # clamp, then send every padding row to the null block
        row_blk = torch.where(valid, row[(row_abs // bs).clamp(max=MBS - 1)],
                              torch.zeros_like(row_abs))
        row_off = row_abs % bs
        positions = row_abs.clamp(max=cos.shape[0] - 1)[None, :]
        allowed = (torch.arange(MBS * bs, device=dev)[None, :]
                   <= row_abs[:, None])                        # (C, S)
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            kc, vc = cache["k"][i], cache["v"][i]         # (NB, bs, KV, D)
            keep = valid[:, None, None]
            kc.index_put_((row_blk, row_off),
                          torch.where(keep, k[0], 0.0).to(kc.dtype))
            vc.index_put_((row_blk, row_off),
                          torch.where(keep, v[0], 0.0).to(vc.dtype))
            out = chunk_attention(
                q, kc[row].reshape(MBS * bs, c.n_kv_heads, c.head_dim),
                vc[row].reshape(MBS * bs, c.n_kv_heads, c.head_dim),
                allowed, scale)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        logits = x[0, max(true_len - 1, 0)].float() @ head
        cache["length"][slot] = start_pos + true_len
        return cache, logits

    return chunk


def make_paged_inject(config: LlamaConfig, page: PagedConfig):
    """inject(cache, table_row (MBS,) i32, k, v, true_len, slot) → cache.
    k/v are (layers, P, KV, D) host arrays or tensors with P a multiple
    of block_size; rows at or beyond true_len must be zero. Blocks at or
    beyond true_len go to the null block, and only there (so writes to
    its repeated index land where nothing reads them as valid). The KV
    half of PD disaggregation and of the legacy prefix cache; the pool
    is written in place."""
    c = config
    bs = page.block_size

    def inject(cache: PagedCache, table_row, k, v, true_len: int,
               slot: int):
        dev, dt = cache["k"].device, cache["k"].dtype
        k = tensor_from_host(k, dev, dt)
        v = tensor_from_host(v, dev, dt)
        pad_len = k.shape[1]
        if pad_len % bs:
            raise ValueError(f"padded KV length {pad_len} not a multiple "
                             f"of block_size {bs}")
        nblk = pad_len // bs
        row = torch.as_tensor(np.asarray(table_row)[:nblk], device=dev)
        dest = torch.where(torch.arange(nblk, device=dev) * bs < true_len,
                           row.long(), torch.zeros_like(row, dtype=torch.long))
        shape = (c.n_layers, nblk, bs, c.n_kv_heads, c.head_dim)
        cache["k"][:, dest] = k.reshape(shape)
        cache["v"][:, dest] = v.reshape(shape)
        cache["length"][slot] = int(true_len)
        return cache

    return inject


def make_block_copy(config: LlamaConfig, page: PagedConfig):
    """copy(cache, src_block, dst_block) → cache. Device-side copy of one
    pool block's k/v rows in every layer: the copy-on-write primitive
    behind radix prefix sharing — a slot that must write into a shared
    block first duplicates it, so the cached original stays read-only.
    Runs on the current stream, in order with the decode kernels."""
    del config, page

    def copy(cache: PagedCache, src: int, dst: int):
        cache["k"][:, int(dst)] = cache["k"][:, int(src)]
        cache["v"][:, int(dst)] = cache["v"][:, int(src)]
        return cache

    return copy


def extract_kv(cache: PagedCache, allocator: BlockAllocator, slot: int,
               true_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Device → host copy of one slot's cached KV rows [0, true_len):
    gathers the slot's blocks and trims. The PD / prefix-cache export:
    numpy arrays (layers, true_len, KV, D) in the JAX package's dtypes
    (bf16 as ``ml_dtypes.bfloat16``)."""
    bs = allocator.page.block_size
    nblk = allocator.blocks_for(true_len)
    ids = torch.as_tensor(allocator.tables[slot, :nblk],
                          device=cache["k"].device).long()
    out = []
    for pool in (cache["k"], cache["v"]):
        rows = pool[:, ids]
        L, _, _, KV, D = rows.shape
        out.append(host_array(rows.reshape(L, nblk * bs, KV, D)
                              [:, :true_len]))
    return out[0], out[1]


def pad_to_block_bucket(n: int, block_size: int,
                        buckets=(64, 128, 256, 512, 1024, 2048)) -> int:
    """Prompt padding bucket that is always a block_size multiple."""
    for b in buckets:
        if n <= b and b % block_size == 0:
            return b
    m = max(block_size, buckets[-1])
    return -(-n // m) * m

"""KV-cache inference: slot-based prefill/decode for continuous batching
(port of ``ray_tpu/models/decoding.py``).

The cache is a (layers, slots, max_seq, kv_heads, head_dim) tensor pair
plus a (slots,) length vector, all on the device. Each active request owns
one slot; the decode step advances every active slot by one token.

Where the JAX package's jitted steps take and return the cache (donated,
so XLA updates it in place), these steps **write in place into the
preallocated cache tensors** and return the same dict. ``scan`` over the
stacked layers is a Python loop over the layer index.

Beside prefill and decode: the chunked prefill, KV injection (the PD
handoff and the legacy prefix cache), the batched speculative verify and
its KV-only sibling (per-slot token windows at per-slot offsets; the
speculative engine's target step and the draft's catch-up), and
``sample_token``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.convert import tensor_from_host
from ray_tpu_torch.models.llama import (LlamaConfig, Params, _attn_out, _mlp,
                                        _qkv, head_f32, layer_params)
from ray_tpu_torch.ops.attention import mha_reference
from ray_tpu_torch.ops.decode_attention import decode_attention
from ray_tpu_torch.ops.norms import rmsnorm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

Cache = Dict[str, torch.Tensor]


def init_cache(config: LlamaConfig, num_slots: int,
               max_seq: Optional[int] = None, dtype=None,
               device=None) -> Cache:
    c = config
    S = max_seq or c.max_seq
    dt = dtype or c.dtype
    shape = (c.n_layers, num_slots, S, c.n_kv_heads, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": torch.zeros((num_slots,), dtype=torch.int32,
                              device=device),
    }


def _attend_cached(q, k_cache, v_cache, lengths, scale):
    """q: (B, 1, H, D) new-token queries; k/v_cache: (B, S, KV, D);
    lengths: (B,) valid prefix per slot (incl. the new token)."""
    return decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def _decode_block(x, layer, k_cache, v_cache, lengths, active, cos, sin,
                  config: LlamaConfig):
    """One transformer block for one new token per slot, writing the
    token's k/v in place.

    x: (B, 1, E); k/v_cache: (B, S, KV, D); lengths: (B,) count BEFORE
    this token; active: (B,) bool. Only active slots below S are written
    (the JAX step computes every slot and keeps the active ones, and drops
    a write at row S); every other slot rewrites its row's current
    contents, so the write needs no host-side selection."""
    c = config
    B, S = k_cache.shape[0], k_cache.shape[1]
    h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
    q, k, v = _qkv(h, layer)
    positions = lengths.long().clamp(max=cos.shape[0] - 1)[:, None]
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)

    rows = torch.arange(B, device=x.device)
    row = lengths.long().clamp(max=S - 1)
    write = (active & (lengths < S))[:, None, None]
    k_cache[rows, row] = torch.where(write, k[:, 0].to(k_cache.dtype),
                                     k_cache[rows, row])
    v_cache[rows, row] = torch.where(write, v[:, 0].to(v_cache.dtype),
                                     v_cache[rows, row])

    out = _attend_cached(q, k_cache, v_cache, lengths + 1,
                         c.head_dim ** -0.5)
    x = x + _attn_out(out, layer)
    return x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)


def make_decode_step(params: Params, config: LlamaConfig,
                     head: Optional[torch.Tensor] = None):
    """Build the one-token-for-all-slots decode step.

    step(cache, tokens (B,) int32, active (B,) bool) →
        (cache, logits (B, vocab) f32)
    Inactive slots keep their cache rows and length. ``head``: the f32
    output head, made once by the caller (default: made here)."""
    c = config
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head

    def step(cache: Cache, tokens, active):
        lengths = cache["length"]
        tokens = torch.as_tensor(tokens, device=dev).long()
        active = torch.as_tensor(active, device=dev)
        x = params["embed"].to(c.dtype)[tokens][:, None, :]      # (B,1,E)
        for i in range(c.n_layers):
            x = _decode_block(x, layer_params(params, i), cache["k"][i],
                              cache["v"][i], lengths, active, cos, sin, c)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        logits = x[:, 0].float() @ head
        lengths += active.to(lengths.dtype)      # only active slots advance
        return cache, logits

    return step


def make_prefill(params: Params, config: LlamaConfig,
                 head: Optional[torch.Tensor] = None):
    """Build the single-slot prefill.

    prefill(cache, tokens (1, P) padded, true_len, slot) →
        (cache, last_logits (vocab,) f32)
    Writes the slot's rows [0, P) in place, zero past ``true_len``."""
    c = config
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head

    def prefill(cache: Cache, tokens, true_len: int, slot: int):
        tokens = torch.as_tensor(tokens, device=dev).long()
        pad_len = tokens.shape[1]
        if pad_len > cache["k"].shape[2]:
            raise ValueError(f"padded prompt {pad_len} exceeds the cache's "
                             f"{cache['k'].shape[2]} rows")
        x = params["embed"].to(c.dtype)[tokens]               # (1, P, E)
        pos = torch.arange(pad_len, device=dev)
        valid = (pos < true_len)[None, :, None, None]
        positions = pos.clamp(max=cos.shape[0] - 1)[None, :]
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            out = mha_reference(q, k, v, causal=True)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
            kc, vc = cache["k"][i], cache["v"][i]     # (slots, S, KV, D)
            kc[slot, :pad_len] = torch.where(valid, k, torch.zeros_like(k))[0]
            vc[slot, :pad_len] = torch.where(valid, v, torch.zeros_like(v))[0]
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        last = x[0, max(int(true_len) - 1, 0)]
        logits = last.float() @ head
        cache["length"][slot] = int(true_len)
        return cache, logits

    return prefill


def window_attention(q, ks, vs, allowed, scale):
    """Attention of per-slot token windows over each slot's cached rows,
    as the JAX package's verify and chunked prefills compute it: q (B, C,
    H, D); ks, vs (B, S, KV, D); allowed (B, C, S) bool. f32 scores,
    masked with -1e30, f32 softmax over all S rows, grouped heads (KV never
    repeated a head); returns (B, C, H, D) in q's dtype."""
    B, C, H, D = q.shape
    KV = ks.shape[2]
    qg = q.float().reshape(B, C, KV, H // KV, D)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, ks.float()) * scale
    s = torch.where(allowed[:, None, None], s,
                    torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgcs,bskd->bckgd", p, vs.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def chunk_attention(q, ks, vs, allowed, scale):
    """One slot's prefill chunk: q (1, C, H, D); ks, vs (S, KV, D);
    allowed (C, S) bool (:func:`window_attention` of a single slot)."""
    return window_attention(q, ks[None], vs[None], allowed[None], scale)


def make_chunked_prefill(params: Params, config: LlamaConfig,
                         head: Optional[torch.Tensor] = None):
    """Build the chunked prefill (Sarathi-style): one fixed-size chunk of
    a long prompt per call, attending causally within the chunk and over
    the slot's already-written prefix rows, so the engine can interleave
    decode steps of other slots between chunks.

    chunk(cache, tokens (1, C) padded, true_len-in-chunk, start_pos,
          slot) → (cache, last_logits (vocab,) f32)

    Writes exactly the valid rows ``[start_pos, start_pos + true_len)`` of
    the slot, in place. (The JAX step writes the whole padded chunk with
    ``dynamic_update_slice``; where ``start_pos + C`` runs past the cache,
    XLA moves the write back over the prefix. This step has no such
    case.) The slot's length becomes ``start_pos + true_len``; the logits
    are the chunk's last valid token's."""
    c = config
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    head = head_f32(params, c) if head is None else head
    scale = c.head_dim ** -0.5

    def chunk(cache: Cache, tokens, true_len: int, start_pos: int,
              slot: int):
        tokens = torch.as_tensor(tokens, device=dev).long()
        pad_len = tokens.shape[1]
        S = cache["k"].shape[2]
        true_len, start_pos = int(true_len), int(start_pos)
        end = start_pos + true_len
        if end > S:
            raise ValueError(f"chunk rows [{start_pos}, {end}) exceed the "
                             f"cache's {S} rows")
        x = params["embed"].to(c.dtype)[tokens]               # (1, C, E)
        row_abs = start_pos + torch.arange(pad_len, device=dev)
        positions = row_abs.clamp(max=cos.shape[0] - 1)[None, :]
        allowed = (torch.arange(S, device=dev)[None, :]
                   <= row_abs[:, None])                        # (C, S)
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, positions)
            k = apply_rope(k, cos, sin, positions)
            kc, vc = cache["k"][i], cache["v"][i]     # (slots, S, KV, D)
            kc[slot, start_pos:end] = k[0, :true_len].to(kc.dtype)
            vc[slot, start_pos:end] = v[0, :true_len].to(vc.dtype)
            out = chunk_attention(q, kc[slot], vc[slot], allowed, scale)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
        x = rmsnorm(x, params["final_norm"], c.norm_eps)
        logits = x[0, max(true_len - 1, 0)].float() @ head
        cache["length"][slot] = end
        return cache, logits

    return chunk


def make_batched_spec_verify(params: Params, config: LlamaConfig,
                             head: Optional[torch.Tensor] = None):
    """Speculative-decoding verify: score up to C candidate tokens for
    every slot in one forward (:mod:`ray_tpu_torch.models.speculation`
    owns the proposers and the acceptance rule).

    verify(cache, tokens (B, C), true_lens (B,), start_pos (B,)) →
        (cache, logits (B, C, vocab) f32)

    B must equal the cache's slot count. Per slot, ``tokens[b,
    :true_lens[b]]`` is the window [pending token, proposals...] written
    at rows ``[start_pos[b], start_pos[b] + true_lens[b])``; a window of 1
    is a plain decode step for that slot and 0 leaves the slot untouched.
    Rejected rows sit past the accepted length the caller installs
    afterwards, and later writes overwrite them. ``head``: the f32 output
    head, made once by the caller (default: made here)."""
    return _make_window_forward(params, config,
                                head_f32(params, config) if head is None
                                else head)


def make_kv_ingest(params: Params, config: LlamaConfig):
    """KV-write-only sibling of :func:`make_batched_spec_verify`: writes
    exactly the same cache rows but skips the final norm and the head (the
    draft's catch-up after an all-accepted round needs only the rows).

    ingest(cache, tokens (B, C), true_lens (B,), start_pos (B,)) → cache
    """
    call = _make_window_forward(params, config, None)

    def ingest(cache: Cache, tokens, true_lens, start_pos):
        return call(cache, tokens, true_lens, start_pos)[0]

    return ingest


def _host_ints(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu()
    return np.asarray(a, np.int64).reshape(-1)


def _make_window_forward(params: Params, config: LlamaConfig,
                         head: Optional[torch.Tensor]):
    """Makes the verify (``head`` given: logits) and the ingest
    (``head`` None: no logits). Writes exactly the valid rows of each
    window, in place: the JAX step scatters every padded row at unclamped
    positions and XLA drops those past S, where torch would fault, so the
    rows are selected on the host once a call (ROADMAP.md, C). In-range
    padding rows keep their contents."""
    c = config
    dev = params["embed"].device
    cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                device=dev)
    scale = c.head_dim ** -0.5

    def window(cache: Cache, tokens, true_lens, start_pos):
        tokens = torch.as_tensor(tokens, device=dev).long()
        B, C = tokens.shape
        S = cache["k"].shape[2]
        if B != cache["k"].shape[1]:
            raise ValueError(f"{B} windows for a cache of "
                             f"{cache['k'].shape[1]} slots")
        lens, starts = _host_ints(true_lens), _host_ints(start_pos)
        rel = np.arange(C)
        pos = starts[:, None] + rel[None, :]                   # (B, C)
        wb, wc = np.nonzero((rel[None, :] < lens[:, None]) & (pos < S))
        b_idx = torch.as_tensor(wb, device=dev)
        c_idx = torch.as_tensor(wc, device=dev)
        r_idx = torch.as_tensor(pos[wb, wc], device=dev)
        positions = torch.as_tensor(pos, device=dev)
        rope_pos = positions.clamp(max=cos.shape[0] - 1)
        allowed = (torch.arange(S, device=dev)[None, None, :]
                   <= positions[:, :, None])                  # (B, C, S)
        x = params["embed"].to(c.dtype)[tokens]               # (B, C, E)
        for i in range(c.n_layers):
            layer = layer_params(params, i)
            h = rmsnorm(x, layer["attn_norm"], c.norm_eps)
            q, k, v = _qkv(h, layer)
            q = apply_rope(q, cos, sin, rope_pos)
            k = apply_rope(k, cos, sin, rope_pos)
            kc, vc = cache["k"][i], cache["v"][i]     # (slots, S, KV, D)
            kc[b_idx, r_idx] = k[b_idx, c_idx].to(kc.dtype)
            vc[b_idx, r_idx] = v[b_idx, c_idx].to(vc.dtype)
            out = window_attention(q, kc, vc, allowed, scale)
            x = x + _attn_out(out, layer)
            x = x + _mlp(rmsnorm(x, layer["mlp_norm"], c.norm_eps), layer)
        logits = None
        if head is not None:
            x = rmsnorm(x, params["final_norm"], c.norm_eps)
            logits = (x.float().reshape(B * C, -1) @ head).reshape(B, C, -1)
        # provisional: start + window for touched slots; the engine
        # installs the accepted lengths right after
        new_len = np.where(lens > 0, starts + lens, 0)
        touched = torch.as_tensor(lens > 0, device=dev)
        cache["length"].copy_(torch.where(
            touched, torch.as_tensor(new_len, device=dev).to(torch.int32),
            cache["length"]))
        return cache, logits

    return window


def make_inject(config: LlamaConfig):
    """Build the KV injection: write an externally computed prompt KV
    (from a prefill replica or a prefix cache) into one slot, in place.

    inject(cache, k, v, true_len, slot) → cache
        k, v: (layers, P, kv_heads, head_dim) host arrays or tensors,
        padded to a bucket of at most the cache's rows; rows at or beyond
        true_len must be zero."""
    del config

    def inject(cache: Cache, k, v, true_len: int, slot: int):
        dev, dt = cache["k"].device, cache["k"].dtype
        k = tensor_from_host(k, dev, dt)
        v = tensor_from_host(v, dev, dt)
        P = k.shape[1]
        if P > cache["k"].shape[2]:
            raise ValueError(f"KV of {P} rows exceeds the cache's "
                             f"{cache['k'].shape[2]} rows")
        cache["k"][:, slot, :P] = k
        cache["v"][:, slot, :P] = v
        cache["length"][slot] = int(true_len)
        return cache

    return inject


def pad_to_bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 511) // 512) * 512


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0        # 0 → greedy
    eos_token: Optional[int] = None


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, Optional[torch.Generator]]:
    """(..., vocab) logits → (...) int32 token ids and the generator.
    Temperature 0 is the argmax (the first of tied maxima, as
    ``jnp.argmax``); above 0, one categorical draw a row from
    softmax(logits / temperature) with ``generator``, which lives on the
    logits' device and advances. ``jax.random`` streams cannot be
    reproduced here: the draws follow the same distribution, not the JAX
    package's tokens."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32), generator
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                            generator=generator)
    return tok.reshape(probs.shape[:-1]).to(torch.int32), generator

"""LLM serving: continuous batching on one GPU (port of
``ray_tpu/serve/llm.py``).

An Orca-style engine loop over a KV cache — admit waiting requests into
free slots (bucketed prefill), then advance ALL active slots one token per
decode step. ``kv_cache="paged"`` (default) backs the slots with the
block-table pool of :mod:`ray_tpu_torch.models.paged_cache`, whose decode
attention is the hand-written CUDA kernel ``paged_decode_attention_kernel``;
``kv_cache="slot"`` keeps a flat per-slot ``max_seq`` reservation and
decodes through ``decode_attention_kernel``.

Chunked prefill (``prefill_chunk``): a prompt longer than the chunk
prefills one chunk per engine iteration, interleaved with the decode of
the other slots. Prefix reuse (``prefix_cache``): ``"radix"`` shares pool
blocks between requests through the radix tree of
:mod:`ray_tpu_torch.models.prefix_cache` and prefills only a hit's
uncached suffix; ``"legacy"`` is the exact-match full-prompt host cache,
re-injected on a hit. ``submit_prefilled`` admits a request whose prompt
KV a prefill replica computed (PD disaggregation). Speculative decoding
(``speculation``, slot cache only): a proposer of
:mod:`ray_tpu_torch.models.speculation` (``"ngram"`` prompt lookup, or a
small ``"draft"`` model in lockstep) guesses up to ``k`` tokens a slot, one
batched verify forward scores every slot's window, and the acceptance rule
keeps a prefix and a bonus token; when no slot has a proposal the engine
runs the plain decode step.

Numerics: decode and prefill logits are f32 × f32 against one f32 copy of
the output head made when the engine is built (2.1 GB at 8b) — not a cast
per step. On the card the engine turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are process-wide settings), so f32
products are full f32 as in the JAX package.

``LLMServer`` wraps one engine as a Serve deployment: it takes token lists
from handles and JSON bodies from the HTTP proxy, and streams tokens to
the proxy's SSE path.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.convert import params_to

@dataclasses.dataclass
class _Request:
    prompt: List[int]
    max_tokens: int
    temperature: float
    eos_token: Optional[int]
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    output: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    enqueued_at: float = dataclasses.field(default_factory=time.monotonic)
    # KV handed off from a prefill replica (PD disaggregation): dict with
    # "k"/"v" (layers, len, kv_heads, hd) numpy + "logits" of the last
    # prompt token; admission injects instead of prefilling.
    preload: Optional[dict] = None
    # per-request speculation override, normalized by _parse_req_spec
    spec: Optional[dict] = None
    # multi-tenant identity: per-tenant fair-share admission keys off this
    tenant: Optional[str] = None
    # set by LLMEngine.cancel: the engine thread notices at its next
    # finish check and frees the slot + blocks
    cancelled: bool = False


def _parse_req_spec(speculation) -> Optional[dict]:
    """Normalize a per-request speculation override (None / bool / dict
    with "enabled" and/or "k"). On an engine built without speculation
    the override is validated, then a no-op."""
    if speculation is None:
        return None
    if isinstance(speculation, bool):
        return {"enabled": speculation, "k": None}
    if isinstance(speculation, dict):
        unknown = set(speculation) - {"enabled", "k"}
        if unknown:
            raise ValueError(
                f"per-request speculation has unknown fields "
                f"{sorted(unknown)}; overridable: ['enabled', 'k']")
        k = speculation.get("k")
        if k is not None and int(k) <= 0:
            raise ValueError("per-request speculation k must be positive")
        return {"enabled": bool(speculation.get("enabled", True)),
                "k": None if k is None else int(k)}
    raise ValueError("per-request speculation must be a bool or dict")


class LLMEngine:
    """Single-replica continuous-batching engine.

    ``kv_cache="paged"`` (default): KV memory per request tracks tokens
    actually cached, ``kv_pool_tokens`` bounds the total, and a request
    that outgrows the pool first evicts cold cached prefixes, then
    preempts the youngest other slot (recompute preemption: its blocks are
    freed and it re-queues with prompt+generated-so-far as the new
    prompt). ``kv_cache="slot"`` keeps the flat per-slot ``max_seq``
    reservation.

    Prefix reuse is off by default; ``prefix_cache`` (or the
    ``RT_prefix_cache`` environment variable) picks ``"radix"`` (paged
    only) or ``"legacy"``, and a positive ``prefix_cache_size`` or
    ``prefix_cache_bytes`` turns it on (radix when paged). Both modes
    share one byte budget, ``prefix_cache_bytes``; the legacy mode's
    entry cap ``prefix_cache_size`` applies too.

    ``device=None`` means ``"cuda"`` and raises without CUDA; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    """

    def __init__(self, config=None, params=None, *, num_slots: int = 8,
                 max_seq: Optional[int] = None, model: str = "tiny",
                 seed: int = 0, prefix_cache_size: int = 0,
                 prefix_cache: Optional[str] = None,
                 prefix_cache_bytes: Optional[int] = None,
                 kv_cache: str = "paged",
                 kv_pool_tokens: Optional[int] = None,
                 kv_block_size: int = 64,
                 prefill_chunk: Optional[int] = None,
                 speculation=None,
                 spec_k: int = 4,
                 device=None):
        from ray_tpu_torch.models import llama

        if kv_cache not in ("paged", "slot"):
            raise ValueError(f"kv_cache={kv_cache!r}: 'paged' or 'slot'")
        if kv_cache == "paged" and (kv_block_size <= 0
                                    or 2048 % kv_block_size):
            # must divide the prompt padding buckets or _prompt_pad can
            # return a non-multiple and crash every prefill
            raise ValueError(
                f"kv_block_size={kv_block_size} must divide 2048")
        if prefill_chunk is not None:
            if prefill_chunk <= 0:
                raise ValueError("prefill_chunk must be positive")
            if kv_cache == "paged" and prefill_chunk % kv_block_size:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be a multiple of "
                    f"kv_block_size={kv_block_size}")
        spec_cfg = None
        if speculation is not None:
            from ray_tpu_torch.models.speculation import SpeculationConfig

            spec_cfg = SpeculationConfig.parse(speculation, default_k=spec_k)
            if kv_cache != "slot":
                raise ValueError(
                    "speculation currently requires kv_cache='slot'")
            speculation, spec_k = spec_cfg.method, spec_cfg.k
        mode = prefix_cache
        if mode is None:
            mode = os.environ.get("RT_prefix_cache")
        if mode is None:
            if prefix_cache_size > 0 or (prefix_cache_bytes or 0) > 0:
                mode = "radix" if kv_cache == "paged" else "legacy"
            else:
                mode = "off"
        if mode not in ("radix", "legacy", "off"):
            raise ValueError(
                f"prefix_cache={mode!r}: 'radix', 'legacy' or 'off'")
        if mode == "radix" and kv_cache != "paged":
            raise ValueError("prefix_cache='radix' requires "
                             "kv_cache='paged' (it shares pool blocks)")
        self.prefill_chunk = prefill_chunk
        self.speculation = speculation
        self.spec_k = spec_k

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config or llama.CONFIGS[model]
        given = params
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(self.config, gen, self.device)
        self.params = params_to(params, self.device)
        self.num_slots = num_slots
        self.max_seq = max_seq or self.config.max_seq
        self.kv_cache = kv_cache
        head = llama.head_f32(self.params, self.config)
        if kv_cache == "paged":
            from ray_tpu_torch.models.paged_cache import (
                BlockAllocator, PagedConfig, init_paged_cache,
                make_chunked_paged_prefill, make_paged_decode_step,
                make_paged_inject, make_paged_prefill)

            pool_tokens = kv_pool_tokens or num_slots * self.max_seq
            num_blocks = 1 + -(-pool_tokens // kv_block_size)  # +null
            self._page = PagedConfig(num_blocks=num_blocks,
                                     block_size=kv_block_size,
                                     max_seq=self.max_seq)
            self._alloc = BlockAllocator(self._page, num_slots,
                                         device=self.device)
            self._cache = init_paged_cache(self.config, self._page,
                                           num_slots, device=self.device)
            self._decode = make_paged_decode_step(self.params, self.config,
                                                  self._page, head=head)
            self._prefill = make_paged_prefill(self.params, self.config,
                                               self._page, head=head)
            self._inject = make_paged_inject(self.config, self._page)

            def chunked():
                return make_chunked_paged_prefill(
                    self.params, self.config, self._page, head=head)
        else:
            from ray_tpu_torch.models.decoding import (init_cache,
                                                       make_chunked_prefill,
                                                       make_decode_step,
                                                       make_inject,
                                                       make_prefill)

            self._cache = init_cache(self.config, num_slots, self.max_seq,
                                     device=self.device)
            self._decode = make_decode_step(self.params, self.config,
                                            head=head)
            self._prefill = make_prefill(self.params, self.config,
                                         head=head)
            self._inject = make_inject(self.config)

            def chunked():
                return make_chunked_prefill(self.params, self.config,
                                            head=head)
        # Chunked prefill: prompts longer than the chunk prefill one chunk
        # per engine iteration, interleaved with the decode of the other
        # slots, so a long prompt does not stall everyone's TTFT.
        self._chunk_prefill = chunked() if prefill_chunk is not None \
            else None
        # Speculative decoding: the proposer guesses up to k tokens a slot,
        # one batched verify scores every slot's window (1-token windows
        # for slots without proposals), greedy acceptance only skips
        # compute, and temperature > 0 keeps the target distribution by
        # residual resampling.
        self._proposer = None
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._plain_steps = 0          # decode-step calls (K4 on the card)
        self._verify_steps = 0         # verify calls (plain f32 attention)
        if spec_cfg is not None:
            from ray_tpu_torch.models.decoding import make_batched_spec_verify
            from ray_tpu_torch.models.speculation import make_length_installer

            if given is not None and spec_cfg.draft_params is given:
                # a draft of the target's own weights shares its tensors
                spec_cfg = dataclasses.replace(spec_cfg,
                                               draft_params=self.params)
            self._spec_verify = make_batched_spec_verify(
                self.params, self.config, head=head)
            self._spec_fix_len = make_length_installer()
            self._proposer = spec_cfg.build_proposer(
                self.config, num_slots=num_slots, max_seq=self.max_seq,
                device=self.device)
        # slot -> {"req", "tokens", "pos"} for in-progress chunked prefills
        self._prefilling: Dict[int, dict] = {}
        self._chunks_run = 0
        # Prefix reuse across requests, off by default:
        #   "radix"  — the radix tree shares the prompt's pool blocks
        #              read-only between requests (copy-on-write at the
        #              divergence block), so a shared-system-prompt
        #              request prefills only its new tokens;
        #   "legacy" — the exact-match full-prompt host cache, kept as a
        #              parity oracle: a hit re-injects a device→host KV
        #              copy.
        self._prefix_mode = mode
        self._prefix_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._prefix_cache_size = prefix_cache_size
        self._prefix_cache_hostbytes = 0
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_match_faults = 0
        self._prefix_insert_faults = 0
        self._radix = None
        if mode == "radix":
            from ray_tpu_torch.models.paged_cache import make_block_copy
            from ray_tpu_torch.models.prefix_cache import RadixPrefixCache

            c = self.config
            bytes_per_block = (2 * c.n_layers * kv_block_size * c.n_kv_heads
                               * c.head_dim * self._cache["k"].element_size())
            if prefix_cache_bytes is None:
                # the tree may cache up to half the pool: pool-pressure
                # eviction reclaims cold blocks anyway
                prefix_cache_bytes = ((self._page.num_blocks - 1) // 2
                                      * bytes_per_block)
            self._radix = RadixPrefixCache(
                self._alloc, bytes_per_block=bytes_per_block,
                budget_bytes=prefix_cache_bytes)
            self._block_copy = make_block_copy(self.config, self._page)
            if self._chunk_prefill is None:
                # a radix hit's suffix prefill rides the chunked prefill
                # (row-level scatter, any start) even without chunking
                self._chunk_prefill = chunked()
        elif mode == "legacy" and prefix_cache_bytes is None:
            prefix_cache_bytes = 64 << 20
        self._prefix_cache_bytes = prefix_cache_bytes or 0
        self._fair_share_skips = 0

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._waiting: "collections.deque[_Request]" = collections.deque()
        self._pending: Dict[str, dict] = {}      # streaming submit/poll
        self._pending_lock = threading.Lock()
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._last_token = np.zeros(num_slots, np.int32)
        # host mirror of cached tokens per slot (= device cache length)
        self._slot_len = np.zeros(num_slots, np.int64)
        self._admit_seq = np.zeros(num_slots, np.int64)  # preempt-victim age
        self._admit_counter = 0
        self._steps = 0
        self._tokens_generated = 0
        self._preemptions = 0
        self._steps_since_sweep = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ------------------------------------------------------------- public
    def _check_vocab(self, prompt: List[int]) -> None:
        """Reject out-of-vocab prompt token ids at submission (the embed
        gather would fail inside a step shared by every slot)."""
        V = self.config.vocab_size
        for t in prompt:
            if not 0 <= int(t) < V:
                raise ValueError(
                    f"prompt token {t} out of vocab range [0, {V})")

    def _new_request(self, prompt, max_tokens, temperature, eos_token,
                     speculation, tenant) -> _Request:
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) + max_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_tokens ({max_tokens}) "
                f"exceeds max_seq {self.max_seq}")
        self._check_vocab(prompt)
        return _Request(list(prompt), max_tokens, temperature, eos_token,
                        spec=_parse_req_spec(speculation), tenant=tenant)

    def generate(self, prompt: List[int], max_tokens: int = 64,
                 temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 timeout_s: float = 300.0,
                 speculation=None, tenant: Optional[str] = None
                 ) -> List[int]:
        req = self._new_request(prompt, max_tokens, temperature, eos_token,
                                speculation, tenant)
        self._queue.put(req)
        if not req.done.wait(timeout_s):
            raise TimeoutError("generation timed out")
        if req.error:
            raise RuntimeError(req.error)
        return req.output

    def submit(self, prompt: List[int], max_tokens: int = 64,
               temperature: float = 0.0,
               eos_token: Optional[int] = None,
               speculation=None, tenant: Optional[str] = None) -> str:
        """Enqueue without blocking; poll with :meth:`poll`."""
        req = self._new_request(prompt, max_tokens, temperature, eos_token,
                                speculation, tenant)
        rid = uuid.uuid4().hex
        with self._pending_lock:
            self._pending[rid] = {"req": req, "sent": 0}
        self._queue.put(req)
        return rid

    def cancel(self, request_id: str) -> bool:
        """Mark the request cancelled and drop its poll entry. The engine
        thread notices at its next finish check and frees the slot —
        blocks are never freed from the caller's thread."""
        with self._pending_lock:
            ent = self._pending.pop(request_id, None)
        if ent is None:
            return False
        ent["req"].cancelled = True
        return True

    def submit_prefilled(self, prompt: List[int], k, v, logits,
                         max_tokens: int = 64, temperature: float = 0.0,
                         eos_token: Optional[int] = None) -> str:
        """Decode-side half of PD disaggregation: admit a request whose
        prompt KV a prefill replica computed. k/v are (layers,
        len(prompt), kv_heads, head_dim) host arrays (a JAX engine's
        bf16 ``ml_dtypes`` arrays included) or tensors on any device (a
        prefill replica's device object), logits the last prompt
        position's logits. Poll with :meth:`poll`."""
        req = self._new_request(prompt, max_tokens, temperature, eos_token,
                                None, None)
        if not isinstance(k, torch.Tensor):
            k, v = np.asarray(k), np.asarray(v)
        if isinstance(logits, torch.Tensor):
            logits = logits.float().cpu().numpy()
        c = self.config
        want = (c.n_layers, len(prompt), c.n_kv_heads, c.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            # the caller's thread: the mismatch reaches the submitter
            # instead of failing the engine loop for every request
            raise ValueError(
                f"prefilled KV shape {tuple(k.shape)}/{tuple(v.shape)} != "
                f"expected {want}")
        req.preload = {"k": k, "v": v, "logits": np.asarray(logits)}
        rid = uuid.uuid4().hex
        with self._pending_lock:
            self._pending[rid] = {"req": req, "sent": 0}
        self._queue.put(req)
        return rid

    def poll(self, request_id: str) -> Dict[str, Any]:
        """New tokens since the last poll + done flag. The entry is dropped
        once fully drained after completion."""
        with self._pending_lock:
            ent = self._pending.get(request_id)
            if ent is None:
                return {"chunks": [], "done": True}
            ent["last_poll"] = time.monotonic()
            req = ent["req"]
            out = list(req.output)   # snapshot (engine thread appends)
            chunks = out[ent["sent"]:]
            ent["sent"] = len(out)
            finished = req.done.is_set() and ent["sent"] >= len(req.output)
            if finished:
                del self._pending[request_id]
            if req.error:
                raise RuntimeError(req.error)
            return {"chunks": chunks, "done": finished}

    def stats(self) -> Dict[str, Any]:
        out = {"steps": self._steps,
               "tokens_generated": self._tokens_generated,
               "active_slots": sum(s is not None for s in self._slots),
               "queued": self._queue.qsize() + len(self._waiting),
               "kv_cache": self.kv_cache,
               "device": str(self.device),
               "fair_share_skips": self._fair_share_skips,
               "prefix_hits": self._prefix_hits,
               "prefix_misses": self._prefix_misses,
               "prefill_chunks_run": self._chunks_run,
               "prefilling_slots": len(self._prefilling),
               "spec_proposed": self._spec_proposed,
               "spec_accepted": self._spec_accepted,
               "spec_acceptance_rate": (
                   round(self._spec_accepted / self._spec_proposed, 4)
                   if self._spec_proposed else None),
               "speculation": self.speculation}
        if self._proposer is not None:
            out.update(self._proposer.stats())
        if self.kv_cache == "paged":
            out.update(
                preemptions=self._preemptions,
                kv_blocks_free=self._alloc.free_blocks(),
                kv_blocks_total=self._page.num_blocks - 1,
                kv_block_size=self._page.block_size)
        pc = {"mode": self._prefix_mode,
              "match_faults": self._prefix_match_faults,
              "insert_faults": self._prefix_insert_faults,
              "budget_bytes": self._prefix_cache_bytes}
        if self._radix is not None:
            pc.update(self._radix.stats())
            out["prefix_hits"] = pc["hits"]
            out["prefix_misses"] = pc["misses"]
        else:
            pc.update(entries=len(self._prefix_cache),
                      cached_bytes=self._prefix_cache_hostbytes)
        out["prefix_cache"] = pc
        return out

    def prefix_digest(self) -> List[int]:
        """Cached prefixes for prefix-aware routing: cumulative
        16-token-chunk hashes in the router's scheme
        (:func:`ray_tpu_torch.models.prefix_cache.prefix_hashes`). The
        engine thread mutates the cache meanwhile, so a torn walk returns
        a partial digest rather than an error (it is a routing hint)."""
        try:
            if self._radix is not None:
                return self._radix.digest()
            if self._prefix_mode == "legacy":
                from ray_tpu_torch.models.prefix_cache import prefix_hashes

                out = set()
                for key in list(self._prefix_cache):
                    out.update(prefix_hashes(list(key)))
                return sorted(out)[:128]
        except Exception:  # noqa: BLE001 — a hint only, never a failure
            pass
        return []

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------- engine
    def _prompt_pad(self, plen: int) -> int:
        """Bucketed padded prompt length (block-multiple when paged)."""
        from ray_tpu_torch.models.decoding import pad_to_bucket
        from ray_tpu_torch.models.paged_cache import pad_to_block_bucket

        if self.kv_cache == "paged":
            cap = self._page.max_blocks_per_seq * self._page.block_size
            return min(pad_to_block_bucket(plen, self._page.block_size),
                       cap)
        return min(pad_to_bucket(plen), self.max_seq)

    def _free_slot(self) -> Optional[int]:
        for slot in range(self.num_slots):
            if self._slots[slot] is None:
                return slot
        return None

    def _pick_waiting(self) -> int:
        """Index into the waiting deque of the next request to admit:
        FIFO, except that a preempted request resumes first and, under
        multi-tenant contention, a tenant holding its fair share of slots
        yields to the first under-share tenant in the queue."""
        if len(self._waiting) == 1 or self._waiting[0].output:
            return 0
        held: Dict[Optional[str], int] = {}
        for s in range(self.num_slots):
            r = self._slots[s]
            if r is not None:
                held[r.tenant] = held.get(r.tenant, 0) + 1
        tenants = {r.tenant for r in self._waiting} | set(held)
        if len(tenants) <= 1:
            return 0
        share = max(1, self.num_slots // len(tenants))
        for i, r in enumerate(self._waiting):
            if held.get(r.tenant, 0) < share:
                if i:
                    self._fair_share_skips += 1
                return i
        return 0  # every tenant at/over share: work-conserving FIFO

    def _inject_kv(self, slot: int, k, v, true_len: int):
        """Pad external KV rows to a bucket and write them into ``slot``.
        Paged: the caller must have ensure()d blocks for ``true_len``."""
        from ray_tpu_torch.models.convert import tensor_from_host

        P = self._prompt_pad(true_len)
        dev, dt = self._cache["k"].device, self._cache["k"].dtype
        k = tensor_from_host(k, dev, dt)
        v = tensor_from_host(v, dev, dt)
        pad = P - k.shape[1]
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if self.kv_cache == "paged":
            self._cache = self._inject(self._cache, self._alloc.tables[slot],
                                       k, v, true_len, slot)
        else:
            self._cache = self._inject(self._cache, k, v, true_len, slot)

    def _extract_kv(self, slot: int, true_len: int):
        """Device → host copy of one slot's prompt KV (rows [0, true_len))
        as numpy arrays in the JAX package's dtypes."""
        if self.kv_cache == "paged":
            from ray_tpu_torch.models.paged_cache import extract_kv

            return extract_kv(self._cache, self._alloc, slot, true_len)
        from ray_tpu_torch.models.convert import host_array

        return (host_array(self._cache["k"][:, slot, :true_len]),
                host_array(self._cache["v"][:, slot, :true_len]))

    def _radix_match(self, full_prompt: List[int]):
        """Longest cached prefix of the prompt. All but the last prompt
        token is eligible, so the block where the suffix prefill and the
        first decode write land is always private: a shared block is never
        written. An injected serve.llm.prefix_match fault degrades to a
        cold prefill with a typed counter, never a failed request."""
        from ray_tpu_torch.common import faults

        try:
            faults.fault_point("serve.llm.prefix_match")
        except ConnectionError:
            self._prefix_match_faults += 1
            return None
        m = self._radix.match(full_prompt[:-1])
        return m if m.matched else None

    def _radix_insert(self, req: _Request, toks: List[int], slot: int):
        """Share the slot's full-block prefix into the radix tree, zero
        copy: the tree increfs the slot's own blocks. Gated by the byte
        budget and the per-tenant fair share; an injected
        serve.llm.prefix_insert fault skips the insert with a typed
        counter (nothing is ever half-inserted)."""
        if self._radix is None:
            return
        from ray_tpu_torch.common import faults

        try:
            faults.fault_point("serve.llm.prefix_insert")
        except ConnectionError:
            self._prefix_insert_faults += 1
            return
        bs = self._page.block_size
        nfull = min(len(toks) // bs,
                    int(np.count_nonzero(self._alloc.tables[slot])))
        if nfull <= 0:
            return
        max_new = None
        tb = self._radix.tenant_blocks
        tenants = set(tb) | {req.tenant}
        if len(tenants) > 1:
            # cache-insert fair share: with several tenants caching, each
            # may pin at most its share of the byte budget
            cap = max(1, self._radix.budget_blocks() // len(tenants))
            max_new = cap - tb.get(req.tenant, 0)
            if max_new <= 0:
                self._fair_share_skips += 1
                return
        blocks = [int(b) for b in self._alloc.tables[slot, :nfull]]
        self._radix.insert(toks[:nfull * bs], blocks, tenant=req.tenant,
                           max_new=max_new)

    def _legacy_insert(self, key, logits_np, slot: int, plen: int,
                       resumed: bool):
        """Exact-match host cache insert (the legacy parity oracle), under
        the same byte budget as the radix path and the entry cap."""
        if self._prefix_mode != "legacy" or resumed:
            return
        self._prefix_misses += 1
        k, v = self._extract_kv(slot, plen)
        self._prefix_cache[key] = {"k": k, "v": v, "logits": logits_np}
        self._prefix_cache_hostbytes += k.nbytes + v.nbytes
        while self._prefix_cache and (
                (self._prefix_cache_size > 0
                 and len(self._prefix_cache) > self._prefix_cache_size)
                or (self._prefix_cache_bytes > 0
                    and self._prefix_cache_hostbytes
                    > self._prefix_cache_bytes)):
            _, old = self._prefix_cache.popitem(last=False)
            self._prefix_cache_hostbytes -= (old["k"].nbytes
                                             + old["v"].nbytes)

    def _start_prefilling(self, slot: int, req: _Request,
                          tokens: List[int], pos: int):
        """Park ``slot`` mid-prefill: the engine loop advances it one
        chunk per iteration from ``pos`` and activates it after the last
        (:meth:`_advance_chunked_prefill`)."""
        self._slots[slot] = req
        self._slot_len[slot] = 0
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        self._prefilling[slot] = {"req": req, "tokens": tokens, "pos": pos}

    def _admit(self):
        # drain the thread-safe queue into the FIFO admission deque
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except queue.Empty:
                break
        while self._waiting:
            slot = self._free_slot()
            if slot is None:
                return
            idx = self._pick_waiting()
            req = self._waiting[idx]
            if req.cancelled:
                del self._waiting[idx]
                req.done.set()
                continue
            # preempted requests resume by recomputing prompt+generated
            full_prompt = req.prompt + req.output
            plen = len(full_prompt)
            match = None
            if self.kv_cache == "paged":
                # ensure plen + 1: this iteration's decode step writes
                # the first generated token at position plen, which
                # lives in a NEW block when the prompt is block-aligned.
                total = self._alloc.blocks_for(plen + 1)
                if total > min(self._page.num_blocks - 1,
                               self._page.max_blocks_per_seq):
                    # can never fit, even with the pool idle: fail it
                    # rather than deadlock the queue
                    del self._waiting[idx]
                    req.error = (f"prompt of {plen} tokens exceeds KV "
                                 "pool capacity")
                    req.done.set()
                    continue
                if self._radix is not None and req.preload is None:
                    match = self._radix_match(full_prompt)
                shared = match.blocks if match is not None else []
                # watermark: beyond this request's blocks, keep one
                # growth block of headroom per already-active slot, or
                # admission starves running requests into preemption
                need = (total - len(shared)
                        + sum(s is not None for s in self._slots))
                if shared:
                    # pin the matched blocks first: the pool-pressure
                    # eviction below must never reclaim them
                    self._alloc.adopt(slot, shared)
                if self._alloc.free_blocks() < need and \
                        self._radix is not None:
                    self._radix.evict_for(need - self._alloc.free_blocks())
                if self._alloc.free_blocks() < need or not \
                        self._alloc.ensure(slot, plen + 1):
                    self._alloc.release(slot)  # un-pin the match
                    return  # picked request waits for blocks (no bypass)
                if match is not None and match.cow is not None:
                    # copy-on-write at the divergence block: ensure()
                    # placed a private block at the first position past
                    # the shared prefix; copy the cached block's rows into
                    # it, so the suffix prefill resumes mid-block while
                    # the cached original stays read-only
                    self._cache = self._block_copy(
                        self._cache, match.cow[0],
                        int(self._alloc.tables[slot, len(shared)]))
            del self._waiting[idx]
            resumed = bool(req.output)
            matched = match.matched if match is not None else 0
            key = tuple(full_prompt)
            cached = None
            if (self._prefix_mode == "legacy" and req.preload is None
                    and not resumed):
                cached = self._prefix_cache.get(key)
            if req.preload is not None:
                # PD handoff: prompt KV computed by a prefill replica
                self._inject_kv(slot, req.preload["k"], req.preload["v"],
                                plen)
                logits_np = req.preload["logits"]
                req.preload = None  # free the host copy
            elif cached is not None:
                self._prefix_hits += 1
                self._prefix_cache.move_to_end(key)
                self._inject_kv(slot, cached["k"], cached["v"], plen)
                logits_np = cached["logits"]
            elif matched > 0:
                # radix hit: the adopted blocks hold the prefix KV;
                # prefill only the uncached suffix, through the chunked
                # prefill, so a long suffix still interleaves with decode
                self._start_prefilling(slot, req, full_prompt, matched)
                continue
            elif (self.prefill_chunk is not None
                  and plen > self.prefill_chunk):
                self._start_prefilling(slot, req, full_prompt, 0)
                continue
            else:
                P = self._prompt_pad(plen)
                tokens = np.zeros((1, P), np.int32)
                tokens[0, :plen] = full_prompt
                if self.kv_cache == "paged":
                    self._cache, logits = self._prefill(
                        self._cache, self._alloc.tables[slot], tokens, plen,
                        slot)
                else:
                    self._cache, logits = self._prefill(self._cache, tokens,
                                                        plen, slot)
                logits_np = logits.cpu().numpy()
                self._legacy_insert(key, logits_np, slot, plen, resumed)
                self._radix_insert(req, full_prompt, slot)
            tok = self._sample(logits_np.reshape(1, -1), req.temperature)[0]
            req.output.append(int(tok))
            self._slots[slot] = req
            self._last_token[slot] = tok
            self._slot_len[slot] = plen
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            if self._proposer is not None:
                self._proposer.admit(slot, full_prompt)
            self._maybe_finish(slot)

    def _spec_decode_step(self, active: np.ndarray) -> bool:
        """One speculative iteration for all active slots: collect per-slot
        proposals, score every window in one batched verify, apply the
        acceptance rule per slot, and install the accepted lengths (the
        target's, then the proposer's rollback). Slots with no proposal
        (lookup miss, per-request opt-out, window out of room) ride the
        same forward as 1-token windows.

        Returns False without touching the cache when no slot has any
        proposal: every window would be 1 token, and the caller's plain
        decode step gives the same result for less. (A draft proposer with
        no proposals ran no decode step, so nothing needs rolling back.)"""
        from ray_tpu_torch.models.speculation import (accept_greedy,
                                                      accept_speculative)

        C = self.spec_k + 1
        infos: Dict[int, dict] = {}
        for slot in range(self.num_slots):
            if not active[slot]:
                continue
            req = self._slots[slot]
            start = int(self._slot_len[slot])
            k_req = self.spec_k
            if req.spec is not None:
                if not req.spec["enabled"]:
                    k_req = 0
                elif req.spec["k"] is not None:
                    k_req = min(req.spec["k"], self.spec_k)
            room = req.max_tokens - len(req.output)
            k_eff = max(0, min(k_req, room - 1, self.max_seq - start - 1))
            infos[slot] = {"seq": req.prompt + req.output,
                           "target_len": start, "k": k_eff}
        proposals = self._proposer.propose(infos) if infos else {}
        if not any(proposals.get(slot) for slot in infos):
            return False
        buf = np.zeros((self.num_slots, C), np.int32)
        true_lens = np.zeros(self.num_slots, np.int32)
        starts = np.zeros(self.num_slots, np.int32)
        for slot, info in infos.items():
            props = proposals.get(slot) or []
            buf[slot, 0] = self._last_token[slot]
            buf[slot, 1:1 + len(props)] = props
            true_lens[slot] = 1 + len(props)
            starts[slot] = info["target_len"]
        self._cache, all_logits = self._spec_verify(self._cache, buf,
                                                    true_lens, starts)
        self._verify_steps += 1
        # greedy slots need only the (B, C) argmax ids, taken on the
        # device: the full logits leave it only when some slot samples
        greedy_np = all_logits.argmax(-1).cpu().numpy()
        need_full = any(self._slots[s].temperature > 0.0 for s in infos)
        logits_np = all_logits.cpu().numpy() if need_full else None
        # increment before seeding, like _sample: seeding first would reuse
        # the stream the previous plain step sampled with
        self._steps += 1
        rng = np.random.default_rng(self._steps)
        accepted_map: Dict[int, int] = {}
        touched = np.zeros(self.num_slots, bool)
        new_lens = np.zeros(self.num_slots, np.int32)
        for slot in sorted(infos):
            req = self._slots[slot]
            props = proposals.get(slot) or []
            if req.temperature <= 0.0:
                emitted, accepted = accept_greedy(
                    greedy_np[slot, :1 + len(props)], props)
            else:
                emitted, accepted = accept_speculative(
                    logits_np[slot, :1 + len(props)], props,
                    req.temperature, rng)
            self._spec_proposed += len(props)
            self._spec_accepted += accepted
            accepted_map[slot] = accepted
            # max_tokens and eos inside the window
            room = req.max_tokens - len(req.output)
            emitted = emitted[:max(1, room)]
            if req.eos_token is not None and req.eos_token in emitted:
                emitted = emitted[:emitted.index(req.eos_token) + 1]
            req.output.extend(emitted)
            self._last_token[slot] = emitted[-1]
            # the last emitted token is pending (not cached yet): the
            # accepted length is start + len(emitted); rejected rows past
            # it are invisible and get overwritten later
            new_len = int(starts[slot]) + len(emitted)
            self._slot_len[slot] = new_len
            touched[slot] = True
            new_lens[slot] = new_len
            self._tokens_generated += len(emitted)
        if touched.any():
            dev = self._cache["length"].device
            self._cache["length"] = self._spec_fix_len(
                self._cache["length"], torch.as_tensor(new_lens, device=dev),
                torch.as_tensor(touched, device=dev))
        self._proposer.after_verify(accepted_map)
        for slot in sorted(accepted_map):
            self._maybe_finish(slot)
        return True

    def _advance_chunked_prefill(self):
        """Run one chunk of the oldest in-progress chunked prefill; after
        the last chunk, sample the first token and activate the slot."""
        slot = next(iter(self._prefilling))
        st = self._prefilling[slot]
        toks, pos, C = st["tokens"], st["pos"], self.prefill_chunk
        if C is None:
            # a radix hit's suffix on an engine without chunked prefill:
            # one call covering the whole uncached suffix
            C = self._prompt_pad(len(toks) - pos)
        n = min(C, len(toks) - pos)
        buf = np.zeros((1, C), np.int32)
        buf[0, :n] = toks[pos:pos + n]
        if self.kv_cache == "paged":
            self._cache, logits = self._chunk_prefill(
                self._cache, self._alloc.tables[slot], buf, n, pos, slot)
        else:
            self._cache, logits = self._chunk_prefill(self._cache, buf, n,
                                                      pos, slot)
        self._chunks_run += 1
        st["pos"] = pos + n
        if st["pos"] < len(toks):
            return
        req = st["req"]
        del self._prefilling[slot]
        plen = len(toks)
        logits_np = logits.cpu().numpy()
        self._legacy_insert(tuple(toks), logits_np, slot, plen,
                            bool(req.output))
        self._radix_insert(req, toks, slot)
        tok = self._sample(logits_np.reshape(1, -1), req.temperature)[0]
        req.output.append(int(tok))
        self._last_token[slot] = tok
        self._slot_len[slot] = plen
        if self._proposer is not None:
            self._proposer.admit(slot, toks)
        self._maybe_finish(slot)

    def _sample(self, logits: np.ndarray, temperature: float) -> np.ndarray:
        if temperature <= 0.0:
            return logits.argmax(-1).astype(np.int32)
        z = logits / max(temperature, 1e-5)
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        rng = np.random.default_rng(self._steps)
        return np.array([rng.choice(p.shape[-1], p=row) for row in p],
                        np.int32)

    def _maybe_finish(self, slot: int):
        req = self._slots[slot]
        if req is None:
            return
        done = (req.cancelled
                or len(req.output) >= req.max_tokens
                or (req.eos_token is not None and req.output
                    and req.output[-1] == req.eos_token)
                or len(req.prompt) + len(req.output) >= self.max_seq)
        if done:
            if self._radix is not None and not req.cancelled:
                # on completion, offer the whole cached sequence (prompt +
                # generated) to the tree: multi-turn conversations hit on
                # their own history. Zero copy: the tree increfs the
                # blocks release() is about to drop the slot's ref on.
                seq = (req.prompt + req.output)[:int(self._slot_len[slot])]
                self._radix_insert(req, seq, slot)
            req.done.set()
            self._slots[slot] = None
            if self._proposer is not None:
                self._proposer.release(slot)
            if self.kv_cache == "paged":
                self._alloc.release(slot)

    def _preempt(self, slot: int):
        """Recompute preemption: free the slot's blocks and put the
        request back at the HEAD of the admission queue; it resumes by
        prefilling prompt+generated-so-far."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._alloc.release(slot)
        if self._proposer is not None:
            self._proposer.release(slot)
        # a mid-chunked-prefill victim restarts its prefill on re-admission
        self._prefilling.pop(slot, None)
        self._waiting.appendleft(req)
        self._preemptions += 1

    def _grow_active_slots(self) -> None:
        """Before a decode step each active slot needs its next token's
        block. On pool exhaustion, evict cold cached prefixes first, then
        preempt the youngest other active slot; a slot alone in the pool
        preempts itself."""
        for slot in range(self.num_slots):
            if self._slots[slot] is None:
                continue
            while not self._alloc.ensure(slot, int(self._slot_len[slot]) + 1):
                # LRU, refcount-0 only: a block any live slot references
                # is untouchable
                if self._radix is not None and self._radix.evict_for(1):
                    continue
                victims = [s for s in range(self.num_slots)
                           if s != slot and self._slots[s] is not None]
                if victims:
                    victim = max(victims, key=lambda s: self._admit_seq[s])
                else:
                    victim = slot
                self._preempt(victim)
                if victim == slot:
                    break

    def _loop(self):
        # grad mode is thread-local: the engine thread sets its own
        with torch.inference_mode():
            if self.device.type == "cuda" and self.device.index is not None:
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                try:
                    self._loop_once()
                except Exception as e:  # noqa: BLE001 — engine must survive
                    logging.getLogger(__name__).error(
                        "engine step failed:\n%s", traceback.format_exc())
                    # fail every active request rather than hanging them
                    for slot in range(self.num_slots):
                        req = self._slots[slot]
                        if req is not None:
                            req.error = f"engine step failed: {e!r}"
                            req.done.set()
                            self._slots[slot] = None
                            if self.kv_cache == "paged":
                                self._alloc.release(slot)
                    self._prefilling.clear()

    _PENDING_TTL_S = 180.0

    def _sweep_pending(self):
        """Drop submit/poll entries whose client stopped polling."""
        now = time.monotonic()
        with self._pending_lock:
            stale = [rid for rid, ent in self._pending.items()
                     if now - ent.get("last_poll",
                                      ent["req"].enqueued_at)
                     > self._PENDING_TTL_S]
            for rid in stale:
                del self._pending[rid]

    def _loop_once(self):
        self._steps_since_sweep += 1
        if self._steps_since_sweep >= 500:
            self._steps_since_sweep = 0
            self._sweep_pending()
        # grow BEFORE admitting: otherwise a tight pool admits the queue
        # head (paying its prefill), then immediately preempts it as the
        # youngest slot to feed an older slot's growth
        if self.kv_cache == "paged":
            self._grow_active_slots()
        self._admit()
        # one prefill chunk per iteration: bounded interference with the
        # decode of the already-active slots
        if self._prefilling:
            self._advance_chunked_prefill()
        active = np.array([self._slots[s] is not None
                           and s not in self._prefilling
                           for s in range(self.num_slots)])
        if not active.any():
            if not self._prefilling:
                time.sleep(0.002)
            return
        # speculation replaces the decode step: every active slot gets a
        # verify window; when no slot has a proposal this iteration, the
        # plain (cheaper) decode step below runs instead
        if self._proposer is not None and self._spec_decode_step(active):
            return
        if self.kv_cache == "paged":
            self._cache, logits = self._decode(
                self._cache, self._alloc.device_tables(), self._last_token,
                active)
        else:
            self._cache, logits = self._decode(self._cache, self._last_token,
                                               active)
        logits_np = logits.cpu().numpy()
        self._steps += 1
        self._plain_steps += 1
        for slot in range(self.num_slots):
            req = self._slots[slot]
            if req is None or slot in self._prefilling:
                # mid-prefill slots were masked out of the decode
                continue
            tok = self._sample(logits_np[slot][None], req.temperature)[0]
            req.output.append(int(tok))
            self._last_token[slot] = tok
            self._slot_len[slot] += 1
            self._tokens_generated += 1
            self._maybe_finish(slot)


class LLMServer:
    """Serve deployment wrapper: one engine per replica.

    Deploy with ``serve.deployment(LLMServer).options(
    ray_actor_options={"num_gpus": 1})`` (or ``serve.api.llm_app``), so the
    replica holds a GPU lease; requests are token-id lists (tokenization
    is a host-side pre/post step, kept off the replica).
    """

    def __init__(self, model: str = "tiny", num_slots: int = 8,
                 max_seq: Optional[int] = None, **engine_kwargs):
        self.engine = LLMEngine(model=model, num_slots=num_slots,
                                max_seq=max_seq, **engine_kwargs)

    @staticmethod
    def _parse(prompt_or_request, kwargs: Dict[str, Any]):
        """Accept either direct args (handle calls) or a proxy Request whose
        JSON body is {"prompt": [...], "max_tokens": n, ...}."""
        from ray_tpu_torch.serve.proxy import Request

        if isinstance(prompt_or_request, Request):
            body = prompt_or_request.json() or {}
            merged = {"max_tokens": body.get("max_tokens", 64),
                      "temperature": body.get("temperature", 0.0),
                      "eos_token": body.get("eos_token"),
                      "speculation": body.get("speculation"),
                      # tenant identity for engine-level fair share:
                      # body field wins, else the same x-client-id
                      # header the proxy's admission control keys on
                      "tenant": (body.get("tenant")
                                 or prompt_or_request.headers.get(
                                     "x-client-id"))}
            return body.get("prompt", []), merged
        return prompt_or_request, kwargs

    def __call__(self, prompt_or_request, **kwargs) -> List[int]:
        prompt, kw = self._parse(prompt_or_request, kwargs)
        return self.engine.generate(
            prompt, kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("eos_token"), speculation=kw.get("speculation"),
            tenant=kw.get("tenant"))

    def submit(self, prompt_or_request, **kwargs) -> str:
        prompt, kw = self._parse(prompt_or_request, kwargs)
        return self.engine.submit(
            prompt, kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("eos_token"), speculation=kw.get("speculation"),
            tenant=kw.get("tenant"))

    def poll(self, request_id: str) -> Dict[str, Any]:
        return self.engine.poll(request_id)

    def cancel(self, request_id: str) -> bool:
        return self.engine.cancel(request_id)

    def prefix_digest(self) -> List[int]:
        """Exported through the Replica harness → controller →
        router-refresh path so prefix-aware handles can route to the
        replica holding the longest cached prefix."""
        return self.engine.prefix_digest()

    def stream(self, prompt_or_request, **kwargs):
        """Generator-protocol streaming: tokens yield as the engine
        produces them, and the proxy's SSE path pushes each one to the
        client over the streaming-generator protocol — no proxy→replica
        poll RPCs. The wait on the engine is replica-local (this generator
        runs on the replica's executor thread, never an event loop).
        ``submit``/``poll`` stay for pre-generator callers."""
        prompt, kw = self._parse(prompt_or_request, kwargs)
        request_id = self.engine.submit(
            prompt, kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("eos_token"), speculation=kw.get("speculation"),
            tenant=kw.get("tenant"))
        from ray_tpu_torch.serve.proxy import SSEBatch

        while True:
            st = self.engine.poll(request_id)
            chunks = st["chunks"]
            if len(chunks) == 1:
                yield chunks[0]
            elif chunks:
                # burst since the last engine poll: ONE streamed item (one
                # report RPC), fanned back out to per-token SSE events at
                # the proxy
                yield SSEBatch(chunks)
            if st["done"]:
                return
            time.sleep(0.005)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

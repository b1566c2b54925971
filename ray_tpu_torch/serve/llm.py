"""LLM serving: continuous batching on one GPU (port of
``ray_tpu/serve/llm.py``).

An Orca-style engine loop over a KV cache — admit waiting requests into
free slots (bucketed prefill), then advance ALL active slots one token per
decode step. ``kv_cache="paged"`` (default) backs the slots with the
block-table pool of :mod:`ray_tpu_torch.models.paged_cache`, whose decode
attention is the hand-written CUDA kernel ``paged_decode_attention_kernel``;
``kv_cache="slot"`` keeps a flat per-slot ``max_seq`` reservation and
decodes through ``decode_attention_kernel``.

Numerics: decode and prefill logits are f32 × f32 against one f32 copy of
the output head made when the engine is built (2.1 GB at 8b) — not a cast
per step. On the card the engine turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are process-wide settings), so f32
products are full f32 as in the JAX package.

Not ported yet, and refused with ``NotImplementedError``: prefix caching,
chunked prefill, speculation, PD ``submit_prefilled``, the Serve proxy's
``Request`` bodies and ``LLMServer.stream`` (ROADMAP.md, queue A).
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

_ROADMAP = {
    "prefill_chunk": "queue A item 1, chunked paged prefill",
    "prefix_cache": "queue A item 2, radix prefix cache",
    "submit_prefilled": "queue A item 3, PD inject/extract",
    "speculation": "queue A item 4, speculative decoding",
    "serve": "queue A item 5, LLMServer.stream and the Serve proxy",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet "
        f"(ROADMAP.md, {_ROADMAP[item]})")


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
    that outgrows the pool preempts the youngest other slot (recompute
    preemption: its blocks are freed and it re-queues with
    prompt+generated-so-far as the new prompt). ``kv_cache="slot"`` keeps
    the flat per-slot ``max_seq`` reservation.

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
            raise _not_ported("prefill_chunk", "prefill_chunk")
        if speculation is not None:
            raise _not_ported("speculation", "speculation")
        # the reference's order: resolve the mode, refuse what no engine
        # takes, then what the port does not take yet
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
        if mode != "off":
            # the legacy mode re-injects cached KV: it rests on item 3
            raise _not_ported(f"prefix_cache={mode!r}",
                              "prefix_cache" if mode == "radix"
                              else "submit_prefilled")
        self.prefill_chunk = prefill_chunk
        self.speculation = speculation
        self.spec_k = spec_k
        self._prefix_cache_bytes = prefix_cache_bytes or 0

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config or llama.CONFIGS[model]
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = llama.init_params(self.config, gen, self.device)
        self.params = _to_device(params, self.device)
        self.num_slots = num_slots
        self.max_seq = max_seq or self.config.max_seq
        self.kv_cache = kv_cache
        head = llama.head_f32(self.params, self.config)
        if kv_cache == "paged":
            from ray_tpu_torch.models.paged_cache import (
                BlockAllocator, PagedConfig, init_paged_cache,
                make_paged_decode_step, make_paged_prefill)

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
        else:
            from ray_tpu_torch.models.decoding import (init_cache,
                                                       make_decode_step,
                                                       make_prefill)

            self._cache = init_cache(self.config, num_slots, self.max_seq,
                                     device=self.device)
            self._decode = make_decode_step(self.params, self.config,
                                            head=head)
            self._prefill = make_prefill(self.params, self.config,
                                         head=head)
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

    def submit_prefilled(self, *args, **kwargs) -> str:
        raise _not_ported("submit_prefilled", "submit_prefilled")

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
               # the reference's keys for features that are off here
               "prefix_hits": 0,
               "prefix_misses": 0,
               "prefill_chunks_run": 0,
               "prefilling_slots": 0,
               "spec_proposed": 0,
               "spec_accepted": 0,
               "spec_acceptance_rate": None,
               "speculation": self.speculation,
               "prefix_cache": {"mode": "off",
                                "match_faults": 0, "insert_faults": 0,
                                "budget_bytes": self._prefix_cache_bytes,
                                "entries": 0, "cached_bytes": 0}}
        if self.kv_cache == "paged":
            out.update(
                preemptions=self._preemptions,
                kv_blocks_free=self._alloc.free_blocks(),
                kv_blocks_total=self._page.num_blocks - 1,
                kv_block_size=self._page.block_size)
        return out

    def prefix_digest(self) -> List[int]:
        """Cached prefixes for prefix-aware routing: none, as the
        reference's engine with its prefix cache off."""
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
                # watermark: beyond this request's blocks, keep one
                # growth block of headroom per already-active slot, or
                # admission starves running requests into preemption
                need = total + sum(s is not None for s in self._slots)
                if self._alloc.free_blocks() < need or not \
                        self._alloc.ensure(slot, plen + 1):
                    self._alloc.release(slot)
                    return  # picked request waits for blocks (no bypass)
            del self._waiting[idx]
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
            tok = self._sample(logits_np.reshape(1, -1), req.temperature)[0]
            req.output.append(int(tok))
            self._slots[slot] = req
            self._last_token[slot] = tok
            self._slot_len[slot] = plen
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
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
            req.done.set()
            self._slots[slot] = None
            if self.kv_cache == "paged":
                self._alloc.release(slot)

    def _preempt(self, slot: int):
        """Recompute preemption: free the slot's blocks and put the
        request back at the HEAD of the admission queue; it resumes by
        prefilling prompt+generated-so-far."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._alloc.release(slot)
        self._waiting.appendleft(req)
        self._preemptions += 1

    def _grow_active_slots(self) -> None:
        """Before a decode step each active slot needs its next token's
        block. On pool exhaustion, preempt the youngest other active
        slot; a slot alone in the pool preempts itself."""
        for slot in range(self.num_slots):
            if self._slots[slot] is None:
                continue
            while not self._alloc.ensure(slot, int(self._slot_len[slot]) + 1):
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
        active = np.array([s is not None for s in self._slots])
        if not active.any():
            time.sleep(0.002)
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
        for slot in range(self.num_slots):
            req = self._slots[slot]
            if req is None:
                continue
            tok = self._sample(logits_np[slot][None], req.temperature)[0]
            req.output.append(int(tok))
            self._last_token[slot] = tok
            self._slot_len[slot] += 1
            self._tokens_generated += 1
            self._maybe_finish(slot)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMServer:
    """Serve deployment wrapper: one engine per replica. Requests are
    token-id lists (tokenization is a host-side pre/post step)."""

    def __init__(self, model: str = "tiny", num_slots: int = 8,
                 max_seq: Optional[int] = None, **engine_kwargs):
        self.engine = LLMEngine(model=model, num_slots=num_slots,
                                max_seq=max_seq, **engine_kwargs)

    @staticmethod
    def _parse(prompt, kwargs: Dict[str, Any]):
        if not isinstance(prompt, (list, tuple)):
            raise _not_ported("proxy Request bodies", "serve")
        return prompt, kwargs

    def __call__(self, prompt, **kwargs) -> List[int]:
        prompt, kw = self._parse(prompt, kwargs)
        return self.engine.generate(
            prompt, kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("eos_token"), speculation=kw.get("speculation"),
            tenant=kw.get("tenant"))

    def submit(self, prompt, **kwargs) -> str:
        prompt, kw = self._parse(prompt, kwargs)
        return self.engine.submit(
            prompt, kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("eos_token"), speculation=kw.get("speculation"),
            tenant=kw.get("tenant"))

    def poll(self, request_id: str) -> Dict[str, Any]:
        return self.engine.poll(request_id)

    def cancel(self, request_id: str) -> bool:
        return self.engine.cancel(request_id)

    def prefix_digest(self) -> List[int]:
        return self.engine.prefix_digest()

    def stream(self, prompt, **kwargs):
        raise _not_ported("LLMServer.stream", "serve")

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

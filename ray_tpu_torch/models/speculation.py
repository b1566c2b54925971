"""Speculative decoding: pluggable proposers and the acceptance rule
(port of ``ray_tpu/models/speculation.py``).

The serve engine (:mod:`ray_tpu_torch.serve.llm`) turns a decode iteration
into a *verify* step over a window of up to k+1 tokens per slot
(:func:`ray_tpu_torch.models.decoding.make_batched_spec_verify`): a
proposer guesses up to k next tokens per active slot, the target model
scores every window in one forward, and the rejection-sampling rule
accepts a prefix and one bonus token. Slots with no proposal ride the
same forward as 1-token windows, a plain decode step, so speculation
composes with continuous batching.

Proposers:

- ``ngram``: prompt lookup. Propose the k tokens that followed the most
  recent earlier occurrence of the trailing n-gram. No model, no device
  state.
- ``draft``: a small Llama-family model in lockstep with the target. Its
  own slot cache is prefilled on admission, advanced k greedy decode steps
  per round (``decode_attention_kernel`` on the card), and rolled back to
  the accepted prefix after each verify. A slot the draft fell behind on
  (an all-k acceptance consumes one token the draft never cached) catches
  up through the draft's KV ingest before it proposes.

Acceptance (:func:`accept_speculative`): proposals are deterministic given
the proposer's state, a delta distribution q. At temperature 0 the rule is
the argmax-chain comparison (the tokens of plain greedy decoding). Above
0, token x is accepted with probability p(x); on rejection the bonus token
is drawn from the residual p with x zeroed, renormalized, so the emitted
stream follows the target distribution. The acceptance is numpy host
code, the reference's, with the same ``rng`` calls in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_METHODS = ("ngram", "draft")
# no "enabled" here: engine-level speculation is off with speculation=None;
# the per-request opt-out ({"enabled": False}) is another surface
# (serve.llm._parse_req_spec)
_DICT_KEYS = {"method", "k", "ngram", "draft_model", "draft_config",
              "draft_params", "draft_seed"}


@dataclasses.dataclass(frozen=True)
class SpeculationConfig:
    """Canonical speculation config (the engine's ``speculation``).

    Accepted forms (``parse``): a method string (``"ngram"``, ``"draft"``)
    or a dict ``{"method": ..., "k": ..., "draft_model": ...}``.
    ``draft_model`` names a config in
    :data:`ray_tpu_torch.models.llama.CONFIGS`; explicit ``draft_config``
    and ``draft_params`` override it (they are not JSON-serializable, so
    ``to_dict`` drops them)."""

    method: str = "ngram"
    k: int = 4
    ngram: int = 2
    draft_model: Optional[str] = None
    draft_config: Any = None
    draft_params: Any = None
    draft_seed: int = 1

    @classmethod
    def parse(cls, spec, default_k: int = 4) -> "SpeculationConfig":
        if isinstance(spec, SpeculationConfig):
            return spec
        if isinstance(spec, str):
            spec = {"method": spec}
        if not isinstance(spec, dict):
            raise ValueError(
                f"speculation must be a method string or dict, got "
                f"{type(spec).__name__}")
        unknown = set(spec) - _DICT_KEYS
        if unknown:
            raise ValueError(
                f"speculation has unknown fields {sorted(unknown)}; "
                f"known: {sorted(_DICT_KEYS)}")
        method = spec.get("method", "ngram")
        if method not in _METHODS:
            raise ValueError(
                f"speculation method {method!r}: one of {_METHODS}")
        k = int(spec.get("k", default_k))
        if k <= 0:
            raise ValueError("speculation k must be positive")
        ngram = int(spec.get("ngram", 2))
        if ngram <= 0:
            raise ValueError("speculation ngram must be positive")
        out = cls(method=method, k=k, ngram=ngram,
                  draft_model=spec.get("draft_model"),
                  draft_config=spec.get("draft_config"),
                  draft_params=spec.get("draft_params"),
                  draft_seed=int(spec.get("draft_seed", 1)))
        if method == "draft" and out.draft_model is None \
                and out.draft_config is None:
            raise ValueError(
                "speculation method 'draft' needs a draft_model name "
                "(ray_tpu_torch.models.llama.CONFIGS) or an explicit "
                "draft_config/draft_params pair")
        return out

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able canonical form; drops the explicit config and params."""
        out: Dict[str, Any] = {"method": self.method, "k": self.k}
        if self.method == "ngram":
            out["ngram"] = self.ngram
        if self.draft_model is not None:
            out["draft_model"] = self.draft_model
            out["draft_seed"] = self.draft_seed
        return out

    def build_proposer(self, target_config, *, num_slots: int,
                       max_seq: int, device=None):
        """The proposer on ``device`` (default: the CPU). A ``draft_model``
        without ``draft_params`` is initialised there from
        ``torch.Generator(device).manual_seed(draft_seed)``, so its weights
        differ from the JAX package's ``jax.random.key(draft_seed)``
        init."""
        if self.method == "ngram":
            return NgramProposer(self.k, ngram=self.ngram)
        from ray_tpu_torch.models import llama

        config = self.draft_config
        if config is None:
            if self.draft_model not in llama.CONFIGS:
                raise ValueError(
                    f"draft_model {self.draft_model!r}: not in "
                    f"{sorted(llama.CONFIGS)}")
            config = llama.CONFIGS[self.draft_model]
        _check_vocab(config, target_config)   # before a draft's GBs of init
        device = torch.device("cpu" if device is None else device)
        params = self.draft_params
        if params is None:
            gen = torch.Generator(device=device).manual_seed(self.draft_seed)
            params = llama.init_params(config, gen, device)
        return DraftProposer(target_config, config, params,
                             num_slots=num_slots, max_seq=max_seq,
                             k=self.k, device=device)


def _check_vocab(draft_config, target_config) -> None:
    if draft_config.vocab_size != target_config.vocab_size:
        raise ValueError(
            f"draft/target tokenizer mismatch: draft vocab_size "
            f"{draft_config.vocab_size} != target "
            f"{target_config.vocab_size} — speculation requires the "
            "models to share one tokenizer")


def make_length_installer():
    """``install(length, new, touched) -> where(touched, new, length)``:
    the cache lengths after a verify (the target's and the draft's
    rollback), one elementwise select however many slots changed."""
    return lambda length, new, touched: torch.where(
        touched, new.to(length.dtype), length)


def propose_ngram(context: List[int], k: int, ngram: int = 2):
    """Prompt-lookup proposal: find the most recent earlier occurrence of
    the trailing ``ngram`` tokens and propose the k tokens that followed
    it. None if no match."""
    if len(context) < ngram + 1 or k <= 0:
        return None
    tail = context[-ngram:]
    # scan right to left, excluding the trailing occurrence itself
    for i in range(len(context) - ngram - 1, -1, -1):
        if context[i:i + ngram] == tail:
            nxt = context[i + ngram:i + ngram + k]
            if nxt:
                return list(nxt)
            return None
    return None


class Proposer:
    """Per-slot proposal source driven by the engine loop.

    ``infos`` (propose) maps slot -> {"seq": prompt+output token list (the
    last entry is the pending token, not yet in any cache), "target_len":
    tokens cached in the target's slot, "k": most proposals wanted for
    this slot this round (0 = plain decode)}."""

    def admit(self, slot: int, tokens: List[int]) -> None:
        """Slot was (re)admitted with ``tokens`` cached in the target."""

    def release(self, slot: int) -> None:
        """Slot finished or was preempted."""

    def propose(self, infos: Dict[int, dict]) -> Dict[int, List[int]]:
        raise NotImplementedError

    def after_verify(self, accepted: Dict[int, int]) -> None:
        """Per-slot accepted counts from the verify just run (slots that
        finished inside the window are included; release() follows)."""

    def stats(self) -> Dict[str, Any]:
        return {}


class NgramProposer(Proposer):
    """Prompt-lookup proposals per slot; no model, no device state."""

    def __init__(self, k: int, ngram: int = 2):
        self.k = k
        self.ngram = ngram

    def propose(self, infos: Dict[int, dict]) -> Dict[int, List[int]]:
        out = {}
        for slot, info in infos.items():
            prop = propose_ngram(info["seq"], info["k"], self.ngram)
            out[slot] = prop or []
        return out


class DraftProposer(Proposer):
    """Small-model proposals: the draft keeps its own slot cache in
    lockstep with the target (prefill on admission, k batched greedy
    decode steps a round, rollback to the accepted prefix after the
    verify, a KV-ingest catch-up when it falls a token behind).
    ``draft_params`` already on ``device`` are used as they are, so a
    draft of the target's own weights shares the target's tensors."""

    def __init__(self, target_config, draft_config, draft_params, *,
                 num_slots: int, max_seq: int, k: int = 4, device=None):
        from ray_tpu_torch.models.decoding import (init_cache,
                                                   make_decode_step,
                                                   make_kv_ingest,
                                                   make_prefill)
        from ray_tpu_torch.models.convert import params_to
        from ray_tpu_torch.models.llama import head_f32

        _check_vocab(draft_config, target_config)
        self.device = torch.device(
            draft_params["embed"].device if device is None else device)
        self.config = draft_config
        self.params = params_to(draft_params, self.device)
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.k = k
        self.cache = init_cache(draft_config, num_slots, max_seq,
                                device=self.device)
        head = head_f32(self.params, draft_config)
        self._prefill = make_prefill(self.params, draft_config, head=head)
        self._decode = make_decode_step(self.params, draft_config, head=head)
        self._ingest = make_kv_ingest(self.params, draft_config)
        self._len = np.zeros(num_slots, np.int64)   # host mirror
        self._last_m: Dict[int, int] = {}           # proposals last round
        self.draft_steps = 0
        self._fix_len = make_length_installer()

    def admit(self, slot: int, tokens: List[int]) -> None:
        from ray_tpu_torch.models.decoding import pad_to_bucket

        P = min(pad_to_bucket(len(tokens)), self.max_seq)
        buf = np.zeros((1, P), np.int32)
        buf[0, :len(tokens)] = tokens
        self.cache, _ = self._prefill(self.cache, buf, len(tokens), slot)
        self._len[slot] = len(tokens)
        self._last_m.pop(slot, None)

    def release(self, slot: int) -> None:
        self._len[slot] = 0
        self._last_m.pop(slot, None)

    def _catch_up(self, infos: Dict[int, dict]) -> None:
        """Ingest the sequence tokens the draft cache is missing (one,
        after an all-k acceptance) in windows of up to k+1 tokens."""
        # a fixed window width, as in the reference (its compiled ingest
        # is shaped by it); per-slot k shrinks near max_tokens/max_seq
        C = self.k + 1
        while True:
            missing = {}
            for slot, info in infos.items():
                # k == 0 slots (opted out, window out of room) never
                # propose: their gap is ingested if k becomes positive
                if info["k"] <= 0:
                    continue
                have = int(self._len[slot])
                if have < info["target_len"]:
                    missing[slot] = info["seq"][have:info["target_len"]]
            if not missing:
                return
            buf = np.zeros((self.num_slots, C), np.int32)
            true_lens = np.zeros(self.num_slots, np.int32)
            starts = np.asarray(self._len, np.int32).copy()
            for slot, toks in missing.items():
                n = min(len(toks), C)
                buf[slot, :n] = toks[:n]
                true_lens[slot] = n
            self.cache = self._ingest(self.cache, buf, true_lens, starts)
            for slot in missing:
                self._len[slot] += int(true_lens[slot])

    def propose(self, infos: Dict[int, dict]) -> Dict[int, List[int]]:
        self._last_m = {}
        if not infos:
            return {}
        self._catch_up(infos)
        props: Dict[int, List[int]] = {s: [] for s in infos}
        kmax = max(info["k"] for info in infos.values())
        feed = np.zeros(self.num_slots, np.int32)
        for slot, info in infos.items():
            feed[slot] = info["seq"][-1]
        for step in range(kmax):
            active = np.zeros(self.num_slots, bool)
            for slot, info in infos.items():
                active[slot] = info["k"] > step
            if not active.any():
                break
            self.cache, logits = self._decode(self.cache, feed, active)
            self.draft_steps += 1
            toks = logits.argmax(-1).cpu().numpy()    # (B,) ids, not logits
            for slot, info in infos.items():
                if info["k"] > step:
                    t = int(toks[slot])
                    props[slot].append(t)
                    feed[slot] = t
                    self._len[slot] += 1
        self._last_m = {s: len(p) for s, p in props.items()}
        return props

    def after_verify(self, accepted: Dict[int, int]) -> None:
        """Roll the draft cache back to the accepted prefix: rows
        [target_len, target_len + min(a+1, m)) hold fed window tokens the
        accepted sequence kept; rejected rows sit past the new length and
        later writes overwrite them. An all-k acceptance leaves the draft
        one token short (the last proposal was never fed): the next
        round's catch-up feeds it."""
        touched = np.zeros(self.num_slots, bool)
        new_lens = np.zeros(self.num_slots, np.int32)
        for slot, a in accepted.items():
            m = self._last_m.get(slot, 0)
            if m == 0:
                continue
            pre = int(self._len[slot]) - m
            new = pre + min(a + 1, m)
            self._len[slot] = new
            touched[slot] = True
            new_lens[slot] = new
        if touched.any():
            self.cache["length"] = self._fix_len(
                self.cache["length"],
                torch.as_tensor(new_lens, device=self.device),
                torch.as_tensor(touched, device=self.device))

    def stats(self) -> Dict[str, Any]:
        return {"spec_draft_steps": self.draft_steps}


def _softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    z = logits.astype(np.float64) / max(temperature, 1e-5)
    z -= z.max()
    p = np.exp(z)
    return p / p.sum()


def accept_greedy(greedy: np.ndarray, proposal: List[int]) -> tuple:
    """Temperature-0 acceptance from the window's argmax ids only.

    ``greedy``: (1+m,) argmax token per window position. Equals
    ``accept_speculative(logits, proposal, 0.0, ...)``, and lets the
    engine ship (B, C) ids off the device instead of the (B, C, vocab)
    logits when no active slot samples."""
    m = len(proposal)
    a = 0
    while a < m and int(greedy[a]) == proposal[a]:
        a += 1
    return [int(t) for t in proposal[:a]] + [int(greedy[a])], a


def accept_speculative(logits: np.ndarray, proposal: List[int],
                       temperature: float, rng) -> tuple:
    """The rejection-sampling acceptance rule on one slot's window.

    ``logits``: (1+m, vocab) target logits for the window [pending token,
    p_1..p_m]; row i is the target's next-token distribution after
    window[0..i]. Returns ``(emitted, accepted)``: ``emitted`` is
    ``proposal[:accepted] + [bonus]`` (1..m+1 tokens), ``accepted`` the
    proposal tokens kept. Temperature 0: accept while the argmax chain
    matches. Above 0: token x is accepted with probability p(x), and the
    bonus is drawn from the residual p with x zeroed, renormalized."""
    m = len(proposal)
    if temperature <= 0.0:
        return accept_greedy(logits.argmax(-1), proposal)
    for i in range(m):
        probs = _softmax(logits[i], temperature)
        if rng.random() < probs[proposal[i]]:
            continue
        residual = probs.copy()
        residual[proposal[i]] = 0.0
        total = residual.sum()
        if total <= 0.0:
            # p was (numerically) a delta at the proposal yet it was
            # rejected, only through float rounding: the proposal token is
            # the sample then
            return [int(t) for t in proposal[:i + 1]], i
        bonus = int(rng.choice(residual.size, p=residual / total))
        return [int(t) for t in proposal[:i]] + [bonus], i
    probs = _softmax(logits[m], temperature)
    bonus = int(rng.choice(probs.size, p=probs))
    return [int(t) for t in proposal] + [bonus], m

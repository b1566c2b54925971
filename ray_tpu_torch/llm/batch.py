"""Batch LLM inference over datasets (port of ``ray_tpu/llm/batch.py``).

Reference: ``python/ray/llm/_internal/batch/processor/`` (Processor =
preprocess stage → engine stage on an actor pool → postprocess stage,
``build_llm_processor``) and ``.../stages/vllm_engine_stage.py`` (the
stateful engine UDF). The engine stage hosts the in-framework
continuous-batching :class:`~ray_tpu_torch.serve.llm.LLMEngine` (one per
pool actor, slots shared by every row the actor sees) instead of
delegating to vLLM. Each pool actor takes its own GPU through the
``num_gpus`` remote arg (the JAX package's ``num_tpus``), and the engine
runs on ``ProcessorConfig.device``: ``None`` is the card, which the stage
sees only under its GPU lease; ``"cpu"`` asks for the CPU. Weights from
``params_path`` are a :class:`~ray_tpu_torch.train.checkpoint.Checkpoint`
(the JAX package's is orbax).

Pipeline shape (all lazy until the dataset is consumed):

    ds = from_items([...])
    processor = build_llm_processor(config, preprocess=..., postprocess=...)
    out = processor(ds)            # Dataset with generated columns
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class ByteTokenizer:
    """Self-contained reversible tokenizer (token = byte value). The
    default for tests and for models trained in-framework; any object
    with ``encode(str)->List[int]`` / ``decode(List[int])->str`` plugs in
    (e.g. a transformers tokenizer)."""

    vocab_size = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", "replace"))

    def decode(self, ids: List[int]) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", "replace")


@dataclasses.dataclass
class ProcessorConfig:
    """Engine-stage knobs (reference ``vLLMEngineProcessorConfig``)."""

    model: str = "debug"                 # named config for a fresh engine
    params_path: Optional[str] = None    # Checkpoint dir (optional)
    tokenizer: Any = None                # defaults to ByteTokenizer
    concurrency: int = 1                 # engine actors in the pool
    batch_size: int = 16                 # rows per engine-stage batch
    num_slots: int = 8                   # continuous-batching slots/engine
    max_tokens: int = 32
    temperature: float = 0.0
    num_gpus: float = 0                  # GPUs per engine actor
    seed: int = 0
    device: Any = None                   # engine device; None = the card
    # further LLMEngine keywords (kv_cache, max_seq, kv_block_size, ...)
    engine_kwargs: Optional[Dict[str, Any]] = None


class _EngineStage:
    """Stateful UDF constructed ONCE per actor-pool actor: loads the model
    and serves every batch routed to this actor (reference
    vllm_engine_stage.py). Rows need a "prompt" (str) or "prompt_tokens"
    (list[int]) column; adds "generated_tokens" + "generated_text"."""

    def __init__(self, cfg_blob: bytes):
        import pickle

        from ray_tpu_torch.serve.llm import LLMEngine

        cfg: ProcessorConfig = pickle.loads(cfg_blob)
        self.cfg = cfg
        self.tokenizer = cfg.tokenizer or ByteTokenizer()
        params = None
        if cfg.params_path:
            from ray_tpu_torch.train.checkpoint import Checkpoint

            params = Checkpoint.from_directory(cfg.params_path).to_pytree()
        self.engine = LLMEngine(model=cfg.model, params=params,
                                num_slots=cfg.num_slots, seed=cfg.seed,
                                device=cfg.device,
                                **(cfg.engine_kwargs or {}))

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        n = len(next(iter(batch.values())))
        if "prompt_tokens" in batch:
            prompts = [list(map(int, p)) for p in batch["prompt_tokens"]]
        elif "prompt" in batch:
            prompts = [self.tokenizer.encode(str(p))
                       for p in batch["prompt"]]
        else:
            raise KeyError(
                "engine stage needs a 'prompt' or 'prompt_tokens' column")
        # submit ALL rows, then drain: the continuous-batching engine
        # interleaves them across its slots (this is where batch mode wins
        # over row-at-a-time generate calls)
        rids = [self.engine.submit(
            p, max_tokens=self.cfg.max_tokens,
            temperature=self.cfg.temperature) for p in prompts]
        import time

        deadline = time.monotonic() + 600.0
        collected: List[List[int]] = [[] for _ in range(n)]
        done = [False] * n
        while not all(done) and time.monotonic() < deadline:
            for i, rid in enumerate(rids):
                if done[i]:
                    continue
                st = self.engine.poll(rid)
                collected[i].extend(st["chunks"])
                if st["done"]:
                    done[i] = True
            time.sleep(0.005)
        if not all(done):
            raise TimeoutError("engine stage timed out draining batch")
        out = dict(batch)
        out["generated_tokens"] = [list(c) for c in collected]
        out["generated_text"] = [self.tokenizer.decode(c)
                                 for c in collected]
        return out


class Processor:
    def __init__(self, config: ProcessorConfig,
                 preprocess: Optional[Callable[[dict], dict]] = None,
                 postprocess: Optional[Callable[[dict], dict]] = None):
        self.config = config
        self._pre = preprocess
        self._post = postprocess

    def __call__(self, dataset):
        import pickle

        from ray_tpu_torch.data.execution import ActorPoolStrategy

        ds = dataset
        if self._pre is not None:
            pre = self._pre
            ds = ds.map(pre)
        remote_args = {}
        if self.config.num_gpus:
            remote_args["num_gpus"] = self.config.num_gpus
        ds = ds.map_batches(
            _EngineStage,
            batch_size=self.config.batch_size,
            compute=ActorPoolStrategy(size=self.config.concurrency),
            fn_constructor_args=(pickle.dumps(self.config),),
            ray_remote_args=remote_args or None,
        )
        if self._post is not None:
            post = self._post
            ds = ds.map(post)
        return ds


def build_llm_processor(config: ProcessorConfig,
                        preprocess: Optional[Callable] = None,
                        postprocess: Optional[Callable] = None) -> Processor:
    """Reference ``ray.data.llm.build_llm_processor``."""
    return Processor(config, preprocess, postprocess)

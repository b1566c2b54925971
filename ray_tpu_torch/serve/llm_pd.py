"""Prefill/decode disaggregation for LLM serving (port of
``ray_tpu/serve/llm_pd.py``).

Reference: ``python/ray/llm/_internal/serve/deployments/
prefill_decode_disagg/`` — prefill and decode run as separate Serve
deployments so the bursty, compute-bound prefill fleet scales
independently of the steady, memory-bound decode fleet. Here the prefill
replica computes the prompt KV with the single-slot prefill
(:func:`ray_tpu_torch.models.decoding.make_prefill`) and keeps it on its
device as a device object; the decode replica gets it through the object
plane (staged through the host between processes) and injects it into a
slot of its engine (``LLMEngine.submit_prefilled``) — no re-prefill on the
decode side, and the orchestrator passes only references.

Every server takes ``device`` like the port's other entry points: ``None``
means CUDA and raises without it. A worker sees a GPU only under a lease,
so :func:`build_pd_app` takes ``ray_actor_options`` (``{"num_gpus": 0.5}``
puts both fleets on one card) and applies them to both fleets::

    handle = build_pd_app(model="8b", ray_actor_options={"num_gpus": 0.5})
    out = ray_tpu_torch.get(handle.remote([1, 2, 3], max_tokens=8))
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np

STATS_KEPT = 256   # per-request timings a server keeps for stats()


class PrefillServer:
    """Prefill-only replica: one-slot cache, returns the prompt KV as a
    device object.

    Scale this deployment with prompt traffic; it seeds the same weights
    as the decode fleet (same model, seed and device type) but only ever
    runs the prefill.
    """

    def __init__(self, model: str = "tiny", seed: int = 0,
                 max_seq: Optional[int] = None, device=None):
        import threading

        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.decoding import init_cache, make_prefill

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 products stay f32, as in the decode replica's engine
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = llama.CONFIGS[model]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = llama.init_params(self.config, gen, self.device)
        self.max_seq = max_seq or self.config.max_seq
        self._cache = init_cache(self.config, 1, self.max_seq,
                                 device=self.device)
        self._prefill = make_prefill(self.params, self.config)
        # replica actors run handle_request with max_concurrency > 1 and
        # the prefill writes the one cache slot in place: calls serialize
        self._lock = threading.Lock()
        self._prefills = collections.deque(maxlen=STATS_KEPT)

    def __call__(self, prompt: List[int]):
        import torch

        with self._lock, torch.inference_mode():
            return self._prefill_one(prompt)

    def _prefill_one(self, prompt: List[int]):
        import torch

        import ray_tpu_torch
        from ray_tpu_torch.models.decoding import pad_to_bucket

        plen = len(prompt)
        if plen == 0:
            raise ValueError("empty prompt")
        t = time.perf_counter()
        P = min(pad_to_bucket(plen), self.max_seq)
        tokens = np.zeros((1, P), np.int64)
        tokens[0, :plen] = prompt
        self._cache, logits = self._prefill(self._cache, tokens, plen, 0)
        kv = {"k": self._cache["k"][:, 0, :plen].clone(),
              "v": self._cache["v"][:, 0, :plen].clone(),
              "logits": logits.clone(), "len": plen}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prefills.append({
            "ms": 1e3 * (time.perf_counter() - t),
            "kv_bytes": sum(kv[n].numel() * kv[n].element_size()
                            for n in ("k", "v"))})
        # the KV stays on this replica's device until a decode replica
        # gets it (the device-object path); the reply carries a reference
        return ray_tpu_torch.put(kv, _tensor_transport="device")

    def stats(self) -> Dict[str, Any]:
        """Prefill times (ms) and KV sizes of the last STATS_KEPT calls."""
        return {"prefills": list(self._prefills)}


class DecodeServer:
    """Decode-only replica: full slot engine, admits prefilled KV."""

    def __init__(self, model: str = "tiny", num_slots: int = 8,
                 seed: int = 0, max_seq: Optional[int] = None,
                 prefix_cache_size: int = 0, device=None):
        from ray_tpu_torch.serve.llm import LLMEngine

        self.engine = LLMEngine(model=model, num_slots=num_slots, seed=seed,
                                max_seq=max_seq,
                                prefix_cache_size=prefix_cache_size,
                                device=device)
        self._handoffs = collections.deque(maxlen=STATS_KEPT)

    def submit_prefilled(self, prompt: List[int], kv: Any,
                         max_tokens: int = 64, temperature: float = 0.0,
                         eos_token: Optional[int] = None) -> str:
        import ray_tpu_torch
        from ray_tpu_torch.core_worker.reference import ObjectRef

        # KV shipped by reference: resolve it from the object plane HERE
        # (prefill replica -> this process, skipping the orchestrator); the
        # prefill's reply is itself a reference to its device object.
        # Only the last get, the one that brings the KV, is the handoff:
        # the gets before it wait out the prefill's queueing and compute.
        waited = handoff = 0.0
        while isinstance(kv, ObjectRef):
            waited += handoff
            t = time.perf_counter()
            kv = ray_tpu_torch.get(kv, timeout=120.0)
            handoff = time.perf_counter() - t
        if self.engine.device.type == "cuda":
            import torch

            t = time.perf_counter()
            torch.cuda.synchronize(self.engine.device)
            handoff += time.perf_counter() - t
        self._handoffs.append((1e3 * handoff, 1e3 * waited))
        return self.engine.submit_prefilled(
            prompt, kv["k"], kv["v"], kv["logits"], max_tokens=max_tokens,
            temperature=temperature, eos_token=eos_token)

    def poll(self, request_id: str) -> Dict[str, Any]:
        return self.engine.poll(request_id)

    def stats(self) -> Dict[str, Any]:
        """The engine's stats, and of the last STATS_KEPT requests the KV
        handoff times (ms: the get that brought the KV, and the device
        sync) and the waits for the prefill's reply before them (ms)."""
        return dict(self.engine.stats(),
                    kv_handoff_ms=[h for h, _ in self._handoffs],
                    prefill_wait_ms=[w for _, w in self._handoffs])

    def __del__(self):
        try:
            self.engine.shutdown()
        except Exception:  # noqa: BLE001
            pass


class PDOrchestrator:
    """Ingress deployment gluing the two fleets: route the prompt to a
    prefill replica, hand the KV to a decode replica, stream tokens.

    The KV crosses replica boundaries through the object plane — the
    orchestrator passes the prefill reply's reference straight through and
    never holds the KV.
    """

    def __init__(self, prefill_handle, decode_handle,
                 poll_interval_s: float = 0.01):
        import ray_tpu_torch

        self._rt = ray_tpu_torch
        self.prefill = prefill_handle
        self.decode = decode_handle
        self._poll_interval = poll_interval_s

    def __call__(self, prompt: List[int], max_tokens: int = 64,
                 temperature: float = 0.0,
                 eos_token: Optional[int] = None,
                 timeout_s: float = 300.0) -> List[int]:
        # the KV ObjectRef passes through UNTOUCHED: the decode replica
        # resolves it from the object plane, so the payload never lands
        # in the orchestrator process
        kv_ref = self.prefill.remote(list(prompt))
        # Sticky routing: submit and every poll must hit the SAME decode
        # replica (the request id lives in that replica's engine state) —
        # same idiom as the proxy's SSE path (proxy.py _dispatch_stream).
        self.decode._state.refresh()
        acquired = self.decode._state.acquire_replica()
        if acquired is None:
            raise RuntimeError("no running decode replicas")
        replica, ridx = acquired
        try:
            rid = self._rt.get(
                replica.handle_request.remote(
                    "submit_prefilled", (list(prompt), kv_ref),
                    {"max_tokens": max_tokens, "temperature": temperature,
                     "eos_token": eos_token}),
                timeout=timeout_s)
            out: List[int] = []
            deadline = time.monotonic() + timeout_s
            while True:
                r = self._rt.get(
                    replica.handle_request.remote("poll", (rid,), {}),
                    timeout=timeout_s)
                out.extend(r["chunks"])
                if r["done"]:
                    return out
                if time.monotonic() > deadline:
                    raise TimeoutError("PD generation timed out")
                time.sleep(self._poll_interval)
        finally:
            self.decode._state.release(ridx)

    def stats(self) -> Dict[str, Any]:
        """Aggregate the numeric engine stats over every decode replica."""
        self.decode._state.refresh()
        replicas = list(self.decode._state.replicas)
        per = self._rt.get(
            [r.handle_request.remote("stats", (), {}) for r in replicas])
        out: Dict[str, Any] = {}
        for s in per:
            for key, val in s.items():
                if isinstance(val, (int, float)):
                    out[key] = out.get(key, 0) + val
        return out


def build_pd_app(model: str = "tiny", *, prefill_replicas: int = 1,
                 decode_replicas: int = 1, num_slots: int = 8,
                 seed: int = 0, max_seq: Optional[int] = None,
                 name: str = "llm-pd", device=None,
                 ray_actor_options: Optional[dict] = None):
    """Deploy prefill fleet + decode fleet + orchestrator; returns the
    orchestrator's DeploymentHandle. ``ray_actor_options`` apply to the
    replicas of both fleets (the orchestrator needs no device)."""
    from ray_tpu_torch import serve

    prefill_dep = serve.deployment(
        PrefillServer, name=f"{name}-prefill",
        num_replicas=prefill_replicas, ray_actor_options=ray_actor_options)
    decode_dep = serve.deployment(
        DecodeServer, name=f"{name}-decode", num_replicas=decode_replicas,
        ray_actor_options=ray_actor_options)
    serve.run(prefill_dep.bind(model=model, seed=seed, max_seq=max_seq,
                               device=device))
    serve.run(decode_dep.bind(model=model, num_slots=num_slots, seed=seed,
                              max_seq=max_seq, device=device))
    pf = serve.get_deployment_handle(f"{name}-prefill")
    dc = serve.get_deployment_handle(f"{name}-decode")
    orch_dep = serve.deployment(PDOrchestrator, name=name)
    serve.run(orch_dep.bind(pf, dc))
    return serve.get_deployment_handle(name)

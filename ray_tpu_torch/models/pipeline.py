"""Pipeline-parallel model execution over compiled channel DAGs.

Reference: the reference framework has no native pipeline-parallel engine —
its building block is compiled actor graphs with accelerator channels
(SURVEY.md §2.3 "Pipeline parallel": ``python/ray/dag/`` + vLLM's
``pipeline_parallel_size`` delegating stages to actors). The model's layer
stack is split into contiguous stages, each stage is a resident actor
holding its parameter shard on its device, and microbatches stream
through preallocated channels — stage k runs microbatch i while stage k+1
runs microbatch i-1, which is exactly 1F pipelining (inference/forward).

Each stage runs the port's Llama block (``models/llama.py::make_block``)
over its layers under ``torch.inference_mode()``, so on a CUDA device
every layer's attention launches K1 (``ops/attention.py::flash_attention``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


class LlamaPipelineStage:
    """One resident stage: layers [lo, hi) (+ embedding on the first
    stage, final norm + head on the last). Constructed inside the DAG's
    stage actor; the channel exec loop calls :meth:`forward` per item."""

    def __init__(self, spec: dict):
        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.llama import make_block
        from ray_tpu_torch.ops.rope import rope_frequencies

        # a forward pass keeps no activations for a backward: no remat
        self._cfg = c = dataclasses.replace(spec["config"], remat=False)
        self.device = resolve_device(spec.get("device"))
        self._params = _tree_to(spec["params"], self.device)
        self._first = spec["first"]
        self._last = spec["last"]
        # device-channel pipelines keep activations on the device end to
        # end (the channel stages to the host itself); shm pipelines hand
        # the exec loop a CPU tensor
        self._device_out = spec.get("device_out", False)
        cos, sin = rope_frequencies(c.head_dim, c.max_seq, c.rope_theta,
                                    device=self.device)
        self._block = make_block(c, cos, sin)

    def _apply(self, params, x):
        from ray_tpu_torch.models.llama import _head_logits
        from ray_tpu_torch.ops.norms import rmsnorm

        c = self._cfg
        if self._first:
            x = params["embed"].to(c.dtype)[x.long()]
        names = list(params["layers"])
        for ws in zip(*(params["layers"][n].unbind(0) for n in names)):
            x = self._block(x, dict(zip(names, ws)))
        if self._last:
            x = rmsnorm(x, params["final_norm"], c.norm_eps)
            head = (params["embed"].T if c.tie_embeddings
                    else params["lm_head"])
            x = _head_logits(x, head)
        return x

    def forward(self, x):
        import torch

        with torch.inference_mode():
            out = self._apply(self._params,
                              torch.as_tensor(x).to(self.device))
        return out if self._device_out else out.cpu()


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def split_params(params: dict, config, n_stages: int) -> List[dict]:
    """Slice the stacked layer tree into contiguous per-stage shards.
    Stage 0 carries the embedding; the last stage carries final norm +
    head (plus the embedding when tied). Each layer shard is a copy: a
    view pickles its whole storage, so a view of layers [lo, hi) would
    ship every layer to its stage."""
    L = config.n_layers
    if not (1 <= n_stages <= L):
        raise ValueError(f"n_stages {n_stages} not in [1, {L}]")
    bounds = [round(i * L / n_stages) for i in range(n_stages + 1)]
    shards = []
    for s in range(n_stages):
        lo, hi = bounds[s], bounds[s + 1]
        shard = {"layers": {name: w[lo:hi].clone()
                            for name, w in params["layers"].items()}}
        if s == 0:
            shard["embed"] = params["embed"]
        if s == n_stages - 1:
            shard["final_norm"] = params["final_norm"]
            if config.tie_embeddings:
                shard["embed"] = params["embed"]
            else:
                shard["lm_head"] = params["lm_head"]
        shards.append(shard)
    return shards


def build_llama_pipeline(config, params, n_stages: int, *,
                         channels: bool = True,
                         channel_capacity: int = 64 << 20,
                         channel_kind: str = "shm",
                         stage_options: Optional[dict] = None,
                         device=None):
    """Compile an n-stage llama forward pipeline. Returns a CompiledDAG:
    ``dag.execute(tokens).get()`` → f32 logits; in channel mode
    consecutive ``execute`` calls pipeline across stages.
    ``channel_kind="device"`` carries activations as tensors on the
    stages' device over DeviceBufferChannels (staged to the host by the
    channel, placed on the reader's device) instead of pickled CPU
    tensors. ``device`` is the stages' device (``None``: CUDA, which a
    stage sees only under a GPU lease, e.g. ``stage_options={"num_gpus":
    1}``; pass ``"cpu"`` to run on the CPU).

    Each stage's shard goes into the object store once and its actor is
    created with the reference: the stage reads the tensors from the
    store, while the creation spec that the GCS and the raylet relay
    stays a few kilobytes whatever the model's size."""
    import ray_tpu_torch
    from ray_tpu_torch.graph.dag import InputNode

    shards = split_params(params, config, n_stages)
    stage_cls = ray_tpu_torch.remote(LlamaPipelineStage)
    with InputNode() as inp:
        node = inp
        for s in range(n_stages):
            spec = ray_tpu_torch.put({
                "config": config, "params": _tree_to(shards[s], "cpu"),
                "first": s == 0, "last": s == n_stages - 1,
                "device_out": channel_kind == "device", "device": device,
            })
            opts = dict(stage_options or {})
            node = stage_cls.options(**opts).bind(spec).forward.bind(node)
    return node.experimental_compile(channels=channels,
                                     channel_capacity=channel_capacity,
                                     channel_kind=channel_kind)

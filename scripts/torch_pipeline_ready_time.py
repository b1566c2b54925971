#!/usr/bin/env python3
"""Time for a two-stage Llama pipeline of ray_tpu_torch to come up on the
CPU, measured on the host it runs on:

    python3 scripts/torch_pipeline_ready_time.py [--vocab 256000]
        [--store-bytes N]

The ``tiny`` config cut to 2 layers, with ``--vocab`` rows of embedding and
head, so each stage's shard is about ``vocab * 512 * 2`` bytes: stage 0
holds the embedding, stage 1 the head. ``--store-bytes`` sizes the node's
object store (``shm_store_bytes``; the default leaves it as configured).
Prints one JSON object: the shard bytes, ``build_llama_pipeline``'s own
seconds, the seconds from the build's start to the first microbatch's
logits (the stages' start-up and weight transfer included), the logits'
largest difference from the in-process ``forward``, and the driver's peak
RSS in MB.
"""

import argparse
import dataclasses
import json
import os
import resource
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=256000)
    ap.add_argument("--store-bytes", type=int, default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama, pipeline

    cfg = dataclasses.replace(llama.CONFIGS["tiny"], vocab_size=args.vocab,
                              n_layers=2, max_seq=64)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    shard_bytes = args.vocab * cfg.hidden * params["embed"].element_size()
    rt.init(num_cpus=4, num_gpus=0,
            system_config=(None if args.store_bytes is None
                           else {"shm_store_bytes": args.store_bytes}))
    try:
        t = time.perf_counter()
        dag = pipeline.build_llama_pipeline(
            cfg, params, 2, channel_capacity=64 << 20, device="cpu")
        build_s = time.perf_counter() - t
        try:
            tokens = torch.randint(0, cfg.vocab_size, (1, 16))
            got = dag.execute(tokens).get(timeout_s=300)
            first_s = time.perf_counter() - t
        finally:
            dag.teardown()
    finally:
        rt.shutdown()
    want = llama.forward(params, tokens, cfg)
    print(json.dumps({
        "host_cpus": os.cpu_count(), "embed_bytes": shard_bytes,
        "build_s": build_s, "first_result_s": first_s,
        "max_abs_err": (got - want).abs().max().item(),
        "driver_max_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

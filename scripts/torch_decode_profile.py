#!/usr/bin/env python3
"""Where a decode step of ray_tpu_torch goes, on one CUDA card.

    python3 scripts/torch_decode_profile.py [--model 8b] [--kv-cache paged]
        [--slots 4] [--context 1024] [--steps 8]

Builds random weights for the model, fills every slot's cache to
``--context`` tokens through the engine's own prefill, then runs
``--steps`` decode steps under ``torch.profiler`` and prints the mean
step time (host clock around synchronized steps) and the device time by
kernel, largest first. The full table goes to
``chiprun_out/torch_decode_profile.txt``. Needs CUDA.
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="8b")
    ap.add_argument("--kv-cache", default="paged", choices=["paged", "slot"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.decoding import (init_cache, make_decode_step,
                                               make_prefill)
    from ray_tpu_torch.models.paged_cache import (BlockAllocator,
                                                  PagedConfig,
                                                  init_paged_cache,
                                                  make_paged_decode_step,
                                                  make_paged_prefill)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama.CONFIGS[args.model]
    params = llama.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    head = llama.head_f32(params, cfg)
    B, ctx = args.slots, args.context
    rng = np.random.default_rng(0)
    tokens = np.zeros((1, ctx), np.int32)
    with torch.inference_mode():
        if args.kv_cache == "paged":
            page = PagedConfig(num_blocks=1 + B * args.max_seq // 64,
                               block_size=64, max_seq=args.max_seq)
            alloc = BlockAllocator(page, B, device=dev)
            cache = init_paged_cache(cfg, page, B, device=dev)
            prefill = make_paged_prefill(params, cfg, page, head=head)
            decode = make_paged_decode_step(params, cfg, page, head=head)
            for s in range(B):
                alloc.ensure(s, ctx + args.steps + 1)
                tokens[0] = rng.integers(0, cfg.vocab_size, ctx)
                prefill(cache, alloc.tables[s], tokens, ctx, s)

            def step(last, active):
                return decode(cache, alloc.device_tables(), last, active)
        else:
            cache = init_cache(cfg, B, args.max_seq, device=dev)
            prefill = make_prefill(params, cfg, head=head)
            decode = make_decode_step(params, cfg, head=head)
            for s in range(B):
                tokens[0] = rng.integers(0, cfg.vocab_size, ctx)
                prefill(cache, tokens, ctx, s)

            def step(last, active):
                return decode(cache, last, active)

        last = np.zeros(B, np.int32)
        active = np.ones(B, bool)
        step(last, active)                        # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(args.steps):
            step(last, active)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t) / args.steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.steps):
                step(last, active)
            torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "torch_decode_profile.txt"), "w") as f:
        f.write(table)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.device_time_total)
    device_ms = sum(e.device_time_total for e in events) / 1e3 / args.steps
    print(f"model={args.model} kv_cache={args.kv_cache} slots={B} "
          f"context={ctx}: step {step_ms:.3f} ms (host clock), device "
          f"kernels {device_ms:.3f} ms per step")
    for e in events[:15]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.3f} ms/step "
              f"{e.count // args.steps:5d} calls/step  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

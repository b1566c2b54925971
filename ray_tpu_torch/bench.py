"""Training throughput of the port on one CUDA card (the counterpart of
``bench.py:55`` ``run()``): tokens/s, final loss and MFU of Llama training
steps through :mod:`ray_tpu_torch.models.training`.

    python3 -m ray_tpu_torch.bench [--config 1b_bench] [--batch 8]
        [--seq 2048] [--steps 10]

prints one JSON line. ``1b_bench`` is the JAX package's headline training
configuration (``bench.py:307-311``): ``1b`` with vocab 32000, tied
embeddings, ``max_seq`` 2048 and ``attn_block`` 1024.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.training import (OptimizerConfig,
                                           init_train_state,
                                           make_train_step)

# Dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's data sheet,
# without sparsity, at the full 700 W power limit): the MFU denominator.
H100_BF16_PEAK_FLOPS = 989e12

CONFIGS = dict(llama.CONFIGS)
CONFIGS["1b_bench"] = dataclasses.replace(
    llama.CONFIGS["1b"], vocab_size=32000, tie_embeddings=True, max_seq=2048,
    attn_block=1024)


def run(config_name: str, batch: int, seq: int, steps: int = 10,
        device=None, seed: int = 0):
    """Train one warm-up step and then ``steps`` timed steps, all on the
    same random token batch (as ``bench.py:89-101``), and return tokens/s,
    the losses (the warm-up step's first) and MFU. The timed steps are
    queued back to back; the clock stops when the last loss reaches the
    host."""
    dev = resolve_device(device)
    cfg = CONFIGS[config_name]
    opt = OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = init_train_state(lambda g: llama.init_params(cfg, g, dev), opt,
                             gen, dev)
    step_fn = make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    b = {"tokens": tokens}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    state, m = step_fn(state, b)                   # warm-up
    losses = [m["loss"]]
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, b)
        losses.append(m["loss"])
    final_loss = float(m["loss"])                  # waits for every step
    dt = time.perf_counter() - t0
    tokens_per_sec = batch * seq * steps / dt
    result = {
        "metric": f"llama_{config_name}_train_tokens_per_s_1card",
        "tokens_per_sec": tokens_per_sec,
        "step_ms": 1e3 * dt / steps,
        "losses": [float(x) for x in losses], "loss": final_loss,
        "grad_norm": float(m["grad_norm"]),
        "batch": batch, "seq": seq, "steps": steps,
        "num_params": cfg.num_params(),
        "flops_per_token": cfg.flops_per_token(seq),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if dev.type == "cuda":
        result["mfu"] = (cfg.flops_per_token(seq) * tokens_per_sec
                         / H100_BF16_PEAK_FLOPS)
        result["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="1b_bench")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    print(json.dumps(run(args.config, args.batch, args.seq, args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a training step of ray_tpu_torch goes, on one CUDA card.

    python3 scripts/torch_train_profile.py [--model llama|moe|vit]
        [--config NAME] [--layers N] [--batch B] [--seq S] [--steps 3]

Trains ``--config`` of ``--model`` from random weights on one random
batch, as ``ray_tpu_torch.bench.run`` does: a warm-up step, ``--steps``
steps timed by the host clock (one synchronize at the end), then
``--steps`` steps under ``torch.profiler``. The defaults: llama
``1b_bench``, batch 8 × 2048; moe ``8x7b`` cut to ``--layers 3``, batch 2
× 2048; vit ``B16``, 256 images. Prints one JSON object with, per step:

- ``step_ms``, the host clock; ``device_busy_ms``, the sum of the
  device's kernels and copies (one stream, so they do not overlap);
  ``idle_share`` = 1 - busy / step;
- ``by_kind``: device time and launches by kind of kernel: the flash
  kernels (K1 ``flash_fwd``, bf16 or f32; the bf16 backward
  ``flash_bwd``; the f32 backward's K2a ``flash_dq`` and K2b
  ``flash_dkv``), cuBLAS products, elementwise, reductions, softmax,
  copies, other;
- ``by_phase``: device time between CUDA events recorded where each
  phase starts: the layers' forward, the head's and the loss's forward,
  their backward, the layers' backward (remat recompute included) and the
  optimizer (global norm, clip, AdamW);
- ``split``: device time by the op that launched it: the products
  (``aten::mm`` calls with an (expert · slot) dimension are the MoE
  dispatch and combine products and their gradients; ``aten::bmm`` the
  expert FFN; other ``aten::mm`` the dense weights and the head), the
  flash kernels, the optimizer (the kernels launched inside
  ``AdamW.update_``), and the rest (elementwise work, reductions, copies
  outside the optimizer).

The profiler's table goes to ``chiprun_out/torch_train_profile.txt``.
Needs CUDA.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPT_RANGE = "optimizer"   # the profiler range around AdamW.update_
DEFAULTS = {  # model: (config, layers or None for the config's, batch)
    "llama": ("1b_bench", None, 8),
    "moe": ("8x7b", 3, 2),
    "vit": ("B16", None, 256),
}
PHASES = [  # (name, event that starts it, event that ends it)
    ("layers forward", "step_start", "head_fwd_start"),
    ("head forward", "head_fwd_start", "head_fwd_end"),
    ("loss forward", "head_fwd_end", "loss_fwd_end"),
    ("loss backward", "loss_fwd_end", "loss_bwd_end"),
    ("head backward", "loss_bwd_end", "head_bwd_end"),
    ("layers backward", "head_bwd_end", "opt_start"),
    ("optimizer", "opt_start", "opt_end"),
]
KINDS = [  # (kind, substrings of the kernel name), first match wins
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_f32_kernel")),
    ("flash_bwd", ("flash_bwd_kernel",)),
    ("flash_dq", ("flash_bwd_dq_kernel",)),
    ("flash_dkv", ("flash_bwd_dkv_kernel",)),
    ("cublas products", ("nvjet", "gemm", "cublas", "cutlass", "xmma",
                         "sm90_")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise", ("elementwise", "index", "gather", "scatter")),
    ("copies", ("Memcpy", "Memset", "memcpy", "memset")),
]


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(key in name for key in keys):
            return kind
    return "other"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(DEFAULTS), default="llama")
    ap.add_argument("--config")
    ap.add_argument("--layers", type=int,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import llama, moe, vit
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    dev = torch.device("cuda")
    config, layers, batch_size = DEFAULTS[args.model]
    config = args.config or config
    layers = args.layers or layers
    batch_size = args.batch or batch_size
    module = {"llama": llama, "moe": moe, "vit": vit}[args.model]
    cfg = (bench.CONFIGS if args.model == "llama"
           else module.CONFIGS)[config]
    if layers is not None:
        cfg = (dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, n_layers=layers)) if args.model == "moe"
            else dataclasses.replace(cfg, n_layers=layers))
    opt = OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(lambda g: module.init_params(cfg, g, dev), opt,
                             gen, dev)
    if args.model == "vit":
        batch = {"images": torch.rand(
                     batch_size, cfg.image_size, cfg.image_size,
                     cfg.channels, generator=gen, device=dev),
                 "labels": torch.randint(0, cfg.num_classes, (batch_size,),
                                         generator=gen, device=dev)}
        seq = cfg.seq_len
    else:
        vocab = (cfg.base if args.model == "moe" else cfg).vocab_size
        batch = {"tokens": torch.randint(
            0, vocab, (batch_size, args.seq), generator=gen, device=dev,
            dtype=torch.int32)}
        seq = args.seq
    # the MoE's (expert · slot) axis: its products are dispatch and combine
    expert_slots = (cfg.n_experts * cfg.capacity(batch_size * seq)
                    if args.model == "moe" else None)

    marks = {}

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name] = ev

    head_logits = llama._head_logits
    head_module = vit if args.model == "vit" else llama

    def marked_head_logits(x, head):
        mark("head_fwd_start")
        if x.requires_grad:
            x.register_hook(lambda g: mark("head_bwd_end"))
        out = head_logits(x, head)
        mark("head_fwd_end")
        if out.requires_grad:
            out.register_hook(lambda g: mark("loss_bwd_end"))
        return out

    head_module._head_logits = marked_head_logits
    update = opt.update_

    def marked_update(*a):
        mark("opt_start")
        with torch.profiler.record_function(OPT_RANGE):
            out = update(*a)
        mark("opt_end")
        return out

    opt.update_ = marked_update

    def loss(p, b):
        mark("step_start")
        out = module.loss_fn(p, b, cfg)
        mark("loss_fwd_end")
        return out

    step = make_train_step(loss, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    state, m = step(state, batch)                   # warm-up
    torch.cuda.synchronize()
    phases = {name: 0.0 for name, _, _ in PHASES}
    t = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch)
        torch.cuda.synchronize()
        for name, a, b in PHASES:
            phases[name] += marks[a].elapsed_time(marks[b]) / args.steps
    step_ms = 1e3 * (time.perf_counter() - t) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                record_shapes=True) as prof:
        for _ in range(args.steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    products = {"dispatch/combine products": 0.0, "expert bmm": 0.0,
                "other products": 0.0, "optimizer": 0.0}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.key_averages(group_by_input_shape=True):
        if getattr(e, "device_type", None) == cuda:
            continue        # kernels, and the range's copy on the GPU
        if e.key == OPT_RANGE:
            part = "optimizer"
        elif e.key == "aten::bmm":
            part = "expert bmm"
        elif e.key == "aten::mm":
            dims = [d for shape in e.input_shapes for d in shape]
            part = ("dispatch/combine products" if expert_slots in dims
                    else "other products")
        else:
            continue
        products[part] += e.device_time_total / 1e3 / args.steps
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "torch_train_profile.txt"),
              "w") as f:
        f.write(averages.table(sort_by="cuda_time_total", row_limit=60))
    kernels = [e for e in averages
               if getattr(e, "device_type", None) == cuda
               and e.device_time_total > 0 and e.key != OPT_RANGE]
    by_kind = {}
    for e in kernels:
        rec = by_kind.setdefault(kind_of(e.key), {"ms": 0.0, "launches": 0})
        rec["ms"] += e.device_time_total / 1e3 / args.steps
        rec["launches"] += e.count / args.steps
    busy_ms = sum(r["ms"] for r in by_kind.values())
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    flash_ms = sum(r["ms"] for k, r in by_kind.items()
                   if k.startswith("flash"))
    split = dict(products, flash=flash_ms)
    split["elementwise and the rest"] = busy_ms - sum(split.values())
    print(json.dumps({
        "model": args.model, "config": config, "layers": getattr(
            getattr(cfg, "base", cfg), "n_layers"),
        "batch": batch_size, "seq": seq,
        "device": torch.cuda.get_device_name(0),
        "step_ms": step_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / step_ms,
        ("images_per_s" if args.model == "vit" else "tokens_per_s"):
        batch_size * (1 if args.model == "vit" else seq) / (step_ms / 1e3),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
        "card_memory_gb": torch.cuda.mem_get_info(dev)[1] / 1e9,
        "loss": float(m["loss"]),
        "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1]["ms"])),
        "by_phase": phases,
        "split": split,
        "top_kernels": [{"name": e.key[:100], "ms": e.device_time_total
                         / 1e3 / args.steps, "launches": e.count / args.steps}
                        for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

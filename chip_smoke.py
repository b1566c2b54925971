#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself on the CPU, and serves Llama-3-8B.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. device: the card's name and power limit;
  2. build: every CUDA source under ray_tpu_torch/csrc, one nvcc each, all
     started together;
  3. kernels: each decode-attention kernel against its plain PyTorch
     version at the serving shapes, in bf16 and f32, with edge lengths
     (1, a block, a non-multiple, full, stale full+1, 0) and shuffled
     block tables; times of kernel, plain version and the library
     yardstick (F.scaled_dot_product_attention, timed here only), and the
     least time the card could take (bytes over 3.35 TB/s, or operations
     over the peak rate);
  4. debug engine on the card (f32, paged with preemption and slot) gives
     the same greedy tokens as the same engine on the CPU;
  5. the 8b configuration served on the card through LLMEngine, paged then
     slot, from random weights: every output complete, logits finite, and
     each kernel launched once per layer per decode step;
  6. the kernels line, then the result line.

Needs one CUDA card, nvcc, and about 40 GB of device memory; no network.
"""

import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,    # f32 outside the tensor cores
            "bfloat16": 989e12}  # bf16 tensor cores, dense
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
TIMED_ITERS = 20
INPUT_COPIES = 4                 # rotate inputs so K/V come from HBM, not L2


def log(*args):
    print(*args, flush=True)


def time_ms(fns, iters=TIMED_ITERS):
    """Mean device time of one call, rotating over ``fns`` (one closure
    per input copy), by CUDA events after a warm-up."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(rows, B, H, KV, D, itemsize, dtype_name, index_bytes):
    """Least time for the call: every valid K/V row read once, q read and
    out written once, plus the index bytes; ~4 flops per K/V element."""
    kv_bytes = 2 * rows * KV * D * itemsize
    io_bytes = 2 * B * H * D * itemsize + index_bytes
    ops = 4 * rows * H * D
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------- phase 3

def kernel_checks(device, B=8, H=32, KV=8, D=128, bs=64, MBS=32, S=2048,
                  seed=0):
    """Both kernels against their plain versions; returns per-kernel
    records keyed by dtype."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    from ray_tpu_torch.ops.paged_decode_attention import (
        paged_attention_reference, paged_decode_attention)

    # enable_gqa (one library call for grouped heads) exists from 2.5 on
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    cap = MBS * bs
    edge = [1, bs, bs + 37, cap, cap + 1, 0]
    lens = (edge + [cap // 2 + 11, 3 * bs - 1] * B)[:B]
    NB = B * MBS + 1
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(NB - 1, generator=gen, device=device) + 1
    tables = torch.zeros(B, MBS, dtype=torch.int32, device=device)
    for b, n in enumerate(lens):
        nblk = min(-(-n // bs), MBS)
        tables[b, :nblk] = perm[b * MBS:b * MBS + nblk]  # shuffled, sparse
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    scale = D ** -0.5
    paged_rows = sum(min(n, cap) for n in lens)
    slot_rows = sum(min(n, S) for n in lens)
    out = {"paged": {}, "slot": {}, "lengths": lens}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        sets = [(rand(B, 1, H, D).to(dt), rand(NB, bs, KV, D).to(dt),
                 rand(NB, bs, KV, D).to(dt)) for _ in range(INPUT_COPIES)]
        q, kp, vp = sets[0]
        got = paged_decode_attention(q, kp, vp, tables, lengths, scale=scale)
        torch.cuda.synchronize()
        want = paged_attention_reference(q, kp, vp, tables, lengths,
                                         scale=scale)
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all(), "paged kernel: non-finite output"
        assert err <= TOL[name], f"paged kernel {name}: max_abs_err {err}"
        assert got[lens.index(0)].abs().max().item() == 0.0
        gathered = [(q_.transpose(1, 2), k_[tables.long()].reshape(
            B, cap, KV, D).transpose(1, 2), v_[tables.long()].reshape(
            B, cap, KV, D).transpose(1, 2)) for q_, k_, v_ in sets]
        mask = (torch.arange(cap, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        rec = {
            "max_abs_err": err, "tolerance": TOL[name],
            "ms": time_ms([lambda s=s: paged_decode_attention(
                *s, tables, lengths, scale=scale) for s in sets]),
            "plain_ms": time_ms([lambda s=s: paged_attention_reference(
                *s, tables, lengths, scale=scale) for s in sets]),
            # over the pre-gathered cache: no single library call takes a
            # block table
            "library_ms": time_ms([lambda g=g: F.scaled_dot_product_attention(
                g[0], g[1], g[2], attn_mask=mask, scale=scale,
                enable_gqa=True) for g in gathered]) if gqa else None,
        }
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            paged_rows, B, H, KV, D, q.element_size(), name,
            index_bytes=4 * B + 4 * sum(min(-(-n // bs), MBS) for n in lens))
        out["paged"][name] = rec
        del gathered

        csets = [(q_, rand(B, S, KV, D).to(dt), rand(B, S, KV, D).to(dt))
                 for q_, _, _ in sets]
        q, kc, vc = csets[0]
        got = decode_attention(q, kc, vc, lengths, scale=scale)
        torch.cuda.synchronize()
        want = decode_attention_reference(q, kc, vc, lengths, scale=scale)
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all(), "slot kernel: non-finite output"
        assert err <= TOL[name], f"slot kernel {name}: max_abs_err {err}"
        smask = (torch.arange(S, device=device)[None, :]
                 < lengths[:, None])[:, None, None, :]
        rec = {
            "max_abs_err": err, "tolerance": TOL[name],
            "ms": time_ms([lambda s=s: decode_attention(
                *s, lengths, scale=scale) for s in csets]),
            "plain_ms": time_ms([lambda s=s: decode_attention_reference(
                *s, lengths, scale=scale) for s in csets]),
            "library_ms": time_ms([lambda s=s: F.scaled_dot_product_attention(
                s[0].transpose(1, 2), s[1].transpose(1, 2),
                s[2].transpose(1, 2), attn_mask=smask, scale=scale,
                enable_gqa=True) for s in csets]) if gqa else None,
        }
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            slot_rows, B, H, KV, D, q.element_size(), name,
            index_bytes=4 * B)
        out["slot"][name] = rec
        del sets, csets
        for kind in ("paged", "slot"):
            log(f"  {kind:5s} {name:8s} " + json.dumps(out[kind][name]))
    return out


# ------------------------------------------------------------- phases 4-5

def _run_requests(eng, prompts, max_tokens, timeout_s=600):
    """One thread per request: submit, poll to completion; returns
    outputs, first-token latencies (s) and the wall time."""
    outs, ttft, errors = {}, {}, []
    t0 = time.perf_counter()

    def run(i):
        try:
            sent = time.perf_counter()
            rid = eng.submit(prompts[i], max_tokens=max_tokens)
            got = []
            deadline = time.monotonic() + timeout_s
            while True:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"request {i} timed out")
                st = eng.poll(rid)
                if st["chunks"] and i not in ttft:
                    ttft[i] = time.perf_counter() - sent
                got += st["chunks"]
                if st["done"]:
                    break
                time.sleep(0.005)    # ray_tpu's LLMServer.stream period
            outs[i] = got
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(f"request {i}: {e!r}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 30)
    assert not any(t.is_alive() for t in threads), "request threads hung"
    assert not errors, errors
    return outs, ttft, time.perf_counter() - t0


def debug_engine_check(device, kv_cache, seed=0):
    """The f32 debug engine on ``device`` and on the CPU, same weights:
    greedy tokens must be identical."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.CONFIGS["debug"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    prompts = [[2 + i, 9, 4] for i in range(6)]
    kw = dict(num_slots=3, max_seq=128, kv_cache=kv_cache, kv_block_size=16)
    if kv_cache == "paged":
        kw["kv_pool_tokens"] = 96          # forces recompute preemption
    res = {}
    for dev in (device, "cpu"):
        eng = LLMEngine(cfg, params, device=dev, **kw)
        try:
            res[dev] = _run_requests(eng, prompts, 40)[0], eng.stats()
        finally:
            eng.shutdown()
    (on_card, st), (on_cpu, _) = res[device], res["cpu"]
    assert all(len(on_card[i]) == 40 for i in range(6))
    assert on_card == on_cpu, "debug engine: card and CPU tokens differ"
    if kv_cache == "paged":
        assert st["preemptions"] >= 1, st
    return {"requests": 6, "identical": True,
            "preemptions": st.get("preemptions")}


def serve_check(params, cfg, kv_cache, prompts, max_tokens, num_slots=4,
                max_seq=2048, device=None):
    """Serve ``prompts`` through LLMEngine on the card with each kernel's
    launch count read around the run; checks every output's length and
    that every logits tensor was finite."""
    import torch

    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, num_slots=num_slots, max_seq=max_seq,
                    kv_cache=kv_cache, kv_block_size=64, device=device)
    finite, decode_s, prefill_s = [], [], []

    def watch(fn, times):
        def call(*args):
            t = time.perf_counter()
            cache, logits = fn(*args)
            finite.append(bool(torch.isfinite(logits).all()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return cache, logits
        return call

    eng._decode = watch(eng._decode, decode_s)
    eng._prefill = watch(eng._prefill, prefill_s)
    try:
        paged_decode_attention.launches = 0
        decode_attention.launches = 0
        outs, ttft, wall = _run_requests(eng, prompts, max_tokens)
        launches = {"paged_decode_attention": paged_decode_attention.launches,
                    "decode_attention": decode_attention.launches}
        st = eng.stats()
    finally:
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    assert all(len(outs[i]) == max_tokens for i in range(len(prompts))), \
        {i: len(o) for i, o in outs.items()}
    assert finite and all(finite), "non-finite logits"
    tokens = sum(len(o) for o in outs.values())
    ttfts = sorted(ttft.values())
    return {"kv_cache": kv_cache, "requests": len(prompts),
            "prompt_tokens": [len(p) for p in prompts],
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
            "ttft_max_ms": 1e3 * ttfts[-1],
            "decode_steps": st["steps"],
            "decode_step_ms_mean": 1e3 * sum(decode_s) / len(decode_s),
            "prefill_ms_mean": 1e3 * sum(prefill_s) / len(prefill_s),
            "preemptions": st.get("preemptions"),
            "launches": launches, "outputs": [outs[i]
                                              for i in range(len(prompts))]}


# ------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch")):
        print("chip_smoke: ray_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build

    report = {}
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    report["nvidia_smi"] = smi
    device = torch.device("cuda")

    # 2. build
    t = time.perf_counter()
    built = _build.build(_build.sources())
    report["build_s"] = time.perf_counter() - t
    log(f"[2] build: {built} in {report['build_s']:.2f} s")

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions (B=8 H=32 KV=8 D=128 bs=64 MBS=32, "
        "S=2048)")
    report["kernels"] = kernel_checks(device)

    # 4. debug engine: card == CPU
    report["debug"] = {}
    for kv in ("paged", "slot"):
        report["debug"][kv] = debug_engine_check(device, kv)
        log(f"[4] debug {kv}: " + json.dumps(report["debug"][kv]))

    # 5. 8b served on the card, paged then slot, same weights
    cfg = llama.CONFIGS["8b"]
    t = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t
    log(f"[5] 8b params: {cfg.num_params() / 1e9:.2f} B in "
        f"{report['init_s']:.1f} s")
    import numpy as np

    rng = np.random.default_rng(0)
    plens = [64, 1500, 300, 777, 129, 1024]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in plens]
    report["serve"] = {}
    for kv in ("paged", "slot"):
        res = serve_check(params, cfg, kv, prompts, max_tokens=32)
        want = res["decode_steps"] * cfg.n_layers
        mine, other = (("paged_decode_attention", "decode_attention")
                       if kv == "paged" else
                       ("decode_attention", "paged_decode_attention"))
        assert res["launches"][mine] == want, (res["launches"], want)
        assert res["launches"][other] == 0, res["launches"]
        report["serve"][kv] = res
        log(f"[5] 8b {kv}: " + json.dumps(
            {k: v for k, v in res.items() if k != "outputs"}))
    same = report["serve"]["paged"]["outputs"] == \
        report["serve"]["slot"]["outputs"]
    log(f"[5] 8b paged and slot outputs identical: {same}")
    report["serve_paged_equals_slot"] = same
    report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # 6. the kernels line and the result line
    k = report["kernels"]
    lines = []
    for name, kind_, src_kernel, replaces in (
            ("paged_decode_attention_kernel", "paged",
             "paged_decode_attention",
             "ray_tpu/ops/pallas/paged_decode_attention.py:97"),
            ("decode_attention_kernel", "slot", "decode_attention",
             "ray_tpu/ops/pallas/decode_attention.py:90")):
        rec = k[kind_]["bfloat16"]
        main_run = report["serve"][kind_]["launches"][src_kernel]
        lines.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/decode_attention.cu",
            "replaces": replaces, "launches": main_run,
            "max_abs_err": max(k[kind_][d]["max_abs_err"]
                               for d in ("bfloat16", "float32")),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "dtype": "bfloat16",
            "float32": k[kind_]["float32"]})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": lines}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

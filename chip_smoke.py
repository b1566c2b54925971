#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch on one NVIDIA GPU: the quickest proof that
the port builds, agrees with itself on the CPU, serves Llama-3-8B (also
speculatively, with a 1B draft, from a GPU actor, through Serve's HTTP
proxy, and as a two-stage pipeline of GPU actors over device channels)
and trains the 1B Llama (also from a Train worker on a mesh, with
checkpoints and a failure restart, and as two GPU pipeline stages), a
Mixtral-shaped MoE (also on a mesh) and ViT-B/16, runs the NCCL
collective group and trains PPO with a GPU learner.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
  1. device: the card's name and power limit;
  2. build: every CUDA source under ray_tpu_torch/csrc, one nvcc each, all
     started together; registers and spills of each kernel as ptxas
     reports them;
  3. kernels: each decode-attention kernel against its plain PyTorch
     version at the serving shapes, in bf16 and f32, with edge lengths
     (1, a block, a non-multiple, full, stale full+1, 0) and shuffled
     block tables, the slot kernel also at its split boundaries (127, 128,
     129 beside 1, 64, 2048, 2049, 0), and at the 1b draft's head dim 64
     at those lengths, each bit for bit equal to itself in a second run;
     times of kernel, plain version and the library yardstick
     (F.scaled_dot_product_attention, timed here only; kernel and library
     from a CUDA graph of 20 calls, since the wrapper's host time exceeds
     the kernel's), and the least time the card could take (bytes over
     3.35 TB/s, or operations over the peak rate);
  4. debug engine on the card (f32: paged with preemption, slot, paged
     with chunked prefill and the radix prefix cache, slot with chunked
     prefill, a PD handoff from a paged engine into a paged and a slot
     engine, and slot engines speculating with ngram, a draft of the same
     weights (k=4) and one of other weights (k=3)) gives the same greedy
     tokens as the same engine on the CPU, and the same spec_* stats;
  5. the 8b configuration served on the card through LLMEngine, paged then
     slot, from random weights: every output complete, logits finite, and
     each kernel launched once per layer per decode step;
  5b. at 8b on the same weights: (a) the chunked prefills (chunks of 256,
     a 1500-token prompt, from 0 and resuming mid-block) against the whole
     prompt's prefill, logits and every written K/V row; (b) phase 5's
     requests with prefill_chunk=256, paged and slot: chunk count, launch
     counts, and where the tokens leave phase 5's (reported); (c) the
     radix prefix cache: eight requests sharing a 1024-token system
     prompt, one diverging inside a block: hits, copy-on-write, allocator
     invariants, TTFT of hits and of the cold request; (d) PD: a paged
     engine's extracted KV submitted to a fresh paged and a fresh slot
     engine gives the source's tokens; extract and inject ms;
  5c. speculative decoding at 8b on the same weights: (a) the batched
     verify of a slot's next five greedy tokens (at a 1500-token prompt)
     and of a window ending at max_seq 2048 with padding past it, against
     plain decode steps, logits and K/V rows (held in f32 on the weights
     cast up; bf16 reported beside the floor of K4 against its plain
     version), and the KV ingest's rows equal to the verify's bits; (b) phase 5's requests on 4 slots with
     ngram (k=4), a draft that is the target (k=4) and the 1b draft (k=4,
     full width and depth): complete outputs, finite logits, the drafts'
     proposals made (ngram's reported), and K4 launched once per layer per
     plain target step and per draft step; acceptance, tokens/s, verify and draft-step ms, and
     where the tokens leave phase 5's (reported); (c) ngram at temperature
     0.8: two engines of one seed give the same tokens;
  6. flash attention: the forward (K1; bf16: flash_fwd_kernel, f32:
     flash_fwd_f32_kernel) and the backward (bf16: the one kernel
     flash_bwd_kernel; f32: K2a dq and K2b dk/dv) against their
     plain versions, in bf16 and f32, at the 1b_bench shapes (B=8, Hq=32,
     Hkv=8, S=2048, D=64, causal), at D=128, and at a ragged S=1000 with
     group 1, non-causal, at ViT-B/16's (B=256, H=12, S=197, D=64,
     non-causal), at the debug ViT's (B=8, H=4, S=17, D=16) and at
     phase 11's 8b pipeline stage's (B=1, Hq=32, Hkv=8, S=256, D=128,
     causal), row by row under the tolerance
     ops/flash_attention.py states, each call launching exactly the
     kernels of its dtype, K1 and the f32 backward bit for bit equal to
     themselves in a second run; times of kernel (the bf16 backward with its
     workspace zeroing and cast), plain version and library yardstick
     (scaled_dot_product_attention and its autograd backward, timed here
     only), and the bound; then the training path's bf16 attention
     (flash_attention_with_lse and its autograd backward) against the
     plain versions on the same tensors;
  7. the f32 debug model trained 5 steps on the card and on the CPU from
     the same weights and batch: same losses and parameters, through the
     f32 kernels flash_fwd_f32_kernel, K2a and K2b;
  8. 1b_bench (the JAX package's headline training configuration) trained
     at full width and depth through ray_tpu_torch.bench.run: finite,
     falling loss, and each flash kernel launched exactly as the path
     needs (K1 and the bf16 flash_bwd_kernel; no K2a, K2b);
  8b. the f32 debug MoE and debug ViT trained 5 steps on the card and on
     the CPU from the same weights and batch, as phase 7;
  8c. 8x7b (the Llama-3-8B backbone with 8 experts of 14336, top-2,
     capacity factor 1.25) at full width and MOE_LAYERS layers, batch 2 x
     2048, 6 steps: finite, falling loss, the router's aux loss in (0.8,
     1.5) at the first step, K1 twice and flash_bwd_kernel once per layer
     per step; step ms, tokens/s, MFU, peak memory;
  8d. ViT-B/16 at full size on 256 seeded images, 6 steps, the same
     checks; images/s, MFU, peak memory;
  8e. 1b_bench under remat_policy "dots" and "nothing" from the same
     weights and batch, 3 steps each: the first loss equal bit for bit,
     the parameters after the second step within max(2e-2, 1.5 x the
     floor) of each other relative to the update (the floor: "nothing"
     run again; bf16 dQ adds in no fixed order), the same K1 launches,
     fewer cuBLAS launches in the backward under "dots"; step ms and peak
     memory of each;
  9. the runtime (ray_tpu_torch.init with no arguments): (a) GPU counted 1
     with no CUDA loaded in the worker factory; (b) a num_gpus=1 task sees
     its grant and one GPU, and runs K4 against its plain version at phase
     3's shape and tolerance with nothing built in the worker; (c) a
     num_gpus=1 actor seeds the 8b weights itself and serves phase 5's
     prompts through actor calls: its greedy tokens equal phase 5's paged
     tokens, K3 launched once per layer per decode step, GPU 0 available
     while it lives; tokens/s beside phase 5's, the p50 round trip of 200
     no-op actor calls; (d) two num_gpus=0.5 actors: a 1 GiB bf16 CUDA
     tensor put as a device object is the same tensor in its producer and
     bit-equal on the consumer's GPU; GB/s and the store's device_bytes;
     (e) after the kills GPU is 1 again, and after shutdown() no process
     of the session is left;
  10. Serve (ray_tpu_torch.serve): serve.start() and a num_gpus=1
     replica of llm_app("8b", phase 5's paged engine): (a) phase 5's
     prompts as concurrent HTTP POSTs with JSON bodies give phase 5's
     paged tokens; (b) the same as SSE streams give (a)'s tokens, one data
     event a token, pushed over the streaming-generator protocol; TTFT
     p50 and tokens/s at the client; (c) one call through
     get_deployment_handle gives phase 5's tokens; K3 launched once per
     layer per decode step in the replica's process, K4 never; (d) the
     PD app (build_pd_app) with the prefill and the decode replica on
     half of the GPU each: a 1500-token prompt's tokens equal phase 5's,
     one prefill and one KV handoff (a device object) a request, prefill
     ms, handoff ms and KV bytes, K3 counted in the decode replica; after
     shutdown() no process of the session is left;
  11. compiled graphs (ray_tpu_torch.graph) under a fresh init(), the free
     space of /dev/shm printed first: (a) a channel-compiled DAG of two
     num_gpus=0.5 actors over device channels carries the 8b activation
     (1, 256, 4096) bf16 and a tensor of the 8b logits' size (1, 256,
     128256) f32 through a known op in each stage: the driver gets a CUDA
     tensor bit-equal to the ops run in the driver; ms and GB/s of one hop;
     (b) build_llama_pipeline on phase 5's 8b weights cut to 4 layers, two
     num_gpus=0.5 stages of 2 layers over device channels: one (1, 256)
     microbatch's logits, a CUDA tensor, against the driver's own forward
     of the same weights, every row within 2e-2 of its norm and the argmax
     equal at every position (bit equality reported); the build and the
     stages' readiness in seconds (each stage is created with a reference
     to its shard in the object store, which init() sizes to hold both
     shards); (c) eight microbatches in flight, then the same eight one
     at a time, each equal to its single run, microbatches/s of both
     (reported); K1 launched once per layer per microbatch in each stage's
     own process, the plain attention never; (d) a stage that raises
     surfaces as PipelineStageError within its deadline; after teardown()
     GPU is 1 again, after shutdown() no process of the session is left;
  12. Train (ray_tpu_torch.train, ray_tpu_torch.parallel) under a fresh
     init(), the free disk space of the checkpoint directory printed
     first: (a) a JaxTrainer gang of one GPU worker (use_gpu=True,
     max_failures=1, num_to_keep=1) joins an NCCL process group of world 1
     and a mesh of MeshConfig() on "cuda" (the code a multi-GPU gang runs,
     with no traffic between ranks), shards phase 8's seeded 1b_bench
     weights with shard_pytree under FSDP_TP_RULES, and trains 6 steps at
     phase 8's batch, full width and depth, with a checkpoint (params and
     moments, torch.distributed.checkpoint) every 2 steps; its first
     attempt raises after reporting step 5, and the restart resumes from
     step 4's checkpoint: the restored bits equal the saved ones (one
     sha256 over every leaf's bytes in key order), the resumed step-5 loss
     equals the first attempt's bit for bit, the first loss is within 1e-4
     relative of phase 8's (bit equality reported) and the first four
     within 5e-3 (the first step's learning rate is 0, so steps 3-4 read
     the sharded step's first updates; steps 5-6 are reported, as the
     bf16 backward's dQ order moves phase 8 itself by up to 6.8e-3 there
     from run to run), losses finite and falling, Result at step 6 with step 6's checkpoint
     the only one left, K1 and flash_bwd_kernel launched in the worker's
     process as phase 8 counts them (no K2a, K2b), GPU 1 again after the
     gang; step ms, tokens/s, restart s, checkpoint write and restore s
     and bytes; (b) then 3 steps with sp_axis="sp" on the same mesh: the
     first two losses and gradient norms (the weights as built) within
     1e-3 of (a)'s, the third loss (after the sp path's first update)
     within 5e-3 (bit equality reported), the same launches — at sp = 1 the ring has one chunk, so the rotation and the
     causal chunk skip are verified on the CPU only
     (tests/test_torch_parallel.py); (c) after shutdown() no process of
     the session is left;
  13. collectives and pipeline training: (a) XlaGroup of world 1 on the
     card (NCCL through torch.cuda.nccl): allreduce (SUM, MAX, MIN),
     broadcast, allgather and reducescatter of a (1, 2^24) f32 tensor and
     its bf16 rounding each equal the input bit for bit, the profiler's
     device activity of one allreduce reported (at world 1 NCCL may copy
     instead of launching a kernel); then with quantized_collectives on,
     allreduce and reducescatter within allreduce_error_bound, apart from
     the input somewhere, and against the port's CPU group (bit equality
     reported); (b) under a fresh init(), PipelineRunner trains the 1b
     Llama (untied head) at full width and depth as two num_gpus=0.5
     stages of 8 layers (the embedding in the first, the final norm, head
     and cross entropy in the last), 4 seeded (1, 2048) microbatches, sgd,
     3 steps, over shm channels sized to one activation, held to a
     single-process step of the same stage functions on the same
     microbatches (the first loss within 1e-4, bit equality reported, the
     later within 5e-3); K1 and flash_bwd_kernel counted in each stage's
     process as the 1F1B schedule implies, K2a, K2b and the plain
     attention never; step ms, microbatches/s, each stage's host step
     (ravel, optimizer, unravel) and device ms; GPU 1 after the runner's
     shutdown, no process of the session after shutdown();
  14. the MoE's expert axis: phase 8c's 8x7b weights and batch on a mesh
     of one rank in this process (MeshConfig() on "cuda", an NCCL group
     of world 1) under FSDP_RULES: (a) 4 steps, the first loss within
     1e-4 of 8c's (bit equality reported), the first four within 5e-3,
     the router's aux loss as 8c holds it, K1 twice and flash_bwd_kernel
     once per layer per step; (b) 3 steps with sp_axis="sp": the first two
     losses within 1e-3 of (a)'s, the third within 5e-3, the same
     launches (at sp = 1 the rotation is checked on the CPU only); step
     ms beside 8c's;
  15. RL: (a) PPOLearner on the card against the same learner on the CPU,
     PPOConfig's default width (64, 64), one batch of two local CartPole
     EnvRunners (2 x 256 steps), one update of 4 epochs of 128: metrics
     and weights within 1e-5; (b) under a fresh init(), PPO with
     tests/test_rl.py's learning settings, two CPU env runners and the
     learner on the card, 12 iterations: final return > max(2 x early,
     60); env steps/s and the learner's update ms; (c) a LearnerGroup of
     one num_gpus=1 learner actor sees its lease, its weights after one
     update equal (a)'s card learner's (bit equality reported); GPU 1
     after the group stops, no process of the session after shutdown();
  16. RL beyond PPO: (a) DQN, BC, MARWIL, SAC, CQL, IMPALA, APPO and
     DreamerV3 at their configs' default widths on the card against the
     same learner on the CPU, from the same weights, runner-made batch
     and draws: metrics and weights within 1e-5 (DreamerV3: metrics 1e-4
     relative or 1e-5, weights 5e-5), update ms and launches; (b)
     Anakin's (4, 8) step card vs CPU within 1e-5, then train(30) at 4096
     envs and PPOConfig's fragment length with no host sync inside (the
     sync debug mode "error"), env steps/s, updates/s, launches an
     update, the folded weights' greedy return > ANAKIN_MIN_RETURN; under
     a fresh init(): (c) Sebulba with two CPU runners and a num_gpus=1
     learner actor, lock-step for 3 updates within 1e-5 of the card's
     sync PPO loop, then about 10 s free-running (fragments/s, policy
     lag, updates/s), GPU 1 after each stop(); (d) IMPALA at
     tests/test_rl.py::TestIMPALA's settings with the learner on the
     card: best return 120 within 240 s, num_updates; no process of the
     session after shutdown();
  17. Data, batch LLM inference and Tune, under a fresh init(), after a
     line with the card's pyarrow, pandas, PIL and optuna: (a) phase 8's
     rows in a Dataset of 4 blocks feed 1b_bench's step through
     iter_torch_batches(device="cuda") for phase 8's 6 steps: the first
     loss bit-equal to phase 8's, the first four within 5e-3, K1 and
     flash_bwd_kernel launched as phase 8 counts them, tokens/s beside
     phase 8's, each batch's host-to-card ms; a seeded random_shuffle of
     64 sequences whose card batches hold the bytes of the host's
     iter_batches; (b) a JaxTrainer gang of one GPU worker with
     datasets=: the worker's iter_torch_batches() feed 3 f32 debug steps,
     losses within 1e-5 of the same steps here, K1 f32, K2a, K2b once per
     layer per step, GPU 1 after; (c) phase 5's prompts through
     build_llm_processor(ProcessorConfig(model="8b", num_gpus=1, phase
     5's paged engine)): the stage actor seeds the weights itself, its
     greedy tokens equal phase 5's paged tokens, K3 once per layer per
     decode step in the actor, rows/s and tokens/s beside phase 5's;
     (d) Tuner(JaxTrainer(use_gpu=True)) over a 2-point learning-rate
     grid, one trial at a time: both finish, the best result is the lower
     final loss, GPU 1 after; each GPU-leased actor's creation split
     (raylet spawn, factory fork, torch import, first CUDA call) on a line
     of its own; no process of the session after shutdown();
  18. the kernels line, then the result line.

Needs one CUDA card, nvcc, about 70 GB of device memory, about 9 GB of
/dev/shm (phase 11's object store and channels; phase 13's channels take
about 60 MB), about 13 GB of disk under $TMPDIR (phase 12's checkpoints:
two of about 6.2 GB at once) and about 40 GB of host memory (phase 13's
host steps: each stage's flat f32 parameters and gradients, about 3 GB
each, and their copies); no network.
"""

import faulthandler
import json
import os
import re
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
# the longest gap between two log lines in a passing run is phase 12's fit,
# under 160 s: a gap of STALL_DUMP_S prints every thread's stack to stderr,
# so a run that hangs names where it stopped
STALL_DUMP_S = 300


def log(*args):
    print(*args, flush=True)
    faulthandler.dump_traceback_later(STALL_DUMP_S, exit=False)


def time_ms(fns, iters=TIMED_ITERS, graph=False):
    """Mean device time of one call, rotating over ``fns`` (one closure
    per input copy), by CUDA events after a warm-up. With ``graph`` the
    ``iters`` calls are captured in one CUDA graph and replayed, so that
    the host's launch time (tens of microseconds a wrapper call) does not
    hide a kernel that runs for less."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    g = None
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.cuda.graph(g):
            for i in range(iters):
                fns[i % len(fns)]()
        torch.cuda.current_stream().wait_stream(side)
        g.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if g is not None:
        g.replay()
    else:
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


def kernel_label(mangled):
    """flash_fwd_kernel<64>, flash_fwd_f32_kernel<64>,
    paged_decode_attention_kernel<bf16,128,4>, ... from a mangled kernel
    name: the template whose length-prefixed name ends in ``_kernel``."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        digits = m.group(1)
        start = m.start() + len(digits)
        name = mangled[start:start + int(digits)]
        args = re.match(r"I(.+?E)Ev", mangled[start + len(name):])
        if name.endswith("_kernel") and args:
            args = args.group(1)
            kind = ("bf16" if "__nv_bfloat16" in args
                    else "f32" if args.startswith("f") else "")
            return f"{name}<" + ",".join(
                [kind] * bool(kind) + re.findall(r"Li(\d+)E", args)) + ">"
    return mangled[:60]


# ------------------------------------------------------------- phase 3

def kernel_checks(device, B=8, H=32, KV=8, D=128, bs=64, MBS=32, S=2048,
                  seed=0):
    """Both kernels against their plain versions; returns per-kernel
    records keyed by dtype, each with its error over the tolerance
    (``excess``), whether two runs gave the same bits and what the length-0
    slot got (:func:`assert_kernels` holds them to their bounds)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.decode_attention import (
        SPLIT_ROWS, decode_attention, decode_attention_reference)
    from ray_tpu_torch.ops.paged_decode_attention import (
        paged_attention_reference, paged_decode_attention)

    # enable_gqa (one library call for grouped heads) exists from 2.5 on
    gqa = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)
    cap = MBS * bs
    edge = [1, bs, bs + 37, cap, cap + 1, 0]
    lens = (edge + [cap // 2 + 11, 3 * bs - 1] * B)[:B]
    # K4 also at its split boundaries (S = cap: 2049 is a stale slot)
    split_lens = ([1, bs, SPLIT_ROWS - 1, SPLIT_ROWS, SPLIT_ROWS + 1, S,
                   S + 1, 0] * B)[:B]
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
    out = {"paged": {}, "slot": {}, "slot_d64": {}, "lengths": lens,
           "slot_split_lengths": split_lens}

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def compare(kernel, plain, args, lens_):
        """The kernel twice and its plain version on ``args``."""
        got = kernel(*args, scale=scale)
        again = kernel(*args, scale=scale)
        torch.cuda.synchronize()
        want = plain(*args, scale=scale)
        return {"max_abs_err": (got.float() - want.float()).abs().max()
                .item(),
                "equal_runs": torch.equal(got, again),
                "finite": bool(torch.isfinite(got).all()),
                "zero_slot_max": got[lens_.index(0)].abs().max().item()}

    def slot_record(csets, cases):
        """K4 against its plain version on ``csets[i]`` at the lengths
        ``cases[i]``; timed, with its library call and bound, over every
        input copy at the lengths ``cases[0]``."""
        runs = [compare(decode_attention, decode_attention_reference,
                        (*csets[i], torch.tensor(c, dtype=torch.int32,
                                                 device=device)), c)
                for i, c in enumerate(cases)]
        rec = {"max_abs_err": max(r["max_abs_err"] for r in runs),
               "equal_runs": all(r["equal_runs"] for r in runs),
               "finite": all(r["finite"] for r in runs),
               "zero_slot_max": max(r["zero_slot_max"] for r in runs)}
        if len(runs) > 1:
            rec["split_lengths_max_abs_err"] = runs[1]["max_abs_err"]
        q0, k0 = csets[0][0], csets[0][1]
        B_, S_, KV_, D_ = k0.shape
        lens_t = torch.tensor(cases[0], dtype=torch.int32, device=device)
        smask = (torch.arange(S_, device=device)[None, :]
                 < lens_t[:, None])[:, None, None, :]
        sc = D_ ** -0.5
        rec.update({
            "shape": [B_, q0.shape[2], KV_, D_, S_],
            "tolerance": TOL[str(q0.dtype).split(".")[1]],
            "ms": time_ms([lambda s=s: decode_attention(
                *s, lens_t, scale=sc) for s in csets], graph=True),
            "plain_ms": time_ms([lambda s=s: decode_attention_reference(
                *s, lens_t, scale=sc) for s in csets]),
            "library_ms": time_ms([lambda s=s: F.scaled_dot_product_attention(
                s[0].transpose(1, 2), s[1].transpose(1, 2),
                s[2].transpose(1, 2), attn_mask=smask, scale=sc,
                enable_gqa=True) for s in csets], graph=True)
            if gqa else None,
        })
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            sum(min(n, S_) for n in cases[0]), B_, q0.shape[2], KV_, D_,
            q0.element_size(), str(q0.dtype).split(".")[1],
            index_bytes=4 * B_)
        return rec

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        sets = [(rand(B, 1, H, D).to(dt), rand(NB, bs, KV, D).to(dt),
                 rand(NB, bs, KV, D).to(dt)) for _ in range(INPUT_COPIES)]
        rec = compare(paged_decode_attention, paged_attention_reference,
                      (*sets[0], tables, lengths), lens)
        gathered = [(q_.transpose(1, 2), k_[tables.long()].reshape(
            B, cap, KV, D).transpose(1, 2), v_[tables.long()].reshape(
            B, cap, KV, D).transpose(1, 2)) for q_, k_, v_ in sets]
        mask = (torch.arange(cap, device=device)[None, :]
                < lengths[:, None])[:, None, None, :]
        rec.update({
            "tolerance": TOL[name],
            "ms": time_ms([lambda s=s: paged_decode_attention(
                *s, tables, lengths, scale=scale) for s in sets], graph=True),
            "plain_ms": time_ms([lambda s=s: paged_attention_reference(
                *s, tables, lengths, scale=scale) for s in sets]),
            # over the pre-gathered cache: no single library call takes a
            # block table
            "library_ms": time_ms([lambda g=g: F.scaled_dot_product_attention(
                g[0], g[1], g[2], attn_mask=mask, scale=scale,
                enable_gqa=True) for g in gathered], graph=True)
            if gqa else None,
        })
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            paged_rows, B, H, KV, D, sets[0][0].element_size(), name,
            index_bytes=4 * B + 4 * sum(min(-(-n // bs), MBS) for n in lens))
        out["paged"][name] = rec
        del gathered

        csets = [(q_, rand(B, S, KV, D).to(dt), rand(B, S, KV, D).to(dt))
                 for q_, _, _ in sets]
        out["slot"][name] = slot_record(csets, (lens, split_lens))
        del sets, csets
        # K4 at the 1b draft's heads and cache (D=64), split boundaries
        csets = [(rand(B, 1, H, 64).to(dt), rand(B, S, KV, 64).to(dt),
                  rand(B, S, KV, 64).to(dt)) for _ in range(INPUT_COPIES)]
        out["slot_d64"][name] = slot_record(csets, (split_lens,))
        del csets
        for kind in ("paged", "slot", "slot_d64"):
            r = out[kind][name]
            r["excess"] = r["max_abs_err"] / r["tolerance"]
            r["ok"] = (r["excess"] <= 1.0 and r["equal_runs"] and r["finite"]
                       and r["zero_slot_max"] == 0.0)
            log(f"  {kind:5s} {name:8s} " + json.dumps(r))
    return out


def assert_kernels(records):
    """Each decode kernel within its tolerance of its plain version, finite,
    0 on the length-0 slot, and bit for bit equal to itself in a second
    run."""
    for kind in ("paged", "slot", "slot_d64"):
        for name, r in records[kind].items():
            what = f"{kind} kernel {name}"
            assert r["finite"], f"{what}: non-finite output"
            assert r["excess"] <= 1.0, f"{what}: max_abs_err {r['max_abs_err']}"
            assert r["zero_slot_max"] == 0.0, f"{what}: length 0 is not 0"
            assert r["equal_runs"], f"{what}: two runs differ"


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


def _generate_each(eng, prompts, max_tokens):
    """The prompts one after another, each to completion: outputs."""
    return {i: eng.generate(p, max_tokens=max_tokens, timeout_s=600)
            for i, p in enumerate(prompts)}


def _prefilled(eng, prompt, ent, max_tokens):
    """``submit_prefilled`` of a legacy cache entry, polled to the end."""
    rid = eng.submit_prefilled(prompt, ent["k"], ent["v"], ent["logits"],
                               max_tokens=max_tokens)
    out, deadline = [], time.monotonic() + 600
    while True:
        st = eng.poll(rid)
        out += st["chunks"]
        if st["done"]:
            return out
        if time.monotonic() > deadline:
            raise TimeoutError("prefilled request timed out")
        time.sleep(0.005)


def _debug_prompts(seed=0):
    """Phase 4's prompts: six short ones (the paged case's pool of 96
    tokens preempts), four longer than a chunk of 32 beside a short one,
    a 40-token system prompt with five tails, the fourth diverging inside
    a block of 16 of the second's, and six for speculation, with n-gram
    structure and without (tests/test_speculation.py's)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(1, 256, n).tolist()

    system, tail = toks(40), toks(30)
    return {"short": [[2 + i, 9, 4] for i in range(6)],
            "long": [toks(n) for n in (70, 5, 100, 40, 33)],
            "shared": [system + t for t in (toks(12), tail, toks(3),
                                            tail[:9] + toks(20), toks(25))],
            "spec": [[3, 4, 5, 6, 3, 4, 5, 6, 3, 4], [11, 23, 7, 91, 2, 57],
                     [9] * 8, [100, 2, 3], [42, 17, 42, 17, 42, 17, 42],
                     [7]]}


DEBUG_CASES = {  # name: engine keywords, prompts, max_tokens, sequential
    "paged": (dict(kv_cache="paged", kv_pool_tokens=96), "short", 40,
              False),
    "slot": (dict(kv_cache="slot"), "short", 40, False),
    "paged_chunk_radix": (dict(kv_cache="paged", prefill_chunk=32,
                               prefix_cache="radix"), "shared", 12, True),
    "slot_chunk": (dict(kv_cache="slot", prefill_chunk=32), "long", 12,
                   False),
    # speculation; draft: (weights, k), the target's or another seed's
    "slot_ngram": (dict(kv_cache="slot", speculation="ngram"), "spec", 12,
                   True),
    "slot_draft_same": (dict(kv_cache="slot", draft=("same", 4)), "spec",
                        12, True),
    "slot_draft_other": (dict(kv_cache="slot", draft=("other", 3)), "spec",
                         12, True),
}


def debug_engine_check(device, case, seed=0):
    """The f32 debug engine on ``device`` and on the CPU, same weights:
    greedy tokens must be identical (and, for the sequential radix case,
    the prefix cache's counters; for speculation, the ``spec_*`` stats)."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.CONFIGS["debug"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    kw, which, max_tokens, sequential = DEBUG_CASES[case]
    kw = dict(kw)
    if "draft" in kw:
        weights, k = kw.pop("draft")
        draft = params if weights == "same" else llama.init_params(
            cfg, torch.Generator().manual_seed(seed + 7), "cpu")
        kw["speculation"] = {"method": "draft", "k": k,
                             "draft_config": cfg, "draft_params": draft}
    prompts = _debug_prompts(seed)[which]
    res = {}
    for dev in (device, "cpu"):
        eng = LLMEngine(cfg, params, device=dev, num_slots=3, max_seq=128,
                        kv_block_size=16, **kw)
        try:
            res[dev] = (_generate_each(eng, prompts, max_tokens)
                        if sequential else
                        _run_requests(eng, prompts, max_tokens)[0],
                        eng.stats())
            if eng.kv_cache == "paged":
                eng._alloc.check_invariants()
        finally:
            eng.shutdown()
    (on_card, st), (on_cpu, cpu_st) = res[device], res["cpu"]
    assert all(len(on_card[i]) == max_tokens for i in range(len(prompts)))
    assert on_card == on_cpu, f"debug {case}: card and CPU tokens differ"
    out = {"requests": len(prompts), "identical": True}
    if case == "paged":
        assert st["preemptions"] >= 1, st
        out["preemptions"] = st["preemptions"]
    if "prefill_chunk" in kw:
        want = sum(-(-len(p) // 32) for p in prompts if len(p) > 32)
        if "prefix_cache" not in kw:
            assert st["prefill_chunks_run"] == want, (st, want)
        assert st["prefilling_slots"] == 0, st
        out["prefill_chunks_run"] = st["prefill_chunks_run"]
    if "prefix_cache" in kw:
        pc = st["prefix_cache"]
        assert pc == cpu_st["prefix_cache"], (pc, cpu_st["prefix_cache"])
        assert pc["hits"] == len(prompts) - 1 and pc["cow_hits"] >= 1, pc
        out["prefix_cache"] = pc
    if "speculation" in kw:
        spec = {key: v for key, v in st.items() if key.startswith("spec")}
        assert spec == {key: cpu_st[key] for key in spec}, (spec, cpu_st)
        assert spec["spec_proposed"] > 0, spec
        out["spec"] = spec
    return out


def debug_pd_check(device, seed=0):
    """PD on the debug engine: a paged engine's prompt KV (extracted into
    its legacy cache) submitted to a fresh paged and a fresh slot engine,
    on ``device`` and on the CPU: every run gives the source's tokens."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = llama.CONFIGS["debug"]
    params = llama.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    prompt = _debug_prompts(seed)["long"][2]
    kw = dict(num_slots=2, max_seq=128, kv_block_size=16)
    outs = {}
    for dev in (device, "cpu"):
        src = LLMEngine(cfg, params, device=dev, prefix_cache="legacy", **kw)
        try:
            outs[(dev, "source")] = src.generate(prompt, max_tokens=12)
            ent = src._prefix_cache[tuple(prompt)]
        finally:
            src.shutdown()
        for kv in ("paged", "slot"):
            eng = LLMEngine(cfg, params, device=dev, kv_cache=kv, **kw)
            try:
                outs[(dev, kv)] = _prefilled(eng, prompt, ent, 12)
            finally:
                eng.shutdown()
    want = outs[(device, "source")]
    assert len(want) == 12
    assert all(o == want for o in outs.values()), outs
    return {"prompt_tokens": len(prompt), "identical": True,
            "kv_dtype": str(ent["k"].dtype)}


def assert_decode_launches(res, kv_cache, cfg):
    """The cache mode's decode kernel launched once per layer per decode
    step, the other kernel never."""
    want = res["decode_steps"] * cfg.n_layers
    mine, other = (("paged_decode_attention", "decode_attention")
                   if kv_cache == "paged" else
                   ("decode_attention", "paged_decode_attention"))
    assert res["launches"][mine] == want, (res["launches"], want)
    assert res["launches"][other] == 0, res["launches"]


def mean_ms(times):
    return 1e3 * sum(times) / len(times) if times else None


def watch(fn, times, finite):
    """``fn`` (an engine step returning ``(cache, logits)``) timed to the
    end of its device work into ``times``, with whether its logits were
    finite appended to ``finite``."""
    import torch

    def call(*args):
        t = time.perf_counter()
        cache, logits = fn(*args)
        finite.append(bool(torch.isfinite(logits).all()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return cache, logits
    return call


def serve_check(params, cfg, kv_cache, prompts, max_tokens, num_slots=4,
                max_seq=2048, device=None, **engine_kw):
    """Serve ``prompts`` through LLMEngine on the card with each kernel's
    launch count read around the run; checks every output's length and
    that every logits tensor (prefill, prefill chunk, decode, and with
    speculation the verify and the draft's steps) was finite."""
    import torch

    from ray_tpu_torch.ops.decode_attention import decode_attention
    from ray_tpu_torch.ops.paged_decode_attention import \
        paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, num_slots=num_slots, max_seq=max_seq,
                    kv_cache=kv_cache, kv_block_size=64, device=device,
                    **engine_kw)
    finite, decode_s, prefill_s, chunk_s = [], [], [], []
    eng._decode = watch(eng._decode, decode_s, finite)
    eng._prefill = watch(eng._prefill, prefill_s, finite)
    if eng._chunk_prefill is not None:
        eng._chunk_prefill = watch(eng._chunk_prefill, chunk_s, finite)
    verify_s, draft_s = [], []
    prop = eng._proposer
    if prop is not None:
        eng._spec_verify = watch(eng._spec_verify, verify_s, finite)
        if hasattr(prop, "_decode"):
            prop._decode = watch(prop._decode, draft_s, finite)
    try:
        paged_decode_attention.launches = 0
        decode_attention.launches = 0
        outs, ttft, wall = _run_requests(eng, prompts, max_tokens)
        launches = {"paged_decode_attention": paged_decode_attention.launches,
                    "decode_attention": decode_attention.launches}
        st = eng.stats()
        steps = {"plain_steps": eng._plain_steps,
                 "verify_steps": eng._verify_steps}
    finally:
        eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    assert all(len(outs[i]) == max_tokens for i in range(len(prompts))), \
        {i: len(o) for i, o in outs.items()}
    assert finite and all(finite), "non-finite logits"
    tokens = sum(len(o) for o in outs.values())
    ttfts = sorted(ttft.values())
    spec = {}
    if prop is not None:
        spec = {**{key: v for key, v in st.items() if key.startswith("spec")},
                **steps, "draft_steps": st.get("spec_draft_steps", 0),
                "verify_ms_mean": mean_ms(verify_s),
                "draft_step_ms_mean": mean_ms(draft_s)}
    return {"kv_cache": kv_cache, "requests": len(prompts),
            "prompt_tokens": [len(p) for p in prompts],
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
            "ttft_max_ms": 1e3 * ttfts[-1],
            "decode_steps": st["steps"],
            "decode_step_ms_mean": mean_ms(decode_s),
            "prefill_ms_mean": mean_ms(prefill_s),
            "prefill_chunks_run": st["prefill_chunks_run"],
            "chunk_ms_mean": mean_ms(chunk_s),
            "preemptions": st.get("preemptions"), **spec,
            "launches": launches, "outputs": [outs[i]
                                              for i in range(len(prompts))]}


# ------------------------------------------------------------- phase 5b

KV_ROW_RTOL = 2e-2       # bf16 rows: ||got_r - want_r|| <= 2e-2 ||want_r||


def row_excess(got, want):
    """The largest error of a row (the last dimension) over its allowance,
    KV_ROW_RTOL of the row's norm plus 1e-3 of the rows' rms (a row of
    zeros, a padding row, must stay zero)."""
    g, w = got.double(), want.double()
    err = (g - w).norm(dim=-1)
    norm = w.norm(dim=-1)
    rms = norm.square().mean().sqrt()
    return (err / (KV_ROW_RTOL * norm + 1e-3 * rms).clamp(min=1e-30)).max() \
        .item()


def chunk_layer_check(params, cfg, plen=1500, C=256, seed=1):
    """At full width and depth: the chunked prefills of a ``plen``-token
    prompt in chunks of ``C`` (from 0, then again resuming mid-block
    after a first chunk of 100 tokens) against the whole-prompt prefill
    on the same prompt, paged and slot: the last position's logits and
    every written K/V row (per layer, position and kv head) within
    KV_ROW_RTOL of the row's norm. Returns the worst excess of each and
    the ms of each chunk (host clock, synchronized)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import decoding, llama
    from ray_tpu_torch.models import paged_cache as pc

    device = params["embed"].device
    head = llama.head_f32(params, cfg)
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, plen).tolist()
    page = pc.PagedConfig(num_blocks=1 + 2048 // 64, block_size=64,
                          max_seq=2048)
    al = pc.BlockAllocator(page, 1, device=device)
    assert al.ensure(0, plen + 1)
    table = al.tables[0]
    P = pc.pad_to_block_bucket(plen, 64)
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :plen] = prompt
    modes = {
        "paged": (lambda: pc.init_paged_cache(cfg, page, 1, device=device),
                  lambda c, *a: pc.make_paged_prefill(
                      params, cfg, page, head=head)(c, table, *a),
                  pc.make_chunked_paged_prefill(params, cfg, page, head=head),
                  (table,)),
        "slot": (lambda: decoding.init_cache(cfg, 1, 2048, device=device),
                 decoding.make_prefill(params, cfg, head=head),
                 decoding.make_chunked_prefill(params, cfg, head=head), ()),
    }
    out = {}
    for mode, (fresh, whole_fn, chunk_fn, lead) in modes.items():
        whole, want = whole_fn(fresh(), tokens, plen, 0)

        def rows(cache):
            if mode == "paged":
                ids = torch.as_tensor(table[:-(-plen // 64)], device=device)
                return [cache[n][:, ids.long()].flatten(1, 2)[:, :plen]
                        for n in ("k", "v")]
            return [cache[n][:, 0, :plen] for n in ("k", "v")]

        want_rows = rows(whole)
        del whole
        for start_first in (C, 100):
            cache, ms, pos, n = fresh(), [], 0, start_first
            while pos < plen:
                n = min(n, plen - pos)
                buf = np.zeros((1, C), np.int32)
                buf[0, :n] = prompt[pos:pos + n]
                torch.cuda.synchronize()
                t = time.perf_counter()
                cache, got = chunk_fn(cache, *lead, buf, n, pos, 0)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t))
                pos, n = pos + n, C
            assert int(cache["length"][0]) == plen
            rec = {"chunks": len(ms), "chunk_ms": ms,
                   "logits_excess": row_excess(got, want),
                   "logits_max_abs_err": (got - want).abs().max().item(),
                   "logits_finite": bool(torch.isfinite(got).all())}
            for name, g, w in zip(("k", "v"), rows(cache), want_rows):
                rec[f"{name}_excess"] = row_excess(g, w)
            out[f"{mode}_first{start_first}"] = rec
            del cache
        del want_rows
        torch.cuda.empty_cache()
    for key, rec in out.items():
        assert rec["logits_finite"], key
        bad = {k: v for k, v in rec.items()
               if k.endswith("_excess") and not v <= 1.0}
        assert not bad, f"chunked prefill {key}: outside tolerance: {bad}"
    return out


def first_divergence(a, b):
    """First position where two token lists differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def radix_check(params, cfg, system_len=1024, n=8, max_tokens=32, seed=2,
                device=None):
    """Radix prefix cache at full width and depth, paged: ``n`` requests
    share a ``system_len``-token system prompt, with distinct suffixes of
    64–300 tokens; the sixth diverges inside a block of the second's
    suffix. One request at a time: the first prefills cold, every later
    one hits and prefills only its suffix. Checks the hits, the hit tokens
    and a copy-on-write hit, the allocator's invariants, and that dropping
    the tree frees the whole pool; returns the TTFT of the cold request
    and of the hits."""
    import numpy as np
    import torch

    from ray_tpu_torch.serve.llm import LLMEngine

    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, system_len).tolist()
    suffixes = [rng.integers(0, cfg.vocab_size, int(k)).tolist()
                for k in rng.integers(64, 301, n)]
    suffixes[5] = suffixes[1][:30] + suffixes[5][30:]
    prompts = [system + s_ for s_ in suffixes]
    eng = LLMEngine(cfg, params, num_slots=4, max_seq=2048,
                    kv_cache="paged", kv_block_size=64,
                    prefix_cache="radix", device=device)
    ttft, outs = [], []
    try:
        for p in prompts:
            got, t = _run_requests(eng, [p], max_tokens)[:2]
            outs.append(got[0])
            ttft.append(1e3 * t[0])
        st = eng.stats()
    finally:
        eng.shutdown()
    try:
        assert all(len(o) == max_tokens for o in outs)
        pc = st["prefix_cache"]
        assert pc["hits"] >= n - 1, pc
        assert pc["hit_tokens"] >= (n - 1) * system_len, pc
        assert pc["cow_hits"] >= 1, pc
        eng._alloc.check_invariants()
        eng._radix.clear()
        eng._alloc.check_invariants()
        assert eng._alloc.free_blocks() == eng._page.num_blocks - 1
    finally:
        del eng
        torch.cuda.empty_cache()
    hits = sorted(ttft[1:])
    return {"prompt_tokens": [len(p) for p in prompts],
            "prefix_cache": pc, "prefill_chunks_run": st["prefill_chunks_run"],
            "ttft_cold_ms": ttft[0], "ttft_hit_ms": ttft[1:],
            "ttft_hit_p50_ms": hits[len(hits) // 2]}


def pd_check(params, cfg, prompt, max_tokens=32, device=None):
    """PD at full width and depth: a paged engine's prompt KV, extracted
    into its legacy cache, submitted to a fresh paged and a fresh slot
    engine. Their greedy tokens equal the source's exactly (injection
    copies the bf16 rows bit for bit, and K3 and K4 give the same bits).
    Returns the extract and inject ms (host clock, synchronized)."""
    import torch

    from ray_tpu_torch.serve.llm import LLMEngine

    def timed(fn, times):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            return res
        return call

    kw = dict(num_slots=4, max_seq=2048, kv_block_size=64, device=device)
    extract_ms, inject_ms, outs = [], {}, {}
    # the legacy cache's 64 MiB default would drop this prompt's KV
    src = LLMEngine(cfg, params, kv_cache="paged", prefix_cache="legacy",
                    prefix_cache_bytes=1 << 30, **kw)
    src._extract_kv = timed(src._extract_kv, extract_ms)
    try:
        want = src.generate(prompt, max_tokens=max_tokens, timeout_s=600)
        ent = src._prefix_cache[tuple(prompt)]
    finally:
        src.shutdown()
        del src
        torch.cuda.empty_cache()
    for kv in ("paged", "slot"):
        eng = LLMEngine(cfg, params, kv_cache=kv, **kw)
        inject_ms[kv] = []
        eng._inject_kv = timed(eng._inject_kv, inject_ms[kv])
        try:
            outs[kv] = _prefilled(eng, prompt, ent, max_tokens)
        finally:
            eng.shutdown()
            del eng
            torch.cuda.empty_cache()
    assert len(want) == max_tokens
    for kv, got in outs.items():
        assert got == want, (kv, first_divergence(got, want))
    return {"prompt_tokens": len(prompt), "kv_dtype": str(ent["k"].dtype),
            "kv_bytes": int(ent["k"].nbytes + ent["v"].nbytes),
            "extract_ms": extract_ms[0],
            "inject_ms": {k: v[0] for k, v in inject_ms.items()},
            "identical": True}


# ------------------------------------------------------------- phase 5c

def verify_layer_check(params, cfg, plens=(1500, 2045), C=5, S=2048, seed=3,
                       gate=True):
    """At full width and depth, a slot cache of two slots and ``S`` rows:
    slot 0 at a 1500-token prompt, slot 1 at 2045. From the prefilled
    cache, plain decode steps feed each slot its next greedy tokens one
    at a time (five for slot 0; three for slot 1, up to row S-1); the
    verify of the same windows (slot 1's padded past S) from a copy of
    the prefilled cache gives each decode step's logits row and K/V rows
    within KV_ROW_RTOL of the row's norm (checked with ``gate``), every
    other row of the slots bit for bit, and the ingest the verify's bits.

    Without ``gate`` (bf16) the excess is reported beside its floor: the
    same decode steps, fed the same tokens, with K4's plain version in
    place of K4. The two agree within their tolerance each call (phase
    3), and through 32 layers of random weights that difference of a
    bf16 rounding grows as far as the verify's does."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import decoding, llama
    from ray_tpu_torch.ops.decode_attention import decode_attention_reference

    device = params["embed"].device
    head = llama.head_f32(params, cfg)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in plens]
    B = len(plens)
    start = decoding.init_cache(cfg, B, S, device=device)
    prefill = decoding.make_prefill(params, cfg, head=head)
    first = []
    for slot, p in enumerate(prompts):
        buf = np.zeros((1, min(decoding.pad_to_bucket(len(p)), S)), np.int32)
        buf[0, :len(p)] = p
        start, lg = prefill(start, buf, len(p), slot)
        first.append(int(lg.argmax()))
    nwin = [min(C, S - n) for n in plens]
    step = decoding.make_decode_step(params, cfg, head=head)
    step_ms = []

    def decode_steps(feed=None):
        """Decode steps from a copy of the prefilled cache, each slot fed
        its greedy tokens (or ``feed``'s): the cache, each slot's logits
        rows and its tokens."""
        cache = {k: v.clone() for k, v in start.items()}
        toks = [list(t) for t in feed] if feed else [[t] for t in first]
        rows = [[] for _ in plens]
        for i in range(max(nwin)):
            active = np.array([i < n for n in nwin])
            torch.cuda.synchronize()
            t = time.perf_counter()
            cache, lg = step(cache, np.array(
                [t_[min(i, len(t_) - 1)] for t_ in toks], np.int32), active)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            for b in range(B):
                if active[b]:
                    rows[b].append(lg[b])
                    if not feed:
                        toks[b].append(int(lg[b].argmax()))
        return cache, [torch.stack(r) for r in rows], toks

    cache, rows, toks = decode_steps()
    win = np.zeros((B, C), np.int32)
    for b in range(B):
        win[b, :nwin[b]] = toks[b][:nwin[b]]
    lens, starts = np.array(nwin, np.int32), np.array(plens, np.int32)
    ingested = decoding.make_kv_ingest(params, cfg)(
        {k: v.clone() for k, v in start.items()}, win, lens, starts)
    verify = decoding.make_batched_spec_verify(params, cfg, head=head)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got, logits = verify({k: v.clone() for k, v in start.items()}, win, lens,
                         starts)
    torch.cuda.synchronize()
    verify_ms = 1e3 * (time.perf_counter() - t)
    out = {"dtype": str(cfg.dtype), "prompt_tokens": list(plens),
           "window": nwin, "verify_ms": verify_ms, "decode_step_ms": step_ms,
           "logits_finite": bool(torch.isfinite(logits).all()),
           "lengths": got["length"].tolist(),
           "ingest_equals_verify": all(torch.equal(ingested[n], got[n])
                                       for n in ("k", "v", "length"))}
    del ingested

    def excess(prefix, got_rows, got_cache, want_rows, want_cache):
        for b in range(B):
            out[f"{prefix}slot{b}_logits_excess"] = row_excess(
                got_rows[b], want_rows[b])
            w = slice(plens[b], plens[b] + nwin[b])
            for n in ("k", "v"):
                out[f"{prefix}slot{b}_{n}_excess"] = row_excess(
                    got_cache[n][:, b, w], want_cache[n][:, b, w])

    excess("", [logits[b, :nwin[b]] for b in range(B)], got, rows, cache)
    for b in range(B):
        stop = plens[b] + nwin[b]
        out[f"slot{b}_other_rows_equal"] = all(
            torch.equal(got[n][:, b, :plens[b]], cache[n][:, b, :plens[b]])
            and torch.equal(got[n][:, b, stop:], cache[n][:, b, stop:])
            for n in ("k", "v"))
    del got
    if not gate:
        orig = decoding._attend_cached
        decoding._attend_cached = \
            lambda q, k, v, lengths, scale: decode_attention_reference(
                q, k, v, lengths, scale=scale)
        try:
            plain_cache, plain_rows, _ = decode_steps(feed=toks)
        finally:
            decoding._attend_cached = orig
        excess("floor_", plain_rows, plain_cache, rows, cache)
        del plain_cache
    del cache, start
    torch.cuda.empty_cache()
    assert out["logits_finite"], out
    assert out["lengths"] == [n + w for n, w in zip(plens, nwin)], out
    assert out["lengths"][-1] == S, out
    assert out["ingest_equals_verify"], "ingest and verify rows differ"
    assert all(out[f"slot{b}_other_rows_equal"] for b in range(B)), out
    bad = {k: v for k, v in out.items()
           if gate and k.endswith("_excess") and not v <= 1.0}
    assert not bad, f"verify vs decode steps: {bad}"
    return out


def cast_params(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def assert_spec_launches(res, cfg, draft_layers):
    """K4 launched once per layer per plain target step and per draft step
    (the verify's attention is plain PyTorch), K3 never."""
    want = (res["plain_steps"] * cfg.n_layers
            + res["draft_steps"] * draft_layers)
    assert res["launches"]["decode_attention"] == want, (res["launches"],
                                                         want)
    assert res["launches"]["paged_decode_attention"] == 0, res["launches"]


def temperature_check(params, cfg, prompts, max_tokens=32, temperature=0.8):
    """Two speculative (ngram) slot engines with the same seed, the same
    requests one after another at ``temperature``: the same tokens."""
    import torch

    from ray_tpu_torch.serve.llm import LLMEngine

    outs, stats = [], []
    for _ in range(2):
        eng = LLMEngine(cfg, params, num_slots=4, max_seq=2048,
                        kv_cache="slot", speculation="ngram", seed=0)
        try:
            outs.append([eng.generate(p, max_tokens=max_tokens,
                                      temperature=temperature,
                                      timeout_s=600) for p in prompts])
            stats.append({k: v for k, v in eng.stats().items()
                          if k.startswith("spec") or k == "steps"})
        finally:
            eng.shutdown()
            del eng
            torch.cuda.empty_cache()
    assert all(len(o) == max_tokens for o in outs[0]), outs[0]
    assert all(0 <= t < cfg.vocab_size for o in outs[0] for t in o)
    assert outs[0] == outs[1], "same seed, different tokens"
    assert stats[0] == stats[1], stats
    return {"temperature": temperature, "requests": len(prompts),
            "identical": True, "stats": stats[0]}


# ------------------------------------------------------------- phase 6

FLASH_CASES = [  # name, B, Hq, Hkv, S (= Sq = Skv), D, causal
    ("1b_bench", 8, 32, 8, 2048, 64, True),   # the training path's shapes
    ("d128", 2, 32, 8, 2048, 128, True),      # and 8x7b's (phase 8c)
    ("ragged", 2, 8, 8, 1000, 64, False),
    ("vit_b16", 256, 12, 12, 197, 64, False),  # phase 8d's
    ("vit_debug", 8, 4, 4, 17, 16, False),     # phase 8b's ViT
    ("8b_stage", 1, 32, 8, 256, 128, True),    # phase 11's pipeline stage
]


def flash_bound_ms(kernel, B, Hq, Hkv, S, D, causal, itemsize, dtype_name):
    """Least time of one call: its products over the peak rate (only the
    unmasked query-key pairs), or each operand read and each result
    written once over 3.35 TB/s. Products: K1 Q·Kᵀ and P·V; the backward
    (bwd) Q·Kᵀ, dO·Vᵀ, dS·K, Pᵀ·dO and dSᵀ·Q, reading q, k, v, dO, lse
    and delta and writing dq, dk and dv; K2a the first three; K2b all but
    dS·K."""
    pairs = B * Hq * (S * (S + 1) // 2 if causal else S * S)
    products = {"fwd": 2, "bwd": 5, "dq": 3, "dkv": 4}[kernel]
    ops = 2 * D * pairs * products
    qsize, kvsize, rows = B * Hq * S * D, B * Hkv * S * D, 4 * B * Hq * S
    nbytes = {"fwd": itemsize * (2 * qsize + 2 * kvsize) + rows,
              "bwd": itemsize * (3 * qsize + 4 * kvsize) + 2 * rows,
              "dq": itemsize * (3 * qsize + 2 * kvsize) + 2 * rows,
              "dkv": itemsize * (2 * qsize + 4 * kvsize) + 2 * rows}[kernel]
    t_ops = ops / PEAK_OPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def top_kernel(fn):
    """Name of the CUDA kernel that takes most device time in one call of
    ``fn`` (which backend a library call chose)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CUDA]
    return max(events, key=lambda e: e.device_time_total).key[:120] \
        if events else None


def flash_inputs(device, dt, B, Hq, Hkv, S, D, seed=0):
    """q, k, v and a cotangent dout from a seed, in the (B, H, S, D)
    layout of the flash kernels."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    return rand(B, Hq, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, D), \
        rand(B, Hq, S, D)


BWD_KERNELS = {"bfloat16": ("bwd",), "float32": ("dq", "dkv")}


def flash_compare(q, k, v, do, causal):
    """K1, and the backward kernels of q's dtype through
    flash_attention_bwd, against their plain versions on the same inputs
    (both backward versions take the plain forward's lse and delta); K1
    and the f32 backward must give the same bits in a second run.
    Returns each result's mismatch (ops.flash_attention.mismatch: row by
    row under the stated tolerance) and the backward's operands."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    kw = dict(causal=causal, scale=q.shape[-1] ** -0.5)
    got_out, got_lse = fa.flash_attention_fwd(q, k, v, **kw)
    again = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got_out, again[0]) and torch.equal(got_lse, again[1]), \
        "K1: two runs differ"
    del again
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * want_out.float()).sum(-1)
    bwd_args = (q, k, v, want_lse, delta, do)
    before = dict(fa.flash_attention_bwd.launches)
    got = fa.flash_attention_bwd(*bwd_args, **kw)
    torch.cuda.synchronize()
    ran = BWD_KERNELS[str(q.dtype).split(".")[1]]
    assert fa.flash_attention_bwd.launches == {
        key: n + (key in ran) for key, n in before.items()}, \
        (before, fa.flash_attention_bwd.launches)
    if q.dtype == torch.float32:
        # K2a and K2b own their tiles (bf16's dQ adds in L2 in no order)
        again = fa.flash_attention_bwd(*bwd_args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "f32 K2a/K2b: two runs differ"
        del again
    want = fa.flash_attention_bwd_reference(*bwd_args, **kw)
    errs = {}
    for part, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                          (got_out, got_lse) + tuple(got),
                          (want_out, want_lse) + tuple(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, part
        errs[part] = fa.mismatch(g, w)
    return errs, bwd_args


def flash_grad_check(device, B=2, Hq=32, Hkv=8, S=2048, D=64, seed=1):
    """The training path's bf16 attention, flash_attention_with_lse (its
    autograd function runs K1, then delta = rowsum(dO·O) − dlse and K2a,
    K2b), at one 1b_bench layer's head shapes with the batch cut to 2,
    against the plain versions on the same tensors: out, lse and the
    gradients of a loss that reads out and lse, per leaf, under the
    kernels' tolerance."""
    import torch

    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q, k, v = (rand(B, S, h, D).bfloat16().requires_grad_()
               for h in (Hq, Hkv, Hkv))
    w, wl = rand(B, S, Hq, D).bfloat16(), rand(B, Hq, S)
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=True)
    loss = (out.float() * w.float()).sum() + (lse * wl).sum()
    reset_flash_launches()
    got = torch.autograd.grad(loss, (q, k, v))
    torch.cuda.synchronize()
    launches = flash_launches()
    assert launches == {"fwd": 0, "bwd": 1, "dq": 0, "dkv": 0}, launches
    # the plain versions on the same tensors: the forward on q, k, v; the
    # backward also on the card's out and lse, with delta formed here
    qh, kh, vh, dout = (t.detach().transpose(1, 2).contiguous()
                        for t in (q, k, v, w))
    out, lse = out.detach().transpose(1, 2), lse.detach()
    kw = dict(causal=True, scale=D ** -0.5)
    out_r, lse_r = fa.flash_attention_fwd_reference(qh, kh, vh, **kw)
    delta = (dout.float() * out.float()).sum(-1) - wl
    want = fa.flash_attention_bwd_reference(qh, kh, vh, lse, delta, dout,
                                            **kw)
    res = {"out": fa.mismatch(out, out_r), "lse": fa.mismatch(lse, lse_r)}
    for name, g, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w_.dtype and g.shape == w_.transpose(
            1, 2).shape, name
        res[name] = fa.mismatch(g, w_.transpose(1, 2))
    return res


def assert_within(what, errs):
    bad = {part: e for part, e in errs.items() if not e["ok"]}
    assert not bad, f"{what}: outside tolerance: {bad}"


def flash_checks(device, cases=FLASH_CASES, iters=TIMED_ITERS, seed=0):
    """K1 and the backward kernels (bf16: flash_bwd_kernel; f32: K2a and
    K2b) against their plain versions, with the times of kernel, plain
    version and the library yardstick (F.scaled_dot_product_attention
    forward, and the autograd backward through it, timed here only).
    Returns records keyed by case and dtype."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    out = {}
    for name, B, Hq, Hkv, S, D, causal in cases:
        for dt in (torch.bfloat16, torch.float32):
            dname = str(dt).split(".")[1]
            q, k, v, do = flash_inputs(device, dt, B, Hq, Hkv, S, D, seed)
            kw = dict(causal=causal, scale=D ** -0.5)
            errs, bwd_args = flash_compare(q, k, v, do, causal)
            assert_within(f"flash {name} {dname}", errs)

            ql, kl, vl = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lib_kw = dict(is_causal=causal, scale=D ** -0.5, enable_gqa=True)
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, **lib_kw)

            def lib_fwd():
                return F.scaled_dot_product_attention(q, k, v, **lib_kw)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                           retain_graph=True)

            plain_iters = max(2, iters // 4)
            times = {
                "fwd": (time_ms([lambda: fa.flash_attention_fwd(
                            q, k, v, **kw)], iters),
                        time_ms([lambda: fa.flash_attention_fwd_reference(
                            q, k, v, **kw)], plain_iters),
                        time_ms([lib_fwd], iters)),
            }
            if dt == torch.bfloat16:
                # the wrapper's whole call: workspace zeroing, kernel, cast
                times["bwd"] = (
                    time_ms([lambda: fa.bwd_fused(*bwd_args, **kw)], iters),
                    time_ms([lambda: fa.flash_attention_bwd_reference(
                        *bwd_args, **kw)], plain_iters),
                    None)
            else:
                times["dq"] = (
                    time_ms([lambda: fa.bwd_dq(*bwd_args, **kw)], iters),
                    time_ms([lambda: fa.bwd_dq_reference(*bwd_args, **kw)],
                            plain_iters),
                    None)
                times["dkv"] = (
                    time_ms([lambda: fa.bwd_dkv(*bwd_args, **kw)], iters),
                    time_ms([lambda: fa.bwd_dkv_reference(*bwd_args, **kw)],
                            plain_iters),
                    None)
            lib_bwd_ms = time_ms([lib_bwd], iters)
            rec = {"errors": errs, "tolerance": fa.TOLERANCE[dt],
                   "shape": [B, Hq, Hkv, S, D, causal],
                   "library_backend": {"fwd": top_kernel(lib_fwd),
                                       "bwd": top_kernel(lib_bwd)},
                   # one autograd backward gives dq, dk and dv together
                   "library_bwd_ms": lib_bwd_ms}
            for kern, (ms, plain, lib) in times.items():
                b_ms, b_by = flash_bound_ms(kern, B, Hq, Hkv, S, D, causal,
                                            q.element_size(), dname)
                rec[kern] = {"ms": ms, "plain_ms": plain,
                             "library_ms": lib if lib is not None
                             else lib_bwd_ms,
                             "bound_ms": b_ms, "bound_by": b_by}
            out.setdefault(name, {})[dname] = rec
            log(f"  {name:8s} {dname:8s} " + json.dumps(rec))
            del q, k, v, do, ql, kl, vl, lib_out, bwd_args
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- phases 7-8

def flash_launches():
    from ray_tpu_torch.ops import flash_attention as fa

    return {"fwd": fa.flash_attention_fwd.launches,
            **fa.flash_attention_bwd.launches}


def reset_flash_launches():
    from ray_tpu_torch.ops import flash_attention as fa

    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.launches = {"bwd": 0, "dq": 0, "dkv": 0}


def card_equals_cpu(device, init_params, loss_fn, batch, n_layers,
                    steps=5):
    """An f32 model trained ``steps`` steps on the card and on the CPU from
    the same weights (``init_params()`` on the CPU) and numpy ``batch``:
    losses to 1e-4 relative, final parameters to 1e-4 absolute, the CPU's
    loss falling, and K1 and the f32 K2a, K2b each launched once per layer
    per step on the card (no remat)."""
    import torch

    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step, tree_leaves,
                                               tree_map)

    params0 = init_params()
    res = {}
    for dev in (device, torch.device("cpu")):
        opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=2,
                              decay_steps=20).make()
        state = init_train_state(
            lambda g: tree_map(lambda t: t.clone(), params0), opt, None, dev)
        step = make_train_step(loss_fn, opt)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        reset_flash_launches()
        losses = []
        for _ in range(steps):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        res[dev.type] = (losses, [t.detach().cpu() for t in
                                  tree_leaves(state.params)],
                         flash_launches())
    (card, card_p, launches), (cpu, cpu_p, _) = res["cuda"], res["cpu"]
    want = {"fwd": steps * n_layers, "bwd": 0,
            "dq": steps * n_layers, "dkv": steps * n_layers}
    assert launches == want, (launches, want)
    for a, b in zip(card, cpu):
        assert abs(a - b) <= 1e-4 * abs(b), ("losses", card, cpu)
    assert cpu[-1] < cpu[0], cpu
    p_err = max((a - b).abs().max().item() for a, b in zip(card_p, cpu_p))
    assert p_err <= 1e-4, f"params differ by {p_err}"
    return {"steps": steps, "losses_card": card, "losses_cpu": cpu,
            "max_loss_rel_err": max(abs(a - b) / abs(b)
                                    for a, b in zip(card, cpu)),
            "max_param_abs_err": p_err, "launches": launches}


def debug_train_check(device, steps=5, seed=0):
    """The f32 debug Llama, card == CPU (:func:`card_equals_cpu`)."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama

    cfg = llama.CONFIGS["debug"]
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    return card_equals_cpu(
        device, lambda: llama.init_params(
            cfg, torch.Generator().manual_seed(seed), "cpu"),
        lambda p, b: llama.loss_fn(p, b, cfg), {"tokens": tokens},
        cfg.n_layers, steps)


def train_1b_check(device, steps=5):
    """1b_bench at full width and depth through ray_tpu_torch.bench.run:
    finite losses, the last below the warm-up step's, and each flash
    kernel launched exactly as the path needs (K1 twice per layer per
    step, forward and remat recompute; the bf16 backward flash_bwd_kernel
    once; the f32 K2a and K2b never)."""
    import math

    from ray_tpu_torch import bench

    cfg = bench.CONFIGS["1b_bench"]
    reset_flash_launches()
    res = bench.run("1b_bench", batch=8, seq=2048, steps=steps,
                    device=device)
    launches = flash_launches()
    n = steps + 1                                  # warm-up included
    want = {"fwd": 2 * n * cfg.n_layers, "bwd": n * cfg.n_layers, "dq": 0,
            "dkv": 0}
    assert launches == want, (launches, want)
    assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
    assert res["losses"][-1] < res["losses"][0], res["losses"]
    res["launches"] = launches
    return res


# ------------------------------------------------------------- phases 8b-8e

H100_BF16_PEAK = 989e12          # dense bf16 tensor-core FLOP/s (MFU)
# 8x7b depth on one 80 GB card: 4 layers peak at 80.5 of its 85.0 GB
# reserved by the allocator, 3 leave more than 8 GB free (PERF.md §4)
MOE_LAYERS = 3
CUBLAS_KEYS = ("nvjet", "gemm", "cublas", "cutlass", "xmma", "sm90_")


def family_debug_checks(device, steps=5, seed=0):
    """The f32 debug MoE and ViT, card == CPU (:func:`card_equals_cpu`):
    the f32 kernels at the MoE's D=16, causal, group 2, and the ViT's
    D=16, non-causal, S=17."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import moe, vit

    rng = np.random.default_rng(seed)
    mcfg, vcfg = moe.CONFIGS["debug"], vit.CONFIGS["debug"]
    tokens = rng.integers(0, mcfg.base.vocab_size, (4, 64)).astype(np.int32)
    images = rng.random((8, vcfg.image_size, vcfg.image_size,
                         vcfg.channels)).astype(np.float32)
    labels = rng.integers(0, vcfg.num_classes, 8).astype(np.int32)
    return {
        "moe": card_equals_cpu(
            device, lambda: moe.init_params(
                mcfg, torch.Generator().manual_seed(seed), "cpu"),
            lambda p, b: moe.loss_fn(p, b, mcfg), {"tokens": tokens},
            mcfg.base.n_layers, steps),
        "vit": card_equals_cpu(
            device, lambda: vit.init_params(
                vcfg, torch.Generator().manual_seed(seed), "cpu"),
            lambda p, b: vit.loss_fn(p, b, vcfg),
            {"images": images, "labels": labels}, vcfg.n_layers, steps),
    }


def timed_training(device, init_fn, loss_fn, batch, n_layers, steps=6):
    """Train ``steps`` steps of a bf16 model with remat "nothing" through
    ``make_train_step`` (learning rate 0 at the first step, as in
    ``bench.run``), all on ``batch``: finite losses, the last below the
    first, and K1 launched twice per layer per step (forward and
    recompute), ``flash_bwd_kernel`` once, the f32 K2a, K2b never. Step
    time by the host clock over the steps after the first, each ended by a
    synchronize; peak device memory over the run."""
    import math

    import torch

    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    opt = OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(init_fn, opt, gen, device)
    step = make_train_step(loss_fn, opt)
    reset_flash_launches()
    metrics, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = flash_launches()
    want = {"fwd": 2 * steps * n_layers, "bwd": steps * n_layers, "dq": 0,
            "dkv": 0}
    assert launches == want, (launches, want)
    losses = [m["loss"] for m in metrics]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    del state
    step_s = sum(times[1:]) / (steps - 1)
    return {"losses": losses, "metrics": metrics, "launches": launches,
            "step_ms_each": [1e3 * t for t in times],
            "step_ms": 1e3 * step_s,
            "peak_memory_gb": (torch.cuda.max_memory_allocated(device)
                               - held) / 1e9,
            # what the allocator held at most, against the card's memory
            "free_at_peak_gb": (torch.cuda.mem_get_info(device)[1]
                                - torch.cuda.max_memory_reserved(device))
            / 1e9, "steps": steps}, step_s


def train_moe_check(device, layers=MOE_LAYERS, batch=2, seq=2048, steps=6):
    """8x7b at full width (hidden 4096, 32/8 heads of 128, 8 experts of
    14336, top-2, capacity factor 1.25, vocab 128256) and ``layers``
    layers, bf16, remat "nothing", on one seeded (batch, seq) token batch:
    :func:`timed_training`'s checks, the router's aux loss in (0.8, 1.5)
    at the first step, and dropped_frac reported. MFU counts
    ``MoEConfig.flops_per_token(seq)``."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import moe

    full = moe.CONFIGS["8x7b"]
    cfg = dataclasses.replace(full, base=dataclasses.replace(
        full.base, n_layers=layers))
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.base.vocab_size, (batch, seq),
                           generator=gen, device=device, dtype=torch.int32)
    res, step_s = timed_training(
        device, lambda g: moe.init_params(cfg, g, device),
        lambda p, b: moe.loss_fn(p, b, cfg), {"tokens": tokens}, layers,
        steps)
    aux0 = res["metrics"][0]["aux_loss"]
    assert 0.8 < aux0 < 1.5, aux0
    tokens_per_s = batch * seq / step_s
    res.update({
        "layers": layers, "batch": batch, "seq": seq,
        "num_params": cfg.num_params(), "active_params": cfg.active_params(),
        "capacity": cfg.capacity(batch * seq),
        "aux_loss_step0": aux0,
        "dropped_frac": [m["dropped_frac"] for m in res["metrics"]],
        "tokens_per_s": tokens_per_s,
        "mfu": cfg.flops_per_token(seq) * tokens_per_s / H100_BF16_PEAK})
    return res


def train_vit_check(device, batch=256, steps=6):
    """ViT-B/16 at full size (224², patch 16, 12 layers of 768, 12 heads of
    64, mlp 3072, 1000 classes), bf16, remat "nothing", on ``batch``
    seeded images and labels: :func:`timed_training`'s checks. MFU counts
    ``ViTConfig.flops_per_image``."""
    import torch

    from ray_tpu_torch.models import vit

    cfg = vit.CONFIGS["B16"]
    gen = torch.Generator(device=device).manual_seed(2)
    images = torch.rand(batch, cfg.image_size, cfg.image_size, cfg.channels,
                        generator=gen, device=device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=device)
    res, step_s = timed_training(
        device, lambda g: vit.init_params(cfg, g, device),
        lambda p, b: vit.loss_fn(p, b, cfg),
        {"images": images, "labels": labels}, cfg.n_layers, steps)
    images_per_s = batch / step_s
    res.update({"batch": batch, "seq_len": cfg.seq_len,
                "num_params": cfg.num_params(),
                "images_per_s": images_per_s,
                "mfu": cfg.flops_per_image() * images_per_s
                / H100_BF16_PEAK})
    return res


def backward_products(loss_fn, params, batch):
    """One forward, then its backward under torch.profiler: the cuBLAS
    kernels the backward launches. (The profiler's aten::mm count would not
    do: under "dots" the recompute still enters aten::mm, and the
    checkpoint hands back the kept output without a launch.)"""
    import torch

    from ray_tpu_torch.models.training import tree_leaves

    leaves = tree_leaves(params)
    loss, _ = loss_fn(params, batch)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    del grads, loss
    return {"cublas_launches": sum(
        e.count for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        and any(k in e.key for k in CUBLAS_KEYS))}


def remat_dots_check(device, steps=3, batch=8, seq=2048):
    """1b_bench under remat "dots" and "nothing", from the same weights
    and token batch, ``steps`` steps each, and "nothing" again for two
    steps (the floor: bf16 dQ adds in no fixed order, ROADMAP C). Gates:
    the first loss equal bit for bit; the parameters after the second step
    (the first with a learning rate) of "dots" within max(2e-2, 1.5 x the
    floor's) of "nothing"'s, relative to the update's norm; K1 launched
    twice and flash_bwd_kernel once per layer per step under both; fewer
    cuBLAS launches in the backward under "dots". Step ms (the steps after
    the first) and peak memory of each."""
    import dataclasses
    import functools

    import torch

    from ray_tpu_torch import bench
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step, tree_leaves,
                                               tree_map)

    base = bench.CONFIGS["1b_bench"]
    gen = torch.Generator(device=device).manual_seed(3)
    params0 = llama.init_params(base, gen, device)
    tokens = torch.randint(0, base.vocab_size, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    b = {"tokens": tokens}

    def dist(a, c):
        return sum((x.float() - y.float()).square().sum()
                   for x, y in zip(a, c)).sqrt().item()

    p0 = tree_leaves(params0)
    runs = {}
    for name, policy, n in (("nothing", "nothing", steps),
                            ("dots", "dots", steps),
                            ("nothing_again", "nothing", 2)):
        cfg = dataclasses.replace(base, remat_policy=policy)
        opt = OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        state = init_train_state(
            lambda g: tree_map(lambda t: t.clone(), params0), opt, None,
            device)
        loss_fn = functools.partial(llama.loss_fn, config=cfg)
        step = make_train_step(loss_fn, opt)
        reset_flash_launches()
        losses, times = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(m["loss"])
            if i == 1:
                p1 = [x.detach().clone() for x in tree_leaves(state.params)]
        # the run's own peak: what earlier runs left held is taken out
        rec = {"losses": [float(x) for x in losses],
               "launches": flash_launches(), "p1": p1,
               "peak_memory_gb": (torch.cuda.max_memory_allocated(device)
                                  - held) / 1e9,
               "step_ms_each": [1e3 * t for t in times]}
        if name != "nothing_again":
            want = {"fwd": 2 * n * base.n_layers, "bwd": n * base.n_layers,
                    "dq": 0, "dkv": 0}
            assert rec["launches"] == want, (name, rec["launches"], want)
            rec["step_ms"] = 1e3 * sum(times[1:]) / (n - 1)
            rec["backward"] = backward_products(loss_fn, state.params, b)
            rec["loss0_tensor"] = losses[0]
        runs[name] = rec
        del state, step
    nothing, dots, again = runs["nothing"], runs["dots"], runs["nothing_again"]
    assert torch.equal(dots.pop("loss0_tensor"),
                       nothing.pop("loss0_tensor")), "first losses differ"
    update = dist(nothing["p1"], p0)
    rel = dist(dots["p1"], nothing["p1"]) / update
    floor = dist(again["p1"], nothing["p1"]) / update
    for r in runs.values():
        del r["p1"]
    assert rel <= max(2e-2, 1.5 * floor), (rel, floor)
    assert dots["launches"]["fwd"] == nothing["launches"]["fwd"]
    assert dots["backward"]["cublas_launches"] < \
        nothing["backward"]["cublas_launches"], (dots, nothing)
    return {"nothing": nothing, "dots": dots, "nothing_again": again,
            "params_step1_rel_err": rel, "floor_rel_err": floor,
            "update_norm": update, "batch": batch, "seq": seq}


# ------------------------------------------------------------- phase 9
# The runtime: remote functions and actor classes below are plain, made
# remote in runtime_check and shipped to the workers by value (cloudpickle).

DEVICE_OBJECT_BYTES = 1 << 30    # the bf16 tensor phase 9 (d) moves
NOOP_CALLS = 200


def natives_loaded():
    """The runtime's C natives in this process. Each loader returns None
    where its build failed, and the runtime then takes its Python paths
    without a word, so phase 9 asserts them in the driver and in a GPU
    actor."""
    from ray_tpu_torch.object_store import shm
    from ray_tpu_torch.rpc import native

    return {"fastspec": native.load_fastspec() is not None,
            "fastloop": native.load_fastloop() is not None,
            "shm_store": shm._load() is not None}


def k4_in_worker(seed=0, B=8, H=32, KV=8, D=128, S=2048):
    """A num_gpus=1 task: its grant, and K4 against its plain version on
    CUDA tensors made here, at phase 3's shape and lengths."""
    import torch

    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    count = torch.cuda.device_count()
    if count != 1:
        raise RuntimeError(f"a num_gpus=1 worker sees {count} GPUs "
                           f"(CUDA_VISIBLE_DEVICES={visible!r})")
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=gen, device=device)
    k, v = (torch.randn(B, S, KV, D, generator=gen, device=device)
            for _ in range(2))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    lens = torch.tensor(([1, 64, 127, 128, 129, S, 777, 0] * B)[:B],
                        dtype=torch.int32, device=device)
    decode_attention.launches = 0
    got = decode_attention(q, k, v, lens, scale=D ** -0.5)
    launches = decode_attention.launches
    want = decode_attention_reference(q, k, v, lens, scale=D ** -0.5)
    err = (got.float() - want.float()).abs().max().item()
    return {"visible": visible, "device_count": count,
            "device": torch.cuda.get_device_name(0), "launches": launches,
            "max_abs_err": err, "excess": err / TOL["bfloat16"],
            "built_here": sorted(_build.LOGS)}


class EngineHost:
    """An actor hosting LLMEngine on its own GPU: the weights are seeded
    here (phase 5's seed), so none cross the object store."""

    def __init__(self, model, seed, **engine_kw):
        import torch

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.llm import LLMEngine

        device = resolve_device(None)   # raises where no GPU is visible
        self.cfg = llama.CONFIGS[model]
        params = llama.init_params(
            self.cfg, torch.Generator(device=device).manual_seed(seed),
            device)
        self.eng = LLMEngine(self.cfg, params, device=None, **engine_kw)
        # timed as phase 5's serve_check times its engine
        self.decode_s, self.prefill_s, self.finite = [], [], []
        self.eng._decode = watch(self.eng._decode, self.decode_s, self.finite)
        self.eng._prefill = watch(self.eng._prefill, self.prefill_s,
                                  self.finite)

    def grant(self):
        import torch

        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.device_count())

    def natives(self):
        return natives_loaded()

    def reset_counts(self):
        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        paged_decode_attention.launches = 0
        decode_attention.launches = 0
        self._steps0 = self.eng.stats()["steps"]
        for times in (self.decode_s, self.prefill_s, self.finite):
            times.clear()

    def counts(self):
        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        return {"launches": {
            "paged_decode_attention": paged_decode_attention.launches,
            "decode_attention": decode_attention.launches},
            "decode_steps": self.eng.stats()["steps"] - self._steps0,
            "n_layers": self.cfg.n_layers,
            "decode_step_ms_mean": mean_ms(self.decode_s),
            "prefill_ms_mean": mean_ms(self.prefill_s),
            "finite": bool(self.finite) and all(self.finite)}

    def generate(self, prompt, max_tokens):
        return self.eng.generate(prompt, max_tokens=max_tokens,
                                 timeout_s=600)

    def noop(self):
        return None

    def shutdown(self):
        self.eng.shutdown()


class TensorProducer:
    """Puts a seeded bf16 CUDA tensor as a device object, and notes where
    its memory store keeps each large value it stores (the host copy a
    consumer pulls in chunks): the node's shm arena, the heap, or the
    spill directory."""

    def put(self, nbytes, seed):
        import torch

        import ray_tpu_torch as rt
        from ray_tpu_torch.core_worker.worker import CoreWorker

        store = CoreWorker.current_or_raise().memory_store
        self.stored, put = [], store.put

        def put_and_note(object_id, *args, **kw):
            put(object_id, *args, **kw)
            e = store._entries.get(object_id)
            if e is not None and e.size >= 1 << 20:
                self.stored.append({
                    "bytes": e.size, "shm": e.shm_backed,
                    "spilled": e.spilled_path is not None})

        store.put = put_and_note
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.t = torch.randn(nbytes // 2, generator=gen, device="cuda",
                             dtype=torch.bfloat16)
        ref = rt.put(self.t, _tensor_transport="device")
        same = rt.get(ref, timeout=60).data_ptr() == self.t.data_ptr()
        stats = CoreWorker.current_or_raise().device_store.stats()
        return [ref], same, stats

    def staging(self):
        return self.stored


class TensorConsumer:
    """Gets a producer's device object and holds it to the same seed."""

    def get(self, refs, nbytes, seed):
        import torch

        import ray_tpu_torch as rt

        torch.cuda.synchronize()
        t = time.perf_counter()
        got = rt.get(refs[0], timeout=600)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        gen = torch.Generator(device="cuda").manual_seed(seed)
        want = torch.randn(nbytes // 2, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        return {"device": str(got.device), "dtype": str(got.dtype),
                "bit_equal": torch.equal(got.view(torch.int16),
                                         want.view(torch.int16)),
                "seconds": secs, "gb_per_s": nbytes / secs / 1e9}


def _available_gpu(rt, expect, within=60.0):
    deadline = time.monotonic() + within
    while True:
        got = rt.available_resources().get("GPU", 0.0)
        if got == expect or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _session_processes(session_dir):
    """Live processes (zombies excluded) of a runtime session: the worker
    factory and its forks name the session's socket on their command line,
    exec-spawned workers carry RT_SESSION_DIR."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = f.read()
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state != "Z" and (session_dir.encode() in cmd or
                             b"RT_SESSION_DIR=" + session_dir.encode()
                             in env):
            found.append(int(pid))
    return found


def runtime_check(prompts, max_tokens, want_outputs, in_process):
    """Phase 9: the runtime on the card. (a) init() finds the GPU with no
    CUDA in the worker factory; (b) a num_gpus=1 task runs K4; (c) a
    num_gpus=1 actor serves phase 5's prompts at 8b through actor calls,
    its greedy tokens ``want_outputs`` and its rates reported beside
    ``in_process`` (phase 5's paged tokens/s and step times); (d) a 1 GiB
    bf16 device object crosses two num_gpus=0.5 actors; (e) the GPU comes
    back and shutdown() leaves no worker of the session."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api
    from ray_tpu_torch.core_worker.worker import CoreWorker

    out = {}
    t = time.perf_counter()
    rt.init()
    out["init_s"] = time.perf_counter() - t
    raylet, session = api._head["raylet"], api._head["session_dir"]
    try:
        out["natives_driver"] = natives_loaded()
        assert all(out["natives_driver"].values()), out["natives_driver"]
        # (a)
        total = rt.cluster_resources()
        out["cluster_resources"] = total
        assert total.get("GPU") == 1, total
        deadline = time.monotonic() + 60
        while raylet._factory is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert raylet._factory is not None, "the worker factory never came up"
        cuda_in_factory = []
        for proc in raylet._factory_procs:
            with open(f"/proc/{proc.pid}/maps") as f:
                cuda_in_factory.append("libcuda" in f.read())
        out["cuda_in_factory"] = cuda_in_factory
        assert not any(cuda_in_factory), "the worker factory loaded CUDA"

        # (b)
        task = rt.remote(num_gpus=1)(k4_in_worker)
        out["k4_task"] = rec = rt.get(task.remote(), timeout=600)
        log("[9] num_gpus=1 task: " + json.dumps(rec))
        assert rec["visible"] == "0" and rec["device_count"] == 1, rec
        assert rec["launches"] == 1 and rec["excess"] <= 1.0, rec
        assert rec["built_here"] == [], rec

        # (c)
        Host = rt.remote(num_gpus=1, max_concurrency=len(prompts) + 2)(
            EngineHost)
        t = time.perf_counter()
        host = Host.remote("8b", 0, num_slots=4, max_seq=2048,
                           kv_cache="paged", kv_block_size=64)
        out["actor_grant"] = list(rt.get(host.grant.remote(), timeout=900))
        out["actor_start_s"] = time.perf_counter() - t
        assert out["actor_grant"] == ["0", 1], out["actor_grant"]
        out["natives_actor"] = rt.get(host.natives.remote(), timeout=60)
        assert all(out["natives_actor"].values()), out["natives_actor"]
        out["gpu_available_while_held"] = _available_gpu(rt, 0.0)
        assert out["gpu_available_while_held"] == 0.0, out
        # the actor's cold first request, reported on its own: phase 5's
        # engine runs in a process whose CUDA libraries earlier phases
        # loaded, the actor's does not
        t = time.perf_counter()
        rt.get(host.generate.remote(prompts[0][:8], 4), timeout=600)
        out["actor_first_request_s"] = time.perf_counter() - t
        rt.get(host.reset_counts.remote(), timeout=60)
        t = time.perf_counter()
        outs = rt.get([host.generate.remote(p, max_tokens)
                       for p in prompts], timeout=900)
        wall = time.perf_counter() - t
        counts = rt.get(host.counts.remote(), timeout=60)
        tokens = sum(len(o) for o in outs)
        out["serve"] = {"tokens": tokens, "wall_s": wall,
                        "tokens_per_s": tokens / wall,
                        "in_process": in_process, **counts,
                        "equal_to_phase_5": outs == want_outputs}
        assert counts["finite"], "non-finite logits in the actor"
        assert outs == want_outputs, [first_divergence(a, b) for a, b in
                                      zip(outs, want_outputs)]
        want = counts["decode_steps"] * counts["n_layers"]
        assert counts["launches"]["paged_decode_attention"] == want, counts
        assert counts["launches"]["decode_attention"] == 0, counts
        # count the no-op calls that ride the native fastloop channel
        sub = CoreWorker.current_or_raise()._actor_submitter(host._actor_id)
        fast, try_fast = [0], sub._try_fast

        def counted(spec):
            ok = try_fast(spec)
            fast[0] += ok
            return ok

        sub._try_fast = counted
        rts = []
        try:
            for _ in range(NOOP_CALLS):
                t = time.perf_counter()
                rt.get(host.noop.remote(), timeout=60)
                rts.append(time.perf_counter() - t)
        finally:
            sub._try_fast = try_fast
        rts.sort()
        out["noop_round_trip_ms"] = {"p50": 1e3 * rts[len(rts) // 2],
                                     "p99": 1e3 * rts[int(len(rts) * 0.99)],
                                     "calls": NOOP_CALLS,
                                     "over_fastloop": fast[0]}
        log("[9] 8b actor: " + json.dumps({k: out[k] for k in (
            "actor_grant", "natives_driver", "natives_actor",
            "actor_start_s", "gpu_available_while_held",
            "actor_first_request_s", "serve", "noop_round_trip_ms")}))
        rt.get(host.shutdown.remote(), timeout=120)
        rt.kill(host)
        assert _available_gpu(rt, 1.0) == 1.0, "the 8b actor's GPU"

        # (d)
        producer = rt.remote(num_gpus=0.5)(TensorProducer).remote()
        consumer = rt.remote(num_gpus=0.5)(TensorConsumer).remote()
        refs, same, stats = rt.get(producer.put.remote(
            DEVICE_OBJECT_BYTES, 7), timeout=600)
        got = rt.get(consumer.get.remote(refs, DEVICE_OBJECT_BYTES, 7),
                     timeout=900)
        out["device_object"] = {"bytes": DEVICE_OBJECT_BYTES,
                                "same_tensor_in_producer": same,
                                "producer_stats": stats, **got,
                                "staged": rt.get(producer.staging.remote(),
                                                 timeout=60)}
        log("[9] device object: " + json.dumps(out["device_object"]))
        assert same, "get in the producer is not the same tensor"
        assert stats["device_bytes"] == DEVICE_OBJECT_BYTES, stats
        assert got["bit_equal"] and got["device"].startswith("cuda"), got
        del refs

        # (e)
        rt.kill(producer)
        rt.kill(consumer)
        out["gpu_after_kills"] = _available_gpu(rt, 1.0)
        assert out["gpu_after_kills"] == 1.0, out["gpu_after_kills"]
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _session_processes(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["left_after_shutdown"] = _session_processes(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


# ------------------------------------------------------------- phase 10

SERVE_ENGINE_KW = dict(kv_cache="paged", num_slots=4, max_seq=2048,
                       kv_block_size=64)   # phase 5's paged engine


class _LaunchCounts:
    """Mixed into a served class whose engine is ``self.engine``: the
    decode kernels' launch counts in the replica's own process, read
    around a run (reset_counts, then counts)."""

    def reset_counts(self):
        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        paged_decode_attention.launches = 0
        decode_attention.launches = 0
        self._steps0 = self.engine.stats()["steps"]

    def counts(self):
        import torch

        from ray_tpu_torch.ops.decode_attention import decode_attention
        from ray_tpu_torch.ops.paged_decode_attention import \
            paged_decode_attention

        return {"launches": {
            "paged_decode_attention": paged_decode_attention.launches,
            "decode_attention": decode_attention.launches},
            "decode_steps": self.engine.stats()["steps"] - self._steps0,
            "n_layers": self.engine.config.n_layers,
            "grant": [os.environ.get("CUDA_VISIBLE_DEVICES"),
                      torch.cuda.device_count()],
            "device": str(self.engine.device)}


def _counted(cls, counts=None):
    """``cls`` with the launch counters (``counts``, by default the decode
    kernels'); made here, in ``__main__``, so the replica or stage gets it
    by value."""
    return type(cls.__name__, (counts or _LaunchCounts, cls), {})


def _http(url, body, headers=None, timeout=600):
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read()


def _sse(url, body, timeout=600):
    """One streamed request, read event by event as it arrives: its
    tokens, SSE data events, seconds to the first event and in all."""
    import urllib.request

    t = time.perf_counter()
    req = urllib.request.Request(url, data=body,
                                 headers={"accept": "text/event-stream"})
    tokens, events, first, error = [], 0, None, False
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200, resp.status
        for line in resp:
            line = line.strip()
            if line == b"event: error":
                error = True
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if error:
                raise RuntimeError(f"SSE error event: {data!r}")
            if data == b"[DONE]":
                break
            if first is None:
                first = time.perf_counter() - t
            events += 1
            tokens.append(json.loads(data))
    return tokens, events, first, time.perf_counter() - t


def _concurrently(fn, args):
    import concurrent.futures

    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(args)) as pool:
        out = list(pool.map(fn, args))
    return out, time.perf_counter() - t


def serve_library_check(prompts, max_tokens, want_outputs, rates,
                        model="8b", pd_prompt=1):
    """Phase 10: Serve on the card, through the user's entry points:
    ``serve.start`` and ``serve.run(llm_app(model, num_gpus=1 replica,
    phase 5's paged engine))``. (a) ``prompts`` as concurrent HTTP POSTs
    with JSON bodies: greedy tokens equal ``want_outputs`` (phase 5's);
    (b) the same as SSE streams: tokens equal (a)'s, one data event a
    token, TTFT and tokens/s at the client; (c) one call through
    ``get_deployment_handle``; K3 counted in the replica's process around
    (a)-(c); (d) ``build_pd_app`` with both fleets on half a GPU each:
    ``prompts[pd_prompt]``'s tokens equal phase 5's, prefill ms, KV
    handoff ms and bytes, K3 counted in the decode replica. ``rates``
    are phase 5's and phase 9's readings, reported beside."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api, serve
    from ray_tpu_torch.serve import llm_pd
    from ray_tpu_torch.serve.api import llm_app
    from ray_tpu_torch.serve.llm import LLMServer

    out = {}
    rt.init()
    session = api._head["session_dir"]
    try:
        addr = serve.start(http_port=0, grpc_port=None)
        url = f"http://{addr['http_host']}:{addr['http_port']}/llm"
        app = llm_app(model, ray_actor_options={"num_gpus": 1},
                      **SERVE_ENGINE_KW)
        # the same Application with the launch counters mixed in
        app.deployment = app.deployment.options(
            func_or_class=_counted(LLMServer))
        t = time.perf_counter()
        handle = serve.run(app, name="llm")
        status, body = _http(url, json.dumps(
            {"prompt": prompts[0][:8], "max_tokens": 4}).encode())
        assert status == 200 and len(json.loads(body)) == 4, (status, body)
        out["replica_ready_s"] = time.perf_counter() - t
        counter = handle.options(method_name="reset_counts")
        rt.get(counter.remote(), timeout=60)

        # (a) whole responses
        bodies = [json.dumps({"prompt": p, "max_tokens": max_tokens})
                  .encode() for p in prompts]
        replies, wall = _concurrently(lambda b: _http(url, b), bodies)
        assert all(s == 200 for s, _ in replies), [s for s, _ in replies]
        whole = [json.loads(b) for _, b in replies]
        tokens = sum(len(o) for o in whole)
        out["whole"] = {"requests": len(prompts), "tokens": tokens,
                        "wall_s": wall, "tokens_per_s": tokens / wall,
                        "equal_to_phase_5": whole == want_outputs, **rates}
        log("[10] (a) whole responses: " + json.dumps(out["whole"]))
        assert whole == want_outputs, [first_divergence(a, b) for a, b in
                                       zip(whole, want_outputs)]

        # (b) SSE streams
        streams, wall = _concurrently(lambda b: _sse(url, b), bodies)
        streamed = [s[0] for s in streams]
        tokens = sum(len(o) for o in streamed)
        ttft = sorted(s[2] for s in streams)
        proxy = rt.get(rt.get_actor("SERVE_PROXY").debug_state.remote(),
                       timeout=60)
        out["stream"] = {"requests": len(prompts), "tokens": tokens,
                         "events": sum(s[1] for s in streams),
                         "wall_s": wall, "tokens_per_s": tokens / wall,
                         "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
                         "ttft_max_ms": 1e3 * ttft[-1],
                         "protocols": proxy["stream_protocols"],
                         "equal_to_whole": streamed == whole, **rates}
        log("[10] (b) SSE streams: " + json.dumps(out["stream"]))
        assert streamed == whole, [first_divergence(a, b) for a, b in
                                   zip(streamed, whole)]
        assert out["stream"]["events"] == tokens, out["stream"]
        assert proxy["stream_protocols"].get("generator") == len(prompts), \
            proxy["stream_protocols"]

        # (c) a handle
        t = time.perf_counter()
        got = rt.get(serve.get_deployment_handle("llm").remote(
            prompts[0], max_tokens=max_tokens), timeout=600)
        out["handle"] = {"seconds": time.perf_counter() - t,
                         "equal_to_phase_5": got == want_outputs[0]}
        assert got == want_outputs[0], first_divergence(got,
                                                        want_outputs[0])
        counts = rt.get(handle.options(method_name="counts").remote(),
                        timeout=60)
        out["replica"] = counts
        out["proxy_stages"] = proxy["stages"]
        log("[10] (c) handle: " + json.dumps(out["handle"])
            + "; replica: " + json.dumps(counts)
            + "; proxy stages: " + json.dumps(proxy["stages"]))
        assert counts["grant"] == ["0", 1], counts
        want = counts["decode_steps"] * counts["n_layers"]
        assert counts["launches"]["paged_decode_attention"] == want > 0, \
            counts
        assert counts["launches"]["decode_attention"] == 0, counts
        serve.delete("llm")
        assert _available_gpu(rt, 1.0) == 1.0, "the replica's GPU"

        # (d) the PD app, both fleets on half of the one GPU; its decode
        # replicas get the launch counters (build_pd_app reads the module's
        # DecodeServer when it is called)
        t = time.perf_counter()
        base = llm_pd.DecodeServer
        llm_pd.DecodeServer = _counted(base)
        try:
            pd = llm_pd.build_pd_app(
                model, name="pd", num_slots=4, max_seq=2048,
                ray_actor_options={"num_gpus": 0.5})
        finally:
            llm_pd.DecodeServer = base
        prefill = serve.get_deployment_handle("pd-prefill")
        decode = serve.get_deployment_handle("pd-decode")
        # both replicas up: a first request of its own, timed apart
        first = rt.get(pd.remote(prompts[0][:8], max_tokens=4), timeout=900)
        assert len(first) == 4, first
        out["pd_ready_s"] = time.perf_counter() - t
        rt.get(decode.options(method_name="reset_counts").remote(),
               timeout=60)
        t = time.perf_counter()
        got = rt.get(pd.remote(prompts[pd_prompt], max_tokens=max_tokens),
                     timeout=600)
        wall = time.perf_counter() - t
        pf = rt.get(prefill.options(method_name="stats").remote(),
                    timeout=60)["prefills"]
        dc_stats = rt.get(decode.options(method_name="stats").remote(),
                          timeout=60)
        counts = rt.get(decode.options(method_name="counts").remote(),
                        timeout=60)
        out["pd"] = {"model": model, "prompt_tokens": len(prompts[pd_prompt]),
                     "tokens": len(got), "wall_s": wall,
                     "prefill_ms": pf[-1]["ms"],
                     "kv_bytes": pf[-1]["kv_bytes"],
                     "kv_handoff_ms": dc_stats["kv_handoff_ms"][-1],
                     "prefill_wait_ms": dc_stats["prefill_wait_ms"][-1],
                     "kv_handoff_gb_s": pf[-1]["kv_bytes"] / 1e6
                     / dc_stats["kv_handoff_ms"][-1],
                     "prefills": len(pf),
                     "handoffs": len(dc_stats["kv_handoff_ms"]),
                     "decode_replica": counts,
                     "equal_to_phase_5": got == want_outputs[pd_prompt]}
        log("[10] (d) PD app: " + json.dumps(out["pd"]))
        assert got == want_outputs[pd_prompt], first_divergence(
            got, want_outputs[pd_prompt])
        # one prefill and one handoff a request (the warm-up's and this)
        assert out["pd"]["prefills"] == out["pd"]["handoffs"] == 2, out["pd"]
        assert counts["grant"] == ["0", 1], counts
        want = counts["decode_steps"] * counts["n_layers"]
        assert counts["launches"]["paged_decode_attention"] == want > 0, \
            counts
        for name in ("pd", "pd-prefill", "pd-decode"):
            serve.delete(name)
        assert _available_gpu(rt, 1.0) == 1.0, "the PD replicas' GPU"
    finally:
        serve.shutdown()
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _session_processes(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["left_after_shutdown"] = _session_processes(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


# ------------------------------------------------------------- phase 11
# Compiled graphs: stage classes below are made remote by the graph API and
# shipped to the stage processes by value (cloudpickle).

PIPE_LAYERS = 4          # the 8b pipeline's depth: 2 layers a stage
PIPE_SEQ = 256
PIPE_MICROBATCHES = 8
ACTIVATION_SHAPE = (1, PIPE_SEQ, 4096)   # 8b's hidden state between stages
HOP_ITERS = {"activation": 20, "logits": 5}


def hop_op(name, x):
    """The known op of a phase 11 (a) stage."""
    import torch

    if name == "tanh3":
        return torch.tanh(x) * 3
    return x * x - 1


class HopStage:
    """A stage of phase 11 (a): one elementwise op on its own GPU."""

    def __init__(self, name):
        self.name = name

    def run(self, x):
        return hop_op(self.name, x)


class _StageCounts:
    """Mixed into the pipeline's stage class (phase 11 (b), (c)): K1
    launches and calls of the plain forward counted in the stage's own
    process, read around a run (reset_counts, then counts, through the
    stage harness's ``call``), and the wall-clock times of the stage's
    start: its process, its __init__'s entry (the shard is in the process
    by then) and end (the shard is on the card)."""

    def __init__(self, *args, **kwargs):
        self._wall = {"process": _process_start_wall(),
                      "init_enter": time.time()}
        super().__init__(*args, **kwargs)
        self._wall["init_done"] = time.time()

    def reset_counts(self):
        from ray_tpu_torch.ops import flash_attention as fa

        if not hasattr(self, "_plain"):
            plain, count = fa.flash_attention_fwd_reference, [0]

            def counted(*args, **kw):
                count[0] += 1
                return plain(*args, **kw)

            fa.flash_attention_fwd_reference = counted
            self._plain = count
        self._plain[0] = 0
        self._items = 0
        fa.flash_attention_fwd.launches = 0

    def forward(self, x):
        self._items = getattr(self, "_items", 0) + 1
        return super().forward(x)

    def counts(self):
        import torch

        from ray_tpu_torch.ops import flash_attention as fa

        return {"k1": fa.flash_attention_fwd.launches,
                "plain_attention": self._plain[0],
                "microbatches": self._items,
                "layers": next(iter(self._params["layers"].values()))
                .shape[0],
                "pid": os.getpid(),
                "grant": [os.environ.get("CUDA_VISIBLE_DEVICES"),
                          torch.cuda.device_count()],
                "device": str(self.device), "wall": self._wall}


def _process_start_wall():
    """This process's start, in wall-clock seconds (Linux: its start in
    clock ticks after boot, /proc/self/stat field 22, plus the boot time
    of /proc/stat, which has a resolution of one second)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def hop_check(rt, device, seed=11):
    """Phase 11 (a): a channel-compiled DAG of two num_gpus=0.5 HopStage
    actors over device channels carries the 8b activation (bf16) and a
    tensor of the 8b logits' size (f32) through both ops: the driver gets
    a CUDA tensor of the input's dtype, bit-equal to the ops run here. One
    hop (driver to stage, stage to stage, stage to driver: three a
    round trip) in ms and GB/s, from sequential round trips."""
    import torch

    from ray_tpu_torch.graph import InputNode

    Hop = rt.remote(HopStage).options(num_gpus=0.5)
    with InputNode() as inp:
        dag = Hop.bind("sq").run.bind(Hop.bind("tanh3").run.bind(inp))
    cap = PIPE_SEQ * 128256 * 4 + (1 << 20)
    t = time.perf_counter()
    compiled = dag.experimental_compile(channels=True, channel_kind="device",
                                        channel_capacity=cap)
    out = {"channel_capacity": cap}
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        for name, shape, dt in (
                ("activation", ACTIVATION_SHAPE, torch.bfloat16),
                ("logits", (1, PIPE_SEQ, 128256), torch.float32)):
            x = torch.randn(*shape, generator=gen, device=device).to(dt)
            got = compiled.execute(x).get(timeout_s=600)
            if name == "activation":
                out["ready_s"] = time.perf_counter() - t
            want = hop_op("sq", hop_op("tanh3", x))
            torch.cuda.synchronize()
            rec = {"shape": list(shape), "dtype": str(dt).split(".")[1],
                   "bytes": x.numel() * x.element_size(),
                   "got_device": str(got.device),
                   "got_dtype": str(got.dtype).split(".")[1],
                   "bit_equal": got.dtype == dt and torch.equal(got, want)}
            secs = []
            for _ in range(HOP_ITERS[name]):
                t0 = time.perf_counter()
                compiled.execute(x).get(timeout_s=600)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            secs.sort()
            hop = secs[len(secs) // 2] / 3
            rec.update({"round_trips": len(secs),
                        "round_trip_ms_p50": 1e3 * 3 * hop,
                        "hop_ms": 1e3 * hop,
                        "hop_gb_per_s": rec["bytes"] / hop / 1e9})
            out[name] = rec
            log(f"[11] (a) device channel, {name}: " + json.dumps(rec))
            assert rec["bit_equal"] and got.is_cuda, rec
            del x, got, want
    finally:
        compiled.teardown()
    return out


def pipeline_check(rt, params4, cfg4, device, seed=12):
    """Phase 11 (b)-(d) on the 8b weights cut to PIPE_LAYERS layers:
    build_llama_pipeline into two num_gpus=0.5 stages over device
    channels; (b) one microbatch's logits against the driver's own
    forward; (c) PIPE_MICROBATCHES microbatches in flight, then one at a
    time, each equal to its single run; K1 counted in each stage's
    process around (b) and (c); (d) a stage that raises, teardown."""
    import numpy as np
    import torch

    from ray_tpu_torch.graph.compiled import PipelineStageError
    from ray_tpu_torch.models import llama, pipeline

    out = {}
    logits_bytes = PIPE_SEQ * cfg4.vocab_size * 4
    cap = logits_bytes + (1 << 20)
    base = pipeline.LlamaPipelineStage
    pipeline.LlamaPipelineStage = _counted(base, _StageCounts)
    wall0 = time.time()
    t = time.perf_counter()
    try:
        dag = pipeline.build_llama_pipeline(
            cfg4, params4, 2, channel_kind="device", channel_capacity=cap,
            stage_options={"num_gpus": 0.5, "max_concurrency": 2})
    finally:
        pipeline.LlamaPipelineStage = base
    out["build_s"] = time.perf_counter() - t
    out["channel_capacity"] = cap
    try:
        stages = dag._owned_actors
        rng = np.random.default_rng(seed)
        batches = [torch.from_numpy(rng.integers(
            0, cfg4.vocab_size, (1, PIPE_SEQ)).astype(np.int64))
            for _ in range(PIPE_MICROBATCHES + 1)]
        gpu = {k: ({n: w.to(device) for n, w in v.items()}
                   if k == "layers" else v.to(device))
               for k, v in params4.items()}
        # the driver's own forward of the same weights
        with torch.inference_mode():
            want = llama.forward(gpu, batches[0].to(device), cfg4)
        del gpu
        torch.cuda.empty_cache()
        out["driver_forward_done_s"] = time.perf_counter() - t
        # (b): the stages come up (each maps its shard from the object
        # store), then the counts go to 0 just before the main path
        rt.get([h.call.remote("reset_counts") for h in stages], timeout=1800)
        out["ready_s"] = time.perf_counter() - t
        log(f"[11] (b) build_llama_pipeline returned in {out['build_s']:.2f}"
            f" s, its stages ready in {out['ready_s']:.2f} s")
        got = dag.execute(batches[0]).get(timeout_s=600)
        torch.cuda.synchronize()
        excess = row_excess(got, want)
        out["logits"] = {
            "shape": list(got.shape), "dtype": str(got.dtype).split(".")[1],
            "device": str(got.device),
            "finite": bool(torch.isfinite(got).all()),
            "row_excess": excess, "row_rtol": KV_ROW_RTOL,
            "max_abs_err": (got - want).abs().max().item(),
            "argmax_equal": bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))),
            "bit_equal": bool(torch.equal(got, want))}
        log("[11] (b) 8b pipeline logits vs the driver's forward: "
            + json.dumps(out["logits"]))
        assert out["logits"]["shape"] == [1, PIPE_SEQ, cfg4.vocab_size]
        assert got.is_cuda and out["logits"]["finite"], out["logits"]
        assert excess <= 1.0 and out["logits"]["argmax_equal"], out["logits"]
        del got, want

        # (c): in flight, then one at a time
        mbs = batches[1:]
        t0 = time.perf_counter()
        futs = [dag.execute(b) for b in mbs]
        flight = [f.get(timeout_s=600) for f in futs]
        torch.cuda.synchronize()
        flight_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = []
        for b in mbs:
            single.append(dag.execute(b).get(timeout_s=600))
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        out["pipelining"] = {
            "microbatches": len(mbs),
            "in_flight_s": flight_s, "one_at_a_time_s": single_s,
            "in_flight_per_s": len(mbs) / flight_s,
            "one_at_a_time_per_s": len(mbs) / single_s,
            "equal_to_single_run": [bool(torch.equal(a, b))
                                    for a, b in zip(flight, single)]}
        log("[11] (c) pipelining: " + json.dumps(out["pipelining"]))
        assert all(out["pipelining"]["equal_to_single_run"]), \
            out["pipelining"]
        del flight, single
        counts = rt.get([h.call.remote("counts") for h in stages],
                        timeout=60)
        for c in counts:
            # seconds after the build began: the stage's process started,
            # entered its __init__ with its shard, had it on the card
            c["start_s"] = {k: v - wall0 for k, v in c.pop("wall").items()}
        out["stages"] = counts
        log("[11] (b)-(c) stages: " + json.dumps(counts))
        items = 1 + 2 * len(mbs)
        for c in counts:
            assert c["grant"] == ["0", 1] and c["pid"] != os.getpid(), c
            assert c["microbatches"] == items, (c, items)
            assert c["k1"] == c["layers"] * items > 0, c
            assert c["plain_attention"] == 0, c
        assert sum(c["layers"] for c in counts) == cfg4.n_layers, counts

        # (d): a stage that raises comes back typed within its deadline
        t0 = time.perf_counter()
        try:
            dag.execute("not tokens").get(timeout_s=60)
            raised = None
        except PipelineStageError as e:
            raised = type(e).__name__
        out["stage_error"] = {"raised": raised,
                              "seconds": time.perf_counter() - t0}
        log("[11] (d) stage error: " + json.dumps(out["stage_error"]))
        assert raised == "PipelineStageError", out["stage_error"]
        assert out["stage_error"]["seconds"] < 60, out["stage_error"]
    finally:
        dag.teardown()
    out["gpu_after_teardown"] = _available_gpu(rt, 1.0)
    assert out["gpu_after_teardown"] == 1.0, out["gpu_after_teardown"]
    return out


def graph_check(params4, cfg4, device):
    """Phase 11: compiled graphs on the card under a fresh init(): (a) the
    device channel between two half-GPU actors, (b)-(d) the 8b pipeline;
    after shutdown() no process of the session is left."""
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import api

    out = {"dev_shm_free_bytes": shutil.disk_usage("/dev/shm").free}
    log(f"[11] /dev/shm free: {out['dev_shm_free_bytes']} bytes")
    # build_llama_pipeline puts each stage's shard into the object store
    # and creates the stage with the reference: an arena that holds both
    # shards lets each stage map its own, where the default 512 MiB would
    # send it in 5 MiB chunk RPCs
    out["stage_weight_bytes"] = sum(
        w.numel() * w.element_size()
        for v in params4.values()
        for w in (v.values() if isinstance(v, dict) else [v]))
    out["shm_store_bytes"] = 2 * out["stage_weight_bytes"]
    assert out["dev_shm_free_bytes"] > out["shm_store_bytes"] + (1 << 30), out
    log(f"[11] stage weights {out['stage_weight_bytes']} bytes, object "
        f"store {out['shm_store_bytes']} bytes")
    rt.init(system_config={"shm_store_bytes": out["shm_store_bytes"]})
    session = api._head["session_dir"]
    try:
        out["hop"] = hop_check(rt, device)
        out["gpu_after_hop_teardown"] = _available_gpu(rt, 1.0)
        assert out["gpu_after_hop_teardown"] == 1.0, out
        out["pipeline"] = pipeline_check(rt, params4, cfg4, device)
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _session_processes(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["left_after_shutdown"] = _session_processes(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


# ------------------------------------------------------------- phase 12
# Train: train_1b_worker is made remote by the trainer and shipped to the
# worker by value (cloudpickle); it writes one JSON line per event into
# the run's storage, which this script reads after fit().

TRAIN_STEPS = 6          # steps of the gang's run (phase 8's count)
CKPT_EVERY = 2           # a checkpoint after every second step
FAIL_AFTER = 5           # the first attempt raises after reporting this step
SP_STEPS = 3             # steps of the sp_axis run: the first two take
                         # the weights as built (the first step's learning
                         # rate is 0), the third those after an update
# (b)'s losses and gradient norms of the weights as built (steps 1-2)
# against (a)'s: the same forward, and gradients apart only by the bf16
# backward's order of dQ adds
SP_RTOL = 1e-3
# A loss read after an update, against another run's at the same step. The
# bf16 backward adds dQ in no fixed order, and Adam's first update is about
# lr * sign(g), so a gradient element near zero may flip: step 3's loss
# differed by up to 8.8e-4 relative between runs in this PR's chip calls,
# and the training run amplifies it further, to 6.8e-3 at step 6 (PERF.md,
# PR 13). (a) is held to phase 8 over its first PHASE8_STEPS steps (steps
# 3-4 read the sharded step's first updates), steps 5-6 are reported; (b)'s
# third step is held to (a)'s. The first update moves the loss by about 40%,
# so a dropped or misdirected gradient of a large leaf still fails.
PHASE8_STEPS = 4
UPDATED_RTOL = 5e-3


def _tree_fingerprint(tree):
    """The sha256 of a tree's bits, in key order: every leaf's name, dtype,
    shape and local shard's bytes (a permuted or compensating restore
    gives another digest)."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
            return
        t = node.to_local() if hasattr(node, "to_local") else node
        t = t.detach().contiguous().reshape(-1)
        h.update(f"{prefix}:{t.dtype}:{tuple(node.shape)};".encode())
        b = t.view(torch.uint8)
        for i in range(0, b.numel(), 1 << 28):
            h.update(b[i:i + (1 << 28)].cpu().numpy().tobytes())

    walk("", tree)
    return h.hexdigest()


def train_1b_worker(config):
    """Phase 12's ``train_loop_per_worker`` (one GPU worker): join the
    process group, build the mesh, shard the seeded weights, train with
    checkpoints every CKPT_EVERY steps; the first attempt raises after
    reporting step FAIL_AFTER, the second restores the latest checkpoint
    and finishes, then (b) runs SP_STEPS steps with sp_axis="sp". The
    state is fingerprinted at the checkpoint the restart resumes from and
    after the restore."""
    import dataclasses
    import json
    import os
    import time

    import torch
    import torch.distributed as dist

    from ray_tpu_torch import bench, train
    from ray_tpu_torch.models import llama, training
    from ray_tpu_torch.parallel import MeshConfig, make_mesh, shard_pytree
    from ray_tpu_torch.parallel.sharding import FSDP_TP_RULES

    t_start = time.time()
    ctx = train.get_context()
    ck = ctx.get_checkpoint()
    attempt = 1 if ck is None else 2
    resume_step = (config["fail_after"] // config["ckpt_every"]) \
        * config["ckpt_every"]
    log_path = os.path.join(ctx.get_storage_path(), "events.jsonl")

    def record(**kw):
        with open(log_path, "a") as f:
            f.write(json.dumps(dict(kw, attempt=attempt, t=time.time()))
                    + "\n")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    ctx.init_jax_distributed()
    mesh = make_mesh(MeshConfig(), device_type=config["device_type"])
    dev = torch.device(config["device_type"])
    record(kind="start", t_start=t_start, backend=dist.get_backend(),
           world=dist.get_world_size(), mesh_shape=list(mesh.shape),
           mesh_names=list(mesh.mesh_dim_names),
           visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
           resume=ck.path if ck is not None else None)
    cfg = bench.CONFIGS[config["model"]]
    rules = FSDP_TP_RULES
    axes = llama.param_logical_axes(cfg)
    opt = training.OptimizerConfig(warmup_steps=1, decay_steps=1000).make()

    def build(c):
        # phase 8's weights and batch: bench.run draws both from one
        # generator of the seed, the weights first
        gen = torch.Generator(device=dev).manual_seed(config["seed"])
        params = llama.init_params(c, gen, dev)
        tokens = torch.randint(0, c.vocab_size,
                               (config["batch"], config["seq"]),
                               generator=gen, device=dev, dtype=torch.int32)
        sharded = shard_pytree(params, axes, mesh, rules)
        del params
        state, _ = training.init_train_state(
            lambda g: sharded, opt, gen, param_axes=axes, mesh=mesh,
            rules=rules)
        step = training.make_train_step(
            lambda p, b: llama.loss_fn(p, b, c, rules, mesh=mesh), opt,
            mesh, rules)
        return state, step, {"tokens": tokens}

    def ckpt_tree(state):
        return {"params": state.params, "mu": state.opt_state.mu,
                "nu": state.opt_state.nu,
                "counts": torch.tensor([state.step,
                                        state.opt_state.adam_count,
                                        state.opt_state.schedule_count])}

    state, step, batch = build(cfg)
    if ck is not None:
        target = ckpt_tree(state)
        sync()
        t = time.perf_counter()
        train.Checkpoint(ck.path).to_pytree(target)
        sync()
        restore_s = time.perf_counter() - t
        counts = [int(c) for c in target["counts"]]
        state.step = counts[0]
        state.opt_state.adam_count = counts[1]
        state.opt_state.schedule_count = counts[2]
        record(kind="restore", path=ck.path, step=state.step,
               seconds=restore_s, bytes=_dir_bytes(ck.path),
               fingerprint=_tree_fingerprint(
                   {k: v for k, v in target.items() if k != "counts"}))
    reset_flash_launches()
    while True:
        sync()
        t = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])           # waits for the step
        ms = 1e3 * (time.perf_counter() - t)
        n = state.step
        record(kind="step", step=n, loss=loss, ms=ms,
               grad_norm=float(m["grad_norm"]), launches=flash_launches())
        ckpt = None
        if n % config["ckpt_every"] == 0:
            sync()
            t = time.perf_counter()
            ckpt = train.Checkpoint.from_pytree(train.checkpoint_dir(n),
                                                ckpt_tree(state))
            record(kind="checkpoint", step=n, path=ckpt.path,
                   seconds=time.perf_counter() - t,
                   bytes=_dir_bytes(ckpt.path),
                   fingerprint=_tree_fingerprint(
                       {k: v for k, v in ckpt_tree(state).items()
                        if k != "counts"}) if n == resume_step else None)
        metrics = {"step": n, "loss": loss}
        if n == config["steps"]:
            # (b): the sp_axis path on the same mesh, weights and batch
            del state, step, m
            torch.cuda.empty_cache() if dev.type == "cuda" else None
            sp_state, sp_step, sp_batch = build(
                dataclasses.replace(cfg, sp_axis="sp"))
            reset_flash_launches()
            for _ in range(config["sp_steps"]):
                sync()
                t = time.perf_counter()
                sp_state, sm = sp_step(sp_state, sp_batch)
                record(kind="sp_step", step=sp_state.step,
                       loss=float(sm["loss"]),
                       ms=1e3 * (time.perf_counter() - t),
                       grad_norm=float(sm["grad_norm"]),
                       launches=flash_launches())
            del sp_state, sp_step
        train.report(metrics, checkpoint=ckpt)
        if attempt == 1 and n == config["fail_after"]:
            record(kind="fail", step=n)
            raise RuntimeError(f"planted failure after step {n}")
        if n == config["steps"]:
            break


def _dir_bytes(path):
    """Bytes of a checkpoint's files (the manager's _metrics.json aside)."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files
               if f != "_metrics.json")


def train_library_check(phase8_losses, model="1b_bench", batch=8, seq=2048,
                        device_type="cuda", use_gpu=True,
                        expect_launches=True, smi=""):
    """Phase 12: Train on the card under a fresh init(): (a) a JaxTrainer
    gang of one GPU worker trains ``model`` TRAIN_STEPS steps on a mesh of
    one rank (an NCCL process group of world 1: the code a multi-GPU gang
    takes, with no traffic between ranks), checkpointing every CKPT_EVERY
    steps; its first attempt fails after step FAIL_AFTER, and the restart
    resumes from the latest checkpoint; (b) then SP_STEPS steps with
    sp_axis="sp" — at sp = 1 the ring has one chunk, so the rotation and
    the causal chunk skip are verified on the CPU only
    (tests/test_torch_parallel.py); (c) after shutdown() no process of
    the session is left. The checkpoints' directory is removed however
    the phase ends."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rtt_train_")
    try:
        return _train_checks(root, phase8_losses, model, batch, seq,
                             device_type, use_gpu, expect_launches, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _train_checks(root, phase8_losses, model, batch, seq, device_type,
                  use_gpu, expect_launches, smi):
    """Phase 12 with its checkpoints under ``root``."""
    import json as _json
    import math
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import api, bench, train

    cfg = bench.CONFIGS[model]
    out = {"storage": root, "disk_free_bytes": shutil.disk_usage(root).free}
    log(f"[12] checkpoint storage {root}: {out['disk_free_bytes']} bytes "
        f"free | {smi}")
    # params and two moments, in the weights' dtype; two on disk at once
    import torch

    ckpt_est = 3 * cfg.num_params() * torch.empty(
        0, dtype=cfg.dtype).element_size()
    assert out["disk_free_bytes"] > 2.5 * ckpt_est, (out, ckpt_est)
    rt.init()
    session = api._head["session_dir"]
    try:
        out["gpu_before"] = rt.available_resources().get("GPU", 0.0)
        t = time.perf_counter()
        result = train.JaxTrainer(
            train_1b_worker,
            train_loop_config={
                "model": model, "batch": batch, "seq": seq, "seed": 0,
                "steps": TRAIN_STEPS, "ckpt_every": CKPT_EVERY,
                "fail_after": FAIL_AFTER, "sp_steps": SP_STEPS,
                "device_type": device_type},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=use_gpu),
            run_config=train.RunConfig(
                name=model, storage_path=root,
                checkpoint_config=train.CheckpointConfig(num_to_keep=1),
                failure_config=train.FailureConfig(max_failures=1)),
        ).fit(timeout_s=900)
        out["fit_s"] = time.perf_counter() - t
        if use_gpu:
            out["gpu_after"] = _available_gpu(rt, out["gpu_before"])
            assert out["gpu_after"] == out["gpu_before"] == 1.0, out
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 30
    while _session_processes(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    out["left_after_shutdown"] = _session_processes(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]

    with open(os.path.join(result.path, "events.jsonl")) as f:
        events = [_json.loads(line) for line in f]
    ev = lambda kind, attempt=None: [  # noqa: E731
        e for e in events if e["kind"] == kind
        and (attempt is None or e["attempt"] == attempt)]
    starts = ev("start")
    # 1. one restart, resumed from step FAIL_AFTER - 1's checkpoint
    assert [e["attempt"] for e in starts] == [1, 2], starts
    resume_step = (FAIL_AFTER // CKPT_EVERY) * CKPT_EVERY
    assert starts[1]["resume"] == os.path.join(
        result.path, f"checkpoint_{resume_step:08d}"), starts[1]
    out["backend"] = starts[0]["backend"]
    out["world"] = starts[0]["world"]
    out["mesh"] = dict(zip(starts[0]["mesh_names"], starts[0]["mesh_shape"]))
    out["visible_devices"] = starts[0]["visible"]
    log(f"[12] (a) process group backend {out['backend']}, world "
        f"{out['world']}, mesh {out['mesh']}, CUDA_VISIBLE_DEVICES "
        f"{out['visible_devices']}")
    if use_gpu:
        assert out["backend"] == "nccl" and out["world"] == 1, out
    steps1, steps2 = ev("step", 1), ev("step", 2)
    assert [e["step"] for e in steps1] == list(range(1, FAIL_AFTER + 1))
    assert [e["step"] for e in steps2] == list(range(resume_step + 1,
                                                     TRAIN_STEPS + 1))
    # 2. the resumed step's loss equals the first attempt's, bit for bit
    again = {e["step"]: e["loss"] for e in steps2}
    first = {e["step"]: e["loss"] for e in steps1}
    out["resumed_equal"] = {n: again[n] == first[n] for n in again
                            if n in first}
    assert out["resumed_equal"] and all(out["resumed_equal"].values()), (
        first, again)
    (restore,) = ev("restore")
    saved = {e["step"]: e for e in ev("checkpoint")}
    out["restore_bit_equal"] = (restore["fingerprint"]
                                == saved[resume_step]["fingerprint"])
    assert out["restore_bit_equal"], (restore, saved[resume_step])
    losses = [first[n] for n in sorted(first)] + [
        again[n] for n in sorted(again) if n not in first]
    out["losses"] = losses
    # 3. the first loss against phase 8's mesh-less step in this process
    out["first_loss_rel_err_vs_phase8"] = (
        abs(losses[0] - phase8_losses[0]) / abs(phase8_losses[0]))
    out["first_loss_bit_equal_phase8"] = losses[0] == phase8_losses[0]
    out["losses_phase8"] = list(phase8_losses[:TRAIN_STEPS])
    assert out["first_loss_rel_err_vs_phase8"] <= 1e-4, out
    # ... and the first PHASE8_STEPS, after the sharded step's updates
    out["rel_err_vs_phase8"] = [abs(a - b) / abs(b) for a, b in
                                zip(losses, out["losses_phase8"])]
    assert len(out["rel_err_vs_phase8"]) == TRAIN_STEPS and max(
        out["rel_err_vs_phase8"][:PHASE8_STEPS]) <= UPDATED_RTOL, out
    # 4. finite and falling
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    # 5. the result and the one checkpoint left
    out["result_metrics"] = result.metrics
    assert result.metrics["step"] == TRAIN_STEPS, result.metrics
    kept = sorted(e for e in os.listdir(result.path)
                  if e.startswith("checkpoint_"))
    out["kept"] = kept
    assert kept == [f"checkpoint_{TRAIN_STEPS:08d}"], kept
    assert result.checkpoint.path == os.path.join(result.path, kept[0])
    # 6. the kernels in the worker's process, as phase 8 counts them
    L = cfg.n_layers
    per_step = {"fwd": 2 * L if cfg.remat else L, "bwd": L, "dq": 0,
                "dkv": 0}
    out["launches"] = {k: steps1[-1]["launches"][k]
                       + steps2[-1]["launches"][k] for k in per_step}
    n_steps = len(steps1) + len(steps2)
    want = {k: v * n_steps for k, v in per_step.items()}
    if expect_launches:
        assert out["launches"] == want, (out["launches"], want)
    # timings: steps after each attempt's first, checkpoint I/O
    timed = [e["ms"] for e in steps1[1:] + steps2[1:]]
    out["step_ms"] = sorted(timed)[len(timed) // 2]
    out["step_ms_all"] = [e["ms"] for e in steps1 + steps2]
    out["tokens_per_s"] = batch * seq / (out["step_ms"] / 1e3)
    out["checkpoints"] = [{k: e[k] for k in ("step", "seconds", "bytes")}
                          for e in ev("checkpoint")]
    out["restore"] = {k: restore[k] for k in ("step", "seconds", "bytes")}
    (fail,) = ev("fail")
    out["restart_s"] = starts[1]["t_start"] - fail["t"]
    out["restart_to_first_step_s"] = steps2[0]["t"] - fail["t"]
    log("[12] (a) " + _json.dumps({k: out[k] for k in (
        "losses", "losses_phase8", "first_loss_rel_err_vs_phase8",
        "rel_err_vs_phase8",
        "first_loss_bit_equal_phase8", "resumed_equal", "restore_bit_equal",
        "kept", "launches", "step_ms", "tokens_per_s", "checkpoints",
        "restore", "restart_s", "restart_to_first_step_s", "fit_s")})
        + f" | {smi}")
    # (b) the sp_axis path
    sp = ev("sp_step")
    out["sp_losses"] = [e["loss"] for e in sp]
    out["sp_rel_err"] = [abs(a - b) / abs(b)
                         for a, b in zip(out["sp_losses"], losses)]
    out["sp_bit_equal"] = [a == b for a, b in zip(out["sp_losses"], losses)]
    # the ring path's backward: gradient norms of the weights as built
    out["grad_norms"] = [e["grad_norm"] for e in steps1]
    out["sp_grad_norms"] = [e["grad_norm"] for e in sp]
    out["sp_grad_norm_rel_err"] = [
        abs(a - b) / abs(b) for a, b in zip(out["sp_grad_norms"][:2],
                                            out["grad_norms"][:2])]
    out["sp_launches"] = sp[-1]["launches"]
    out["sp_step_ms"] = [e["ms"] for e in sp]
    assert len(sp) == SP_STEPS == 3, out
    assert max(out["sp_rel_err"][:2] + out["sp_grad_norm_rel_err"]) \
        <= SP_RTOL and out["sp_rel_err"][2] <= UPDATED_RTOL, out
    want_sp = {k: v * SP_STEPS for k, v in per_step.items()}
    if expect_launches:
        assert out["sp_launches"] == want_sp, (out["sp_launches"], want_sp)
    log("[12] (b) sp_axis='sp' (one chunk at sp=1): " + _json.dumps(
        {k: out[k] for k in ("sp_losses", "sp_rel_err", "sp_bit_equal",
                             "grad_norms", "sp_grad_norms",
                             "sp_grad_norm_rel_err", "sp_launches",
                             "sp_step_ms")}) + f" | {smi}")
    log(f"[12] (c) left after shutdown: {out['left_after_shutdown']}")
    return out


# ------------------------------------------------------------- main

# ------------------------------------------------------------- phase 13
# (a) the in-program collective group (XlaGroup: NCCL across the devices
# this process owns) at world 1; (b) Train's pipeline mode on the 1b
# Llama as two GPU stages.

NCCL_ELEMS = 1 << 24     # (1, 2^24): 64 MiB in f32, 32 MiB in bf16
# the JAX package's slack on its quantized bound (float32 dequantisation
# rounding; tests/test_quantized_collective.py:203)
QUANT_SLACK = 1e-5
PIPE_TRAIN_MODEL = "1b"  # untied head: the embedding and the head can
                         # live in different stages (1b_bench ties them)
PIPE_TRAIN_STAGES = 2
PIPE_TRAIN_M = 4         # microbatches a step
PIPE_TRAIN_SEQ = 2048
PIPE_TRAIN_STEPS = 3
PIPE_TRAIN_LR = 0.5      # sgd: bf16 weights keep a step of this size
# the first loss is the same forward on the same bits in both runs; the
# later ones read updates made from bf16 gradients whose dQ adds in no
# fixed order (PERF.md §6: up to 8.8e-4 at the first update)
PIPE_FIRST_RTOL = 1e-4
PIPE_LATER_RTOL = 5e-3


def _timed(fn, device):
    """``fn()`` once to warm, then once timed: (result, ms), the time
    ended by a synchronize."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def _device_kernels(fn):
    """The device activity ``torch.profiler`` records over one ``fn()``:
    {name: calls}, kernels and copies alike."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.key not in out:
            out[e.key] = e.count
    return out


def nccl_group_check(device, n=NCCL_ELEMS, seed=13):
    """Phase 13 (a): ``XlaGroup`` of world 1 on ``device`` (NCCL through
    ``torch.cuda.nccl`` on the card). allreduce (SUM, MAX, MIN),
    broadcast, allgather and reducescatter of a (1, n) f32 tensor and its
    bf16 rounding each give the input bit for bit, as world 1 implies; the
    device activity of one NCCL allreduce as the profiler names it. Then
    with ``quantized_collectives`` on, allreduce and reducescatter of the
    f32 tensor: within ``allreduce_error_bound`` (+ QUANT_SLACK), apart
    from the input somewhere (the quantized path ran), and bit-equal to
    the port's own CPU group on the same input (reported)."""
    import numpy as np
    import torch

    from ray_tpu_torch.collective import quantization as q
    from ray_tpu_torch.collective.types import ReduceOp
    from ray_tpu_torch.collective.xla_group import XlaGroup
    from ray_tpu_torch.common.config import GLOBAL_CONFIG

    g = XlaGroup(1) if device.type == "cuda" else XlaGroup(
        1, devices=[device])
    gen = torch.Generator(device=device).manual_seed(seed)
    x32 = torch.randn((1, n), generator=gen, device=device) * 2
    out = {"devices": [str(d) for d in g.devices], "elements": n,
           "exact": {}}
    for name, x in (("float32", x32), ("bfloat16", x32.bfloat16())):
        res = {}
        ops = {f"allreduce_{op}": (lambda op=op: g.allreduce(
            x, ReduceOp[op]), x[0]) for op in ("SUM", "MAX", "MIN")}
        ops["broadcast"] = (lambda: g.broadcast(x, 0), x[0])
        ops["allgather"] = (lambda: g.allgather(x)[0], x[0])
        ops["reducescatter"] = (lambda: g.reducescatter(x), x)
        for op, (fn, want) in ops.items():
            got, ms = _timed(fn, device)
            res[op] = {"bit_equal": bool(torch.equal(got, want)),
                       "device": str(got.device), "ms": ms}
        out["exact"][name] = res
        log(f"[13] (a) XlaGroup world 1, {name}: " + json.dumps(res))
        bad = {op: r for op, r in res.items() if not r["bit_equal"]}
        assert not bad, bad
    if device.type == "cuda":
        acts = _device_kernels(lambda: g.allreduce(x32))
        out["allreduce_device_activity"] = acts
        out["nccl_kernels"] = [k for k in acts if "nccl" in k.lower()]
        out["nccl_launched_a_kernel"] = bool(out["nccl_kernels"])
        log("[13] (a) one f32 allreduce on the card, its device activity "
            "(a world-1 NCCL call may copy instead of launching a kernel): "
            + json.dumps(acts))
    block = GLOBAL_CONFIG.get("quantized_collectives_block")
    host = x32[0].cpu().numpy()
    bound = torch.from_numpy(q.allreduce_error_bound([host], block))
    cpu_group = XlaGroup(1, devices=[torch.device("cpu")])
    GLOBAL_CONFIG.set_system_config_value("quantized_collectives", True)
    try:
        quant = {}
        for op, fn, cpu_fn, want in (
                ("allreduce", lambda: g.allreduce(x32),
                 lambda: cpu_group.allreduce(x32.cpu()), x32[0]),
                ("reducescatter", lambda: g.reducescatter(x32),
                 lambda: cpu_group.reducescatter(x32.cpu()), x32)):
            got, ms = _timed(fn, device)
            err = (got.double() - want.double()).abs().cpu().reshape(-1)
            quant[op] = {
                "ms": ms, "max_abs_err": err.max().item(),
                "max_bound": bound.max().item(),
                "within_bound": bool((err <= bound.double() + QUANT_SLACK)
                                     .all()),
                "differs_from_input": bool(err.max() > 0),
                "bit_equal_cpu_group": bool(torch.equal(got.cpu(),
                                                        cpu_fn()))}
        out["quantized"] = quant
        log("[13] (a) quantized (block-int8) allreduce and reducescatter, "
            "world 1: " + json.dumps(quant))
        for op, r in quant.items():
            assert r["within_bound"] and r["differs_from_input"], (op, r)
    finally:
        GLOBAL_CONFIG.set_system_config_value("quantized_collectives",
                                              False)
    g.barrier()
    return out


def pipeline_stage_specs(cfg, n_stages=PIPE_TRAIN_STAGES):
    """``cfg`` cut into ``n_stages`` stages of equal depth: stage 0 takes
    the tokens through the embedding and its layers, the last ends in the
    final norm and the f32 head (the logits); ``init`` draws a stage's
    weights from its generator (llama.init_params of the stage's depth,
    the parts it holds kept). Without remat: the stage's backward is
    already a full recompute."""
    import dataclasses

    from ray_tpu_torch.train import StageSpec

    sub = dataclasses.replace(cfg, n_layers=cfg.n_layers // n_stages,
                              remat=False)

    def make(first, last):
        def init(gen):
            from ray_tpu_torch.models import llama

            p = llama.init_params(sub, gen, gen.device)
            keep = ["layers"] + (["embed"] if first else []) + (
                ["final_norm", "lm_head"] if last else [])
            return {k: p[k] for k in keep}

        def apply(p, x):
            from ray_tpu_torch.models import llama
            from ray_tpu_torch.ops.norms import rmsnorm
            from ray_tpu_torch.ops.rope import rope_frequencies

            if first:
                x = p["embed"].to(sub.dtype)[x.long()]
            cos, sin = rope_frequencies(sub.head_dim, sub.max_seq,
                                        sub.rope_theta, device=x.device)
            block = llama.make_block(sub, cos, sin)
            names = list(p["layers"])
            for ws in zip(*(p["layers"][n].unbind(0) for n in names)):
                x = block(x, dict(zip(names, ws)))
            if last:
                x = llama._head_logits(
                    rmsnorm(x, p["final_norm"], sub.norm_eps), p["lm_head"])
            return x

        return init, apply

    return [StageSpec(*make(i == 0, i == n_stages - 1), name=f"stage{i}")
            for i in range(n_stages)], sub


def pipeline_loss(logits, y):
    """Next-token cross entropy of the last stage's f32 logits."""
    import torch

    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


class _PipeStageCounts:
    """Mixed into the pipeline's stage actor (phase 13 (b)): the flash
    launches and calls of the plain forward in the stage's own process,
    counted from the start of its exec loop, a step's device time (its
    forward, backward and fused programs, each between two synchronizes;
    the other stage's work on the shared card can fall inside) and the
    host time of its step boundaries (ravel, optimizer, unravel)."""

    def run_pipeline(self, *args):
        from ray_tpu_torch.ops import flash_attention as fa

        plain, self._plain = fa.flash_attention_fwd_reference, [0]

        def counted(*a, **kw):
            self._plain[0] += 1
            return plain(*a, **kw)

        fa.flash_attention_fwd_reference = counted
        self._device_ms, self._step_device_ms, self._host_ms = [], [], []
        reset_flash_launches()
        return super().run_pipeline(*args)

    def _build_fns(self, like):
        import torch

        def sync():
            if self._device.type == "cuda":
                torch.cuda.synchronize()

        def timed(fn):
            if fn is None:
                return None

            def run(*a):
                sync()
                t = time.perf_counter()
                out = fn(*a)
                sync()
                self._device_ms.append(1e3 * (time.perf_counter() - t))
                return out
            return run

        return tuple(timed(f) for f in super()._build_fns(like))

    def _host_step(self, *args):
        self._step_device_ms.append(sum(self._device_ms))
        self._device_ms = []
        t = time.perf_counter()
        out = super()._host_step(*args)
        self._host_ms.append(1e3 * (time.perf_counter() - t))
        return out

    def counts(self):
        import torch

        return {"launches": flash_launches(),
                "plain_attention": self._plain[0], "pid": os.getpid(),
                "grant": [os.environ.get("CUDA_VISIBLE_DEVICES"),
                          torch.cuda.device_count()],
                "device": str(self._device),
                "device_ms": self._step_device_ms,
                "host_step_ms": self._host_ms}


def pipeline_reference(specs, loss, xs, ys, steps, lr, device, seed=0):
    """The single-process step phase 13 (b) is held to: the same stage
    functions (``_PipelineStageActor``'s forward, recomputing backward and
    fused loss, in this process) composed on the same microbatches, each
    stage's gradients summed in microbatch order and averaged over M, and
    the same host step (``FlatOptimizer`` sgd on the flat f32 vector).
    Returns each step's mean loss."""
    import cloudpickle
    import torch

    from ray_tpu_torch.models.training import tree_leaves
    from ray_tpu_torch.train import pipeline as pl
    from ray_tpu_torch.train.collectives import FlatOptimizer

    S, M = len(specs), len(xs)
    stages = []
    for i, s in enumerate(specs):
        a = pl._PipelineStageActor(cloudpickle.dumps(
            {"init": s.init, "apply": s.apply,
             "loss": loss if i == S - 1 else None}), i, S, M, seed, "sgd",
            lr)
        a._device = device
        tree = s.init(torch.Generator(device=device).manual_seed(seed + i))
        stages.append({"actor": a, "leaves": [pl._on(x, device) for x in
                                             tree_leaves(tree)],
                       "fns": a._build_fns(tree), "state": None})
        del tree
    opt = FlatOptimizer(kind="sgd", lr=lr)
    losses = []
    for _ in range(steps):
        acc = [None] * S
        total = 0.0
        for x, y in zip(xs, ys):
            h, inputs = pl._on(x, device), []
            for st in stages[:-1]:
                inputs.append(h)
                h = st["fns"][0](st["leaves"], h)
            last = stages[-1]
            lv, gp, g = last["fns"][2](last["leaves"], h, pl._on(y, device))
            total += float(lv)
            grads = {S - 1: gp}
            for i in range(S - 2, -1, -1):
                grads[i], g = stages[i]["fns"][1](stages[i]["leaves"],
                                                  inputs[i], g)
            for i, gp in grads.items():
                acc[i] = gp if acc[i] is None else [
                    a + b for a, b in zip(acc[i], gp)]
            del inputs, h, g, grads
        losses.append(total / M)
        for i, st in enumerate(stages):
            st["leaves"], st["state"] = st["actor"]._host_step(
                st["leaves"], [a / M for a in acc[i]], opt, st["state"],
                None, None)
        del acc
    return losses


def pipeline_train_check(rt, device, model=PIPE_TRAIN_MODEL,
                         n_stages=PIPE_TRAIN_STAGES, M=PIPE_TRAIN_M,
                         seq=PIPE_TRAIN_SEQ, steps=PIPE_TRAIN_STEPS,
                         lr=PIPE_TRAIN_LR, actor_options=None, seed=14):
    """Phase 13 (b): ``PipelineRunner`` on ``model`` at full width and
    depth as ``n_stages`` stage actors (``num_gpus=0.5`` each on the
    card), M seeded (1, seq) microbatches, sgd, ``steps`` steps, the
    channels sized to one (1, seq, hidden) activation; held to
    :func:`pipeline_reference` run in this process first: the first loss
    within PIPE_FIRST_RTOL (bit equality reported), the later within
    PIPE_LATER_RTOL; each stage's flash launches in its own process as
    the schedule implies (the first stage runs each microbatch's forward
    twice, its slot and its recompute; the last runs the fused loss and
    gradient once), the f32 K2a, K2b and the plain attention never; GPU
    back to 1 after the runner's shutdown."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train import PipelineRunner, PipelineSpec
    from ray_tpu_torch.train import pipeline as pl

    cfg = llama.CONFIGS[model]
    specs, sub = pipeline_stage_specs(cfg, n_stages)
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, cfg.vocab_size, (1, seq + 1)).astype(np.int64)
            for _ in range(M)]
    xs, ys = [t[:, :-1] for t in toks], [t[:, 1:] for t in toks]
    out = {"model": model, "stages": n_stages, "layers_per_stage":
           sub.n_layers, "microbatches": M, "seq": seq, "lr": lr}

    t = time.perf_counter()
    out["reference_losses"] = pipeline_reference(specs, pipeline_loss, xs,
                                                 ys, steps, lr, device)
    out["reference_s"] = time.perf_counter() - t
    log("[13] (b) single-process reference: " + json.dumps(
        {k: out[k] for k in ("reference_losses", "reference_s")}))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    act_bytes = seq * cfg.hidden * torch.tensor([], dtype=cfg.dtype
                                                ).element_size()
    spec = PipelineSpec(stages=specs, loss=pipeline_loss,
                        num_microbatches=M, optimizer="sgd",
                        learning_rate=lr,
                        channel_capacity=act_bytes + (64 << 10),
                        device=None if device.type == "cuda" else "cpu")
    out["channel_capacity"] = spec.channel_capacity
    base = pl._PipelineStageActor
    pl._PipelineStageActor = type(base.__name__, (_PipeStageCounts, base),
                                  {})
    t = time.perf_counter()
    try:
        runner = PipelineRunner(spec, actor_options=actor_options)
    finally:
        pl._PipelineStageActor = base
    try:
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(runner.step(xs, ys, timeout_s=900)["loss"])
            step_ms.append(1e3 * (time.perf_counter() - t0))
        runner.finish(timeout_s=300)
        counts = rt.get([h.counts.remote() for h in runner._actors],
                        timeout=60)
    finally:
        runner.shutdown()
    out.update({"losses": losses, "step_ms": step_ms,
                "first_step_includes_start_s": step_ms[0] / 1e3,
                "microbatches_per_s": [M / (ms / 1e3) for ms in step_ms],
                "wall_s": time.perf_counter() - t, "stage_counts": counts})
    ref = out["reference_losses"]
    out["rel_err"] = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    out["first_loss_bit_equal"] = losses[0] == ref[0]
    log("[13] (b) pipeline: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("stage_counts",)}))
    log("[13] (b) stages: " + json.dumps(counts))
    assert all(np.isfinite(losses)), losses
    assert out["rel_err"][0] <= PIPE_FIRST_RTOL, out["rel_err"]
    assert max(out["rel_err"]) <= PIPE_LATER_RTOL, out["rel_err"]
    assert losses[1] != losses[0], losses   # the step moved the weights
    L, n = sub.n_layers, M * steps
    for i, c in enumerate(counts):
        last = i == n_stages - 1
        want = {"fwd": (1 if last else 2) * L * n, "bwd": L * n, "dq": 0,
                "dkv": 0} if device.type == "cuda" else c["launches"]
        assert c["launches"] == want, (i, c["launches"], want)
        assert c["plain_attention"] == 0 or device.type != "cuda", c
        assert c["pid"] != os.getpid(), c
        if device.type == "cuda":
            assert c["grant"] == ["0", 1], c
    out["launches"] = {k: sum(c["launches"][k] for c in counts)
                       for k in ("fwd", "bwd", "dq", "dkv")}
    out["gpu_after_shutdown"] = _available_gpu(rt, 1.0)
    if device.type == "cuda":
        assert out["gpu_after_shutdown"] == 1.0, out["gpu_after_shutdown"]
    return out


def collectives_pipeline_check(device, smi=""):
    """Phase 13 under a fresh init(): (a) :func:`nccl_group_check`, (b)
    :func:`pipeline_train_check` with two half-GPU stages; after
    shutdown() no process of the session is left."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api

    out = {"nvidia_smi": smi}
    out["nccl"] = nccl_group_check(device)
    rt.init()
    session = api._head["session_dir"]
    try:
        out["pipeline"] = pipeline_train_check(
            rt, device, actor_options={"num_gpus": 0.5})
    finally:
        rt.shutdown()
    out["left_after_shutdown"] = _wait_session_gone(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    log(f"[13] {smi}: " + json.dumps({
        "nccl_exact_ms_f32": {k: v["ms"] for k, v in
                              out["nccl"]["exact"]["float32"].items()},
        "pipeline_step_ms": out["pipeline"]["step_ms"],
        "pipeline_host_step_ms": [c["host_step_ms"] for c in
                                  out["pipeline"]["stage_counts"]],
        "pipeline_device_ms": [c["device_ms"] for c in
                               out["pipeline"]["stage_counts"]]}))
    return out


def _wait_session_gone(session, within=30.0):
    """The session's processes still alive ``within`` seconds after
    shutdown() (none is the pass)."""
    deadline = time.monotonic() + within
    while _session_processes(session) and time.monotonic() < deadline:
        time.sleep(0.1)
    return _session_processes(session)


# ------------------------------------------------------------- phase 14
# The MoE's expert axis: phase 8c's 8x7b weights and batch on a mesh of
# one rank (an NCCL group of world 1) under FSDP_RULES, where the experts
# shard over fsdp x sp.

MOE_MESH_STEPS = 4
MOE_SP_STEPS = 3


def _moe_train(cfg, mesh, rules, init_fn, tokens, steps):
    """``steps`` sharded train steps of the MoE ``cfg`` on ``mesh``: each
    step's metrics and host ms (ended by the loss's read), the flash
    launches over the steps."""
    import torch

    from ray_tpu_torch.models import moe, training
    from ray_tpu_torch.parallel import shard_pytree

    axes = moe.param_logical_axes(cfg)
    opt = training.OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
    sharded = shard_pytree(init_fn(), axes, mesh, rules)
    state, _ = training.init_train_state(
        lambda g: sharded, opt, None, param_axes=axes, mesh=mesh,
        rules=rules)
    del sharded
    step = training.make_train_step(
        lambda p, b: moe.loss_fn(p, b, cfg, rules, mesh=mesh), opt, mesh,
        rules)
    reset_flash_launches()
    metrics, ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        metrics.append({k: float(v) for k, v in m.items()})
        ms.append(1e3 * (time.perf_counter() - t))
    launches = flash_launches()
    del state, step
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return metrics, ms, launches


def moe_mesh_check(device, phase8c, layers=MOE_LAYERS, batch=2, seq=2048,
                   smi="", model="8x7b"):
    """Phase 14: 8x7b at full width and ``layers`` layers, phase 8c's
    weights (its generator of seed 0) and batch (seed 1), on a mesh of
    one rank under FSDP_RULES. (a) MOE_MESH_STEPS steps: the first loss
    within PIPE_FIRST_RTOL of 8c's mesh-less first loss (bit equality
    reported), the first four within UPDATED_RTOL, the router's aux loss
    as 8c holds it, K1 twice and flash_bwd_kernel once per layer per step;
    (b) MOE_SP_STEPS steps with sp_axis="sp": the first two losses within
    SP_RTOL of (a)'s, the third within UPDATED_RTOL, the same launches. At
    sp = 1 the ring has one chunk: the rotation is checked on the CPU
    only (tests/test_torch_parallel.py). 8c's step ms beside."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import FSDP_RULES

    full = moe.CONFIGS[model]
    cfg = dataclasses.replace(full, base=dataclasses.replace(
        full.base, n_layers=layers))
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.base.vocab_size, (batch, seq),
                           generator=gen, device=device, dtype=torch.int32)

    def init(c):
        return lambda: moe.init_params(
            c, torch.Generator(device=device).manual_seed(0), device)

    mesh = make_mesh(MeshConfig(), device_type=device.type)
    out = {"mesh_shape": list(mesh.shape),
           "mesh_names": list(mesh.mesh_dim_names),
           "backend": dist.get_backend(), "world": dist.get_world_size(),
           "layers": layers, "rules": "FSDP_RULES",
           "phase8c_step_ms": phase8c.get("step_ms"), "nvidia_smi": smi}
    try:
        m, ms, launches = _moe_train(cfg, mesh, FSDP_RULES, init(cfg),
                                     tokens, MOE_MESH_STEPS)
        losses = [x["loss"] for x in m]
        want = phase8c["losses"][:MOE_MESH_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
        out["mesh"] = {"losses": losses, "rel_err_vs_8c": rel,
                       "first_loss_bit_equal": losses[0] == want[0],
                       "aux_loss_step0": m[0]["aux_loss"],
                       "dropped_frac": [x["dropped_frac"] for x in m],
                       "step_ms": ms, "launches": launches}
        log(f"[14] (a) {model} on a mesh of one: " + json.dumps(out["mesh"]))
        assert rel[0] <= PIPE_FIRST_RTOL, rel
        assert max(rel) <= UPDATED_RTOL, rel
        assert 0.8 < m[0]["aux_loss"] < 1.5, m[0]
        n = layers * MOE_MESH_STEPS
        if device.type == "cuda":
            assert launches == {"fwd": 2 * n, "bwd": n, "dq": 0,
                                "dkv": 0}, launches

        sp_cfg = dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, sp_axis="sp"))
        m, ms, launches = _moe_train(sp_cfg, mesh, FSDP_RULES, init(sp_cfg),
                                     tokens, MOE_SP_STEPS)
        sp_losses = [x["loss"] for x in m]
        rel = [abs(a - b) / abs(b) for a, b in zip(sp_losses, losses)]
        out["sp_axis"] = {"losses": sp_losses, "rel_err_vs_mesh": rel,
                          "bit_equal_vs_mesh": [a == b for a, b in
                                                zip(sp_losses, losses)],
                          "step_ms": ms, "launches": launches}
        log(f"[14] (b) {model} with sp_axis='sp' (sp = 1: one ring chunk): "
            + json.dumps(out["sp_axis"]))
        assert max(rel[:2]) <= SP_RTOL, rel
        assert rel[2] <= UPDATED_RTOL, rel
        n = layers * MOE_SP_STEPS
        if device.type == "cuda":
            assert launches == {"fwd": 2 * n, "bwd": n, "dq": 0,
                                "dkv": 0}, launches
    finally:
        dist.destroy_process_group()
    return out


# ------------------------------------------------------------- phase 15
# RL: a PPO learner on the card against the same learner on the CPU, PPO
# learning CartPole with a GPU learner, a GPU learner actor.

RL_LEARNER_RTOL = 1e-5
RL_ITERS = 12            # tests/test_rl.py:139-143's run


def _rl_batch(params, steps=256, seed=0):
    """Two local EnvRunners' CartPole-v1 fragments under ``params``, as
    ``build_ppo_batch`` assembles them."""
    from ray_tpu_torch.rl.env_runner import EnvRunner
    from ray_tpu_torch.rl.learner import build_ppo_batch

    frags = []
    for i in range(2):
        r = EnvRunner("CartPole-v1", seed=seed, worker_index=i)
        r.set_weights(params, 0)
        frags.append(r.sample(steps))
    return build_ppo_batch(frags)


def _rel_close(got, want, rtol):
    """max over keys of |got - want| / max|want| (weights near 0, such
    as biases that start at 0, are held relative to their leaf's scale)."""
    import numpy as np

    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
                     / max(float(np.abs(np.asarray(want[k])).max()), 1e-12))
               for k in want)


class _LeaseLearner:
    """Mixed into the PPO learner a LearnerGroup actor builds (phase 15
    (c)): its update also reports the lease it sees."""

    def update(self, batch):
        import torch

        m = super().update(batch)
        m["lease_visible_is_0"] = float(
            os.environ.get("CUDA_VISIBLE_DEVICES") == "0")
        m["lease_device_count"] = float(torch.cuda.device_count())
        m["learner_on_cuda"] = float(self.device.type == "cuda")
        return m


def rl_check(device, smi=""):
    """Phase 15 under a fresh init(): (a) ``PPOLearner`` on ``device``
    against the same learner on the CPU, ``PPOConfig``'s default width
    (64, 64), the same batch (two local EnvRunners, 2 x 256 steps), one
    update of 4 epochs of 128: metrics and weights within RL_LEARNER_RTOL;
    (b) ``PPOConfig`` with tests/test_rl.py:125-146's settings at the
    default width, two CPU env runners and the learner on ``device``,
    RL_ITERS iterations: final return > max(2 x early, 60); env steps/s
    and the learner's update ms; (c) a ``LearnerGroup`` of one
    ``num_gpus=1`` learner actor sees its lease and its weights after one
    update on (a)'s batch equal (a)'s learner's (bit equality reported);
    GPU back to 1 after the group stops, and no process of the session
    after shutdown()."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import api
    from ray_tpu_torch.rl import PPOConfig
    from ray_tpu_torch.rl.learner import PPOLearner
    from ray_tpu_torch.rl.learner_group import LearnerGroup
    from ray_tpu_torch.rl.module import init_policy_params

    out = {"nvidia_smi": smi}
    params = init_policy_params(4, 2, hidden=PPOConfig.hidden, seed=0)
    batch, _, env_steps = _rl_batch(params)
    dev_name = None if device.type == "cuda" else "cpu"
    on_dev = PPOLearner(params, device=dev_name)
    on_cpu = PPOLearner(params, device="cpu")
    t = time.perf_counter()
    m_dev = on_dev.update(batch)
    update_ms = 1e3 * (time.perf_counter() - t)
    m_cpu = on_cpu.update(batch)
    w_dev, w_cpu = on_dev.get_weights(), on_cpu.get_weights()
    out["learner"] = {
        "device": str(on_dev.device), "env_steps": env_steps,
        "update_ms": update_ms, "metrics": m_dev,
        "metrics_rel_err": max(abs(m_dev[k] - m_cpu[k]) / max(
            abs(m_cpu[k]), 1e-12) for k in m_cpu),
        "weights_rel_err": _rel_close(w_dev, w_cpu, RL_LEARNER_RTOL)}
    log("[15] (a) PPO learner, card vs CPU: " + json.dumps(out["learner"]))
    assert out["learner"]["metrics_rel_err"] <= RL_LEARNER_RTOL, out
    assert out["learner"]["weights_rel_err"] <= RL_LEARNER_RTOL, out

    rt.init()
    session = api._head["session_dir"]
    try:
        algo = (PPOConfig(seed=1, rollout_fragment_length=512,
                          num_epochs=6, minibatch_size=256, lr=1e-3,
                          learner_device=dev_name)
                .environment("CartPole-v1").env_runners(2).build())
        update = algo.learner.update
        learner_ms = []

        def timed_update(b):
            t0 = time.perf_counter()
            res = update(b)
            learner_ms.append(1e3 * (time.perf_counter() - t0))
            return res

        algo.learner.update = timed_update
        try:
            t = time.perf_counter()
            results = [algo.train() for _ in range(RL_ITERS)]
            wall = time.perf_counter() - t
        finally:
            algo.stop()
        returns = [r["env_runners"]["episode_return_mean"] for r in results]
        sampled = sum(r["env_runners"]["num_env_steps_sampled"]
                      for r in results)
        early, final = returns[0], returns[-1]
        out["ppo"] = {"returns": returns, "early": early, "final": final,
                      "env_steps": sampled, "wall_s": wall,
                      "env_steps_per_s": sampled / wall,
                      "learner_update_ms": learner_ms,
                      "learner_device": str(algo.learner.device)}
        log("[15] (b) PPO on CartPole-v1, learner on the card: "
            + json.dumps(out["ppo"]))
        assert final > max(2 * early, 60.0), (early, final)

        def factory(params=params, dev_name=dev_name):
            from ray_tpu_torch.rl.learner import PPOLearner as _P

            cls = type("PPOLearner", (_LeaseLearner, _P), {})
            return cls(params, device=dev_name)

        opts = {"num_gpus": 1} if device.type == "cuda" else {}
        group = LearnerGroup(factory, num_learners=1, ray_remote_args=opts)
        try:
            gm = group.update(batch)
            gw = group.get_weights()
        finally:
            group.shutdown()
        out["group"] = {
            "metrics": gm, "weights_rel_err": _rel_close(gw, w_dev, 0),
            "bit_equal_to_learner": all(np.array_equal(gw[k], w_dev[k])
                                        for k in w_dev)}
        out["gpu_after_group"] = _available_gpu(rt, 1.0)
        log("[15] (c) LearnerGroup of one num_gpus=1 learner: "
            + json.dumps(out["group"]))
        if device.type == "cuda":
            assert gm["lease_visible_is_0"] == 1.0, gm
            assert gm["lease_device_count"] == 1.0, gm
            assert gm["learner_on_cuda"] == 1.0, gm
            assert out["gpu_after_group"] == 1.0, out["gpu_after_group"]
        assert out["group"]["weights_rel_err"] <= RL_LEARNER_RTOL, out
    finally:
        rt.shutdown()
    out["left_after_shutdown"] = _wait_session_gone(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


# ------------------------------------------------------------- phase 16
# RL beyond PPO: every new learner on the card against the CPU, Anakin's
# in-device loop, Sebulba with a GPU learner actor, IMPALA learning.

# (rtol, atol) of metrics and of weights: tests/test_torch_rl_algos.py's
# (biases start at 0, and a loss of normalized advantages sits near 0)
RL_ALGO_TOL = ((1e-5, 1e-6), (1e-5, 1e-6))
RL_DREAMER_TOL = ((1e-4, 1e-5), (1e-4, 5e-5))   # measured on the CPU
ANAKIN_SMALL = (4, 8)           # tests/test_podracer.py::TestAnakin's
ANAKIN_ENVS = 4096
ANAKIN_UPDATES = 30
# the greedy return the folded weights must exceed, set before the first
# chip run: half the 301.2 that the same settings gave on the CPU (5
# greedy episodes; the card's generator draws another stream)
ANAKIN_MIN_RETURN = 150.0
SEBULBA_FREE_S = 10.0
IMPALA_TARGET, IMPALA_DEADLINE_S = 120.0, 240.0   # tests/test_rl.py:147


def _device_profile(fn):
    """(launches, device ms) of one ``fn()`` as ``torch.profiler`` records
    them: kernels and copies, and the sum of their device times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, dev_us = 0, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            launches += e.count
            dev_us += us
    return launches, dev_us / 1e3


def _synced_ms(fn, n=3):
    """Mean ms of ``n`` calls of ``fn()``, each ended by a synchronize."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sum(times) / len(times)


def _metrics_rel(got, want):
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
               for k in want)


def _tol_ratio(got, want, rtol, atol):
    """max over keys and elements of |got - want| / (atol + rtol |want|):
    at most 1 where numpy's allclose(rtol, atol) holds."""
    import numpy as np

    return max(float((np.abs(np.asarray(got[k], np.float64)
                             - np.asarray(want[k], np.float64))
                      / (atol + rtol * np.abs(np.asarray(want[k],
                                                         np.float64))))
                     .max()) for k in want)


def _abs_err(got, want):
    import numpy as np

    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in want)


def _runner_fragments(env, weights, n, steps, seed=16, next_obs=False):
    """``n`` local EnvRunners' fragments of ``steps`` under ``weights``."""
    from ray_tpu_torch.rl.env_runner import EnvRunner

    out = []
    for i in range(n):
        r = EnvRunner(env, seed=seed, worker_index=i,
                      record_next_obs=next_obs)
        r.set_weights(weights, 0)
        out.append(r.sample(steps))
    return out


def _learner_cases(tmp):
    """(name, build(device) -> learner, update(learner, draws) -> metrics,
    weights(learner), draws(learner) or None, tolerances) of every new
    learner at its
    config's default width, on batches made here: CartPole runner
    fragments (replayed for DQN, aggregated for IMPALA and APPO, written
    as JSON for BC and MARWIL, windowed with the acting latents for
    DreamerV3), Pendulum's for SAC and CQL."""
    import numpy as np

    from ray_tpu_torch.rl import (BCConfig, CQLConfig, DQNConfig,
                                  DreamerV3Config, IMPALAConfig,
                                  MARWILConfig, SACConfig)
    from ray_tpu_torch.rl.appo import APPOConfig, APPOLearner
    from ray_tpu_torch.rl.cql import CQLLearner
    from ray_tpu_torch.rl.dqn import DQNLearner
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3Learner
    from ray_tpu_torch.rl.impala import Aggregator, IMPALALearner
    from ray_tpu_torch.rl.marwil import MARWIL
    from ray_tpu_torch.rl.module import init_policy_params
    from ray_tpu_torch.rl.offline import BC, collect, torch_to_np
    from ray_tpu_torch.rl.replay import (ReplayBuffer, SequenceReplay,
                                         transitions_from_fragment)
    from ray_tpu_torch.rl.sac import SACLearner

    params = init_policy_params(4, 2, hidden=(64, 64), seed=16)
    dev = lambda d: None if d.type == "cuda" else "cpu"  # noqa: E731
    cases = []

    # DQN: 64 transitions replayed from two runners' 256 steps each
    rb = ReplayBuffer(DQNConfig.replay_capacity, seed=16)
    for f in _runner_fragments("CartPole-v1", params, 2, 256, next_obs=True):
        rb.add_fragment(transitions_from_fragment(f))
    dqn_batch = rb.sample(DQNConfig.train_batch_size)
    tol = RL_ALGO_TOL
    cases.append(("dqn", lambda d: DQNLearner(
        params, lr=DQNConfig.lr, gamma=DQNConfig.gamma,
        target_update_freq=DQNConfig.target_update_freq, device=dev(d)),
        lambda lr, dr: lr.update(dqn_batch), lambda lr: lr.get_weights(),
        None, tol))

    # BC and MARWIL: 2048 steps written by collect(), one epoch of 256s
    path = os.path.join(tmp, "offline")
    collect("CartPole-v1", params, path, num_steps=2048, seed=16)
    for name, cfg_cls, cls in (("bc", BCConfig, BC),
                               ("marwil", MARWILConfig, MARWIL)):
        cases.append((name, lambda d, c=cfg_cls, k=cls: k(c(
            input_path=path, learner_device=dev(d))),
            lambda lr, dr: lr.train(),
            lambda lr: torch_to_np(lr.params), None, tol))

    # SAC and CQL: 256 Pendulum transitions, the CPU learner's draws
    sac_w = SACLearner(3, 1, device="cpu", action_scale=2.0).get_weights()
    rb = ReplayBuffer(SACConfig.replay_capacity, seed=16)
    for f in _runner_fragments("Pendulum-v1", sac_w, 2, 256, next_obs=True):
        rb.add_fragment(transitions_from_fragment(f))
    sac_batch = rb.sample(SACConfig.train_batch_size)
    for name, cls, extra in (
            ("sac", SACLearner, {}),
            ("cql", CQLLearner, dict(cql_alpha=CQLConfig.cql_alpha,
                                     cql_n_actions=CQLConfig.cql_n_actions))):
        def build(d, cls=cls, extra=extra):
            return cls(3, 1, hidden=SACConfig.hidden, action_scale=2.0,
                       device=dev(d), **extra)


        def weights(lr):
            s = lr.get_state()
            return {f"{p}/{k}": v for p in ("actor", "q1", "q2", "q1_target",
                                            "q2_target")
                    for k, v in s[p].items()}

        cases.append((name, build,
                      lambda lr, dr: lr.update(sac_batch, dr), weights,
                      lambda lr: lr.draws(len(sac_batch["obs"])), tol))

    # IMPALA and APPO: 4 fragments of 128 aggregated to 512
    agg = Aggregator(IMPALAConfig.train_batch_size)
    agg.add_fragment(_runner_fragments("CartPole-v1", params, 4, 128))
    imp_batch = agg.get_ready_batch()
    for name, cls, kw in (
            ("impala", IMPALALearner, IMPALAConfig().learner_kwargs()),
            ("appo", APPOLearner, APPOConfig().learner_kwargs())):
        kw = {k: v for k, v in kw.items() if k != "device"}
        cases.append((name, lambda d, cls=cls, kw=kw: cls(
            params, device=dev(d), **kw),
            lambda lr, dr: lr.update(imp_batch),
            lambda lr: lr.get_weights(), None, tol))

    # DreamerV3: (16, 16) windows of runner fragments acted on the RSSM
    # tower, with their recorded latents; the CPU learner's draws
    dcfg = DreamerV3Config(seed=16)
    probe = DreamerV3Learner(4, 2, dcfg, device="cpu")
    seq = SequenceReplay(dcfg.replay_capacity, dcfg.seq_len, seed=16)
    for f in _runner_fragments("CartPole-v1", probe.get_runner_weights(),
                               2, 256):
        seq.add_fragment(f)
    d_batch = seq.sample(dcfg.batch_size)

    cases.append(("dreamerv3", lambda d: DreamerV3Learner(
        4, 2, dcfg, device=dev(d)), lambda lr, dr: lr.update(d_batch, dr),
        lambda lr: lr.get_weights(),
        lambda lr: lr.draws(dcfg.batch_size, dcfg.seq_len),
        RL_DREAMER_TOL))
    return cases


def rl_learners_check(device):
    """Phase 16 (a): each new learner on ``device`` against the same
    learner on the CPU, from the same weights, batch and draws (made by
    the CPU learner, passed to both): one update, metrics and weights
    allclose within RL_ALGO_TOL (DreamerV3: RL_DREAMER_TOL), the ratios
    to it reported; then the card's own
    update (its draws from its generator): ms (mean of 3, synchronized),
    launches (kernels and copies) and their device ms a call."""
    import tempfile

    import torch

    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, build, update, weights, draws, tol in _learner_cases(tmp):
            on_dev, on_cpu = build(device), build(torch.device("cpu"))
            dr = None if draws is None else draws(on_cpu)
            m_cpu, m_dev = update(on_cpu, dr), update(on_dev, dr)
            w_dev, w_cpu = weights(on_dev), weights(on_cpu)
            rec = {"metrics_tol_ratio": _tol_ratio(m_dev, m_cpu, *tol[0]),
                   "weights_tol_ratio": _tol_ratio(w_dev, w_cpu, *tol[1]),
                   "metrics_rel_err": _metrics_rel(m_dev, m_cpu),
                   "metrics_abs_err": max(abs(m_dev[k] - m_cpu[k])
                                          for k in m_cpu),
                   "weights_rel_err": _rel_close(w_dev, w_cpu, 0),
                   "weights_abs_err": _abs_err(w_dev, w_cpu)}
            assert rec["metrics_tol_ratio"] <= 1.0, (name, rec)
            assert rec["weights_tol_ratio"] <= 1.0, (name, rec)
            if device.type == "cuda":
                # the card's own update: its draws from its generator
                def step(lr=on_dev, update=update, draws=draws):
                    return update(lr, None if draws is None else draws(lr))

                rec["update_ms"] = _synced_ms(step)
                rec["launches"], rec["device_ms"] = _device_profile(step)
            out[name] = rec
            log(f"[16] (a) {name} card vs CPU: " + json.dumps(rec))
    return out


def _greedy_return(weights, episodes=5, seed=100):
    """Mean return of the argmax policy of ``weights`` on the numpy
    CartPole env."""
    import numpy as np

    from ray_tpu_torch.rl.envs import CartPoleEnv
    from ray_tpu_torch.rl.module import np_forward

    env, returns = CartPoleEnv(seed=seed), []
    for ep in range(episodes):
        obs, _ = env.reset(seed=seed + ep)
        total, done = 0.0, False
        while not done:
            logits, _ = np_forward(weights, np.asarray(obs)[None])
            obs, r, term, trunc, _ = env.step(int(logits[0].argmax()))
            total += r
            done = term or trunc
        returns.append(total)
    return float(np.mean(returns))


def anakin_small_check(device):
    """Phase 16 (b), first part: one Anakin step at ANAKIN_SMALL on
    ``device`` against the CPU, from the same weights, reset uniforms and
    draws (made on the CPU): params, Adam's moments and metrics allclose
    within RL_ALGO_TOL, env state within RL_LEARNER_RTOL."""
    import torch

    from ray_tpu_torch.rl import PPOConfig
    from ray_tpu_torch.rl.envs import TorchCartPole
    from ray_tpu_torch.rl.learner import _tensors
    from ray_tpu_torch.rl.module import init_policy_params, torch_gumbel
    from ray_tpu_torch.rl.podracer import _build_anakin_step

    B, T = ANAKIN_SMALL
    c = PPOConfig()
    hyper = {"gamma": c.gamma, "lam": c.lam, "clip": c.clip,
             "vf_coeff": c.vf_coeff, "entropy_coeff": c.entropy_coeff,
             "num_epochs": 2, "lr": c.lr}
    step, opt = _build_anakin_step(TorchCartPole, T, hyper)
    params = init_policy_params(4, 2, hidden=c.hidden, seed=0)
    g = torch.Generator().manual_seed(0)
    u0 = torch.rand((B, 4), generator=g) * 0.1 - 0.05
    draws = {"act": torch_gumbel((T, B, 2), g, "cpu"),
             "env": torch.rand((T, B, 4), generator=g) * 0.1 - 0.05}
    outs = {}
    for d in (device, torch.device("cpu")):
        p = _tensors(params, d)
        env, obs = TorchCartPole.reset(u0.to(d), B)
        outs[d.type] = step(p, opt.init(p), env, obs,
                            {k: v.to(d) for k, v in draws.items()})
    got, want = outs[device.type], outs["cpu"]
    host = lambda t: {k: v.detach().cpu().numpy()  # noqa: E731
                      for k, v in t.items()}
    tol = RL_ALGO_TOL[1]
    m_got = {k: float(v) for k, v in got[4].items()}
    m_want = {k: float(v) for k, v in want[4].items()}
    rec = {"params_tol_ratio": _tol_ratio(host(got[0]), host(want[0]), *tol),
           "mu_tol_ratio": _tol_ratio(host(got[1]["mu"]),
                                      host(want[1]["mu"]), *tol),
           "metrics_tol_ratio": _tol_ratio(m_got, m_want, *tol),
           "params_rel_err": _rel_close(host(got[0]), host(want[0]), 0),
           "env_abs_err": float((got[2]["s"].cpu() - want[2]["s"])
                                .abs().max()),
           "metrics_rel_err": _metrics_rel(m_got, m_want)}
    log("[16] (b) Anakin (4, 8) card vs CPU: " + json.dumps(rec))
    assert max(rec["params_tol_ratio"], rec["mu_tol_ratio"],
               rec["metrics_tol_ratio"]) <= 1.0, rec
    assert rec["env_abs_err"] <= RL_LEARNER_RTOL, rec
    return rec


class _SyncChecked:
    """``fn`` run under ``torch.cuda.set_sync_debug_mode("error")``: any
    host sync inside raises."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        import torch

        torch.cuda.set_sync_debug_mode("error")
        try:
            self.calls += 1
            return self.fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def anakin_check(device, num_updates=ANAKIN_UPDATES, batch_envs=ANAKIN_ENVS):
    """Phase 16 (b), second part (under init(): the algorithm's one env
    runner stays idle): Anakin at ``batch_envs`` envs and PPOConfig's
    rollout_fragment_length, ``train(num_updates)`` on ``device`` with
    every device call of the loop (the draws and the step) under the
    sync debug mode "error", so a host sync inside train() raises; env
    steps/s, updates/s, launches and device ms an update (one more step,
    profiled) and the device's busy share,
    and the greedy return of the folded weights on the numpy CartPole
    env, which must exceed ANAKIN_MIN_RETURN."""
    from ray_tpu_torch.rl import PodracerConfig, PPOConfig

    dev_name = None if device.type == "cuda" else "cpu"
    algo = (PPOConfig(seed=0, learner_device=dev_name)
            .environment("CartPole-v1").env_runners(1).build())
    try:
        an = algo.scale_out(PodracerConfig(mode="anakin",
                                           batch_envs=batch_envs))
        if device.type == "cuda":
            an._step, an.draws = _SyncChecked(an._step), _SyncChecked(
                an.draws)
        res = an.train(num_updates)
        rec = {"batch_envs": batch_envs, "unroll": an._T,
               "updates": num_updates, "env_steps": res["env_steps"],
               "env_steps_per_s": res["env_steps_per_s"],
               "updates_per_s": res["learner_steps_per_s"],
               "metrics": res["metrics"], "device": str(an.device),
               "sync_checked_calls": getattr(an._step, "calls", 0)}
        if device.type == "cuda":
            step, draws = an._step.fn, an.draws.fn
            rec["launches_per_update"], rec["device_ms_per_update"] = \
                _device_profile(lambda: step(*an._carry, draws()))
            rec["device_busy_share"] = (rec["device_ms_per_update"]
                                        * rec["updates_per_s"] / 1e3)
        rec["greedy_return"] = _greedy_return(algo.get_weights())
    finally:
        algo.stop()
    log("[16] (b) Anakin at scale: " + json.dumps(rec))
    assert rec["greedy_return"] > ANAKIN_MIN_RETURN, rec
    return rec


def sebulba_check(rt, device):
    """Phase 16 (c): Sebulba with two CPU runners (two envs each) and the
    learner actor on ``device`` (``num_gpus=1`` on the card): lock-step
    for 3 updates, its weights within RL_LEARNER_RTOL of the synchronous
    PPO loop with its learner on ``device`` in this process; then
    free-running for SEBULBA_FREE_S: fragments/s, policy lag, updates/s;
    the GPU back after each stop()."""
    from ray_tpu_torch.rl import PodracerConfig, PPOConfig

    dev_name = None if device.type == "cuda" else "cpu"

    def build():
        return (PPOConfig(seed=1, learner_device=dev_name,
                          rollout_fragment_length=64, minibatch_size=128,
                          num_epochs=2)
                .environment("CartPole-v1").env_runners(2, 2).build())

    out = {}
    algo = build()
    try:
        h = algo.scale_out(PodracerConfig(mode="sebulba", num_runners=2,
                                          sync_weights=True))
        try:
            recs = h.wait_updates(3, timeout_s=180)
            out["gpu_during"] = rt.available_resources().get("GPU", 0.0)
        except BaseException:
            h.shutdown()
            raise
        s = h.stop(timeout_s=120)
        if device.type == "cuda":
            out["gpu_after_stop"] = _available_gpu(rt, 1.0)
        learner = s["learner"]
        produced = sum(r["fragments_produced"] for r in s["runners"].values())
        drops = sum(r["push_drops"] for r in s["runners"].values())
        out["lock_step"] = {
            "learner_device": h.learner_device, "version": learner["version"],
            "policy_lag": [r["policy_lag"] for r in recs],
            "produced": produced, "push_drops": drops,
            "consumed": learner["consumed"],
            "undelivered": s["queue"]["undelivered"]}
        oracle = build()
        try:
            for _ in range(learner["version"]):
                oracle.train()
            out["lock_step"]["weights_rel_err"] = _rel_close(
                algo.get_weights(), oracle.get_weights(), 0)
        finally:
            oracle.stop()
        log("[16] (c) Sebulba lock-step: " + json.dumps(out["lock_step"]))
        assert out["lock_step"]["weights_rel_err"] <= RL_LEARNER_RTOL, out
        assert produced - drops == learner["consumed"], out
        assert all(lag == 0 for lag in out["lock_step"]["policy_lag"]), out

        h = algo.scale_out(PodracerConfig(mode="sebulba", num_runners=2))
        try:
            recs = h.wait_updates(1, timeout_s=180)
            t0, first = time.perf_counter(), recs[-1]
            while time.perf_counter() - t0 < SEBULBA_FREE_S:
                recs += h.wait_updates(1, timeout_s=60)
            dt = time.perf_counter() - t0
        except BaseException:
            h.shutdown()
            raise
        last = recs[-1]
        s = h.stop(timeout_s=120)
        lags = [r["policy_lag"] for r in recs[1:]]
        out["free"] = {
            "seconds": dt, "updates": last["update"] - first["update"],
            "updates_per_s": (last["update"] - first["update"]) / dt,
            "fragments_per_s": (last["consumed"] - first["consumed"]) / dt,
            "env_steps_per_s": (last["env_steps"] - first["env_steps"]) / dt,
            "policy_lag_mean": sum(lags) / max(len(lags), 1),
            "policy_lag_max": max(lags, default=0),
            "queue_depth_last": last["queue_depth"],
            "learner_updates": s["learner"]["updates"],
            "broadcast_skips": s["learner"]["broadcast_skips"],
            "lag_dropped": s["learner"]["lag_dropped"]}
        if device.type == "cuda":
            out["gpu_after_free_stop"] = _available_gpu(rt, 1.0)
        log("[16] (c) Sebulba free-running: " + json.dumps(out["free"]))
    finally:
        algo.stop()
    if device.type == "cuda":
        assert out["lock_step"]["learner_device"] == "cuda", out
        assert out["gpu_during"] == 0.0, out
        assert out["gpu_after_stop"] == 1.0, out
        assert out["gpu_after_free_stop"] == 1.0, out
    assert out["free"]["updates"] > 0, out
    return out


def impala_check(device):
    """Phase 16 (d): IMPALA at tests/test_rl.py::TestIMPALA's settings
    with the learner on ``device``: the best return reaches IMPALA_TARGET
    within IMPALA_DEADLINE_S; ``num_updates`` reported."""
    from ray_tpu_torch.rl import IMPALAConfig

    algo = IMPALAConfig(
        seed=0, hidden=(32, 32), env="CartPole-v1", num_env_runners=2,
        rollout_fragment_length=128, train_batch_size=512, lr=1e-3,
        max_updates_per_step=6,
        learner_device=None if device.type == "cuda" else "cpu").build()
    best, returns, result = 0.0, [], {}
    t0 = time.perf_counter()
    try:
        for _ in range(40):
            result = algo.train()
            er = result["env_runners"]["episode_return_mean"]
            returns.append(er)
            if er == er:
                best = max(best, er)
            if best >= IMPALA_TARGET or (time.perf_counter() - t0
                                         > IMPALA_DEADLINE_S):
                break
    finally:
        algo.stop()
    learners = result["learners"]["default_policy"]
    rec = {"best": best, "returns": returns, "iterations": len(returns),
           "seconds": time.perf_counter() - t0,
           "num_updates": learners["num_updates"],
           "env_steps_trained": learners["num_env_steps_trained"],
           "env_steps_sampled": result["env_runners"][
               "num_env_steps_sampled"],
           "learner_device": str(algo.learner.device)}
    log("[16] (d) IMPALA, learner on the card: " + json.dumps(rec))
    assert best >= IMPALA_TARGET, rec
    assert learners["num_updates"] >= 5, rec
    return rec


def rl_algos_check(device, smi=""):
    """Phase 16: (a) the new learners card vs CPU; (b) Anakin (4, 8) card
    vs CPU, then at scale; (c) Sebulba with a GPU learner actor; (d)
    IMPALA learning CartPole. (b)'s second part, (c) and (d) under one
    fresh init(), with no process of the session left after shutdown()."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api

    out = {"nvidia_smi": smi}
    t = time.perf_counter()
    out["learners"] = rl_learners_check(device)
    out["learners_s"] = time.perf_counter() - t
    out["anakin_small"] = anakin_small_check(device)
    rt.init()
    session = api._head["session_dir"]
    try:
        t = time.perf_counter()
        out["anakin"] = anakin_check(device)
        out["anakin_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["sebulba"] = sebulba_check(rt, device)
        out["sebulba_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["impala"] = impala_check(device)
        out["impala_s"] = time.perf_counter() - t
    finally:
        rt.shutdown()
    out["left_after_shutdown"] = _wait_session_gone(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


# ------------------------------------------------------------- phase 17
# Data, batch LLM inference and Tune on the card, under one fresh init():
# (a) 1b_bench fed by a Dataset's CUDA batches; (b) a one-GPU Train gang
# reading its dataset shard; (c) 8b batch inference through an engine
# stage on a GPU lease; (d) Tune over a one-GPU trainer. Each GPU-leased
# actor reports its creation split from the stamps the runtime keeps: the
# raylet's spawn (RT_SPAWN_T), the factory's fork (RT_CHILD_T), the
# creation's arrival at the worker (RT_CREATE_T), then torch's import and
# the first CUDA call.

DATA_BLOCKS = 4          # phase 8's rows over this many blocks
DATA_STEPS = 5           # bench.run's timed steps (+ its warm-up): phase 8's
SHUFFLE_ROWS = 64        # (a)'s seeded shuffle: sequences of phase 8's length
GANG_STEPS = 3           # (b) and (d): f32 debug steps a worker takes
GANG_RTOL = 1e-5         # (b): the worker's losses against the driver's
TUNE_LRS = (1e-3, 3e-3)  # (d)'s grid
DEBUG_BATCH, DEBUG_SEQ = 4, 64   # phase 7's debug batch


def actor_start_split():
    """Inside a GPU-leased actor, at the top of its user code: seconds from
    the raylet's spawn to the factory's fork, from the fork to the
    creation's arrival (a pooled worker waits there for an actor), from
    the arrival to here, for torch's import (0 when something already
    loaded it) and for the first CUDA call."""
    import sys

    now = time.monotonic()
    spawn = float(os.environ.get("RT_SPAWN_T") or "nan")
    fork = float(os.environ.get("RT_CHILD_T") or "nan")
    create = float(os.environ.get("RT_CREATE_T") or "nan")
    had_torch = "torch" in sys.modules
    t = time.monotonic()
    import torch

    t_torch = time.monotonic()
    if torch.cuda.is_available():     # else the actor's device raises later
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    t_cuda = time.monotonic()
    return {"spawn_to_fork_s": fork - spawn, "fork_to_create_s": create - fork,
            "create_to_user_s": now - create,
            "torch_import_s": t_torch - t, "torch_loaded_before": had_torch,
            "first_cuda_s": t_cuda - t_torch,
            "create_to_cuda_s": t_cuda - create,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def _log_split(what, split):
    log(f"[17] {what} creation: spawn->fork {split['spawn_to_fork_s']:.3f} "
        f"s, fork->creation push {split['fork_to_create_s']:.3f} s (in the "
        f"pool), push->user code {split['create_to_user_s']:.3f} s, torch "
        f"import {split['torch_import_s']:.3f} s (loaded before: "
        f"{split['torch_loaded_before']}), first CUDA call "
        f"{split['first_cuda_s']:.3f} s; push->CUDA "
        f"{split['create_to_cuda_s']:.3f} s")


def phase8_tokens(device, model="1b_bench", batch=8, seq=2048, seed=0):
    """Phase 8's batch: bench.run draws it from one generator of the seed
    after the weights."""
    import torch

    from ray_tpu_torch import bench
    from ray_tpu_torch.models import llama

    cfg = bench.CONFIGS[model]
    gen = torch.Generator(device=device).manual_seed(seed)
    llama.init_params(cfg, gen, device)      # the weights' draws, dropped
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device, dtype=torch.int32).cpu().numpy()


def dataset_fed_run(model, batch, seq, steps, device, batches, seed=0):
    """``ray_tpu_torch.bench.run``'s training, one warm-up step and
    ``steps`` timed ones queued back to back, with each step's batch the
    next of ``batches`` (``iter_torch_batches``) in place of bench.run's
    fixed random one; the weights are bench.run's (drawn first from the
    seed's generator). Returns bench.run's losses, tokens/s and step ms,
    and the host's wait for each batch."""
    import torch

    from ray_tpu_torch import bench
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    cfg = bench.CONFIGS[model]
    opt = OptimizerConfig(warmup_steps=1, decay_steps=1000).make()
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(lambda g: llama.init_params(cfg, g, device),
                             opt, gen, device)
    step_fn = make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)
    waits = []

    def next_batch():
        t = time.perf_counter()
        b = next(batches)
        waits.append(1e3 * (time.perf_counter() - t))
        return b

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state, m = step_fn(state, next_batch())            # warm-up
    losses = [m["loss"]]
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, next_batch())
        losses.append(m["loss"])
    float(m["loss"])                                    # waits for every step
    dt = time.perf_counter() - t0
    out = {"losses": [float(x) for x in losses],
           "tokens_per_sec": batch * seq * steps / dt,
           "step_ms": 1e3 * dt / steps, "batch_wait_ms": waits}
    if device.type == "cuda":
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def dataset_train_check(device, phase8, model="1b_bench", batch=8, seq=2048,
                        steps=DATA_STEPS):
    """17 (a): phase 8's rows, repeated for each step, in a Dataset of
    DATA_BLOCKS blocks (batches cross block boundaries); bench.run's step
    takes its batches from ``iter_torch_batches(device)``
    (:func:`dataset_fed_run`). The first loss
    equals phase 8's bit for bit, the first four within UPDATED_RTOL (the
    bf16 backward's dQ order, as phase 12 holds them); K1 and
    flash_bwd_kernel launch as phase 8 counts them. Then the host-to-card
    ms of each batch (from next() to the batch on the card), and a seeded
    random_shuffle of SHUFFLE_ROWS sequences whose card batches hold the
    same bytes as the same pipeline's iter_batches on the host."""
    import numpy as np
    import torch

    from ray_tpu_torch import bench, data

    cfg = bench.CONFIGS[model]
    rows = phase8_tokens(device, model, batch, seq)
    n = steps + 1
    ds = data.from_numpy({"tokens": np.tile(rows, (n, 1))}).repartition(
        DATA_BLOCKS)
    out = {"rows": n * batch, "blocks": ds.num_blocks()}
    reset_flash_launches()
    res = dataset_fed_run(model, batch, seq, steps, device,
                          ds.iter_torch_batches(batch_size=batch,
                                                device=device))
    out["launches"] = flash_launches()
    out["losses"] = res["losses"]
    out["losses_phase8"] = phase8["losses"]
    out["tokens_per_s"] = res["tokens_per_sec"]
    out["tokens_per_s_phase8"] = phase8["tokens_per_sec"]
    out["step_ms"] = res["step_ms"]
    out["batch_wait_ms"] = res["batch_wait_ms"]
    out["first_loss_bit_equal_phase8"] = res["losses"][0] == \
        phase8["losses"][0]
    out["rel_err_vs_phase8"] = [abs(a - b) / abs(b) for a, b in
                                zip(res["losses"], phase8["losses"])]
    if device.type == "cuda":
        out["peak_memory_gb"] = res["peak_memory_gb"]
    del res
    L = cfg.n_layers
    want = {"fwd": (2 if cfg.remat else 1) * n * L, "bwd": n * L, "dq": 0,
            "dkv": 0}
    if device.type == "cuda":     # on the CPU the wrappers launch nothing
        assert out["launches"] == want, (out["launches"], want)
    assert out["first_loss_bit_equal_phase8"], out
    assert max(out["rel_err_vs_phase8"][:PHASE8_STEPS]) <= UPDATED_RTOL, out
    # the host-to-card time of each batch, synchronized
    h2d, it = [], ds.iter_torch_batches(batch_size=batch, device=device)
    while True:
        t = time.perf_counter()
        b = next(it, None)
        if b is None:
            break
        if device.type == "cuda":
            torch.cuda.synchronize()
        h2d.append(1e3 * (time.perf_counter() - t))
        assert b["tokens"].device.type == device.type
        assert np.array_equal(b["tokens"].cpu().numpy(), rows)
    out["h2d_ms"] = h2d
    out["h2d_bytes"] = int(rows.nbytes)
    # a seeded shuffle: the card's batches hold the host's bytes
    srows = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (SHUFFLE_ROWS, seq)).astype(np.int32)
    sds = data.from_numpy({"tokens": srows}).repartition(
        DATA_BLOCKS).random_shuffle(seed=17)
    card = [b["tokens"] for b in sds.iter_torch_batches(batch_size=batch,
                                                        device=device)]
    host = [b["tokens"] for b in sds.iter_batches(batch_size=batch)]
    out["shuffle_equal"] = (
        len(card) == len(host) == SHUFFLE_ROWS // batch and all(
            c.device.type == device.type
            and c.cpu().numpy().tobytes() == h.tobytes()
            for c, h in zip(card, host)))
    out["shuffle_moved_rows"] = not np.array_equal(np.concatenate(host),
                                                   srows)
    assert out["shuffle_equal"] and out["shuffle_moved_rows"], out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _debug_state(device, lr, seed=0):
    """The f32 debug Llama's weights (seeded on ``device``), optimizer and
    step, as phase 7 trains it."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.training import (OptimizerConfig,
                                               init_train_state,
                                               make_train_step)

    cfg = llama.CONFIGS["debug"]
    opt = OptimizerConfig(learning_rate=lr, warmup_steps=2,
                          decay_steps=20).make()
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(lambda g: llama.init_params(cfg, g, device),
                             opt, gen, device)
    return state, make_train_step(lambda p, b: llama.loss_fn(p, b, cfg), opt)


def gang_worker(config):
    """17 (b) and (d)'s ``train_loop_per_worker``: f32 debug steps on the
    worker's GPU (``device=None``: the card under its lease), its batches
    from its dataset shard's ``iter_torch_batches()`` when the trainer has
    datasets, else phase 7's seeded batch; losses, launches and the
    worker's creation split reported once."""
    split = actor_start_split()
    import numpy as np
    import torch

    from ray_tpu_torch import resolve_device, train

    device = resolve_device(config.get("device"))
    ctx = train.get_context()
    state, step = _debug_state(device, config["lr"])
    if config.get("from_dataset"):
        batches = ctx.get_dataset_shard("train").iter_torch_batches(
            batch_size=DEBUG_BATCH, device=config.get("device"))
    else:
        tokens = np.random.default_rng(0).integers(
            0, 256, (DEBUG_BATCH, DEBUG_SEQ)).astype(np.int32)
        batches = iter([{"tokens": torch.from_numpy(tokens).to(device)}]
                       * config["steps"])
    reset_flash_launches()
    losses, devices = [], []
    for _ in range(config["steps"]):
        b = next(batches)
        devices.append(str(b["tokens"].device))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    train.report({"loss": losses[-1], "losses": losses,
                  "launches": flash_launches(), "split": split,
                  "batch_devices": devices})


def gang_dataset_check(rt, device, use_gpu=True, worker_device=None):
    """17 (b): a JaxTrainer gang of one GPU worker with
    ``datasets={"train": ds}``; the worker reads
    ``get_dataset_shard("train").iter_torch_batches()`` on its card for
    GANG_STEPS f32 debug steps. Its losses equal the same step run here on
    the same rows within GANG_RTOL; K1 f32, K2a and K2b launch once per
    layer per step in the worker; the GPU comes back after the gang."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import data, train
    from ray_tpu_torch.models import llama

    rows = np.random.default_rng(3).integers(
        0, 256, (GANG_STEPS * DEBUG_BATCH, DEBUG_SEQ)).astype(np.int32)
    ds = data.from_numpy({"tokens": rows}).repartition(GANG_STEPS)
    root = tempfile.mkdtemp(prefix="rtt_gang_")
    out = {"gpu_before": _available_gpu(rt, 1.0)}
    try:
        t = time.perf_counter()
        res = train.JaxTrainer(
            gang_worker,
            train_loop_config={"lr": 1e-3, "steps": GANG_STEPS,
                               "from_dataset": True,
                               "device": worker_device},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=use_gpu),
            run_config=train.RunConfig(name="gang", storage_path=root),
            datasets={"train": ds}).fit(timeout_s=600)
        out["fit_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m = res.metrics
    out.update({k: m[k] for k in ("losses", "launches", "split",
                                  "batch_devices")})
    # the driver's run of the same step on the same rows
    state, step = _debug_state(device, 1e-3)
    want = []
    for k in range(GANG_STEPS):
        b = {"tokens": torch.from_numpy(
            rows[k * DEBUG_BATCH:(k + 1) * DEBUG_BATCH]).to(device)}
        state, mm = step(state, b)
        want.append(float(mm["loss"]))
    out["losses_driver"] = want
    out["rel_err"] = [abs(a - b) / abs(b) for a, b in zip(m["losses"], want)]
    n_layers = llama.CONFIGS["debug"].n_layers
    out["want_launches"] = {"fwd": GANG_STEPS * n_layers, "bwd": 0,
                            "dq": GANG_STEPS * n_layers,
                            "dkv": GANG_STEPS * n_layers}
    if use_gpu:
        out["gpu_after"] = _available_gpu(rt, out["gpu_before"])
        assert out["gpu_after"] == out["gpu_before"] == 1.0, out
        assert m["split"]["visible"] == "0", m["split"]
    if use_gpu and worker_device is None:     # the worker's card
        assert all(d.startswith("cuda") for d in m["batch_devices"]), m
        assert out["launches"] == out["want_launches"], out
    assert max(out["rel_err"]) <= GANG_RTOL, out
    return out


def _counted_engine_stage():
    """llm.batch's engine stage with the decode kernels' launches, the
    engine's decode steps and the stage's creation split added to its
    output rows (as one JSON string column); made here, in ``__main__``,
    so the pool actor gets it by value."""
    from ray_tpu_torch.llm.batch import _EngineStage

    class CountedEngineStage(_EngineStage):
        def __init__(self, cfg_blob):
            split = actor_start_split()
            t = time.monotonic()
            super().__init__(cfg_blob)
            split["engine_s"] = time.monotonic() - t
            split["create_to_ready_s"] = time.monotonic() - float(
                os.environ.get("RT_CREATE_T") or "nan")
            self._split = split
            # timed as phase 5's serve_check times its engine
            self._decode_s, self._prefill_s, self._finite = [], [], []
            eng = self.engine
            if eng.device.type == "cuda":
                eng._decode = watch(eng._decode, self._decode_s,
                                    self._finite)
                eng._prefill = watch(eng._prefill, self._prefill_s,
                                     self._finite)

        def __call__(self, batch):
            from ray_tpu_torch.ops.decode_attention import decode_attention
            from ray_tpu_torch.ops.paged_decode_attention import \
                paged_decode_attention

            paged_decode_attention.launches = 0
            decode_attention.launches = 0
            steps0 = self.engine.stats()["steps"]
            t = time.perf_counter()
            out = super().__call__(batch)
            info = {"call_s": time.perf_counter() - t,
                    "paged_decode_attention": paged_decode_attention.launches,
                    "decode_attention": decode_attention.launches,
                    "decode_steps": self.engine.stats()["steps"] - steps0,
                    "n_layers": self.engine.config.n_layers,
                    "device": str(self.engine.device), "split": self._split,
                    "rows": len(out["generated_tokens"]),
                    "decode_step_ms_mean": mean_ms(self._decode_s),
                    "prefill_ms": [1e3 * x for x in self._prefill_s],
                    "finite": all(self._finite)}
            out["stage_info"] = [json.dumps(info)] * info["rows"]
            return out

    return CountedEngineStage


def batch_inference_check(rt, prompts, max_tokens, want_outputs, rates,
                          model="8b", num_gpus=1, device=None, seed=0):
    """17 (c): phase 5's prompts in a Dataset through
    ``build_llm_processor(ProcessorConfig(model, num_gpus=1,
    concurrency=1, seed, phase 5's paged engine))``; the stage actor seeds
    the weights itself. Its greedy tokens equal ``want_outputs`` (phase
    5's paged tokens); K3 launches once per layer per decode step in the
    actor; rows/s and tokens/s of the stage's call beside ``rates``
    (phase 5's and phase 9's); the GPU comes back when the pool's actor
    goes."""
    from ray_tpu_torch import data, llm
    from ray_tpu_torch.llm import batch as batch_mod

    ds = data.from_items([{"prompt_tokens": list(p)} for p in prompts])
    cfg = llm.ProcessorConfig(
        model=model, num_gpus=num_gpus, concurrency=1, seed=seed,
        batch_size=len(prompts), num_slots=SERVE_ENGINE_KW["num_slots"],
        max_tokens=max_tokens, device=device,
        engine_kwargs={k: v for k, v in SERVE_ENGINE_KW.items()
                       if k != "num_slots"})
    stage = batch_mod._EngineStage
    batch_mod._EngineStage = _counted_engine_stage()
    try:
        processor = llm.build_llm_processor(cfg)
        out_ds = processor(ds)
    finally:
        batch_mod._EngineStage = stage
    t = time.perf_counter()
    rows = out_ds.take_all()
    wall = time.perf_counter() - t
    infos = {r["stage_info"] for r in rows}
    assert len(infos) == 1, infos      # one stage call over every row
    info = json.loads(infos.pop())
    outs = [list(map(int, r["generated_tokens"])) for r in rows]
    tokens = sum(len(o) for o in outs)
    out = {"rows": len(rows), "tokens": tokens, "wall_s": wall,
           "call_s": info["call_s"],
           "rows_per_s": len(rows) / info["call_s"],
           "tokens_per_s": tokens / info["call_s"],
           "rows_per_s_with_actor_start": len(rows) / wall, **rates,
           "launches": {k: info[k] for k in ("paged_decode_attention",
                                             "decode_attention")},
           "decode_steps": info["decode_steps"], "device": info["device"],
           "decode_step_ms_mean": info["decode_step_ms_mean"],
           "prefill_ms": info["prefill_ms"], "split": info["split"],
           "equal_to_phase_5": outs == want_outputs}
    assert out["equal_to_phase_5"], [first_divergence(a, b) for a, b in
                                     zip(outs, want_outputs)]
    assert info["finite"], "non-finite logits in the engine stage"
    out["gpu_after"] = _available_gpu(rt, 1.0)
    assert out["gpu_after"] == 1.0, out
    if info["device"].startswith("cuda"):   # the CPU launches nothing
        assert out["launches"]["paged_decode_attention"] == \
            info["decode_steps"] * info["n_layers"] > 0, info
        assert out["launches"]["decode_attention"] == 0, info
        assert info["split"]["visible"] == "0", info
    return out


def tune_check(rt, use_gpu=True, worker_device=None):
    """17 (d): ``Tuner(JaxTrainer(gang_worker, one GPU worker))`` over a
    TUNE_LRS grid, one trial at a time, GANG_STEPS f32 debug steps each:
    both trials finish, ``get_best_result`` is the lower final loss, each
    worker launched K1 f32, K2a and K2b once per layer per step, and the
    GPU comes back."""
    import shutil
    import tempfile

    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models import llama

    root = tempfile.mkdtemp(prefix="rtt_tune_")
    out = {"gpu_before": _available_gpu(rt, 1.0)}
    try:
        trainer = train.JaxTrainer(
            gang_worker,
            train_loop_config={"steps": GANG_STEPS, "device": worker_device},
            scaling_config=train.ScalingConfig(num_workers=1,
                                               use_gpu=use_gpu),
            run_config=train.RunConfig(name="tuned", storage_path=root))
        t = time.perf_counter()
        grid = tune.Tuner(
            trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1),
        ).fit(timeout_s=600)
        out["fit_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["errors"] = [r.error for r in grid]
    assert out["errors"] == [None] * len(TUNE_LRS), out["errors"]
    out["trials"] = [{"lr": r.config["lr"], "losses": r.metrics["losses"],
                      "launches": r.metrics["launches"],
                      "split": r.metrics["split"]} for r in grid]
    best = grid.get_best_result()
    out["best_lr"] = best.config["lr"]
    low = min(out["trials"], key=lambda r: r["losses"][-1])
    assert best.config["lr"] == low["lr"] and \
        best.metrics["loss"] == low["losses"][-1], out
    n_layers = llama.CONFIGS["debug"].n_layers
    per_trial = {"fwd": GANG_STEPS * n_layers, "bwd": 0,
                 "dq": GANG_STEPS * n_layers, "dkv": GANG_STEPS * n_layers}
    out["launches"] = {k: sum(r["launches"][k] for r in out["trials"])
                       for k in per_trial}
    if use_gpu:
        for r in out["trials"]:
            assert r["split"]["visible"] == "0", r
            if worker_device is None:         # the workers' card
                assert r["launches"] == per_trial, (r, per_trial)
        out["gpu_after"] = _available_gpu(rt, out["gpu_before"])
        assert out["gpu_after"] == out["gpu_before"] == 1.0, out
    return out


def data_library_check(device, phase8, prompts, max_tokens, want_outputs,
                       rates, smi=""):
    """Phase 17: the card's inventory of the Data dependencies, then (a)
    to (d) under one fresh init(); no process of the session after
    shutdown()."""
    import importlib

    import ray_tpu_torch as rt
    from ray_tpu_torch import api

    inventory = {}
    for mod in ("pyarrow", "pandas", "PIL", "optuna"):
        try:
            inventory[mod] = importlib.import_module(mod).__version__
        except ImportError as e:
            inventory[mod] = f"ImportError: {e}"
    log(f"[17] inventory: {json.dumps(inventory)} | {smi}")
    out = {"inventory": inventory, "nvidia_smi": smi}
    import pyarrow  # noqa: F401 — Data's blocks are Arrow tables

    rt.init()
    session = api._head["session_dir"]
    try:
        t = time.perf_counter()
        out["dataset_train"] = dataset_train_check(device, phase8)
        out["dataset_train_s"] = time.perf_counter() - t
        log("[17] (a) 1b_bench from a Dataset's CUDA batches: " + json.dumps(
            out["dataset_train"]) + f" | {smi}")
        t = time.perf_counter()
        out["gang"] = gang_dataset_check(rt, device)
        out["gang_s"] = time.perf_counter() - t
        _log_split("(b) Train worker", out["gang"]["split"])
        log("[17] (b) gang with datasets=: " + json.dumps(
            {k: v for k, v in out["gang"].items() if k != "split"}))
        t = time.perf_counter()
        out["batch_llm"] = batch_inference_check(rt, prompts, max_tokens,
                                                 want_outputs, rates)
        out["batch_llm_s"] = time.perf_counter() - t
        _log_split("(c) 8b engine stage", out["batch_llm"]["split"])
        log("[17] (c) 8b batch inference: " + json.dumps(
            {k: v for k, v in out["batch_llm"].items() if k != "split"})
            + f" | {smi}")
        t = time.perf_counter()
        out["tune"] = tune_check(rt)
        out["tune_s"] = time.perf_counter() - t
        for r in out["tune"]["trials"]:
            _log_split(f"(d) trial lr={r['lr']} worker", r["split"])
        log("[17] (d) Tune over the trainer: " + json.dumps(
            {k: v for k, v in out["tune"].items() if k != "trials"}))
        log("[17] seconds: " + json.dumps({k: out[k] for k in (
            "dataset_train_s", "gang_s", "batch_llm_s", "tune_s")}))
    finally:
        rt.shutdown()
    out["left_after_shutdown"] = _wait_session_gone(session)
    assert out["left_after_shutdown"] == [], out["left_after_shutdown"]
    return out


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
    report["ptxas"] = {
        kernel_label(name): res for src in _build.sources()
        for name, res in _build.kernel_resources(
            _build.LOGS.get(src, "")).items()}
    log("[2] ptxas (registers, spill stores/loads in bytes): " + json.dumps(
        report["ptxas"]))

    # 3. kernels against their plain versions
    log("[3] kernels vs plain versions (B=8 H=32 KV=8 D=128 bs=64 MBS=32, "
        "S=2048; K4 also at D=64, the 1b draft's)")
    report["kernels"] = kernel_checks(device)
    assert_kernels(report["kernels"])

    # 4. debug engine: card == CPU
    report["debug"] = {}
    for case in DEBUG_CASES:
        report["debug"][case] = debug_engine_check(device, case)
        log(f"[4] debug {case}: " + json.dumps(report["debug"][case]))
    report["debug"]["pd"] = debug_pd_check(device)
    log("[4] debug pd: " + json.dumps(report["debug"]["pd"]))

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
        assert_decode_launches(res, kv, cfg)
        report["serve"][kv] = res
        log(f"[5] 8b {kv}: " + json.dumps(
            {k: v for k, v in res.items() if k != "outputs"}))
    same = report["serve"]["paged"]["outputs"] == \
        report["serve"]["slot"]["outputs"]
    log(f"[5] 8b paged and slot outputs identical: {same}")
    report["serve_paged_equals_slot"] = same
    report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # 5b. chunked prefill, the radix prefix cache and PD, same weights
    t = time.perf_counter()
    kvm = report["kv"] = {}
    kvm["layer"] = chunk_layer_check(params, cfg)
    log("[5b] 8b chunked prefill (chunks of 256) vs the whole prompt's "
        f"prefill, rows within {KV_ROW_RTOL} of their norm: "
        + json.dumps(kvm["layer"]))
    want_chunks = sum(-(-n // 256) for n in plens if n > 256)
    for kv in ("paged", "slot"):
        res = serve_check(params, cfg, kv, prompts, max_tokens=32,
                          prefill_chunk=256)
        assert_decode_launches(res, kv, cfg)
        assert res["prefill_chunks_run"] == want_chunks, (
            res["prefill_chunks_run"], want_chunks)
        # a report, not a gate: bf16 ties can flip a greedy token
        res["first_divergence_from_unchunked"] = [
            first_divergence(a, b) for a, b in
            zip(res["outputs"], report["serve"][kv]["outputs"])]
        kvm[f"chunked_{kv}"] = res
        log(f"[5b] 8b {kv}, prefill_chunk=256: " + json.dumps(
            {k: v for k, v in res.items() if k != "outputs"}))
    kvm["radix"] = radix_check(params, cfg)
    log("[5b] 8b radix prefix cache: " + json.dumps(kvm["radix"]))
    kvm["pd"] = pd_check(params, cfg, prompts[1])
    log("[5b] 8b PD handoff: " + json.dumps(kvm["pd"]))
    report["kv_s"] = time.perf_counter() - t
    log(f"[5b] phase time {report['kv_s']:.1f} s")

    # 5c. speculative decoding, same weights
    t = time.perf_counter()
    sp = report["spec"] = {}
    # the rows are held in f32 (phase 5's weights cast up: rounding stays
    # far below the allowance); bf16's excess is reported beside its floor
    import dataclasses

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = cast_params(params, torch.float32)
    sp["layer_f32"] = verify_layer_check(params32, cfg32)
    del params32
    torch.cuda.empty_cache()
    log("[5c] 8b f32 verify vs sequential decode steps, rows within "
        f"{KV_ROW_RTOL} of their norm: " + json.dumps(sp["layer_f32"]))
    sp["layer_bf16"] = verify_layer_check(params, cfg, gate=False)
    log("[5c] 8b bf16 verify vs sequential decode steps (reported), and "
        "the floor, K4 vs its plain version in the same steps: "
        + json.dumps(sp["layer_bf16"]))
    draft_layers = {"ngram": 0, "self_draft": cfg.n_layers,
                    "draft_1b": llama.CONFIGS["1b"].n_layers}
    for name, spec in (
            ("ngram", {"method": "ngram", "k": 4}),
            ("self_draft", {"method": "draft", "k": 4, "draft_config": cfg,
                            "draft_params": params}),
            ("draft_1b", {"method": "draft", "k": 4, "draft_model": "1b"})):
        res = serve_check(params, cfg, "slot", prompts, max_tokens=32,
                          speculation=spec)
        assert_spec_launches(res, cfg, draft_layers[name])
        # a draft always proposes; the n-gram lookup only where the output
        # repeats a bigram of its context, which the random target's
        # greedy output may never do (then every iteration is a plain
        # step, which the launch count above holds; phase 4 gates ngram's
        # proposals on the card)
        assert res["spec_proposed"] > 0 or name == "ngram", (
            name, res["spec_proposed"])
        assert (res["verify_steps"] > 0) == (res["spec_proposed"] > 0), res
        # a report, not a gate: bf16 ties can flip a greedy token
        res["first_divergence_from_plain"] = [
            first_divergence(a, b) for a, b in
            zip(res["outputs"], report["serve"]["slot"]["outputs"])]
        sp[name] = res
        log(f"[5c] 8b slot, speculation {name}: " + json.dumps(
            {k: v for k, v in res.items() if k != "outputs"}))
    sp["temperature"] = temperature_check(params, cfg,
                                          [prompts[0], prompts[2]])
    log("[5c] 8b ngram at temperature 0.8, two engines of one seed: "
        + json.dumps(sp["temperature"]))
    report["spec_s"] = time.perf_counter() - t
    log(f"[5c] phase time {report['spec_s']:.1f} s")
    # phase 11's weights: these, cut to PIPE_LAYERS layers, on the host
    cfg4 = dataclasses.replace(cfg, n_layers=PIPE_LAYERS, remat=False)
    params4 = {k: ({n: w[:PIPE_LAYERS].cpu() for n, w in v.items()}
                   if k == "layers" else v.cpu())
               for k, v in params.items()}
    del params
    torch.cuda.empty_cache()

    # 6. flash kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    log("[6] flash kernels vs plain versions (row by row: "
        "||got_r - want_r|| <= rtol ||want_r|| + atol rms_r)")
    report["flash"] = flash_checks(device)
    report["flash_grad"] = flash_grad_check(device)
    log("[6] bf16 training-path attention and gradients vs the plain "
        "versions: " + json.dumps(report["flash_grad"]))
    assert_within("flash_attention_with_lse bf16 gradients",
                  report["flash_grad"])
    torch.cuda.empty_cache()

    # 7. debug training: card == CPU
    report["debug_train"] = debug_train_check(device)
    log("[7] debug train: " + json.dumps(report["debug_train"]))

    # 8. 1b_bench trained on the card: the training path's run
    report["train"] = train_1b_check(device)
    log("[8] 1b_bench train: " + json.dumps(report["train"]))

    # 8b. the debug MoE and ViT: card == CPU
    t = time.perf_counter()
    report["family_debug"] = family_debug_checks(device)
    log("[8b] debug MoE and ViT, card == CPU: "
        + json.dumps(report["family_debug"]))

    # 8c. 8x7b at full width, depth cut
    report["train_moe"] = train_moe_check(device)
    log(f"[8c] 8x7b ({MOE_LAYERS} layers) train: "
        + json.dumps(report["train_moe"]))

    # 8d. ViT-B/16 at full size
    report["train_vit"] = train_vit_check(device)
    log("[8d] ViT-B16 train: " + json.dumps(report["train_vit"]))

    # 8e. 1b_bench under remat "dots" against "nothing"
    report["remat_dots"] = remat_dots_check(device)
    log("[8e] 1b_bench remat dots vs nothing: "
        + json.dumps(report["remat_dots"]))
    report["families_s"] = time.perf_counter() - t
    log(f"[8b-8e] phase time {report['families_s']:.1f} s")

    # 9. the runtime: a GPU task, phase 5's requests served at 8b from a GPU
    # actor, a device object between two half-GPU actors
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["runtime"] = runtime_check(
        prompts, 32, report["serve"]["paged"]["outputs"],
        {k: report["serve"]["paged"][k] for k in (
            "tokens_per_s", "decode_step_ms_mean", "prefill_ms_mean",
            "decode_steps")})
    report["runtime_s"] = time.perf_counter() - t
    log("[9] runtime: " + json.dumps(
        {k: report["runtime"][k] for k in (
            "init_s", "cluster_resources", "cuda_in_factory",
            "gpu_after_kills", "left_after_shutdown")}))
    log(f"[9] phase time {report['runtime_s']:.1f} s")

    # 10. Serve: phase 5's requests through the HTTP proxy (whole and SSE)
    # and a handle, from a num_gpus=1 replica; the PD app on two half-GPU
    # replicas
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["serve_lib"] = serve_library_check(
        prompts, 32, report["serve"]["paged"]["outputs"],
        {"phase_5_tokens_per_s": report["serve"]["paged"]["tokens_per_s"],
         "phase_9_actor_tokens_per_s":
             report["runtime"]["serve"]["tokens_per_s"]})
    report["serve_lib_s"] = time.perf_counter() - t
    log(f"[10] phase time {report['serve_lib_s']:.1f} s")

    # 11. compiled graphs: the device channel between two half-GPU actors,
    # then 8b (phase 5's weights, PIPE_LAYERS layers) as a two-stage
    # pipeline of GPU actors over device channels
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["graph"] = graph_check(params4, cfg4, device)
    del params4
    report["graph_s"] = time.perf_counter() - t
    log(f"[11] phase time {report['graph_s']:.1f} s")

    # 12. Train: a GPU worker trains 1b_bench on a mesh of one rank, with
    # checkpoints and a failure restart, then the sp_axis path
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["train_lib"] = train_library_check(report["train"]["losses"],
                                              smi=smi)
    report["train_lib_s"] = time.perf_counter() - t
    log(f"[12] phase time {report['train_lib_s']:.1f} s")

    # 13. the NCCL group at world 1 (exact and quantized), then 1b trained
    # as two GPU pipeline stages under a fresh init()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["coll_pipe"] = collectives_pipeline_check(device, smi=smi)
    report["coll_pipe_s"] = time.perf_counter() - t
    log(f"[13] phase time {report['coll_pipe_s']:.1f} s")

    # 14. the MoE's expert axis: 8c's 8x7b on a mesh of one rank, then the
    # sp_axis path
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["moe_mesh"] = moe_mesh_check(device, report["train_moe"],
                                        smi=smi)
    report["moe_mesh_s"] = time.perf_counter() - t
    log(f"[14] {smi}: phase time {report['moe_mesh_s']:.1f} s")

    # 15. RL: the PPO learner on the card against the CPU, PPO learning
    # CartPole, a num_gpus=1 learner actor
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["rl"] = rl_check(device, smi=smi)
    report["rl_s"] = time.perf_counter() - t
    log(f"[15] {smi}: phase time {report['rl_s']:.1f} s")

    # 16. RL beyond PPO: the new learners card vs CPU, Anakin, Sebulba
    # with a GPU learner actor, IMPALA learning CartPole
    torch.cuda.empty_cache()
    t = time.perf_counter()
    report["rl_algos"] = rl_algos_check(device, smi=smi)
    report["rl_algos_s"] = time.perf_counter() - t
    log(f"[16] {smi}: phase time {report['rl_algos_s']:.1f} s")

    # 17. Data, batch LLM inference and Tune under a fresh init(): 1b_bench
    # from a Dataset's CUDA batches, a one-GPU gang fed by datasets=, 8b
    # batch inference on a GPU lease, Tune over a one-GPU trainer
    torch.cuda.empty_cache()
    t = time.perf_counter()
    p5 = report["serve"]["paged"]
    report["data_lib"] = data_library_check(
        device, report["train"], prompts, 32, p5["outputs"],
        {"phase_5_tokens_per_s": p5["tokens_per_s"],
         "phase_5_rows_per_s": p5["requests"] / p5["wall_s"],
         "phase_9_actor_tokens_per_s":
             report["runtime"]["serve"]["tokens_per_s"],
         "phase_9_actor_start_s": report["runtime"]["actor_start_s"]},
        smi=smi)
    report["data_lib_s"] = time.perf_counter() - t
    log(f"[17] {smi}: phase time {report['data_lib_s']:.1f} s")

    # 18. the kernels line and the result line
    k = report["kernels"]
    lines = []
    for name, kind_, src_kernel, replaces in (
            ("paged_decode_attention_kernel", "paged",
             "paged_decode_attention",
             "ray_tpu/ops/pallas/paged_decode_attention.py:97"),
            ("decode_attention_kernel", "slot", "decode_attention",
             "ray_tpu/ops/pallas/decode_attention.py:90")):
        rec = k[kind_]["bfloat16"]
        # each run read around itself, in its own process: phase 5's
        # engine; phase 9's 8b actor (K3) and GPU task (K4); phase 10's
        # Serve replica (a)-(c) and the PD decode replica; phase 17 (c)'s
        # engine stage; K4 also phase 5c's speculative engines' plain
        # steps and every draft step
        by_path = {
            "5_serve": report["serve"][kind_]["launches"][src_kernel],
            "9_actor": report["runtime"]["serve"]["launches"][src_kernel],
            "10_replica": report["serve_lib"]["replica"]["launches"][
                src_kernel],
            "10_pd_decode": report["serve_lib"]["pd"]["decode_replica"][
                "launches"][src_kernel],
            "17_batch_stage": report["data_lib"]["batch_llm"]["launches"][
                src_kernel]}
        extra = {}
        if kind_ == "slot":
            by_path.update({f"5c_{n}": report["spec"][n]["launches"][
                src_kernel] for n in ("ngram", "self_draft", "draft_1b")})
            by_path["9_task"] = report["runtime"]["k4_task"]["launches"]
            extra["d64"] = k["slot_d64"]
        main_run = sum(by_path.values())
        extra["launches_by_path"] = by_path
        lines.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/decode_attention.cu",
            "replaces": replaces, "launches": main_run,
            "max_abs_err": max(k[kind_][d]["max_abs_err"]
                               for d in ("bfloat16", "float32")),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "dtype": "bfloat16",
            "float32": k[kind_]["float32"], **extra})
    fl = report["flash"]["1b_bench"]
    # launches: every training path's run, each read around itself; bf16:
    # phases 8 (1b_bench), 8c (8x7b), 8d (ViT-B16), 8e (1b_bench under
    # both remat policies), 11-14, 17 (a); f32: phases 7 (debug Llama), 8b
    # (debug MoE and ViT) and 17 (b), (d)
    paths = {"bfloat16": {
        "1b_bench": report["train"]["launches"],
        "8x7b": report["train_moe"]["launches"],
        "vit_b16": report["train_vit"]["launches"],
        "1b_bench_nothing": report["remat_dots"]["nothing"]["launches"],
        "1b_bench_dots": report["remat_dots"]["dots"]["launches"],
        # phase 11: K1 in the two stage processes, each read around (b)
        # and (c) in its own process
        "8b_pipeline": {"fwd": sum(c["k1"] for c in report["graph"][
            "pipeline"]["stages"]), "bwd": 0, "dq": 0, "dkv": 0},
        # phase 12: the Train worker's (a) and (b), read in its process
        "1b_bench_train_gang": report["train_lib"]["launches"],
        "1b_bench_sp_axis": report["train_lib"]["sp_launches"],
        # phase 13 (b): both pipeline stages, each read in its process
        "1b_pipeline": report["coll_pipe"]["pipeline"]["launches"],
        # phase 14: 8x7b on the mesh, then its sp_axis path
        "8x7b_mesh": report["moe_mesh"]["mesh"]["launches"],
        "8x7b_mesh_sp_axis": report["moe_mesh"]["sp_axis"]["launches"],
        # phase 17 (a): bench.run fed by the Dataset, in this process
        "1b_bench_dataset": report["data_lib"]["dataset_train"]["launches"]},
        "float32": {
        "debug_llama": report["debug_train"]["launches"],
        "debug_moe": report["family_debug"]["moe"]["launches"],
        "debug_vit": report["family_debug"]["vit"]["launches"],
        # phase 17 (b): the gang's worker; (d): both trials' workers, each
        # read in its own process
        "debug_llama_gang": report["data_lib"]["gang"]["launches"],
        "debug_llama_tune": report["data_lib"]["tune"]["launches"]}}
    for name, kern, dname, replaces in (
            ("flash_fwd_kernel", "fwd", "bfloat16",
             "ray_tpu/ops/pallas/flash_attention.py:90"),
            ("flash_fwd_f32_kernel", "fwd", "float32",
             "ray_tpu/ops/pallas/flash_attention.py:90"),
            ("flash_bwd_kernel", "bwd", "bfloat16",
             "ray_tpu/ops/pallas/flash_attention.py:273"),
            ("flash_bwd_dq_kernel", "dq", "float32",
             "ray_tpu/ops/pallas/flash_attention.py:326"),
            ("flash_bwd_dkv_kernel", "dkv", "float32",
             "ray_tpu/ops/pallas/flash_attention.py:363")):
        parts = {"fwd": ("out", "lse"), "bwd": ("dq", "dk", "dv"),
                 "dq": ("dq",), "dkv": ("dk", "dv")}[kern]
        by_path = {path: n[kern] for path, n in paths[dname].items()}
        rec = {
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "max_abs_err": max(fl[dname]["errors"][p]["max_abs_err"]
                               for p in parts),
            **{key: fl[dname][kern][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "dtype": dname, "shape": fl[dname]["shape"],
            "launches_by_path": by_path,
            # the same kernel at the other paths' shapes (phase 6)
            "at_shapes": {case: {
                "shape": report["flash"][case][dname]["shape"],
                "max_abs_err": max(
                    report["flash"][case][dname]["errors"][p]["max_abs_err"]
                    for p in parts),
                **{key: report["flash"][case][dname][kern][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
                for case in report["flash"] if case != "1b_bench"}}
        lines.append(rec)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": lines}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the bf16 flash backward goes, on one CUDA card.

    python3 scripts/flash_bwd_ablation.py

Writes copies of ``ray_tpu_torch/csrc/flash_attention.cu`` into a
temporary directory, each with one part of ``flash_bwd_kernel`` removed or
done another way (``VARIANTS``: text replacements, as
``flash_mutation_check.py`` plants its faults), builds them all with nvcc
at once, and times ``flash_bwd_launch`` alone (the f32 dq workspace zeroed
once, outside the timing) at the 1b_bench shapes (B=8, Hq=32, Hkv=8,
S=2048, D=64, causal) and at D=128 with B=2, each variant twice, in the
order unchanged, variants, variants reversed, unchanged. A variant that
drops work gives wrong results: its time says what that work costs. The
variants that compute the same function ("same" below) are also held to
the plain backward at the first shape. Prints one JSON object; needs one
CUDA card and nvcc.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "ray_tpu_torch", "csrc", "flash_attention.cu")
CASES = [("1b_bench", 8, 32, 8, 2048, 64), ("d128", 2, 32, 8, 2048, 128)]
ITERS = 20

def _indent(block: str, n: int) -> str:
    return "".join((" " * n + line if line.strip() and line[0] != "#"
                    else line) for line in block.splitlines(True))


_PATCH = _indent('''if (lane < 16) bulk_wait_read();
__syncwarp();
#pragma unroll
for (int j = 0; j < DQN / 8; ++j) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    *reinterpret_cast<float2*>(patch + (g + 8 * i) * DQL + 8 * j + 2 * t) =
        make_float2(dqa[4 * j + 2 * i] * scale,
                    dqa[4 * j + 2 * i + 1] * scale);
  }
}
fence_proxy_async();
__syncwarp();
const int row = 16 * w + lane;               // of the q tile
if (lane < 16 && q0 + row < Sq) {
  bulk_reduce_add_f32(
      dq_acc + (head_of(it) * Sq + q0 + row) * D + dc0,
      patch + lane * DQL, DQN * 4);
  bulk_commit();
}
''', 4)
_ATOMICS = _indent('''float* dqt = dq_acc + (head_of(it) * Sq + q0) * D + dc0;
#pragma unroll
for (int j = 0; j < DQN / 8; ++j) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 16 * w + g + 8 * (e >> 1);
    if (q0 + r < Sq) {
      atomicAdd(dqt + static_cast<size_t>(r) * D + 8 * j + 2 * t + (e & 1),
                dqa[4 * j + e] * scale);
    }
  }
}
''', 4)
_DQ_START = "    // dS^T (kv rows, q columns) to shared memory for dQ = dS K: a"
_DQ_END = "    reg_fence<DQN / 2>(dqa);\n"
_DQ_KEEP = ("    wgmma_wait<0>();\n    reg_fence<D / 2>(gv);\n"
            "    reg_fence<D / 2>(gk);\n")
_GRID = "  const dim3 grid(s.B * s.Hkv, (s.Skv + C::BKV - 1) / C::BKV);"

VARIANTS = {  # name: (computes the same function, [(text, replacement)])
    # each dQ element added with its own atomicAdd, no patch, no bulk op
    "atomics": (True, [(_PATCH, _ATOMICS)]),
    # the blocks of one kv head side by side (kv tile fastest): better L2
    # locality, but the causal tiles' unequal work ends in a long last wave
    "kv_tile_fastest": (True, [
        ("  const int bkv = blockIdx.x, k0 = blockIdx.y * BKV;",
         "  const int bkv = blockIdx.y, k0 = blockIdx.x * BKV;"),
        (_GRID, "  const dim3 grid((s.Skv + C::BKV - 1) / C::BKV, s.B * s.Hkv);")]),
    # causal, a block takes kv tile x and its mirror nkv - 1 - x (equal
    # work per block), the blocks of one kv head side by side
    "paired": (True, [
        ("  const int bkv = blockIdx.x, k0 = blockIdx.y * BKV;\n",
         "  const int bkv = blockIdx.y;\n"
         "  const int nkv = (Skv + BKV - 1) / BKV, x = blockIdx.x;\n"
         "  const int n_tiles = causal && 2 * x + 1 != nkv ? 2 : 1;\n"
         "  for (int pass = 0; pass < n_tiles; ++pass) {\n"
         "  const int k0 = (pass ? nkv - 1 - x : x) * BKV;\n"
         "  if (pass) __syncthreads();\n"),
        ("  cp_async_wait_all();\n  if (lane < 16) bulk_wait();\n",
         "  cp_async_wait_all();\n"),
        ("        *reinterpret_cast<uint32_t*>(dv + o) = "
         "pack_bf16(gv[idx], gv[idx + 1]);\n      }\n    }\n  }\n}\n",
         "        *reinterpret_cast<uint32_t*>(dv + o) = "
         "pack_bf16(gv[idx], gv[idx + 1]);\n      }\n    }\n  }\n  }\n"
         "  if (lane < 16) bulk_wait();\n}\n"),
        (_GRID, "  const int nkv = (s.Skv + C::BKV - 1) / C::BKV;\n"
                "  const dim3 grid(causal ? (nkv + 1) / 2 : nkv, s.B * s.Hkv);")]),
    # the dQ patch written, no bulk reduce-add
    "no_dq_reduce": (False, [(
        "      bulk_reduce_add_f32(\n"
        "          dq_acc + (head_of(it) * Sq + q0 + row) * D + dc0,\n"
        "          patch + lane * DQL, DQN * 4);\n", "")]),
    # no dS^T store, barrier, dQ product, patch or reduce-add
    "no_dq": (False, [(None, None), (_PATCH, "")]),
    # no dK product (one of the five)
    "no_dk": (False, [(_indent('''#pragma unroll
for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
  for (int h = 0; h < D / DN; ++h) {
    Wgmma<DN>::template rs<1>(gk + h * DN / 2, da[kk],
                     desc_mn<D>(cQ + core_off<D>(16 * kk, h * DN)), 1);
  }
}
''', 4), "")]),
    # Q, dO, lse and delta loaded for the first two pairs only
    "no_loads": (False, [(
        "    if (it + 1 < n_iter) stage_pair(it + 1);",
        "    if (it + 1 < n_iter && it < 1) stage_pair(it + 1);")]),
    # exp2 and the masks dropped (P^T = the scaled score)
    "no_exp": (False, [(
        "        float p = fast_exp2(fmaf(st[4 * j + e], sl2, "
        "-kLog2e * cL[c]));\n        if (edge) {",
        "        float p = fmaf(st[4 * j + e], sl2, -kLog2e * cL[c]);\n"
        "        if (false) {")]),
}


def variant_text(text: str, reps) -> str:
    for old, new in reps:
        if old is None:       # no_dq: up to the dQ product's wait, kept
            a = text.index(_DQ_START)
            b = text.index(_DQ_END) + len(_DQ_END)
            text = text[:a] + _DQ_KEEP + text[b:]
            continue
        assert text.count(old) == 1, old[:60]
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(SOURCE) as f:
        text = f.read()
    tmp = tempfile.mkdtemp(prefix="flash_bwd_ablation_")
    try:
        procs = {}
        for name, (_, reps) in [("unchanged", (True, []))] + list(
                VARIANTS.items()):
            src = os.path.join(tmp, f"{name}.cu")
            with open(src, "w") as f:
                f.write(variant_text(text, reps))
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(tmp, f"lib{name}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        fns = {}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
            fn = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")) \
                .flash_bwd_launch
            fn.restype = ctypes.c_int
            fn.argtypes = fa.ARGTYPES["flash_bwd_launch"]
            fns[name] = fn
        report = {"device": smi, "ms": {}, "excess": {}}
        dev = torch.device("cuda")
        for case, B, Hq, Hkv, S, D in CASES:
            gen = torch.Generator(device=dev).manual_seed(0)

            def rand(*shape):
                return torch.randn(*shape, generator=gen,
                                   device=dev).bfloat16()

            q, k, v, do = (rand(B, Hq, S, D), rand(B, Hkv, S, D),
                           rand(B, Hkv, S, D), rand(B, Hq, S, D))
            kw = dict(causal=True, scale=D ** -0.5)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            delta = (do.float() * out.float()).sum(-1)
            ws = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            dk, dv = torch.empty_like(k), torch.empty_like(v)

            def launch(fn, acc):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        *fa._shape_args(q, k), float(kw["scale"]), 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"flash_bwd_launch: cudaError {rc}")

            if case == CASES[0][0]:
                want = fa.flash_attention_bwd_reference(q, k, v, lse, delta,
                                                        do, **kw)
                for name, fn in fns.items():
                    if name != "unchanged" and not VARIANTS[name][0]:
                        continue
                    acc = torch.zeros_like(ws)
                    launch(fn, acc)
                    torch.cuda.synchronize()
                    got = (acc.to(q.dtype), dk.clone(), dv.clone())
                    report["excess"][name] = max(
                        fa.mismatch(a, b)["excess"] for a, b in zip(got,
                                                                    want))
                del want
            times = {name: [] for name in fns}
            order = list(fns)[1:]
            for name in ["unchanged"] + order + order[::-1] + ["unchanged"]:
                fn = fns[name]
                launch(fn, ws)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(ITERS):
                    launch(fn, ws)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / ITERS)
            report["ms"][case] = times
            print(case, json.dumps(times), file=sys.stderr, flush=True)
            del q, k, v, do, out, lse, delta, ws, dk, dv
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of the bf16 flash forward (K1) goes, on one CUDA card.

    python3 scripts/flash_fwd_ablation.py

Writes copies of ``ray_tpu_torch/csrc/flash_attention.cu`` into a
temporary directory, each with one part of the bf16 forward removed or
done another way (``VARIANTS``: text replacements, as
``flash_bwd_ablation.py`` and ``flash_mutation_check.py`` do), builds them
all with nvcc at once, and times ``flash_fwd_launch`` alone at the
1b_bench shapes (B=8, Hq=32, Hkv=8, S=2048, D=64, causal) and at D=128
with B=2, each variant twice, in the order unchanged, variants, variants
reversed, unchanged, beside the library yardstick
(``F.scaled_dot_product_attention``, timed here only). A variant that
drops work gives wrong results: its time says what that work costs. The
variants that compute the same function ("same" below) are held to the
plain forward at both shapes. Prints one JSON object with each variant's
times and its registers and spills (ptxas); needs one CUDA card and nvcc.
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

_PV = '''    if (it > 0) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < D / DN; ++h) {
          Wgmma<DN>::template rs<1>(o + h * DN / 2, pa[kk],
                                    swz_desc_mn<D, BKV>(pV, kk, h), 1);
        }
      }
    }
'''

VARIANTS = {  # name: (computes the same function, [(text, replacement)])
    # 128 kv rows a tile at every D (one block an SM at D = 64)
    "bkv128": (True, [("BKV = D < 128 ? 64 : 128, NT = 256;",
                       "BKV = 128, NT = 256;")]),
    # a ring of four stages below D = 128: tiles load two iterations ahead
    "four_stages": (True, [(
        "static constexpr int STAGES = 3, AHEAD = STAGES - 2;",
        "static constexpr int STAGES = D < 128 ? 4 : 3, AHEAD = STAGES - 2;")]),
    # no block barrier: stages freed by mbarriers (both warpgroups' P V
    # done), and the two warpgroups take turns issuing their products
    # (FlashAttention-3's ping-pong), so one's softmax runs during the
    # other's products
    "pingpong": (True, [
        ("__device__ __forceinline__ void mbar_expect_tx(",
         "__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {\n"
         "  asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\"\n"
         "               ::\"r\"(smem_u32(bar)) : \"memory\");\n}\n"
         "__device__ __forceinline__ void mbar_expect_tx("),
        ("  __shared__ uint64_t full[ST + 1];",
         "  __shared__ uint64_t full[ST + 1], empty[ST], turn[2];"),
        ("    const int st = it % ST;\n    mbar_expect_tx",
         "    const int st = it % ST;\n"
         "    if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);\n"
         "    mbar_expect_tx"),
        ("    for (int i = 0; i <= ST; ++i) mbar_init(&full[i], 1);",
         "    for (int i = 0; i <= ST; ++i) mbar_init(&full[i], 1);\n"
         "    for (int i = 0; i < ST; ++i) mbar_init(&empty[i], 8);\n"
         "    mbar_init(&turn[0], 4);\n    mbar_init(&turn[1], 4);"),
        ("    __syncthreads();             // tile it - 2 is done: its stage "
         "is free\n",
         ""),
        ("    mbar_wait(&full[it % ST], (it / ST) & 1);   // tile it landed\n",
         "    mbar_wait(&full[it % ST], (it / ST) & 1);   // tile it landed\n"
         "    if (wg == 1 || it > 0) {\n"
         "      mbar_wait(&turn[wg], (wg == 0 ? it - 1 : it) & 1);\n    }\n"),
        (_PV + "    wgmma_commit();\n",
         _PV + "    wgmma_commit();\n"
         "    if (lane == 0) mbar_arrive(&turn[1 - wg]);\n"),
        ("    reg_fence<D / 2>(o);\n#pragma unroll\n"
         "    for (int i = 0; i < D / 2; ++i) o[i] *= alpha",
         "    reg_fence<D / 2>(o);\n"
         "    if (lane == 0 && it > 0) mbar_arrive(&empty[(it - 1) % ST]);\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < D / 2; ++i) o[i] *= alpha"),
    ]),
    # K and V loaded for the first tiles only
    "no_loads": (False, [
        ("    if (it >= n_kv) return;", "    if (it >= n_kv || it > AHEAD) return;"),
        ("    mbar_wait(&full[it % ST], (it / ST) & 1);",
         "    if (it <= AHEAD) mbar_wait(&full[it % ST], (it / ST) & 1);")]),
    # exp2 and the masks dropped (P = the scaled score)
    "no_exp": (False, [(
        "        const float p = fast_exp2(fmaf(s[4 * j + e], sl2, "
        "-base[e >> 1]));",
        "        const float p = fmaf(s[4 * j + e], sl2, -base[e >> 1]);"),
        ("        if (edge) {\n          const int col = k0 + 8 * j",
         "        if (false) {\n          const int col = k0 + 8 * j")]),
    # no P V product inside the loop
    "no_pv": (False, [(_PV, "")]),
}


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from flash_bwd_ablation import variant_text
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(SOURCE) as f:
        text = f.read()
    tmp = tempfile.mkdtemp(prefix="flash_fwd_ablation_")
    report = {"device": smi, "ms": {}, "excess": {}, "ptxas": {}}
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
            report["ptxas"][name] = {
                chip_smoke.kernel_label(k): v
                for k, v in _build.kernel_resources(out).items()
                if "flash_fwd_kernelI" in k}
            fn = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")) \
                .flash_fwd_launch
            fn.restype = ctypes.c_int
            fn.argtypes = fa.ARGTYPES["flash_fwd_launch"]
            fns[name] = fn
        dev = torch.device("cuda")
        for case, B, Hq, Hkv, S, D in CASES:
            gen = torch.Generator(device=dev).manual_seed(0)

            def rand(*shape):
                return torch.randn(*shape, generator=gen,
                                   device=dev).bfloat16()

            q, k, v = rand(B, Hq, S, D), rand(B, Hkv, S, D), rand(B, Hkv, S, D)
            out = torch.empty_like(q)
            lse = torch.empty(B, Hq, S, dtype=torch.float32, device=dev)
            scale = D ** -0.5

            def launch(fn):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, S, S, D,
                        scale, 1, 1, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"flash_fwd_launch: cudaError {rc}")

            want = fa.flash_attention_fwd_reference(q, k, v, causal=True,
                                                    scale=scale)
            for name, fn in fns.items():
                if name != "unchanged" and not VARIANTS[name][0]:
                    continue
                launch(fn)
                torch.cuda.synchronize()
                report["excess"].setdefault(case, {})[name] = max(
                    fa.mismatch(out, want[0])["excess"],
                    fa.mismatch(lse, want[1])["excess"])
            del want
            timed = {name: lambda fn=fn: launch(fn)
                     for name, fn in fns.items()}
            timed["library"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale, enable_gqa=True)
            times = {name: [] for name in timed}
            order = list(timed)[1:]
            for name in ["unchanged"] + order + order[::-1] + ["unchanged"]:
                f = timed[name]
                f()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(ITERS):
                    f()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end) / ITERS)
            report["ms"][case] = times
            print(case, json.dumps(times), file=sys.stderr, flush=True)
            del q, k, v, out, lse
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

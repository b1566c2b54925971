#!/usr/bin/env python3
"""Where the time of the f32 flash backward goes, on one CUDA card.

    python3 scripts/flash_bwd_f32_ablation.py

As ``flash_bwd_ablation.py`` does for the bf16 kernel: writes copies of
``ray_tpu_torch/csrc/flash_attention.cu`` into a temporary directory, each
with one part of ``flash_bwd_dq_kernel`` (K2a) and
``flash_bwd_dkv_kernel`` (K2b) removed or done another way (``VARIANTS``:
text replacements), builds them all with nvcc at once, and times each
kernel alone through its launch function at the 1b_bench shapes (B=8,
Hq=32, Hkv=8, S=2048, D=64, causal) and at D=128 with B=2, each variant
twice, in the order unchanged, variants, variants reversed, unchanged. A
variant that drops work gives wrong results: its time says what that work
costs. Prints one JSON object; needs one CUDA card and nvcc.
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
ITERS = 10

VARIANTS = {  # name: [(text, replacement)], in both kernels where it says
    # exp2 and the masks dropped (P = the scaled score)
    "no_exp": [
        ("        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[i]));\n"
         "        if (edge) {",
         "        float p = fmaf(s[i][j], sl2, -lse2[i]);\n"
         "        if (false) {"),
        ("        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[j]));\n"
         "        if (edge) {",
         "        float p = fmaf(s[i][j], sl2, -lse2[j]);\n"
         "        if (false) {")],
    # tiles loaded for the first two steps only
    "no_loads": [
        ("    if (t + 1 < n_kv) {", "    if (t + 1 < n_kv && t < 1) {"),
        ("    if (it + 1 < n_iter) {\n      stage_pair(it + 1, st ^ 1);",
         "    if (it + 1 < n_iter && it < 1) {\n"
         "      stage_pair(it + 1, st ^ 1);")],
    # no products from P or dS (dQ += dS K; dV += P^T dO, dK += dS^T Q)
    "no_second_products": [
        ("    mm_nn_f32<D, LDS, LD>(sdS, cK, ty, tx, acc);\n", ""),
        ("    mm_nn_f32<D, LDP, LD>(sP, cdO, ty, tx, av);\n", ""),
        ("    mm_nn_f32<D, LDP, LD>(sdS, cQ, ty, tx, ak);\n", "")],
    # K2a with one block an SM (dS in a tile of its own): the same function
    "dq_one_block_an_sm": [
        ("  static constexpr bool DQ_ALIAS = D >= 64;",
         "  static constexpr bool DQ_ALIAS = false;"),
        ("  static constexpr int DQ_BLOCKS = D < 128 ? 2 : 1;",
         "  static constexpr int DQ_BLOCKS = 1;")],
}


def variant_text(text: str, reps) -> str:
    for old, new in reps:
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
    tmp = tempfile.mkdtemp(prefix="flash_bwd_f32_ablation_")
    try:
        procs = {}
        for name, reps in [("unchanged", [])] + list(VARIANTS.items()):
            src = os.path.join(tmp, f"{name}.cu")
            with open(src, "w") as f:
                f.write(variant_text(text, reps))
            procs[name] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                 os.path.join(tmp, f"lib{name}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        libs = {}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
            lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
            for fn_name in ("flash_bwd_dq_launch", "flash_bwd_dkv_launch"):
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = fa.ARGTYPES[fn_name]
            libs[name] = lib
        report = {"device": smi, "ms": {}}
        dev = torch.device("cuda")
        for case, B, Hq, Hkv, S, D in CASES:
            gen = torch.Generator(device=dev).manual_seed(0)

            def rand(*shape):
                return torch.randn(*shape, generator=gen, device=dev)

            q, k, v, do = (rand(B, Hq, S, D), rand(B, Hkv, S, D),
                           rand(B, Hkv, S, D), rand(B, Hq, S, D))
            kw = dict(causal=True, scale=D ** -0.5)
            out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
            delta = (do * out).sum(-1)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr())
            tail = (*fa._shape_args(q, k), float(kw["scale"]), 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            calls = {
                "dq": lambda lib: lib.flash_bwd_dq_launch(
                    *head, dq.data_ptr(), *tail),
                "dkv": lambda lib: lib.flash_bwd_dkv_launch(
                    *head, dk.data_ptr(), dv.data_ptr(), *tail)}
            order = list(libs)[1:]
            times = {}
            for kern, call in calls.items():
                times[kern] = {name: [] for name in libs}
                for name in ["unchanged"] + order + order[::-1] \
                        + ["unchanged"]:
                    if call(libs[name]):
                        raise RuntimeError(f"{kern} launch failed: {name}")
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(ITERS):
                        call(libs[name])
                    end.record()
                    end.synchronize()
                    times[kern][name].append(start.elapsed_time(end) / ITERS)
            report["ms"][case] = times
            print(case, json.dumps(times), file=sys.stderr, flush=True)
            del q, k, v, do, out, lse, delta, dq, dk, dv, calls
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

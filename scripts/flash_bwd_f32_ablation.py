#!/usr/bin/env python3
"""Where the time of the f32 flash kernels goes, on one CUDA card: the
backward (K2a, K2b) and the forward (K1 in f32).

    python3 scripts/flash_bwd_f32_ablation.py

As ``flash_bwd_ablation.py`` does for the bf16 kernel: writes copies of
``ray_tpu_torch/csrc/flash_attention.cu`` into a temporary directory, each
with one part of ``flash_bwd_dq_kernel`` (K2a) and
``flash_bwd_dkv_kernel`` (K2b), or of ``flash_fwd_f32_kernel``, removed or
done another way (``VARIANTS``: text replacements), builds them all with
nvcc at once, and times each kernel alone through its launch function at
the 1b_bench shapes (B=8, Hq=32, Hkv=8, S=2048, D=64, causal) and at
D=128 with B=2, the unchanged copy and the variants of that kernel twice
each, in the order unchanged, variants, variants reversed, unchanged. A
variant that drops work gives wrong results: its time says what that work
costs. The variants that compute the same function are held to the plain
version under ``ops/flash_attention.py``'s tolerance. Prints one JSON
object with the times, those checks and each variant's registers and
spills (ptxas); needs one CUDA card and nvcc.
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

_FWD_MAX = """    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = half_warp_max(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
    }
"""
_FWD_SUM = """  float sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] = half_warp_sum(l[i]);
"""


def _rows_by_smem(op, src, dst):
    """Code that sets ``dst`` to ``op`` over the 16 threads of each row of
    ``src``, with the backward's lanes (4 rows x 8 columns a warp): three
    shuffles, then the halves of the two warps through shared memory and a
    block barrier."""
    return f"""#pragma unroll
  for (int i = 0; i < 4; ++i) {{
    float x = {src};
    x = {op.format("x", "__shfl_xor_sync(0xffffffffu, x, 1)")};
    x = {op.format("x", "__shfl_xor_sync(0xffffffffu, x, 2)")};
    x = {op.format("x", "__shfl_xor_sync(0xffffffffu, x, 4)")};
    if ((lane & 7) == 0) red[2 * (ty + 16 * i) + (warp & 1)] = x;
  }}
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {{
    {dst} = {op.format("red[2 * (ty + 16 * i)]", "red[2 * (ty + 16 * i) + 1]")};
  }}
"""


KERNELS = {"bwd": ("dq", "dkv"), "fwd": ("fwd",)}
VARIANTS = {  # name: (kernels, [(text, replacement)], same function)
    # exp2 and the masks dropped (P = the scaled score), in both kernels
    "no_exp": ("bwd", [
        ("        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[i]));\n"
         "        if (edge) {",
         "        float p = fmaf(s[i][j], sl2, -lse2[i]);\n"
         "        if (false) {"),
        ("        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[j]));\n"
         "        if (edge) {",
         "        float p = fmaf(s[i][j], sl2, -lse2[j]);\n"
         "        if (false) {")], False),
    # tiles loaded for the first two steps only
    "no_loads": ("bwd", [
        ("    if (t + 1 < n_kv) {", "    if (t + 1 < n_kv && t < 1) {"),
        ("    if (it + 1 < n_iter) {\n      stage_pair(it + 1, st ^ 1);",
         "    if (it + 1 < n_iter && it < 1) {\n"
         "      stage_pair(it + 1, st ^ 1);")], False),
    # no products from P or dS (dQ += dS K; dV += P^T dO, dK += dS^T Q)
    "no_second_products": ("bwd", [
        ("    mm_nn_f32<D, LDS, LD>(sdS, cK, ty, tx, acc);\n", ""),
        ("    mm_nn_f32<D, LDP, LD>(sP, cdO, ty, tx, av);\n", ""),
        ("    mm_nn_f32<D, LDP, LD>(sdS, cQ, ty, tx, ak);\n", "")], False),
    # K2a with one block an SM (dS in a tile of its own): the same function
    "dq_one_block_an_sm": ("bwd", [
        ("  static constexpr bool DQ_ALIAS = D >= 64;",
         "  static constexpr bool DQ_ALIAS = false;"),
        ("  static constexpr int DQ_BLOCKS = D < 128 ? 2 : 1;",
         "  static constexpr int DQ_BLOCKS = 1;")], True),
    # the forward's exp2 and masks dropped (P = the scaled score)
    "fwd_no_exp": ("fwd", [
        ("        const float p = fast_exp2(fmaf(s[i][j], sl2, -m_new));",
         "        const float p = fmaf(s[i][j], sl2, -m_new);"),
        ("    if ((causal && k0 + T - 1 > q0) || k0 + T > Skv) {",
         "    if (false) {")], False),
    # K and V loaded for the first two tiles only
    "fwd_no_loads": ("fwd", [("    if (kt + 1 < n_kt) {",
                              "    if (kt + 1 < n_kt && kt < 1) {")], False),
    # no O += P V
    "fwd_no_pv": ("fwd", [
        ("    mm_nn_f32<D, LDP, LD>(sP, cV, ty, tx, acc);\n", "")], False),
    # one block an SM: shared memory padded to 120 KB, registers up to 255
    "fwd_one_block_an_sm": ("fwd", [
        ("  static constexpr int FWD_BLOCKS = D < 128 ? 2 : 1;",
         "  static constexpr int FWD_BLOCKS = 1;"),
        ("  static constexpr size_t fwd_smem = (5 * TILE + T * LDP_FWD) * "
         "sizeof(float);",
         "  static constexpr size_t fwd_smem =\n"
         "      (5 * TILE + T * LDP_FWD) * sizeof(float) < 120 * 1024\n"
         "          ? 120 * 1024 : (5 * TILE + T * LDP_FWD) * sizeof(float);")],
     True),
    # the backward's lanes, 4 rows x 8 columns a warp: K and V float4 loads
    # take one shared wavefront, and each row's max and sum cross two warps
    # (shared memory and a block barrier per tile; P read by other warps)
    "fwd_lanes_4x8": ("fwd", [
        ("  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);",
         "  const int tx = (warp & 1) * 8 + (lane & 7),\n"
         "            ty = (warp >> 1) * 4 + (lane >> 3);\n"
         "  __shared__ float red[2 * T];"),
        ("  static constexpr int LDP_FWD = T + 16;",
         "  static constexpr int LDP_FWD = T + 8;"),
        (_FWD_MAX, "    float mx[4];\n" + _rows_by_smem(
            "fmaxf({}, {})",
            "fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]))",
            "mx[i]")),
        ("    __syncwarp();                                // this warp's rows"
         " of P",
         "    __syncthreads();"),
        (_FWD_SUM, "  float sum[4];\n"
         + _rows_by_smem("{} + {}", "l[i]", "sum[i]"))], True),
}


def variant_text(text: str, reps) -> str:
    for old, new in reps:
        assert text.count(old) == 1, old[:60]
        text = text.replace(old, new)
    return text


def build(text: str, tmp: str):
    """nvcc of the unchanged source and of every variant, all at once →
    {name: (library, ptxas report)}."""
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    procs = {}
    for name, (_, reps, _) in [("unchanged", (None, [], True))] + list(
            VARIANTS.items()):
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
        for fn_name in ("flash_fwd_launch", "flash_bwd_dq_launch",
                        "flash_bwd_dkv_launch"):
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = fa.ARGTYPES[fn_name]
        libs[name] = (lib, out)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    with open(SOURCE) as f:
        text = f.read()
    tmp = tempfile.mkdtemp(prefix="flash_bwd_f32_ablation_")
    report = {"device": smi, "ms": {}, "excess": {}, "ptxas": {}}
    try:
        libs = build(text, tmp)
        for name, (_, log) in libs.items():
            report["ptxas"][name] = {
                chip_smoke.kernel_label(k): v
                for k, v in _build.kernel_resources(log).items()
                if "f32_kernel" in k or "bwd_d" in k}
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
            dq, dk, dv, o, ls = (torch.empty_like(t)
                                 for t in (q, k, v, out, lse))
            head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr())
            tail = (*fa._shape_args(q, k), float(kw["scale"]), 1, 0,
                    torch.cuda.current_stream().cuda_stream)
            calls = {
                "fwd": lambda lib: lib.flash_fwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    ls.data_ptr(), *tail),
                "dq": lambda lib: lib.flash_bwd_dq_launch(
                    *head, dq.data_ptr(), *tail),
                "dkv": lambda lib: lib.flash_bwd_dkv_launch(
                    *head, dk.data_ptr(), dv.data_ptr(), *tail)}
            want = {"fwd": (out, lse),
                    "dq": (fa.bwd_dq_reference(q, k, v, lse, delta, do,
                                               **kw),),
                    "dkv": fa.bwd_dkv_reference(q, k, v, lse, delta, do,
                                                **kw)}
            got = {"fwd": (o, ls), "dq": (dq,), "dkv": (dk, dv)}
            times, excess = {}, {}
            for kern, call in calls.items():
                names = ["unchanged"] + [
                    n for n, (group, _, _) in VARIANTS.items()
                    if kern in KERNELS[group]]
                for name in names:
                    if name != "unchanged" and not VARIANTS[name][2]:
                        continue
                    if call(libs[name][0]):
                        raise RuntimeError(f"{kern} launch failed: {name}")
                    torch.cuda.synchronize()
                    excess.setdefault(kern, {})[name] = max(
                        fa.mismatch(g, w)["excess"]
                        for g, w in zip(got[kern], want[kern]))
                times[kern] = {name: [] for name in names}
                order = names[1:]
                for name in ["unchanged"] + order + order[::-1] \
                        + ["unchanged"]:
                    if call(libs[name][0]):
                        raise RuntimeError(f"{kern} launch failed: {name}")
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(ITERS):
                        call(libs[name][0])
                    end.record()
                    end.synchronize()
                    times[kern][name].append(start.elapsed_time(end) / ITERS)
            report["ms"][case] = times
            report["excess"][case] = excess
            print(case, json.dumps(times), json.dumps(excess),
                  file=sys.stderr, flush=True)
            del q, k, v, do, out, lse, delta, dq, dk, dv, o, ls, calls, want
            del got
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Do the kernel checks of chip_smoke.py catch a wrong kernel?

    python3 scripts/flash_mutation_check.py

Copies ``ray_tpu_torch`` into a temporary directory once unchanged and
once per mutant in ``MUTANTS``, each planting one fault in
``csrc/flash_attention.cu`` (the bf16 path training runs, K1 and the one
backward kernel ``flash_bwd_kernel``, or the f32 kernels that f32
training runs, ``flash_fwd_f32_kernel`` and the backward K2a/K2b) or in
the decode kernels of ``csrc/decode_attention.cu`` (K3 and K4, the paths
serving runs), builds every copy with nvcc (all started together), and
runs each copy, one process at a time, through four checks of
chip_smoke.py:

- ``kernels``: ``flash_compare`` in bf16, K1 and the backward against their
  plain versions at the 1b_bench shapes (B=8, Hq=32, Hkv=8, S=2048, D=64,
  causal), the inputs of phase 6;
- ``kernels_f32``: the same in f32 (``flash_fwd_f32_kernel``, K2a, K2b);
- ``grads``: ``flash_grad_check``, the training path's attention gradients
  against autograd through the plain forward;
- ``decode``: ``kernel_checks``, phase 3, K3 and K4 against their plain
  versions at the 8b decode shapes.

Each result's ``excess`` is its error over its allowance (at most 1 within
tolerance). Prints one JSON object, each result's mismatch per copy, and
exits 1 unless the unchanged copy passes every check and every mutant
fails one by more than ``CAUGHT_BY`` times its allowance. Needs one CUDA
card and nvcc; writes only under its temporary directory.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLASH = os.path.join("ray_tpu_torch", "csrc", "flash_attention.cu")
DECODE = os.path.join("ray_tpu_torch", "csrc", "decode_attention.cu")

CAUGHT_BY = 10.0
# a mutant's text may need std::is_same, which the source does not include
WITH_TRAITS = ("#include <stdint.h>\n",
               "#include <stdint.h>\n#include <type_traits>\n")

MUTANTS = {  # name: (source, [(its text, the replacement), ...])
    # K1 drops the diagonal kv tile for every q tile from row 1024 on
    "fwd_skips_diagonal_tile_past_row_1024": (FLASH, [(
        "  const int n_kv = (kv_end + BKV - 1) / BKV;\n",
        "  const int n_kv = (kv_end + BKV - 1) / BKV - (causal && q0 >= 1024);\n"
    )]),
    # K1 does not rescale warpgroup 1's accumulators when the max grows
    "fwd_skips_alpha_rescale_in_warpgroup_1": (FLASH, [(
        "    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];",
        "    for (int i = 0; i < D / 2; ++i)\n"
        "      o[i] *= wg == 1 ? 1.f : alpha[(i >> 1) & 1];")]),
    # the backward zeroes dS of warpgroup 1's kv rows in the last q tile
    "bwd_zeroes_ds_of_warpgroup_1_in_last_q_tile": (FLASH, [(
        "        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - cDl[c]);",
        "        dpt[4 * j + e] = (wg == 1 && qt == nqt - 1)\n"
        "            ? 0.f : st[4 * j + e] * (dpt[4 * j + e] - cDl[c]);")]),
    # the backward skips the last q tile of the last member of each group
    "bwd_skips_last_q_tile_of_one_group_member": (FLASH, [(
        "    const int qt = q_first + it % nq, q0 = qt * BQ;\n",
        "    const int qt = q_first + it % nq, q0 = qt * BQ;\n"
        "    if (it == n_iter - 1) continue;\n")]),
    # the backward drops one dQ reduce-add: one row half of the last pair
    # of the first kv tile of each kv head
    "bwd_drops_one_dq_reduce_add": (FLASH, [(
        "    if (lane < 16 && q0 + row < Sq) {",
        "    if (lane < 16 && q0 + row < Sq\n"
        "        && !(k0 == 0 && it == n_iter - 1 && tid == 0)) {")]),
    # the f32 forward leaves row 3 of every thread's micro-tile out of the
    # rescale of O when the running max grows
    "f32_fwd_skips_rescale_in_one_micro_tile_row": (FLASH, [(
        "      for (int n = 0; n < D / 16; ++n) acc[i][n] *= alpha;",
        "      for (int n = 0; n < D / 16; ++n)\n"
        "        acc[i][n] *= i == 3 ? 1.f : alpha;")]),
    # f32 K2a leaves column 3 of every thread's micro-tile out of dS
    "f32_dq_skips_one_micro_tile_column": (FLASH, [(
        "        sdS[(ty + 16 * i) * LDS + tx + 16 * j] = p * (dp[i][j] - dl[i]);",
        "        sdS[(ty + 16 * i) * LDS + tx + 16 * j] =\n"
        "            j == 3 ? 0.f : p * (dp[i][j] - dl[i]);")]),
    # f32 K2b sums dK and dV over all GQA members but the last
    "f32_dkv_drops_last_group_member": (FLASH, [(
        "  const int n_iter = group * max(nqe, 0);",
        "  const int n_iter = (group - 1) * max(nqe, 0);")]),
    # K3's combine leaves out the last split's partial
    "paged_drops_last_split_partial": (DECODE, [WITH_TRAITS, (
        "    for (int t = 1; t < n_live; ++t) {",
        "    for (int t = 1; t < n_live - std::is_same<Rows, PagedRows>::value;"
        " ++t) {")]),
    # K4's combine leaves out the last split's partial
    "slot_drops_last_split_partial": (DECODE, [WITH_TRAITS, (
        "    for (int t = 1; t < n_live; ++t) {",
        "    for (int t = 1; t < n_live - std::is_same<Rows, SlotRows>::value;"
        " ++t) {")]),
}


def child(root: str) -> None:
    """Run the four checks on the copy of ray_tpu_torch under ``root``."""
    sys.path[:0] = [root, HERE]
    import torch

    import chip_smoke
    import ray_tpu_torch

    assert ray_tpu_torch.__file__.startswith(root), ray_tpu_torch.__file__
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for check, dt in (("kernels", torch.bfloat16),
                      ("kernels_f32", torch.float32)):
        res[check], _ = chip_smoke.flash_compare(
            *chip_smoke.flash_inputs(device, dt, 8, 32, 8, 2048, 64),
            causal=True)
        torch.cuda.empty_cache()
    res["grads"] = chip_smoke.flash_grad_check(device)
    torch.cuda.empty_cache()
    recs = chip_smoke.kernel_checks(device)
    res["decode"] = {f"{kind}_{name}": {key: r[key] for key in (
        "ok", "excess", "max_abs_err", "equal_runs", "zero_slot_max")}
        for kind in ("paged", "slot") for name, r in recs[kind].items()}
    print(json.dumps(res))


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="flash_mutants_")
    try:
        roots = {}
        for name in ["unchanged", *MUTANTS]:
            root = roots[name] = os.path.join(tmp, name)
            shutil.copytree(os.path.join(HERE, "ray_tpu_torch"),
                            os.path.join(root, "ray_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            if name in MUTANTS:
                source, edits = MUTANTS[name]
                path = os.path.join(root, source)
                with open(path) as f:
                    text = f.read()
                for old, new in edits:
                    assert text.count(old) == 1, f"{name}: anchor not unique"
                    text = text.replace(old, new)
                with open(path, "w") as f:
                    f.write(text)
        builds = {name: subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
             " from ray_tpu_torch.ops import _build;"
             " _build.build(_build.sources())", root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, root in roots.items()}
        for name, proc in builds.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"build of {name} failed:\n{out}")
        report, ok = {}, True
        for name, root in roots.items():
            run = subprocess.run([sys.executable, __file__, "--child", root],
                                 capture_output=True, text=True, timeout=600)
            if run.returncode:
                raise RuntimeError(f"{name} did not run:\n{run.stderr}")
            checks = json.loads(run.stdout.strip().splitlines()[-1])
            res = {**checks,
                   "fails": {check: sorted(p for p, e in errs.items()
                                           if not e["ok"])
                             for check, errs in checks.items()},
                   "max_excess": max(e["excess"] for errs in checks.values()
                                     for e in errs.values())}
            if name == "unchanged":
                ok &= not any(res["fails"].values())
            else:
                res["caught"] = res["max_excess"] > CAUGHT_BY
                ok &= res["caught"]
            report[name] = res
            print(f"{name}: fails {res['fails']}, largest excess "
                  f"{res['max_excess']:.2f}", file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"mutants": report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main())

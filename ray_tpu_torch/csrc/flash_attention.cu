// Flash attention for training on Hopper (sm_90a): the forward and the
// backward of causal or full attention, GQA-aware, in the (B, H, S, D)
// layout, for float and bfloat16, D in {16, 32, 64, 128}.
//
//   flash_fwd_kernel      bfloat16: replaces the Pallas TPU kernel
//     ray_tpu/ops/pallas/flash_attention.py::flash_attention_fwd_pallas
//     (kernel _fwd_kernel): out and the f32 log-sum-exp per query row.
//   flash_fwd_f32_kernel  float32: the same function.
//   flash_bwd_kernel      bfloat16: replaces both calls of
//     flash_attention_bwd_pallas (kernels _bwd_dq_kernel, _bwd_dkv_kernel)
//     in one pass: dQ = scale * dS K, dV = P^T dO, dK = scale * dS^T Q.
//   flash_bwd_dq_kernel, flash_bwd_dkv_kernel  float32: the same two calls
//     as two kernels, the GQA group of dK/dV reduced inside the block.
// with P = exp(scale * Q K^T - lse) recomputed from lse and
// dS = P o (dO V^T - delta), delta = rowsum(dO o O) - dlse from the caller.
//
// Semantics kept from the TPU kernels: causal masking is top-left aligned
// (row >= col); the kv tail past Skv and the q tail past Sq are masked in
// the kernel (no padded copies); a row with no unmasked column gets out 0
// and lse -1e30; kv rows come from kv head h / group (no repeat); lse is
// written straight to (B, Hq, Sq) f32.
//
// What bounds them: tensor-core operations. At the 1b_bench training shapes
// (B=8, Hq=32, Hkv=8, S=2048, D=64, causal) the forward does
// 4*B*H*S^2*D/2 = 137.4 GFLOP against 67 MB of q/k/v/out, far above the
// ~295 flop/byte ridge, so its least time is 0.139 ms at 989 TFLOP/s of
// bf16. The backward's five products need 343.8 GFLOP, 0.348 ms.
//
// bfloat16 forward design (flash_fwd_kernel<bf16, D>; FlashAttention-3's
// forward without its producer warp): one block of two warpgroups per
// (b*Hq, 128-row q tile), each warpgroup owning 64 q rows, so that a K/V
// tile in shared memory serves 128 rows; the grid starts with every
// head's heaviest causal q tile. Both products are wgmma (bf16 in, f32
// accumulated): S = Q K^T with Q and K K-major from shared memory, and
// O += P V with P repacked in registers from S's accumulators (rounded to
// bf16, as the TPU kernel does) and V read MN-major through the transpose
// bit. Thread 0 loads Q and a ring of three K/V stages by TMA, one
// mbarrier a stage: tiles land as 128/64/32-byte swizzled blocks, wgmma's
// swizzled layouts, and rows past Sq or Skv read as zeros. S of tile i and
// P V of tile i - 1 are issued together, so that P V runs on the tensor
// cores while the warpgroup takes the softmax of S (exp2 with
// scale*log2(e) folded into one FMA; masks only on tiles that cross the
// diagonal or the ragged tail). Kv tiles are 64 rows below D = 128 (under
// 128 registers a thread: two blocks an SM) and 128 at D = 128. At
// 1b_bench the kernel runs at about 1.3x cuDNN's forward; what holds it
// back is the softmax, not loads or products (scripts/flash_fwd_ablation.py,
// PERF.md): without exp2 and masks it takes about a quarter less time,
// without K/V loads after the first tiles or without the P V product no
// less.
//
// bfloat16 backward design (flash_bwd_kernel; FlashAttention-2/3's
// backward): one block of two warpgroups per (b*Hkv, 128-row kv tile)
// computes S^T and dP^T once per (GQA member, q tile) pair and takes all
// five products from them, so nothing is recomputed (the split design did
// 1.40x the work). Every product is a wgmma (bf16 in, f32 accumulated):
// S^T = K Q^T and dP^T = V dO^T from shared memory, dV += P^T dO and
// dK += dS^T Q with P^T, dS^T in registers (the C fragment repacked as the
// A fragment), dQ = dS K with dS^T through shared memory, read M-major.
// Tiles sit in shared memory as wgmma's no-swizzle core matrices, which
// one tile serves both untransposed (S^T, dP^T) and transposed (dV, dK,
// dQ). Loads are cp.async into a double buffer: the next pair's Q, dO, lse
// and delta land while the current pair computes (TMA loads, as the
// forward's, are untried here). dK and dV stay in registers over the whole GQA group
// (deterministic, no atomics). Each pair's dQ tile goes through a
// warp-private patch of shared memory into an f32 workspace by bulk
// (TMA) reduce-adds, cp.reduce.async.bulk .add.f32, one per row: the adds
// happen in L2, asynchronously, in no fixed order, so dQ's last bit
// varies from run to run. exp2 with scale*log2(e) folded into one FMA;
// masks only on tiles that cross the diagonal or a ragged tail.
// At 1b_bench the grid is 64 kv heads x 16 kv tiles on 132 SMs, one block
// each (140-240 registers a thread, no spills), heaviest causal tiles
// first. Bound: 343.8 GFLOP, 0.348 ms at the bf16 peak. What holds it
// back is memory traffic, not the tensor cores (scripts/flash_bwd_ablation.py,
// PERF.md): without the dQ reduce-adds (1.1 GB into L2 a call) the kernel
// takes about a fifth less time, without the Q, dO, lse and delta loads
// about a fifth less, while dropping one of the five products saves
// nothing; blocks of one kv head side by side, or a causal tile paired
// with its mirror per block, did not make it faster.
//
// Float32 runs on the CUDA cores with f32 FMA (no TF32; wgmma has no f32
// operands), bound by operations at 67 TFLOP/s, in three register-tiled
// kernels (designs above them): the forward flash_fwd_f32_kernel and the
// backward flash_bwd_dq_kernel and flash_bwd_dkv_kernel. Each works on
// 64 x 64 score tiles with 256 threads, each thread holding a 4 x 4
// micro-tile of the scores, operands read from shared memory as float4 so
// that one load feeds 16 FMAs, tiles loaded by cp.async into two stages,
// exp2 with the scale folded in, masks on edge tiles only. Each output tile
// is owned by one block, and dK and dV sum the GQA group in registers: the
// three kernels give the same bits every run.
//
// Precision of bfloat16: P is rounded to bf16 before P V, as the TPU kernel
// does. The TPU backward takes dS K, dS^T Q and P^T dO in f32; here P and dS
// are rounded to bf16 for the tensor cores (relative error 2^-9 per term),
// so each row of out/dq/dk/dv is held to 2e-2 of its own norm against the
// f32 plain version, the tolerance ops/flash_attention.py states.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;           // bytes a block may use on H100

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 operands, f32 accumulators d[N/2] in the C fragment
// layout (warp w of the warpgroup holds rows 16w + lane/4 and + 8; chunk j
// of 8 columns holds d[4j..4j+3] at columns 8j + 2(lane%4), + 1). ss: A and
// B from shared memory through descriptors, TA/TB the transpose bits; rs: A
// from registers in the mma.sync A fragment layout. scale_d 0 overwrites d.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}"
        ", %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}"
        ", {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}"
        ", %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}"
        ", {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}"
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of wgmma accumulators across the
// wait that completes them.
template <int R>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes this thread's generic-proxy writes to shared memory (stores,
// completed cp.async) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Bulk (TMA) reduce-add of `bytes` (a multiple of 16) of f32 from shared
// memory into global memory; the adds happen in L2, the issuing thread
// only tracks its bulk groups.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const float* src,
                                                    int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(src));
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
      ::"l"(dst), "r"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk groups have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Element offset of (r, c) in a bf16 tile of W columns stored as wgmma's
// no-swizzle core matrices: 8 rows of 16 bytes in 128 contiguous bytes,
// core matrices row-group major. One such tile serves as a K-major operand
// (K along the columns) and as an MN-major one (K along the rows).
template <int W>
__device__ __forceinline__ int core_off(int r, int c) {
  return ((r >> 3) * (W / 8) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}
// Descriptor of the operand starting at p in a tile of W columns, K along
// the columns: the next 8 K values are the next core matrix (128 bytes),
// the next 8 rows W/8 core matrices on.
template <int W>
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return smem_desc(p, 128, 16 * W);
}
// K along the rows (MN-major, with the transpose bit): the next 8 K rows
// are W/8 core matrices on (leading offset), the next 8 columns the next
// core matrix (stride offset).
template <int W>
__device__ __forceinline__ uint64_t desc_mn(const bf16* p) {
  return smem_desc(p, 16 * W, 128);
}

// Rows [0, nrows) of a row-major (rows, D) tile into core layout with
// cp.async, rows from `avail` on zero-filled (never read).
template <int D, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int avail, int nrows, int tid) {
  constexpr int C = D / 8;
  for (int i = tid; i < nrows * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r < avail;
    cp_async16(dst + core_off<D>(r, c * 8),
               ok ? src + static_cast<size_t>(r) * D + c * 8 : src, ok);
  }
}

template <int NT>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int avail, int n, int tid) {
  for (int i = tid; i < n; i += NT) {
    cp_async4(dst + i, i < avail ? src + i : src, i < avail);
  }
}

template <int D>
struct FwdCfg {                                  // the bf16 forward
  // 128 q rows a block, 64 a warpgroup, so that each K/V tile serves 128
  // rows. 64 kv rows a tile below D = 128 keep a thread under 128
  // registers, so two blocks share an SM (128 took 180 registers at D = 64,
  // one block an SM, and was slower). K and V in a ring of STAGES; tile
  // it + AHEAD loads while tile it computes, into the stage of tile it - 2,
  // whose P V product completed in the last iteration.
  static constexpr int BQ = 128, BKV = D < 128 ? 64 : 128, NT = 256;
  static constexpr int STAGES = 3, AHEAD = STAGES - 2;
  // tiles start on 1024-byte boundaries (the swizzle atom): 1024 bytes
  // of slack for aligning the dynamic shared memory
  static constexpr size_t smem =
      (BQ + 2 * STAGES * BKV) * D * sizeof(bf16) + 1024;
};

// Tiles of the bf16 forward are loaded by TMA in swizzled blocks of
// `BYTES`-byte rows (128, or the whole row when it is shorter): a tile of
// R rows is D / COLS blocks of R x COLS, one after the other, as wgmma's
// swizzled layouts read them.
template <int D>
struct Swz {
  static constexpr int BYTES = D >= 64 ? 128 : 2 * D;
  static constexpr int COLS = BYTES / 2;
  static constexpr uint64_t LAYOUT = BYTES == 128 ? 1 : BYTES == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t swz_desc(const bf16* p, uint32_t lbo,
                                             uint32_t sbo, uint64_t layout) {
  return smem_desc(p, lbo, sbo) | (layout << 62);
}
// K-major operand rows [r0, r0 + 64) x columns [16 kk, 16 kk + 16) of a
// swizzled tile of R rows: the next 8 rows are 8 swizzled rows on.
template <int D, int R>
__device__ __forceinline__ uint64_t swz_desc_k(const bf16* tile, int r0,
                                               int kk) {
  using S = Swz<D>;
  return swz_desc(tile + (16 * kk / S::COLS) * R * S::COLS + r0 * S::COLS
                      + 16 * kk % S::COLS,
                  16, 8 * S::BYTES, S::LAYOUT);
}
// MN-major operand: K along rows [16 kk, 16 kk + 16), N the COLS columns
// of block h; the next 8 K rows are 8 swizzled rows on.
template <int D, int R>
__device__ __forceinline__ uint64_t swz_desc_mn(const bf16* tile, int kk,
                                                int h) {
  using S = Swz<D>;
  return swz_desc(tile + h * R * S::COLS + 16 * kk * S::COLS,
                  R * S::BYTES, 8 * S::BYTES, S::LAYOUT);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// One box of a 3-D tensor map (columns, rows, heads) into shared memory;
// its bytes complete a transaction of `bar`.
__device__ __forceinline__ void tma_load_3d(bf16* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// The bf16 forward: one block of two warpgroups per (b * Hq, 128-row q
// tile), warpgroup wg owning q rows [64 wg, 64 wg + 64) of the tile. Q
// stays in shared memory; the block walks the kv tiles up to the causal
// diagonal, thread 0 loading tile it + AHEAD by TMA (a ring of STAGES,
// each with an mbarrier that its bytes complete) while tile it computes:
//   S = Q K^T                 wgmma ss, 64 x BKV per warpgroup, K = D
//   P = exp2(S scale log2e - m), the running max m and sum l per row
//   O = O alpha + P V         wgmma rs (P in registers, rounded to bf16),
//                             V MN-major through the transpose bit
// S of tile it and P V of tile it - 1 are issued together, so the tensor
// cores run P V while the warpgroup takes the softmax of S (FlashAttention-
// 3's intra-warpgroup overlap); O is rescaled once P V has completed. TMA
// zero-fills the rows past Sq and Skv.
template <int D>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap* tq,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          bf16* __restrict__ out,
                                          float* __restrict__ lse, int Hq,
                                          int Hkv, int Sq, int Skv,
                                          float scale, int causal,
                                          unsigned char* smem) {
  using C = FwdCfg<D>;
  using SW = Swz<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  constexpr int AHEAD = C::AHEAD;
  constexpr int DN = SW::COLS;                   // N of one P V wgmma
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  __shared__ uint64_t full[ST + 1];              // each stage's, then Q's
  bf16* sQ = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  bf16* sK = sQ + BQ * D;                        // ST stages
  bf16* sV = sK + ST * BKV * D;                  // ST stages

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int qw0 = q0 + 64 * wg;                  // this warpgroup's rows
  const int r0 = qw0 + 16 * w + g;               // this thread's: r0, r0 + 8
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  auto load_kv = [&](int it) {                   // thread 0 only
    if (it >= n_kv) return;
    const int st = it % ST;
    mbar_expect_tx(&full[st], 2 * BKV * D * sizeof(bf16));
#pragma unroll
    for (int b = 0; b < D / SW::COLS; ++b) {
      tma_load_3d(sK + st * BKV * D + b * BKV * SW::COLS, tk, &full[st],
                  b * SW::COLS, it * BKV, kvh);
      tma_load_3d(sV + st * BKV * D + b * BKV * SW::COLS, tv, &full[st],
                  b * SW::COLS, it * BKV, kvh);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= ST; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&full[ST], BQ * D * sizeof(bf16));
#pragma unroll
    for (int b = 0; b < D / SW::COLS; ++b) {
      tma_load_3d(sQ + b * BQ * SW::COLS, tq, &full[ST], b * SW::COLS, q0,
                  bh);
    }
#pragma unroll
    for (int it = 0; it < AHEAD; ++it) load_kv(it);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max (of the scores times scale log2e) and sum, rows r0, r0 + 8
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;
  float s[BKV / 2];
  uint32_t pa[BKV / 16][4];                      // P of the previous tile

  mbar_wait(&full[ST], 0);
  for (int it = 0; it < n_kv; ++it) {
    __syncthreads();             // tile it - 2 is done: its stage is free
    if (tid == 0) load_kv(it + AHEAD);
    mbar_wait(&full[it % ST], (it / ST) & 1);   // tile it landed
    const int k0 = it * BKV;
    const bf16* cK = sK + (it % ST) * BKV * D;
    const bf16* pV = sV + ((it + ST - 1) % ST) * BKV * D;   // tile it - 1

    wgmma_fence();
#pragma unroll
    for (int h = 0; h < BKV / 64; ++h) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        Wgmma<64>::template ss<0, 0>(
            s + 32 * h, swz_desc_k<D, BQ>(sQ, 64 * wg, kk),
            swz_desc_k<D, BKV>(cK, 64 * h, kk), kk > 0);
      }
    }
    wgmma_commit();
    if (it > 0) {
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < D / DN; ++h) {
          Wgmma<DN>::template rs<1>(o + h * DN / 2, pa[kk],
                                    swz_desc_mn<D, BKV>(pV, kk, h), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();             // S landed; P V may still run
    reg_fence<BKV / 2>(s);

    // Masks only on tiles that cross the diagonal or the ragged kv tail.
    const bool edge = (causal && k0 + BKV - 1 > qw0) || k0 + BKV > Skv;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + 8 * (e >> 1);
          if (col >= Skv || (causal && col > row)) s[4 * j + e] = neg_inf();
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]) * sl2);
      // exponents are taken from a finite base: a row with no unmasked
      // column so far keeps m = -inf, p = 0 and alpha = 0
      base[i] = m_new == neg_inf() ? 0.f : m_new;
      alpha[i] = fast_exp2(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(fmaf(s[4 * j + e], sl2, -base[e >> 1]));
        s[4 * j + e] = p;
        l[e >> 1] += p;
      }
    }
    wgmma_wait<0>();             // P V of tile it - 1 done: O and P are free
    reg_fence<D / 2>(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P as bf16 A fragments, one per 16 kv rows
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }
  }
  const bf16* lV = sV + ((n_kv - 1) % ST) * BKV * D;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < D / DN; ++h) {
      Wgmma<DN>::template rs<1>(o + h * DN / 2, pa[kk],
                                swz_desc_mn<D, BKV>(lV, kk, h), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<D / 2>(o);

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = quad_sum(l[i]);
    inv[i] = sum == 0.f ? 0.f : 1.f / sum;
    const int r = r0 + 8 * i;
    if (t == 0 && r < Sq) {
      lse[static_cast<size_t>(bh) * Sq + r] =
          sum == 0.f ? kNegInf : (m[i] + log2f(sum)) * kLn2;
    }
  }
  bf16* ob = out + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r) * D + 8 * j
                                   + 2 * t) =
          pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

template <int D>
struct BwdCfg {
  // 64 q rows a pair: 128 took 248 registers a thread at D = 64, and at
  // D = 128 spilled and outgrew shared memory
  static constexpr int BQ = 64, BKV = 128, NT = 256;
  static constexpr int DQN = D / 2;              // dQ columns per warpgroup
  static constexpr int DQL = DQN + 8;            // row of a dQ patch, floats
  static constexpr size_t smem =
      (2 * BKV * D + 4 * BQ * D + BKV * BQ) * sizeof(bf16)
      + (4 * BQ + 2 * BQ * DQL) * sizeof(float);
};

// The bf16 backward: one block of two warpgroups per (b * Hkv, 128-row kv
// tile), warpgroup wg owning kv rows [64 wg, 64 wg + 64) of the tile. K and
// V stay in shared memory; the block walks every (GQA member, BQ-row q
// tile) pair from the causal diagonal on, Q, dO, lse and delta of the next
// pair loading (cp.async, double buffer) while the current one computes:
//   S^T = K Q^T, dP^T = V dO^T          wgmma ss, 64 x BQ, K = D
//   P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta)
//   dV += P^T dO, dK += dS^T Q          wgmma rs (P^T, dS^T in registers)
//   dQ_tile = dS K                      wgmma ss, dS^T through shared memory
//                                       (read M-major), warpgroup wg taking
//                                       columns [wg D/2, wg D/2 + D/2)
// dK and dV accumulate in registers over the whole group (no atomics);
// each warp stages its rows of the dQ tile in shared memory and adds them
// to the f32 workspace dq_acc with bulk reduce-adds, one per row.
template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::NT, 1)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
                 int Hkv, int Sq, int Skv, float scale, int causal) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::NT;
  constexpr int DQN = C::DQN, DQL = C::DQL;
  constexpr int DN = D < 64 ? D : 64;            // N of one dK/dV wgmma
  constexpr int NJ = BQ / 8;                     // 8-column chunks of S^T
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  bf16* sK = reinterpret_cast<bf16*>(bwd_smem);
  bf16* sV = sK + BKV * D;
  bf16* sQ = sV + BKV * D;                       // two buffers
  bf16* sdO = sQ + 2 * BQ * D;                   // two buffers
  bf16* sdS = sdO + 2 * BQ * D;                  // dS^T (BKV x BQ)
  float* sL = reinterpret_cast<float*>(sdS + BKV * BQ);   // two buffers
  float* sDl = sL + 2 * BQ;                      // two buffers
  float* sdQ = sDl + 2 * BQ;                     // (2 wg, BQ, DQL) dQ patches

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x, k0 = blockIdx.y * BKV;
  const int kw0 = k0 + 64 * wg;                  // this warpgroup's rows
  const int group = Hq / Hkv;
  const size_t koff = (static_cast<size_t>(bkv) * Skv + k0) * D;
  stage_rows<D, NT>(sK, k + koff, Skv - k0, BKV, tid);
  stage_rows<D, NT>(sV, v + koff, Skv - k0, BKV, tid);
  cp_async_commit();

  const int q_first = causal ? k0 / BQ : 0;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int nq = max(nqt - q_first, 0);
  const int n_iter = group * nq;
  auto head_of = [&](int it) {                   // q head of pair `it`
    return static_cast<size_t>(bkv / Hkv) * Hq + (bkv % Hkv) * group
           + it / nq;
  };
  auto stage_pair = [&](int it) {
    const int q0 = (q_first + it % nq) * BQ, buf = it & 1;
    const size_t row0 = head_of(it) * Sq + q0;
    stage_rows<D, NT>(sQ + buf * BQ * D, q + row0 * D, Sq - q0, BQ, tid);
    stage_rows<D, NT>(sdO + buf * BQ * D, dout + row0 * D, Sq - q0, BQ, tid);
    stage_vec<NT>(sL + buf * BQ, lse + row0, Sq - q0, BQ, tid);
    stage_vec<NT>(sDl + buf * BQ, delta + row0, Sq - q0, BQ, tid);
    cp_async_commit();
  };
  if (n_iter > 0) stage_pair(0);

  const int dc0 = wg * DQN;                      // this warpgroup's dQ columns
  float* patch = sdQ + (64 * wg + 16 * w) * DQL;   // this warp's 16 rows
  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();             // pair `it` landed; pair it - 1 finished
    if (it + 1 < n_iter) stage_pair(it + 1);
    const int buf = it & 1;
    const bf16* cQ = sQ + buf * BQ * D;
    const bf16* cdO = sdO + buf * BQ * D;
    const float* cL = sL + buf * BQ;
    const float* cDl = sDl + buf * BQ;
    const int qt = q_first + it % nq, q0 = qt * BQ;

    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<BQ>::template ss<0, 0>(st, desc_k<D>(sK + core_off<D>(64 * wg, 16 * kk)),
                          desc_k<D>(cQ + core_off<D>(0, 16 * kk)), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<BQ>::template ss<0, 0>(dpt, desc_k<D>(sV + core_off<D>(64 * wg, 16 * kk)),
                          desc_k<D>(cdO + core_off<D>(0, 16 * kk)), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<BQ / 2>(st);

    // Masks only on tiles that cross the diagonal or a ragged tail.
    const bool edge = (causal && q0 < kw0 + 63) || kw0 + 64 > Skv
                      || q0 + BQ > Sq;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float p = fast_exp2(fmaf(st[4 * j + e], sl2, -kLog2e * cL[c]));
        if (edge) {
          const int kr = kw0 + 16 * w + g + 8 * (e >> 1), qc = q0 + c;
          p = (kr < Skv && qc < Sq && (!causal || qc >= kr)) ? p : 0.f;
        }
        st[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    reg_fence<BQ / 2>(dpt);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - cDl[c]);
      }
    }
    // P^T and dS^T as bf16 A fragments, one per 16 q columns
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
      }
    }
    reg_fence<D / 2>(gv);
    reg_fence<D / 2>(gk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / DN; ++h) {
        Wgmma<DN>::template rs<1>(gv + h * DN / 2, pa[kk],
                         desc_mn<D>(cdO + core_off<D>(16 * kk, h * DN)), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < D / DN; ++h) {
        Wgmma<DN>::template rs<1>(gk + h * DN / 2, da[kk],
                         desc_mn<D>(cQ + core_off<D>(16 * kk, h * DN)), 1);
      }
    }
    wgmma_commit();

    // dS^T (kv rows, q columns) to shared memory for dQ = dS K: a thread's
    // two neighbouring q columns are one 32-bit word, a warp's 32 words
    // 128 contiguous bytes
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 16 * kk + 8 * (i >> 1) + 2 * t;
        const int r = 64 * wg + 16 * w + g + 8 * (i & 1);
        *reinterpret_cast<uint32_t*>(sdS + core_off<BQ>(r, c)) = da[kk][i];
      }
    }
    fence_proxy_async();
    __syncthreads();             // both warpgroups' dS^T written

    float dqa[DQN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      Wgmma<DQN>::template ss<1, 1>(dqa, desc_mn<BQ>(sdS + core_off<BQ>(16 * kk, 0)),
                           desc_mn<D>(sK + core_off<D>(16 * kk, dc0)), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<D / 2>(gv);
    reg_fence<D / 2>(gk);
    reg_fence<DQN / 2>(dqa);
    // This warp's 16 rows of the warpgroup's dQ columns, scaled, into its
    // own patch of shared memory, then one bulk reduce-add per row: lane
    // r < 16 issues row 16 w + r once its previous row has been read.
    if (lane < 16) bulk_wait_read();
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
  }
  cp_async_wait_all();
  if (lane < 16) bulk_wait();

  const size_t base = static_cast<size_t>(bkv) * Skv * D;
#pragma unroll
  for (int h = 0; h < D / DN; ++h) {
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = kw0 + 16 * w + g + 8 * i;
        const int idx = h * DN / 2 + 4 * j + 2 * i;
        if (r >= Skv) continue;
        const size_t o = base + static_cast<size_t>(r) * D + h * DN + 8 * j
                         + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(gk[idx] * scale, gk[idx + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(gv[idx], gv[idx + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ f32

// The float32 kernels, register-tiled on the CUDA cores (FP32 FMA; no
// TF32: wgmma has no f32 operands). All three work on 64 x 64 tiles of
// scores with 256 threads in a 16 x 16 grid: thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of a tile, a 4 x 4 micro-tile
// of S (and of dP) in registers. Operands sit in shared memory row-major,
// rows padded to D + 4 floats: a float4 load (4 values along D) of each of
// the micro-tile's 4 rows and 4 columns feeds 4 x 4 x 4 = 64 FMAs, where a
// scalar dot product does two 4-byte loads per FMA. In the backward, lanes
// of a warp sit 4 rows by 8 columns, so that each load instruction of a
// warp reads its 8 or 4 distinct rows from distinct banks (the padding
// staggers rows by 4 banks) and 8 lanes (rows) or 4 (columns) read each
// address at once: a warp takes one shared wavefront per 8 FMA
// instructions, where the SM issues 4 FMA instructions a clock against one
// wavefront (the forward's lanes differ, see above it). At 1b_bench the
// three kernels run at 45-48% of the FP32 peak, and removing exp2, masks or
// loads saves little: the FMA loops themselves set the time
// (scripts/flash_bwd_f32_ablation.py, PERF.md). The second products read P
// or dS from shared memory the same way, 4 rows x 4 kv (or q) values a
// float4, against rows of V, K, Q or dO read as vectors of the thread's own
// D columns. Tiles come by cp.async into two stages: the next tile lands
// while this one computes. exp2 with scale*log2(e) folded into one FMA;
// masks only on tiles that cross the diagonal or a ragged tail; the
// heaviest causal tiles start first.
template <int D>
struct F32Cfg {
  static constexpr int NT = 256, T = 64;         // threads, rows of a tile
  static constexpr int LD = D + 4;               // floats a staged row
  static constexpr int LDP = T + 8;              // floats a row of P or dS
  // a thread's D columns of dQ, dK, dV: NV vectors of VW floats, vector m
  // at columns 16 VW m + VW tx
  static constexpr int VW = D >= 64 ? 4 : D / 16, NV = D / (16 * VW);
  static constexpr int TILE = T * LD;            // floats of a staged tile
  // dq: Q, dO and two stages of K, V; dS takes the spent V stage where
  // that keeps two blocks on an SM (D = 64), else a tile of its own
  static constexpr bool DQ_ALIAS = D >= 64;
  static constexpr int LDS_DQ = DQ_ALIAS ? LD : LDP;
  static constexpr size_t dq_smem =
      (6 * TILE + (DQ_ALIAS ? 0 : T * LDP)) * sizeof(float);
  static constexpr int DQ_BLOCKS = D < 128 ? 2 : 1;
  // dkv: K, V and two stages of Q, dO, lse, delta; P and dS in a tile each
  // where both fit (D < 128), else in one tile, in turn
  static constexpr size_t dkv_base = (6 * TILE + 4 * T) * sizeof(float);
  static constexpr bool DKV_PS2 =
      dkv_base + 2 * T * LDP * sizeof(float) <= static_cast<size_t>(kMaxSmem);
  static constexpr size_t dkv_smem =
      dkv_base + (DKV_PS2 ? 2 : 1) * T * LDP * sizeof(float);
  static constexpr int DKV_BLOCKS = D <= 32 ? 2 : 1;
  // fwd: Q, two stages of K, V, and P in rows of 80 floats, which puts the
  // two rows of P a warp writes at once 16 banks apart (72 would overlap
  // them by 8); two blocks an SM below D = 128 (105 KB at D = 64)
  static constexpr int LDP_FWD = T + 16;
  static constexpr size_t fwd_smem = (5 * TILE + T * LDP_FWD) * sizeof(float);
  static constexpr int FWD_BLOCKS = D < 128 ? 2 : 1;
};

// Rows [0, 64) of a row-major (rows, D) f32 tile into shared rows of LD
// floats by cp.async, 16 bytes a copy; rows from `avail` on zero-filled.
template <int D, int LD, int NT>
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* src,
                                               int avail, int tid) {
  constexpr int C = D / 4;
#pragma unroll
  for (int i = tid; i < 64 * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool ok = r < avail;
    cp_async16(dst + r * LD + c * 4,
               ok ? src + static_cast<size_t>(r) * D + c * 4 : src, ok);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// s[i][j] += sum_d A[ty + 16 i][d] B[tx + 16 j][d] (both row-major, LD).
template <int D, int LD>
__device__ __forceinline__ void mm_nt_f32(const float* A, const float* B,
                                          int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(lane_of(a[i], k), lane_of(b[j], k), s[i][j]);
        }
      }
    }
  }
}

// acc[i][n] += sum_c P[ty + 16 i][c] B[c][col n] over the tile's 64 rows c
// of B (row-major, LD), P row-major (LDP); col n = 16 VW m + VW tx + e for
// n = m VW + e, the thread's D columns.
template <int D, int LDP, int LD>
__device__ __forceinline__ void mm_nn_f32(const float* P, const float* B,
                                          int ty, int tx,
                                          float (&acc)[4][D / 16]) {
  constexpr int VW = F32Cfg<D>::VW, NV = F32Cfg<D>::NV;
#pragma unroll 2
  for (int c = 0; c < 64; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + c);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* row = B + (c + k) * LD + VW * tx;
      float b[D / 16];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(row + 64 * m);
          b[4 * m] = x.x, b[4 * m + 1] = x.y, b[4 * m + 2] = x.z,
          b[4 * m + 3] = x.w;
        } else if constexpr (VW == 2) {
          const float2 x = *reinterpret_cast<const float2*>(row + 32 * m);
          b[2 * m] = x.x, b[2 * m + 1] = x.y;
        } else {
          b[m] = row[16 * m];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = lane_of(p[i], k);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) acc[i][n] = fmaf(pv, b[n], acc[i][n]);
      }
    }
  }
}

// Stores a thread's D / 16 columns of row `dst` (times `mul`).
template <int D>
__device__ __forceinline__ void store_cols_f32(float* dst, int tx,
                                               const float* a, float mul) {
  constexpr int VW = F32Cfg<D>::VW, NV = F32Cfg<D>::NV;
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    float* p = dst + 16 * VW * m + VW * tx;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(p) =
          make_float4(a[4 * m] * mul, a[4 * m + 1] * mul, a[4 * m + 2] * mul,
                      a[4 * m + 3] * mul);
    } else if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(p) =
          make_float2(a[2 * m] * mul, a[2 * m + 1] * mul);
    } else {
      *p = a[m] * mul;
    }
  }
}

// The largest value, and the sum, of x over the 16 lanes of a half-warp.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The float32 forward (K1 in f32): one block per (b * Hq, 64-row q tile),
// the heaviest causal tiles first. Q stays in shared memory; the block walks
// the kv tiles up to the causal diagonal, tile kt + 1 landing by cp.async
// while tile kt computes:
//   S = Q K^T                 mm_nt_f32, a 4 x 4 micro-tile a thread
//   m = max(m, rowmax(S) scale log2e), alpha = exp2(m_old - m)
//   P = exp2(S scale log2e - m) into shared memory, l = l alpha + rowsum(P)
//   O = O alpha + P V         mm_nn_f32 into acc[4][D / 16], the rows of
//                             the thread's micro-tile, so that each thread
//                             rescales O by its own rows' alpha
// and writes O / l and lse = (m + log2 l) ln 2 (a row with no unmasked
// column: O 0 and lse -1e30). Unlike the backward, which reads lse, the
// forward needs each row's max over the 16 threads that own the row, every
// tile. Lanes sit 2 rows by 16 columns a warp, so those 16 threads are one
// half-warp: four shuffles reduce a row, and the rows of P a warp writes
// are the rows it reads back for P V, so a warp barrier orders them. The
// price: a float4 load of K (and of V) reads 16 rows, two shared wavefronts
// where the backward's 4 x 8 lanes take one; with those lanes and the row
// reductions through shared memory (a block barrier a tile) the kernel was
// 4% slower at both D = 64 and 128. The running max starts at the finite
// -1e30, so the first alpha is 0, not NaN; the row sums stay per thread,
// over its own columns, until the end. Bound at 1b_bench: 137.4 GFLOP of
// FMA, 2.05 ms at 67 TFLOP/s; the kernel takes 4.37 ms (47%), and without
// P V 41% less, without loads after the first tiles 4% less, without exp2
// and masks no less (scripts/flash_bwd_f32_ablation.py, PERF.md); with one
// block an SM in place of two (118 registers a thread at D = 64) it took
// 15% longer.
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::NT, F32Cfg<D>::FWD_BLOCKS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int Hq, int Hkv, int Sq,
                     int Skv, float scale, int causal) {
  using C = F32Cfg<D>;
  constexpr int T = C::T, LD = C::LD, LDP = C::LDP_FWD, NT = C::NT;
  constexpr int TILE = C::TILE;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + TILE;                        // stage s: K, then V
  float* sP = sKV + 4 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;   // heaviest first
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vb = v + static_cast<size_t>(kvh) * Skv * D;
  const int kv_end = causal ? min(Skv, q0 + T) : Skv;
  const int n_kt = (kv_end + T - 1) / T;

  stage_tile_f32<D, LD, NT>(sQ, q + (static_cast<size_t>(bh) * Sq + q0) * D,
                            Sq - q0, tid);
  stage_tile_f32<D, LD, NT>(sKV, kb, Skv, tid);
  stage_tile_f32<D, LD, NT>(sKV + TILE, vb, Skv, tid);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * T;
    const float* cK = sKV + (kt & 1) * 2 * TILE;
    const float* cV = cK + TILE;
    cp_async_wait_all();
    __syncthreads();                             // tile kt in; kt - 1 done
    if (kt + 1 < n_kt) {
      float* nK = sKV + ((kt + 1) & 1) * 2 * TILE;
      const size_t o = static_cast<size_t>(k0 + T) * D;
      stage_tile_f32<D, LD, NT>(nK, kb + o, Skv - k0 - T, tid);
      stage_tile_f32<D, LD, NT>(nK + TILE, vb + o, Skv - k0 - T, tid);
      cp_async_commit();
    }
    float s[4][4] = {};
    mm_nt_f32<D, LD>(sQ, cK, ty, tx, s);
    // Masks only on tiles that cross the diagonal or the ragged kv tail
    // (rows past Sq are computed and never stored).
    if ((causal && k0 + T - 1 > q0) || k0 + T > Skv) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = k0 + tx + 16 * j;
          if (c >= Skv || (causal && c > q0 + ty + 16 * i)) {
            s[i][j] = neg_inf();
          }
        }
      }
    }
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = half_warp_max(
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m[i], mx[i] * sl2);
      const float alpha = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[i][n] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], sl2, -m_new));
        l[i] += p;
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
    }
    __syncwarp();                                // this warp's rows of P
    mm_nn_f32<D, LDP, LD>(sP, cV, ty, tx, acc);
  }
  float sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] = half_warp_sum(l[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const size_t row = static_cast<size_t>(bh) * Sq + r;
    store_cols_f32<D>(out + row * D, tx, acc[i],
                      sum[i] == 0.f ? 0.f : 1.f / sum[i]);
    if (tx == 0) {
      lse[row] = sum[i] == 0.f ? kNegInf : (m[i] + log2f(sum[i])) * kLn2;
    }
  }
}

// dQ for one 64-row q tile of one head (K2a): walks the kv tiles up to the
// diagonal, forming S = Q K^T and dP = dO V^T in registers, dS = P (dP -
// delta) into shared memory, and dQ += dS K in registers; writes scale dQ.
// One block owns its dQ tile: no atomics, the same bits every run.
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::NT, F32Cfg<D>::DQ_BLOCKS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int Hq, int Hkv, int Sq, int Skv, float scale,
                    int causal) {
  using C = F32Cfg<D>;
  constexpr int T = C::T, LD = C::LD, NT = C::NT, TILE = C::TILE;
  constexpr int LDS = C::LDS_DQ;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + TILE;
  float* sKV = sdO + TILE;                       // stage s: K, then V
  float* sdS_own = sKV + 4 * TILE;               // unless DQ_ALIAS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T;   // heaviest first
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vb = v + static_cast<size_t>(kvh) * Skv * D;
  const int kv_end = causal ? min(Skv, q0 + T) : Skv;
  const int n_kv = (kv_end + T - 1) / T;

  const size_t qoff = (static_cast<size_t>(bh) * Sq + q0) * D;
  stage_tile_f32<D, LD, NT>(sQ, q + qoff, Sq - q0, tid);
  stage_tile_f32<D, LD, NT>(sdO, dout + qoff, Sq - q0, tid);
  stage_tile_f32<D, LD, NT>(sKV, kb, Skv, tid);
  stage_tile_f32<D, LD, NT>(sKV + TILE, vb, Skv, tid);
  cp_async_commit();

  float lse2[4], dl[4];                          // this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const size_t o = static_cast<size_t>(bh) * Sq + r;
    lse2[i] = r < Sq ? lse[o] * kLog2e : 0.f;
    dl[i] = r < Sq ? delta[o] : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * T;
    float* cK = sKV + (t & 1) * 2 * TILE;
    float* cV = cK + TILE;
    cp_async_wait_all();
    __syncthreads();                             // tile t in; t - 1 done
    if (t + 1 < n_kv) {
      float* nK = sKV + ((t + 1) & 1) * 2 * TILE;
      const size_t o = static_cast<size_t>(k0 + T) * D;
      stage_tile_f32<D, LD, NT>(nK, kb + o, Skv - k0 - T, tid);
      stage_tile_f32<D, LD, NT>(nK + TILE, vb + o, Skv - k0 - T, tid);
      cp_async_commit();
    }
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt_f32<D, LD>(sQ, cK, ty, tx, s);
    mm_nt_f32<D, LD>(sdO, cV, ty, tx, dp);
    float* sdS = C::DQ_ALIAS ? cV : sdS_own;
    if constexpr (C::DQ_ALIAS) __syncthreads();  // every thread done with V
    const bool edge = (causal && k0 + T - 1 > q0) || k0 + T > Skv
                      || q0 + T > Sq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[i]));
        if (edge) {
          const int r = q0 + ty + 16 * i, c = k0 + tx + 16 * j;
          if (r >= Sq || c >= Skv || (causal && r < c)) p = 0.f;
        }
        sdS[(ty + 16 * i) * LDS + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    mm_nn_f32<D, LDS, LD>(sdS, cK, ty, tx, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < Sq) {
      store_cols_f32<D>(dq + (static_cast<size_t>(bh) * Sq + r) * D, tx,
                        acc[i], scale);
    }
  }
}

// dK and dV for one 64-row kv tile of one kv head (K2b): walks (GQA member,
// q tile) pairs in a fixed order, forming S^T = K Q^T and dP^T = V dO^T in
// registers, P^T and dS^T into shared memory, and dV += P^T dO, dK += dS^T Q
// in registers over the whole group; writes dK (times scale) and dV. No
// atomics: the same bits every run.
template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::NT, F32Cfg<D>::DKV_BLOCKS)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Hq, int Hkv, int Sq, int Skv,
                     float scale, int causal) {
  using C = F32Cfg<D>;
  constexpr int T = C::T, LD = C::LD, LDP = C::LDP, NT = C::NT;
  constexpr int TILE = C::TILE;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + TILE;
  float* sQdO = sV + TILE;                       // stage s: Q, then dO
  float* sLD = sQdO + 4 * TILE;                  // stage s: lse, then delta
  float* sP = sLD + 4 * T;
  float* sdS = C::DKV_PS2 ? sP + T * LDP : sP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = (warp & 1) * 8 + (lane & 7), ty = (warp >> 1) * 4 + (lane >> 3);
  const int bkv = blockIdx.x, k0 = blockIdx.y * T;   // kv tile 0 heaviest
  const int group = Hq / Hkv;
  const size_t bhq0 = static_cast<size_t>(bkv / Hkv) * Hq + (bkv % Hkv) * group;
  // causal: q tiles above the kv tile's first row see none of its rows
  const int q_first = causal ? k0 / T : 0;
  const int nqe = (Sq + T - 1) / T - q_first;
  const int n_iter = group * max(nqe, 0);

  const size_t koff = (static_cast<size_t>(bkv) * Skv + k0) * D;
  stage_tile_f32<D, LD, NT>(sK, k + koff, Skv - k0, tid);
  stage_tile_f32<D, LD, NT>(sV, v + koff, Skv - k0, tid);
  // Q, dO, lse and delta of pair `it` into stage `st`
  auto stage_pair = [&](int it, int st) {
    const size_t bhq = bhq0 + it / nqe;
    const int q0 = (q_first + it % nqe) * T;
    const size_t qoff = (bhq * Sq + q0) * D;
    float* dst = sQdO + st * 2 * TILE;
    stage_tile_f32<D, LD, NT>(dst, q + qoff, Sq - q0, tid);
    stage_tile_f32<D, LD, NT>(dst + TILE, dout + qoff, Sq - q0, tid);
    stage_vec<NT>(sLD + st * 2 * T, lse + bhq * Sq + q0, Sq - q0, T, tid);
    stage_vec<NT>(sLD + st * 2 * T + T, delta + bhq * Sq + q0, Sq - q0, T,
                  tid);
  };
  if (n_iter > 0) stage_pair(0, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float ak[4][D / 16], av[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) ak[i][n] = av[i][n] = 0.f;
  }
  for (int it = 0; it < n_iter; ++it) {
    const int st = it & 1;
    const int q0 = (q_first + it % nqe) * T;
    const float* cQ = sQdO + st * 2 * TILE;
    const float* cdO = cQ + TILE;
    const float* cL = sLD + st * 2 * T;
    const float* cDl = cL + T;
    cp_async_wait_all();
    __syncthreads();                             // pair it in; it - 1 done
    if (it + 1 < n_iter) {
      stage_pair(it + 1, st ^ 1);
      cp_async_commit();
    }
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt_f32<D, LD>(sK, cQ, ty, tx, s);
    mm_nt_f32<D, LD>(sV, cdO, ty, tx, dp);
    const bool edge = (causal && q0 < k0 + T - 1) || q0 + T > Sq
                      || k0 + T > Skv;
    float lse2[4], dlt[4];                       // this thread's q columns
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lse2[j] = cL[tx + 16 * j] * kLog2e;
      dlt[j] = cDl[tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = fast_exp2(fmaf(s[i][j], sl2, -lse2[j]));
        if (edge) {
          const int kr = k0 + ty + 16 * i, qr = q0 + tx + 16 * j;
          if (qr >= Sq || kr >= Skv || (causal && qr < kr)) p = 0.f;
        }
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        s[i][j] = p * (dp[i][j] - dlt[j]);       // dS^T
        if constexpr (C::DKV_PS2) sdS[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();
    mm_nn_f32<D, LDP, LD>(sP, cdO, ty, tx, av);
    if constexpr (!C::DKV_PS2) {                 // dS^T in turn, over P^T
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sdS[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
      }
      __syncthreads();
    }
    mm_nn_f32<D, LDP, LD>(sdS, cQ, ty, tx, ak);
  }
  cp_async_wait_all();                           // K, V of a block with no pair
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr < Skv) {
      const size_t o = (static_cast<size_t>(bkv) * Skv + kr) * D;
      store_cols_f32<D>(dk + o, tx, ak[i], scale);
      store_cols_f32<D>(dv + o, tx, av[i], 1.f);
    }
  }
}

// ------------------------------------------------------------------ kernels

// The bf16 forward reads q, k and v through the tensor maps tq, tk, tv
// (f32 takes flash_fwd_f32_kernel: wgmma has no f32 operands).
template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::NT)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* out,
                 float* lse, int Hq, int Hkv, int Sq, int Skv, float scale,
                 int causal) {
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  fwd_wgmma<D>(&tq, &tk, &tv, out, lse, Hq, Hkv, Sq, Skv, scale, causal,
               fwd_smem);
}

// ------------------------------------------------------------------ host

struct Shape {
  int B, Hq, Hkv, Sq, Skv;
};

bool valid(const Shape& s) {
  return s.B > 0 && s.Hq > 0 && s.Hkv > 0 && s.Hq % s.Hkv == 0 && s.Sq > 0
         && s.Skv > 0 && static_cast<long long>(s.B) * s.Hq <= 65535;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

// The f32 kernels take all of an SM's shared memory as such, so that two
// blocks fit where the budget allows it.
template <typename K>
cudaError_t prepare_f32(K kernel, size_t smem) {
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no link
// to libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found)
            == cudaSuccess
        && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A bf16 (heads, rows, D) tensor as a 3-D tensor map whose box is one
// swizzled block of a tile: Swz<D>::COLS columns of box_rows rows. Rows
// past `rows` read as zeros.
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int heads,
                       int rows, int box_rows) {
  using S = Swz<D>;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {D * sizeof(bf16),
                                 static_cast<cuuint64_t>(rows) * D
                                     * sizeof(bf16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(S::COLS),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      S::BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : S::BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     void* lse, Shape s, float scale, int causal,
                     cudaStream_t st) {
  using C = FwdCfg<D>;
  cudaError_t err = prepare(flash_fwd_kernel<D>, C::smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq{}, tk{}, tv{};
  if ((err = tensor_map<D>(&tq, q, s.B * s.Hq, s.Sq, C::BQ)) != cudaSuccess
      || (err = tensor_map<D>(&tk, k, s.B * s.Hkv, s.Skv, C::BKV))
             != cudaSuccess
      || (err = tensor_map<D>(&tv, v, s.B * s.Hkv, s.Skv, C::BKV))
             != cudaSuccess) {
    return err;
  }
  // q tiles slowest, so every head's heaviest causal tiles go first
  const dim3 grid(s.B * s.Hq, (s.Sq + C::BQ - 1) / C::BQ);
  flash_fwd_kernel<D><<<grid, C::NT, C::smem, st>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), s.Hq,
      s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_f32(const void* q, const void* k, const void* v, void* out,
                    void* lse, Shape s, float scale, int causal,
                    cudaStream_t st) {
  using C = F32Cfg<D>;
  cudaError_t err = prepare_f32(flash_fwd_f32_kernel<D>, C::fwd_smem);
  if (err != cudaSuccess) return err;
  // q tiles in y, so that every head's heaviest causal tile goes first
  const dim3 grid(s.B * s.Hq, (s.Sq + C::T - 1) / C::T);
  flash_fwd_f32_kernel<D><<<grid, C::NT, C::fwd_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), s.Hq, s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, Shape s, float scale, int causal,
                   cudaStream_t st) {
  using C = F32Cfg<D>;
  cudaError_t err = prepare_f32(flash_bwd_dq_kernel<D>, C::dq_smem);
  if (err != cudaSuccess) return err;
  // q tiles in y, so that every head's heaviest causal tile goes first
  const dim3 grid(s.B * s.Hq, (s.Sq + C::T - 1) / C::T);
  flash_bwd_dq_kernel<D><<<grid, C::NT, C::dq_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), s.Hq, s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, Shape s, float scale, int causal,
                    cudaStream_t st) {
  using C = F32Cfg<D>;
  cudaError_t err = prepare_f32(flash_bwd_dkv_kernel<D>, C::dkv_smem);
  if (err != cudaSuccess) return err;
  // kv tiles in y: the heaviest causal tiles (the first) go first
  const dim3 grid(s.B * s.Hkv, (s.Skv + C::T - 1) / C::T);
  flash_bwd_dkv_kernel<D><<<grid, C::NT, C::dkv_smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), s.Hq, s.Hkv, s.Sq,
      s.Skv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq_acc, void* dk, void* dv, Shape s, float scale,
                int causal, cudaStream_t st) {
  using C = BwdCfg<D>;
  cudaError_t err = prepare(flash_bwd_kernel<D>, C::smem);
  if (err != cudaSuccess) return err;
  // kv tiles slowest, so the heaviest causal tiles (the first) go first
  const dim3 grid(s.B * s.Hkv, (s.Skv + C::BKV - 1) / C::BKV);
  flash_bwd_kernel<D><<<grid, C::NT, C::smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s.Hq, s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

// Calls FN<D>(args...) for the runtime head dim.
#define HEAD_DIM_DISPATCH(FN, ...)                                           \
  do {                                                                       \
    switch (D) {                                                             \
      case 16: return FN<16>(__VA_ARGS__);                                   \
      case 32: return FN<32>(__VA_ARGS__);                                   \
      case 64: return FN<64>(__VA_ARGS__);                                   \
      case 128: return FN<128>(__VA_ARGS__);                                 \
      default: return cudaErrorInvalidValue;                                 \
    }                                                                        \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every launch returns a cudaError_t
// (0 on success). q/dout/out/dq (B, Hq, Sq, D); k/v/dk/dv (B, Hkv, Skv, D);
// lse/delta (B, Hq, Sq) float32; all contiguous.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Hq, int Hkv,
                                int Sq, int Skv, int D, float scale,
                                int causal, int dtype, void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    HEAD_DIM_DISPATCH(fwd_f32, q, k, v, out, lse, s, scale, causal, st);
  }
  if (dtype == 1) {
    HEAD_DIM_DISPATCH(fwd_bf16, q, k, v, out, lse, s, scale, causal, st);
  }
  return cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, float scale, int causal,
                                   int dtype, void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;       // f32 only
  HEAD_DIM_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, s, scale, causal,
                    st);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return cudaErrorInvalidValue;       // f32 only
  HEAD_DIM_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, s, scale,
                    causal, st);
}

// The bfloat16 backward in one kernel. dq_acc (B, Hq, Sq, D) float32 must
// hold zeros: the kernel adds scale * dS K into it.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq_acc, void* dk,
                                void* dv, int B, int Hq, int Hkv, int Sq,
                                int Skv, int D, float scale, int causal,
                                void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  HEAD_DIM_DISPATCH(bwd, q, k, v, dout, lse, delta, dq_acc, dk, dv, s, scale,
                    causal, st);
}

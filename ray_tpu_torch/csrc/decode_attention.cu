// Decode attention for serving on Hopper (sm_90a): one new query token per
// slot against that slot's KV cache, in two cache layouts.
//
//   paged_decode_attention_kernel  replaces the Pallas TPU kernel
//     ray_tpu/ops/pallas/paged_decode_attention.py::paged_decode_attention
//     (kernel _paged_kernel). KV lives in a pool of fixed-size blocks
//     (NB, bs, KV, D); each slot's block-table row names its blocks.
//   decode_attention_kernel        replaces the Pallas TPU kernel
//     ray_tpu/ops/pallas/decode_attention.py::decode_attention
//     (kernel _decode_kernel). KV lives in a contiguous (B, S, KV, D) cache.
//
// Both compute, for each slot b and query head h of kv head j = h / group,
//   out[b, h] = softmax(scale * q[b, h] . K[b, :len]) @ V[b, :len]
// with f32 scores, an f32 online-softmax recurrence and an f32 accumulator,
// and write out in q's dtype. A slot with len == 0 gets 0 (the TPU kernel's
// l_safe rule). Supported element types: float and bfloat16.
//
// What bounds them: bytes. Each call must read every valid K and V row once
// (2 * sum_b rows_b * KV * D * itemsize) and does about 4 flops per element
// read, far below the ~295 flop/byte where the tensor cores would be the
// limit, so the least time is those bytes over the 3.35 TB/s of device
// memory.
//
// Design (flash-decoding), one kernel body for both layouts: the template
// decode_split<T, D, G, Rows> takes a row-address policy, PagedRows (a row
// r of slot b is pool row tables[b, r / bs] * bs + r % bs) or SlotRows (row
// b * S + r of the contiguous cache), and the two kernels above are its two
// instantiations. The grid is (kv head, slot, split), a split being a fixed
// run of rows (ops/decode_attention.py::SPLIT_ROWS; for the paged layout,
// whole pool blocks), so a long slot spreads over many SMs (at the engine's
// 8b decode, 4 slots of 1024 rows: 256 blocks instead of 32). A split past
// the slot's length exits at once; rows past the length, and table entries
// past the valid prefix, are never read (a stale slot reads min(len, MBS *
// bs) rows paged and min(len, S) rows in a slot cache). Inside a split,
// each lane loads 16 bytes of a K row and of a V row straight into
// registers, several rows in flight, with no shared-memory staging: each
// row is used once, by the kv head's whole query group, whose q vectors
// live in registers. Scores are f32 FMAs and shuffles over the row's
// lanes; each group of lanes runs an online softmax in base 2 (exp2 with
// scale*log2(e) folded into q). Lanes merge by shuffles and warps in shared
// memory; a slot with one live split writes out directly, otherwise each
// split writes (max, sum, acc) to a workspace and the last split to finish
// (an arrival ticket it resets) combines them in split order, so one call
// is one kernel and the result is bit for bit the same from run to run.
// A length-0 slot gets 0. Both dtypes; head dims 16-128, groups 1-8.
// What still holds it back: at these sizes a call moves 20-30 MB in
// microseconds, so the launch, the longest split's latency chain and the
// combine, not the bytes, set its time (PERF.md).
// Inactive or released slots have all-zero table rows (the null block 0)
// or zero lengths, and a slot cache's inactive rows are rewritten with
// their own contents: they read finite rows, and the caller discards their
// output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSplitWarps = 4;             // warps of a split block
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16 bytes of a row that one lane loads, as floats (exact for bf16).
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Merge a running (max, sum, acc) with another: exponents in base 2, taken
// from a finite base so that two empty states (max -inf) stay empty.
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float* acc,
                                      float mo, float lo, const float* acco) {
  const float mn = fmaxf(m, mo);
  const float base = mn == neg_inf() ? 0.f : mn;
  const float fa = fast_exp2(m - base), fb = fast_exp2(mo - base);
  l = l * fa + lo * fb;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * fa + acco[e] * fb;
  m = mn;
}

// Row addresses: the index of row r of one slot among the (rows, KV, D)
// rows of the cache tensor.
struct PagedRows {                 // K3: through the slot's block table
  const int* table;
  int bs;
  __device__ __forceinline__ size_t operator()(int r) const {
    const int blk = r / bs;
    return static_cast<size_t>(__ldg(table + blk)) * bs + (r - blk * bs);
  }
};
struct SlotRows {                  // K4: the slot's contiguous S rows
  size_t first;
  __device__ __forceinline__ size_t operator()(int r) const {
    return first + r;
  }
};

// One block per (kv head j, slot b, split sp); split sp owns the rows
// [sp * split_rows, (sp + 1) * split_rows) of the slot, of which the first
// min(len, cap) are valid (cap: the rows a slot can hold). A lane loads 16
// bytes of a K row and of a V row straight into registers: LPR lanes cover
// a row, a warp RPW rows at once, U rows per lane in flight. Scores for the
// whole GQA group come from the group's q vectors, held in registers (times
// scale log2 e), by FMAs and shuffles over the row's lanes; each group of
// LPR lanes runs its own online softmax in base 2. The lanes' states are
// merged by shuffles, the warps' in shared memory, both in a fixed order.
// A slot with one live split writes out directly; otherwise each split
// writes (max, sum, acc) per q head to `part` and the last split to arrive
// (a ticket on `arrivals`, which it resets to 0) combines the splits in
// split order, so the result does not depend on arrival order.
template <typename T, int D, int G, typename Rows>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ part,
    int* __restrict__ arrivals, const Rows rows, int len, int cap,
    int split_rows, int KV, float scale) {
  constexpr int EPL = 16 / sizeof(T);            // elements a lane loads
  constexpr int LPR = D / EPL;                   // lanes a row
  constexpr int RPW = 32 / LPR;                  // rows a warp loads at once
  constexpr int U = G <= 4 ? 8 : 4;              // rows a lane has in flight
  constexpr int NW = kSplitWarps, NT = 32 * NW;
  constexpr int STEP = NW * U * RPW;             // rows a block takes a step
  constexpr int PART = G * (D + 2);              // floats of one partial
  constexpr float kLog2e = 1.4426950408889634f;
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "row of 16-byte lanes");
  __shared__ float sAcc[NW][G][D];
  __shared__ float sM[NW][G], sL[NW][G];
  __shared__ int sLast;

  const int j = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int H = KV * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % LPR, slot = lane / LPR;
  const int limit = min(max(len, 0), cap);       // a stale slot: cap rows
  const int n_live = (limit + split_rows - 1) / split_rows;
  T* ob = out + (static_cast<size_t>(b) * H + j * G) * D;
  if (n_live == 0) {                             // length 0 gives 0
    if (sp == 0) {
      for (int i = tid; i < G * D; i += NT) store(ob + i, 0.f);
    }
    return;
  }
  if (sp >= n_live) return;                      // past the slot's length
  const int r_begin = sp * split_rows;
  const int r_end = min(r_begin + split_rows, limit);

  float qv[G][EPL];
  const float sl2 = scale * kLog2e;
  const T* qb = q + (static_cast<size_t>(b) * H + j * G) * D + c * EPL;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[g][e] = to_float(qb[g * D + e]) * sl2;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = neg_inf();
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t head_off = static_cast<size_t>(j) * D + c * EPL;
  for (int r0 = r_begin; r0 < r_end; r0 += STEP) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + (warp * U + u) * RPW + slot;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end) {                           // never past the length
        const size_t off = rows(r) * row_stride + head_off;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      unpack16<T>(kr[u], kf);
      const bool ok = r0 + (warp * U + u) * RPW + slot < r_end;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qv[g][e], kf[e], d);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
          d += __shfl_xor_sync(0xffffffffu, d, o);
        }
        s[u][g] = ok ? d : neg_inf();
      }
    }
    float base[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float mn = fmaxf(m[g], mx);
      base[g] = mn == neg_inf() ? 0.f : mn;
      const float alpha = fast_exp2(m[g] - base[g]);
      m[g] = mn;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      unpack16<T>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = fast_exp2(s[u][g] - base[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // the warp's RPW row groups, by shuffles; then the warps, in order
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ao[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
      merge<EPL>(m[g], l[g], acc[g], __shfl_xor_sync(0xffffffffu, m[g], o),
                 __shfl_xor_sync(0xffffffffu, l[g], o), ao);
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sAcc[warp][g][c * EPL + e] = acc[g][e];
      if (lane == 0) {
        sM[warp][g] = m[g];
        sL[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  float* pp = part + ((static_cast<size_t>(b) * KV + j) * gridDim.z + sp) * PART;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float mb = sM[0][g], lb = sL[0][g], ab = sAcc[0][g][d];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      merge<1>(mb, lb, &ab, sM[w][g], sL[w][g], &sAcc[w][g][d]);
    }
    if (n_live == 1) {
      store(ob + i, ab / lb);
    } else {
      pp[i] = ab;
      if (d == 0) {
        pp[G * D + g] = mb;
        pp[G * D + G + g] = lb;
      }
    }
  }
  if (n_live == 1) return;

  // the last split to arrive combines all of them
  __threadfence();
  __syncthreads();
  int* ticket = arrivals + static_cast<size_t>(b) * KV + j;
  if (tid == 0) {
    sLast = atomicAdd(ticket, 1) == n_live - 1;
    if (sLast) atomicExch(ticket, 0);            // ready for the next call
  }
  __syncthreads();
  if (!sLast) return;
  __threadfence();
  const float* pb =
      part + (static_cast<size_t>(b) * KV + j) * gridDim.z * PART;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float mb = __ldcg(pb + G * D + g), lb = __ldcg(pb + G * D + G + g);
    float ab = __ldcg(pb + i);
    for (int t = 1; t < n_live; ++t) {
      const float* pt = pb + static_cast<size_t>(t) * PART;
      const float at = __ldcg(pt + i);
      merge<1>(mb, lb, &ab, __ldcg(pt + G * D + g), __ldcg(pt + G * D + G + g),
               &at);
    }
    store(ob + i, ab / lb);
  }
}

// K3: k/v are pools (NB, bs, KV, D); a split is bps pool blocks.
template <typename T, int D, int G>
__global__ void __launch_bounds__(32 * kSplitWarps)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ part,
                              int* __restrict__ arrivals, int KV, int bs,
                              int MBS, int bps, float scale) {
  const int b = blockIdx.y;
  decode_split<T, D, G>(q, k, v, out, part, arrivals,
                        PagedRows{tables + static_cast<size_t>(b) * MBS, bs},
                        lengths[b], MBS * bs, bps * bs, KV, scale);
}

// K4: k/v are caches (B, S, KV, D); a split is split_rows rows.
template <typename T, int D, int G>
__global__ void __launch_bounds__(32 * kSplitWarps)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ arrivals,
                        int KV, int S, int split_rows, float scale) {
  const int b = blockIdx.y;
  decode_split<T, D, G>(q, k, v, out, part, arrivals,
                        SlotRows{static_cast<size_t>(b) * S}, lengths[b], S,
                        split_rows, KV, scale);
}

// The operands of either launch: tables is null for the slot layout.
struct Args {
  const void *q, *k, *v, *tables, *lengths;
  void* out;
  float* part;
  int* arrivals;
  int B, KV;
  int bs, MBS, bps;                // paged
  int S, split_rows;               // slot
  float scale;
  cudaStream_t stream;
};

int n_splits(const Args& a) {
  return a.tables != nullptr ? (a.MBS + a.bps - 1) / a.bps
                             : (a.S + a.split_rows - 1) / a.split_rows;
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.KV, a.B, n_splits(a));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* lengths = static_cast<const int*>(a.lengths);
  T* out = static_cast<T*>(a.out);
  if (a.tables != nullptr) {
    paged_decode_attention_kernel<T, D, G><<<grid, 32 * kSplitWarps, 0,
                                             a.stream>>>(
        q, k, v, static_cast<const int*>(a.tables), lengths, out, a.part,
        a.arrivals, a.KV, a.bs, a.MBS, a.bps, a.scale);
  } else {
    decode_attention_kernel<T, D, G><<<grid, 32 * kSplitWarps, 0,
                                       a.stream>>>(
        q, k, v, lengths, out, a.part, a.arrivals, a.KV, a.S, a.split_rows,
        a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(const Args& a, int G) {
  switch (G) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(const Args& a, int D, int G) {
  switch (D) {
    case 16: return by_group<T, 16>(a, G);
    case 32: return by_group<T, 32>(a, G);
    case 64: return by_group<T, 64>(a, G);
    case 128: return by_group<T, 128>(a, G);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.
cudaError_t dispatch(const Args& a, int H, int D, int dtype) {
  if (a.B <= 0 || a.B > kMaxGridYZ || a.KV <= 0 || H % a.KV != 0
      || n_splits(a) > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return by_dim<float>(a, D, H / a.KV);
  if (dtype == 1) return by_dim<bf16>(a, D, H / a.KV);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each launch returns a cudaError_t (0 on success) and runs one kernel.
// Both take a workspace after out: partials, (B, KV, splits, H / KV, D + 2)
// float32 scratch, and arrivals, B * KV int32 that must hold zeros, and
// hold zeros again when the kernel ends (calls that share them must be
// ordered, as on one stream). Paged: splits = ceil(MBS / blocks_per_split).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* partials,
    void* arrivals, int B, int H, int KV, int D, int block_size,
    int max_blocks_per_seq, int blocks_per_split, float scale, int dtype,
    void* stream) {
  if (tables == nullptr || block_size <= 0 || max_blocks_per_seq <= 0
      || blocks_per_split <= 0) {
    return cudaErrorInvalidValue;
  }
  const Args a{q, k_pool, v_pool, tables, lengths, out,
               static_cast<float*>(partials), static_cast<int*>(arrivals),
               B, KV, block_size, max_blocks_per_seq, blocks_per_split, 0, 0,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, H, D, dtype);
}

// Slot: k/v caches (B, S, KV, D); splits = ceil(S / rows_per_split).
extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, void* partials, void* arrivals, int B,
    int H, int KV, int D, int S, int rows_per_split, float scale, int dtype,
    void* stream) {
  if (S <= 0 || rows_per_split <= 0) return cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, nullptr, lengths, out,
               static_cast<float*>(partials), static_cast<int*>(arrivals),
               B, KV, 0, 0, 0, S, rows_per_split, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch(a, H, D, dtype);
}

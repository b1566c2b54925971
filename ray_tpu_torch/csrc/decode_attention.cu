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
// paged_decode_attention_kernel (K3), split-KV (flash-decoding): the grid
// is (kv head, slot, split), a split being a fixed run of pool blocks
// (ops/paged_decode_attention.py::SPLIT_ROWS rows), so a long slot spreads
// over many SMs (at the engine's 8b decode, 4 slots of 1024 rows: 256
// blocks instead of 32). A split past the slot's length exits at once;
// rows past the length, and table entries past the valid prefix, are never
// read (a stale slot with len > MBS * bs reads MBS blocks). Inside a
// split, each lane loads 16 bytes of a K row and of a V row straight into
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
//
// decode_attention_kernel (K4), PR 1's simple design, until it takes the
// split design too:
//   * one thread block per (kv head, slot); the block handles the kv head's
//     whole query group, so each K/V row is read from device memory once;
//   * the block loops over the slot's 64-row tiles, staging the valid rows
//     of its kv head into shared memory with 16-byte loads; rows past the
//     slot's length are never read, so the loop bound is min(len, S) rows;
//   * shared rows are padded by one 4-byte word so that threads reading the
//     same column of consecutive rows hit distinct banks;
//   * one warp per query row runs the online-softmax recurrence.
// Inactive or released slots have all-zero table rows (the null block 0)
// or zero lengths: they read finite rows, and the caller discards their
// output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kSlotTile = 64;              // rows per tile, contiguous cache
constexpr int kMaxSmem = 232448;           // bytes a block may use on H100
constexpr int kSplitWarps = 4;             // paged: warps of a split block
constexpr int kMaxGridYZ = 65535;

template <typename T>
__device__ __forceinline__ float elem(const uint32_t* row, int d);

template <>
__device__ __forceinline__ float elem<float>(const uint32_t* row, int d) {
  return __uint_as_float(row[d]);
}

template <>
__device__ __forceinline__ float elem<bf16>(const uint32_t* row, int d) {
  return __bfloat162float(reinterpret_cast<const bf16*>(row)[d]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// ------------------------------------------------------------ K3, split-KV

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

// One block per (kv head j, slot b, split sp); split sp owns the rows
// [sp * bps * bs, (sp + 1) * bps * bs) of the slot, bps pool blocks. A lane
// loads 16 bytes of a K row and of a V row straight into registers: LPR
// lanes cover a row, a warp RPW rows at once, U rows per lane in flight.
// Scores for the whole GQA group come from the group's q vectors, held in
// registers (times scale log2 e), by FMAs and shuffles over the row's lanes;
// each group of LPR lanes runs its own online softmax in base 2. The lanes'
// states are merged by shuffles, the warps' in shared memory, both in a
// fixed order. A slot with one live split writes out directly; otherwise
// each split writes (max, sum, acc) per q head to `part` and the last split
// to arrive (a ticket on `arrivals`, which it resets to 0) combines the
// splits in split order, so the result does not depend on arrival order.
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
  const int len = max(lengths[b], 0);
  const int limit = min(len, MBS * bs);          // a stale slot: MBS blocks
  const int split_rows = bps * bs;
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

  const int* tb = tables + static_cast<size_t>(b) * MBS;
  const size_t row_stride = static_cast<size_t>(KV) * D;
  const size_t head_off = static_cast<size_t>(j) * D + c * EPL;
  for (int r0 = r_begin; r0 < r_end; r0 += STEP) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + (warp * U + u) * RPW + slot;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end) {                           // never past the length
        const int blk = r / bs;
        const size_t off =
            (static_cast<size_t>(__ldg(tb + blk)) * bs + (r - blk * bs))
                * row_stride + head_off;
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

struct PagedArgs {
  const void *q, *k, *v, *tables, *lengths;
  void* out;
  float* part;
  int* arrivals;
  int B, KV, bs, MBS, bps;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int G>
cudaError_t paged_launch(const PagedArgs& a) {
  const dim3 grid(a.KV, a.B, (a.MBS + a.bps - 1) / a.bps);
  paged_decode_attention_kernel<T, D, G><<<grid, 32 * kSplitWarps, 0,
                                           a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.part,
      a.arrivals, a.KV, a.bs, a.MBS, a.bps, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t paged_group(const PagedArgs& a, int G) {
  switch (G) {
    case 1: return paged_launch<T, D, 1>(a);
    case 2: return paged_launch<T, D, 2>(a);
    case 4: return paged_launch<T, D, 4>(a);
    case 8: return paged_launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t paged_dim(const PagedArgs& a, int D, int G) {
  switch (D) {
    case 16: return paged_group<T, 16>(a, G);
    case 32: return paged_group<T, 32>(a, G);
    case 64: return paged_group<T, 64>(a, G);
    case 128: return paged_group<T, 128>(a, G);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ K4, slot

// 4-byte words of one staged K or V row (one word of padding).
template <typename T>
__host__ __device__ __forceinline__ int row_words(int D) {
  return D * static_cast<int>(sizeof(T)) / 4 + 1;
}

template <typename T>
size_t smem_bytes(int tile, int group, int D) {
  return 4 * (2 * static_cast<size_t>(tile) * row_words<T>(D)
              + 2 * static_cast<size_t>(group) * D      // q, acc
              + static_cast<size_t>(group) * tile       // scores
              + 3 * static_cast<size_t>(group));        // m, l, alpha
}

// k/v are caches (B, S, KV, D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ out, int H, int KV, int D, int tile, int S,
              float scale) {
  const int j = blockIdx.x;                  // kv head
  const int b = blockIdx.y;                  // slot
  const int group = H / KV;
  const int rw = row_words<T>(D);
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;   // per row

  extern __shared__ uint32_t smem[];
  uint32_t* sK = smem;
  uint32_t* sV = sK + tile * rw;
  float* sQ = reinterpret_cast<float*>(sV + tile * rw);
  float* sAcc = sQ + group * D;
  float* sS = sAcc + group * D;
  float* sM = sS + group * tile;
  float* sL = sM + group;
  float* sAlpha = sL + group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const int len = max(lengths[b], 0);
  // rows this slot attends over, and the number of tiles holding them
  const int limit = min(len, S);
  const int ntiles = (limit + tile - 1) / tile;

  const T* qb = q + (static_cast<size_t>(b) * H + j * group) * D;
  for (int i = tid; i < group * D; i += blockDim.x) {
    sQ[i] = to_float(qb[i]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    sM[g] = kNegInf;
    sL[g] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < ntiles; ++it) {
    const int rows = min(tile, limit - it * tile);
    // element offset of row 0
    const size_t base = ((static_cast<size_t>(b) * S + it * tile) * KV + j) * D;
    const size_t row_stride = static_cast<size_t>(KV) * D;
    for (int i = tid; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i % chunks;
      const uint4 kc = reinterpret_cast<const uint4*>(
          k + base + r * row_stride)[c];
      const uint4 vc = reinterpret_cast<const uint4*>(
          v + base + r * row_stride)[c];
      uint32_t* dk = sK + r * rw + c * 4;
      uint32_t* dv = sV + r * rw + c * 4;
      dk[0] = kc.x; dk[1] = kc.y; dk[2] = kc.z; dk[3] = kc.w;
      dv[0] = vc.x; dv[1] = vc.y; dv[2] = vc.z; dv[3] = vc.w;
    }
    __syncthreads();

    // scores: one thread per (query row g, key row r)
    for (int i = tid; i < group * rows; i += blockDim.x) {
      const int g = i / rows, r = i % rows;
      const float* qg = sQ + g * D;
      const uint32_t* kr = sK + r * rw;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc += qg[d] * elem<T>(kr, d);
      sS[g * tile + r] = acc * scale;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int g = warp; g < group; g += nwarps) {
      float* s = sS + g * tile;
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, s[r]);
      mx = warp_max(mx);
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(s[r] - m_new);
        s[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V: one thread per (query row g, column d)
    for (int i = tid; i < group * D; i += blockDim.x) {
      const int g = i / D, d = i % D;
      const float* p = sS + g * tile;
      float a = sAcc[i] * sAlpha[g];
      for (int r = 0; r < rows; ++r) a += p[r] * elem<T>(sV + r * rw, d);
      sAcc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * H + j * group) * D;
  for (int i = tid; i < group * D; i += blockDim.x) {
    const float l = sL[i / D];
    store(ob + i, sAcc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
cudaError_t slot_launch(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, int B, int H, int KV,
                        int D, int S, float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0
      || (D * static_cast<int>(sizeof(T))) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>(kSlotTile, H / KV, D);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_kernel<T><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), H, KV, D, kSlotTile, S, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
// One call runs one kernel. partials: (B, KV, ceil(MBS / blocks_per_split),
// H / KV, D + 2) float32 scratch; arrivals: B * KV int32 that must hold
// zeros, and hold zeros again when the kernel ends (calls that share them
// must be ordered, as on one stream).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* partials,
    void* arrivals, int B, int H, int KV, int D, int block_size,
    int max_blocks_per_seq, int blocks_per_split, float scale, int dtype,
    void* stream) {
  if (B <= 0 || B > kMaxGridYZ || KV <= 0 || H % KV != 0 || block_size <= 0
      || max_blocks_per_seq <= 0 || blocks_per_split <= 0
      || (max_blocks_per_seq + blocks_per_split - 1) / blocks_per_split
             > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  const PagedArgs a{q, k_pool, v_pool, tables, lengths, out,
                    static_cast<float*>(partials), static_cast<int*>(arrivals),
                    B, KV, block_size, max_blocks_per_seq, blocks_per_split,
                    scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return paged_dim<float>(a, D, H / KV);
  if (dtype == 1) return paged_dim<bf16>(a, D, H / KV);
  return cudaErrorInvalidValue;
}

extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int B, int H, int KV, int D, int S,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return slot_launch<float>(q, k_cache, v_cache, lengths, out, B, H, KV,
                              D, S, scale, s);
  }
  if (dtype == 1) {
    return slot_launch<bf16>(q, k_cache, v_cache, lengths, out, B, H, KV, D,
                             S, scale, s);
  }
  return cudaErrorInvalidValue;
}

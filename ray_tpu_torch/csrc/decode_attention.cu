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
// Design (simple and correct first; a fast design with TMA, split-KV across
// SMs and wgmma is later work):
//   * one thread block per (kv head, slot); the block handles the kv head's
//     whole query group, so each K/V row is read from device memory once;
//   * the block loops over the slot's tiles of rows (one pool block when
//     paged, 64 rows when contiguous), staging the valid rows of its kv head
//     into shared memory with 16-byte loads; rows past the slot's length are
//     never read, so the loop bound is min(ceil(len / tile), MBS) pool
//     blocks (a stale slot may pass len > MBS * bs; tables[b, MBS] is never
//     indexed) or min(len, S) rows of a contiguous cache;
//   * shared rows are padded by one 4-byte word so that threads reading the
//     same column of consecutive rows hit distinct banks;
//   * one warp per query row runs the online-softmax recurrence.
// Inactive or released slots have all-zero table rows (the null block 0):
// they read finite rows of block 0, and the caller discards their output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kSlotTile = 64;              // rows per tile, contiguous cache
constexpr int kMaxSmem = 232448;           // bytes a block may use on H100

template <typename T>
__device__ __forceinline__ float elem(const uint32_t* row, int d);

template <>
__device__ __forceinline__ float elem<float>(const uint32_t* row, int d) {
  return __uint_as_float(row[d]);
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* row,
                                                     int d) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[d]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
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

// PAGED: k/v are pools (NB, tile, KV, D) and extent is MBS (tables' width).
// Otherwise k/v are caches (B, extent, KV, D) with extent = S.
template <typename T, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ tables,
              const int* __restrict__ lengths, T* __restrict__ out,
              int H, int KV, int D, int tile, int extent, float scale) {
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
  const int limit = PAGED ? len : min(len, extent);
  const int ntiles = PAGED ? min((limit + tile - 1) / tile, extent)
                           : (limit + tile - 1) / tile;

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
    size_t base;                             // element offset of row 0
    if (PAGED) {
      const int phys = tables[static_cast<size_t>(b) * extent + it];
      base = (static_cast<size_t>(phys) * tile * KV + j) * D;
    } else {
      base = ((static_cast<size_t>(b) * extent + it * tile) * KV + j) * D;
    }
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

template <typename T, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out,
                   int B, int H, int KV, int D, int tile, int extent,
                   float scale, cudaStream_t stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || tile <= 0 || extent <= 0
      || (D * static_cast<int>(sizeof(T))) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>(tile, H / KV, D);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_kernel<T, PAGED><<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), H, KV, D,
      tile, extent, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, int B, int H,
    int KV, int D, int block_size, int max_blocks_per_seq, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, true>(q, k_pool, v_pool, tables, lengths, out, B,
                               H, KV, D, block_size, max_blocks_per_seq,
                               scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, true>(q, k_pool, v_pool, tables, lengths,
                                       out, B, H, KV, D, block_size,
                                       max_blocks_per_seq, scale, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int decode_attention_launch(
    const void* q, const void* k_cache, const void* v_cache,
    const void* lengths, void* out, int B, int H, int KV, int D, int S,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, false>(q, k_cache, v_cache, nullptr, lengths, out,
                                B, H, KV, D, kSlotTile, S, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, false>(q, k_cache, v_cache, nullptr,
                                        lengths, out, B, H, KV, D,
                                        kSlotTile, S, scale, s);
  }
  return cudaErrorInvalidValue;
}
